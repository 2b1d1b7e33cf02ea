"""The traffic generator: deterministic per seed, different between
seeds, the same distributions for every seed."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import generator  # noqa: E402

MIXES = sorted(p.stem for p in (ROOT / "benchmark" / "traffic").glob("*.json"))
START = {"brushed_metal": (0.0, 1.5, 1.45)}


def _frames(mix, seed, n=200):
    params = json.loads((ROOT / "benchmark" / "traffic" / f"{mix}.json")
                        .read_text())
    t = generator.Traffic(params, generator.stream(seed, "window"), START)
    return [t.next_frame() for _ in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_actions(mix):
    big = 2 ** 31 + 12345
    assert _frames(mix, big) == _frames(mix, big)


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_actions_alike(mix):
    a, b = _frames(mix, 3), _frames(mix, 4)
    if not any(a):
        assert a == b  # a mix without input: nothing to differ
        return
    assert a != b
    # the same kinds of action, in about the same numbers
    kinds = [sorted(x[0] for f in fr for x in f) for fr in (a, b)]
    for k in ("mouse", "keys", "move"):
        na, nb = kinds[0].count(k), kinds[1].count(k)
        assert abs(na - nb) <= 0.2 * max(na, nb, 1) + 5


def test_streams_are_independent():
    w = generator.stream(7, "window").random(4)
    c = generator.stream(7, "check").random(4)
    assert not np.allclose(w, c)


def test_drag_walk_stays_near_its_start():
    fr = _frames("edit", 11, n=400)
    c = np.array([f[-1][2] for f in fr])
    assert np.abs(c - np.array(START["brushed_metal"])).max() < 1.0
