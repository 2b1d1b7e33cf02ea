"""The whole run on the CPU at a small image, past the look for a card:
sound it comes out correct; with the timed path broken underneath, or
with the bfloat16 control in the port's place, it comes out not correct.

The faults a cell of this benchmark can have: a step that returns its
state unchanged (a launch that adds nothing), half of the batch left out
with the rest standing in for it (half the image's rows copied from the
other half), and an answer altered where it is produced (one level of one
pixel of the RGBA8 frame).  No cell runs on more than one chip, so none
has an exchange between chips to leave out."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run, spec  # noqa: E402

BENCH = spec.benchmark_json()
CELLS = [w["name"] for w in BENCH["workloads"]]
SIZE = (32, 18)
SECONDS = 0.5


def _run(cell, control=False):
    return run.run_cell(spec.Cell(BENCH, cell), 2 ** 31 + 99, SECONDS,
                        False, "cpu", size=SIZE, control=control)


def _state_unchanged(monkeypatch):
    from cudaraytracer_tpu_torch.viewer import app

    def accumulate(self, cam, frame_index, max_depth, accum, counts=None,
                   spp=1, sample_base=0):
        # a launch's time, so that the window holds as many frames as a
        # sound one and the reference replays no more launches
        time.sleep(0.02)
        return accum

    monkeypatch.setattr(app._CudaPipeline, "accumulate", accumulate)


def _half_batch(monkeypatch):
    from cudaraytracer_tpu_torch.viewer import app

    orig = app.render_sample

    def render_sample(*a, **k):
        out = orig(*a, **k)
        half = out.shape[0] // 2
        out[half:2 * half] = out[:half].clone()
        return out

    monkeypatch.setattr(app, "render_sample", render_sample)


def _answer_altered(monkeypatch):
    from cudaraytracer_tpu_torch.viewer import app

    orig = app.to_rgba8

    def to_rgba8(display):
        out = orig(display)
        out[0, 0, 0] ^= 1
        return out

    monkeypatch.setattr(app, "to_rgba8", to_rgba8)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = _run(cell, control=True)
    assert not out["correct"], out["checks"]
