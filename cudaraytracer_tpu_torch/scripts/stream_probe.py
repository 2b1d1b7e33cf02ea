"""Table-staging probe: the cost of staging a table tile into shared memory.

    python -m cudaraytracer_tpu_torch.scripts.stream_probe [--tile-len 512]
        [--lo 64] [--hi 512] [--rows 1] [--device cuda]

The port of ``tools/stream_probe.py``, with its flags and its one-line
JSON schema.  The question on the card: what does it cost to stage a
table tile from global memory into shared memory on each visit (a bulk
async copy onto an mbarrier), against reading it in place through L1/L2
(``ops/cuda/stream_probe.py``, ``csrc/stream_probe.cu``)?  For each
variant of the table shape (rows 1: resident, stream; rows > 1:
resident, stream2d, streamrows) it walks ``--lo`` and ``--hi`` tiles of
``--rows`` x ``--tile-len`` int32s, checks that every CTA's sum is
``expected`` (a wrong sum raises), and times each walk (CUDA events
around 8 launches after a warm-up).  Per-tile cost is the slope of the
time over the tile count; a staged variant's per-tile cost less
resident's is its staging overhead.  ``--device cpu`` runs the plain
version (``mode`` "plain": host times, no device metric).  The card's
name and power limit belong beside any number kept from it
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops.cuda.stream_probe import (check_probe, expected, probe_table,
                                     stream_probe, variants_for)


def _time_ms(fn, frames: int, cuda: bool) -> float:
    """Mean ms per call of ``frames`` calls after a warm-up call: CUDA
    events with ``cuda``, else the host clock."""
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        return (time.perf_counter() - t0) / frames * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(frames):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / frames


def run(tile_len: int = 512, lo: int = 64, hi: int = 512, rows: int = 1,
        device="cuda", frames: int = 8) -> dict:
    """The probe's result object (tools/stream_probe.py's keys)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False "
                           "(pass device='cpu' for the plain version)")
    if not 0 < lo < hi:
        raise ValueError(f"need 0 < --lo < --hi, got {lo}, {hi}")
    out: dict = {"tile_len": tile_len, "rows": rows,
                 "mode": "compiled" if dev.type == "cuda" else "plain"}
    variants = variants_for(rows)
    tabs = {n: probe_table(n, tile_len, rows, dev) for n in (lo, hi)}
    for variant in variants:  # every argument checked before any walk
        check_probe(tabs[lo], variant, 1)
    for variant in variants:
        for n, tab in tabs.items():
            sums = stream_probe(tab, variant)
            want = expected(n, tile_len, rows)
            bad = int((sums != want).sum())
            if bad:
                raise AssertionError(
                    f"{variant}: {bad} of {sums.numel()} CTA sums != {want} "
                    f"at {n} tiles")
        ms_lo, ms_hi = (_time_ms(lambda t=tabs[n]: stream_probe(t, variant),
                                 frames, dev.type == "cuda")
                        for n in (lo, hi))
        out[variant] = {"ms_lo": round(ms_lo, 4), "ms_hi": round(ms_hi, 4),
                        "us_per_tile": round((ms_hi - ms_lo) / (hi - lo)
                                             * 1e3, 3)}
    for variant in variants[1:]:
        out[f"dma_overhead_us_per_tile_{variant}"] = round(
            out[variant]["us_per_tile"] - out["resident"]["us_per_tile"], 3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile-len", type=int, default=512,
                    help="int32s per tile row (a multiple of 4: the bulk "
                         "copies move 16-byte multiples)")
    ap.add_argument("--lo", type=int, default=64)
    ap.add_argument("--hi", type=int, default=512,
                    help="tile counts for the slope (the table holds "
                         "hi * rows * tile_len * 4 bytes)")
    ap.add_argument("--rows", type=int, default=1,
                    help=">1: 2-D tiles (stream2d = one [rows, tile_len] "
                         "copy; streamrows = rows per-row copies)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.tile_len, args.lo, args.hi, args.rows,
                         args.device)), flush=True)


if __name__ == "__main__":
    main()
