"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

Runs from the root of a checkout, on a machine whose CUDA cards the cell
asks for (``BENCHMARK.json``: ``workloads``); it fails, printing no result,
without them.  Set-up (``drive.Window``) builds the cell's scene from the
seed, the render loop and its warm-up; the window runs frames for
``--seconds``; then the port's state is released and the plain reference
(``check.py``) judges the frames the window kept.  The last line of
standard output is the result:

    {"correct": ..., "attempted": frames, "failed": 0, "metrics": {...},
     "device": {...}, ["breakdown": {...},] "checks": {...}}

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (host spans and a device trace of the traffic's first
frames), each from its reader in ``benchmark/metrics/``.  ``checks`` holds
each number compared with its limit; the same lines end standard error.
``--control 1`` puts the reference, computed in bfloat16, in the port's
place for the comparison (the limits' upper readings): its ``correct``
is expected false.

The run imports neither JAX nor the JAX package: it exits with code 3,
printing no result, when ``sys.modules`` holds either after the window.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# top-level module names that the process must never hold (compared whole:
# the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "cudaraytracer_tpu")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             size=None, control: bool = False,
             t_process: float | None = None) -> dict:
    """Set-up, window, check and metrics of one run -> the result dict."""
    import numpy as np
    import torch

    from . import check, devtrace, drive, spec

    win = drive.Window(cell, seed, device=device, size=size,
                       t_process=t_process)
    t0 = time.perf_counter()
    rec = win.run(seconds, trace, int(cell.traffic["snapshots"]))
    t1 = time.perf_counter()
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)
    prof = rec.pop("prof")
    rec["device_trace"] = devtrace.reduce(prof) if prof is not None else None
    del prof
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    chk = check.run_check(win, rec, dev, control=control)
    print(f"timing: setup {win.setup_s!r} s, window {t1 - t0!r} s, trace "
          f"reduction and check {time.perf_counter() - t1!r} s, "
          f"{chk['lanes']} reference lanes", file=sys.stderr)
    q = np.percentile(rec["frame_ms"], [5, 50, 95, 99, 100])
    print(f"frames: {rec['frames']}, ms p5/p50/p95/p99/max "
          f"{' '.join(f'{v:.2f}' for v in q)}, garbage collections by "
          f"generation in the window {rec['gc_runs']}", file=sys.stderr)
    if rec["parts_ms"]:
        pr = np.percentile(np.asarray(rec["parts_ms"]), [50, 95], axis=0)
        print(f"host: render call p50/p95 {pr[0, 0]:.2f}/{pr[1, 0]:.2f} ms, "
              f"display call {pr[0, 1]:.2f}/{pr[1, 1]:.2f} ms",
              file=sys.stderr)
    rec.pop("snapshots")
    rec.update(setup_s=win.setup_s, reference=chk, config=cell.config,
               traffic=cell.traffic)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = {k: {"value": v, "limit": float(cell.limits[k])}
              for k, v in chk["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
             "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
             "count": cell.chips,
             "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": bool(correct), "attempted": rec["frames"], "failed": 0,
           "metrics": metrics, "device": dinfo}
    if trace and rec["device_trace"]:
        dt = rec["device_trace"]
        dinfo.update(busy_s=dt["busy_s"], window_s=dt["window_s"])
        out["breakdown"] = devtrace.breakdown(dt)
    out["checks"] = checks
    return out


class ForbiddenImport(RuntimeError):
    """The process holds JAX or the JAX package."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")

    import torch

    from . import spec

    cell = spec.Cell(spec.benchmark_json(), args.workload)
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False; the port's "
              "kernels need an NVIDIA GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", control=bool(args.control),
                       t_process=T_PROCESS)
    except ForbiddenImport as e:
        print(f"benchmark: the process holds {e.args[0]} (JAX or the JAX "
              "package)", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    card = power_limit()
    if card:
        print(f"card: {card}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
