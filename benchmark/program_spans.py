"""The port's own spans over a run's window, for the per-layer metrics of
source ``program_span``.

The port records host spans in memory (``cudaraytracer_tpu_torch/utils/
trace.py``: one recorder per process).  A run's window is the last render
layer's spans whose frame index is at least the traffic's
``warmup_frames``: the frames of the harness's own ``spans_ms``.  They are
read only where the harness recorded its synced spans (``--trace 1``), so
that no span holds device work an earlier call queued.  Every read gives
None where the record or the program has no such span, as in a port
without the recorder.
"""

from __future__ import annotations


def window(rec: dict) -> dict | None:
    """The recorder's summary of the window (``Recorder.summary``: by
    span name, ``count``, ``mean_ms``, ``bytes``, ...), or None."""
    if not rec.get("spans_ms"):
        return None
    try:
        from cudaraytracer_tpu_torch.utils import trace
    except ImportError:
        return None
    layer = trace.RECORDER.last_layer()
    if layer is None:
        return None
    return trace.RECORDER.summary(
        layer=layer, min_frame=int(rec["traffic"]["warmup_frames"]))


def mean_ms(rec: dict, name: str) -> float | None:
    """Mean ms of the window's spans ``name``."""
    s = (window(rec) or {}).get(name)
    return s["mean_ms"] if s else None


def bytes_per_span(rec: dict, name: str) -> float | None:
    """Bytes moved between host and device inside each of the window's
    spans ``name``, their children's included, on average."""
    s = (window(rec) or {}).get(name)
    return s["bytes"] / s["count"] if s else None
