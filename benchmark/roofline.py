"""The megakernel's work and the chip's peaks, for its roofline share.

The count reads the same whatever implements the kernel: it is worked out
from the reference's replay, never from a counter of the kernel's walk
(no box, cluster, page or node test enters it).

* Operations: the launch's path segments (one per path-loop iteration of
  a pixel, the reference's tally over the sampled pixels scaled to the
  image) times the configuration's ``ops_per_segment``, which is frozen
  in its file from the reference's tally of what segments hit
  (``shade_ops``).
* Bytes: the packed tables read once (search and payload tables, image
  atlas, light table) and the f32 radiance image written once.
* Peaks: NVIDIA H100 SXM, 67 TFLOP/s f32 outside the tensor cores and
  3.35 TB/s of HBM, at the full 700 W power limit.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Float operations of a path segment outside the search, by what it hit,
# as ``cudaraytracer_tpu_torch/ops/cuda/render_kernel.py::SHADE_OPS``
# counts them from csrc/render_kernel.cu, and of the one primitive test
# that found each hit (``hit_kernel.OPS``: sphere, rect, triangle,
# medium).
SHADE_OPS = {"raygen": 50, "miss": 20, "hit": 80, "smooth": 50, "image": 20,
             "noise": 1680, "medium": 50, "nee": 55, "nee_slot": 20,
             "qmc": 16}
TEST_OPS = {"sphere": 27, "rect": 15, "tri": 40, "med": 40}


def shade_ops(tally: dict) -> float:
    """Operations per segment of a reference tally (``render_lanes``)."""
    ops = sum(SHADE_OPS[k] * tally.get(k, 0) for k in SHADE_OPS)
    ops += sum(TEST_OPS[k] * tally.get("hit_" + k, 0) for k in TEST_OPS)
    return ops / max(tally.get("segments", 0), 1)


def launch_ops(segments_per_lane: float, width: int, height: int,
               ops_per_segment: float) -> float:
    """Operations of one whole-image launch."""
    return segments_per_lane * width * height * ops_per_segment


def launch_bytes(table_bytes: int, width: int, height: int) -> int:
    """Bytes one launch needs: its tables once, its f32 image once."""
    return int(table_bytes) + width * height * 3 * 4


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
