"""Closest hit through the flat BVH on the card: ``csrc/bvh_kernel.cu``.

The kernel of ``render --accel bvh``.  It replaces no TPU kernel: the
JAX package runs the traversal in XLA
(``cudaraytracer_tpu/ops/bvh_traverse.py::bvh_closest_hit`` :102), and its
plain PyTorch version, ``ops/bvh_traverse.py::bvh_closest_hit_plain``,
takes a few dozen launches and a host read per DFS step, up to
``n_nodes + 1`` steps.  ``bvh_hit`` launches the kernel (one thread walks
one ray) on CUDA tensors and counts its launches (``bvh_hit.launches``);
``ops/bvh_traverse.py::bvh_closest_hit`` is the dispatch a caller uses.

``BOX_OPS``, ``LEAF_OPS`` and ``NODE_BYTES`` price a launch's work from
its per-ray counters (``STATS``; ``scripts/bvh_paths.py::work_bound``).
"""

from __future__ import annotations

import torch

from ...utils import trace
from ..bvh_traverse import STATS, check_bvh_inputs
from ..intersect import BIG
from . import build

# f32 operations of one node's slab test (6 subtractions, 6 products,
# 6 min/max of the slabs, 4 for the entry and exit, the compare) and of
# each leaf kind's test, counted from ops/bvh_traverse.py::_leaf_prim_t
BOX_OPS = 23
LEAF_OPS = {"sphere_tests": 34, "rect_tests": 16, "tri_tests": 51}
NODE_BYTES = 32  # f32[6] box, i32 prim, i32 skip


def bvh_hit(org, dirn, bvh, prim_type, center, size, t_min: float = 0.001,
            t_max: float | None = None, edge1=None, edge2=None,
            with_stats: bool = False):
    """The kernel's closest hit: (hit bool[R], t f32[R], prim i32[R]), and
    with ``with_stats`` the per-ray counters i32[R, len(STATS)], from the
    counting instantiation.  The same contract as
    ``bvh_closest_hit_plain``, bit for bit.  Needs CUDA tensors."""
    if org.device.type != "cuda":
        raise ValueError(f"bvh_hit runs on cuda tensors, not {org.device}")
    check_bvh_inputs(org, dirn, bvh, prim_type, center, size, edge1, edge2)
    r = org.shape[0]
    dev = org.device
    hit = torch.empty((r,), dtype=torch.bool, device=dev)
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    prim = torch.empty((r,), dtype=torch.int32, device=dev)
    stats = (torch.empty((r, len(STATS)), dtype=torch.int32, device=dev)
             if with_stats else None)
    lib = build.load_library()
    with torch.cuda.device(dev):
        rc = lib.crt_bvh_closest_hit(
            bvh.node_min.data_ptr(), bvh.node_max.data_ptr(),
            bvh.node_prim.data_ptr(), bvh.node_skip.data_ptr(),
            int(bvh.n_nodes), prim_type.data_ptr(), center.data_ptr(),
            size.data_ptr(), None if edge1 is None else edge1.data_ptr(),
            None if edge2 is None else edge2.data_ptr(), org.data_ptr(),
            dirn.data_ptr(), r, float(t_min),
            float(BIG if t_max is None else t_max),
            None if stats is None else stats.data_ptr(), hit.data_ptr(),
            t.data_ptr(), prim.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "crt_bvh_closest_hit", rc)
    bvh_hit.launches += 1
    return (hit, t, prim, stats) if with_stats else (hit, t, prim)


bvh_hit.launches = 0
trace.register("bvh_hit.launches", bvh_hit)

