"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cudaraytracer_tpu_torch/csrc/`` (one
nvcc per source, run together), shows each instantiation's registers and
spill stores (beside the numbers PERF.md recorded for the earlier ones),
checks each kernel against its plain PyTorch version on the card (the
closest hit on 2^20 uniform rays, on the sorted bounce wavefronts of
1280x720 frames of rtow_final, terrain_big and cornell_mesh_light and on
rays that graze block corners, ``scripts/bounce_rays.py``; the resident
G-buffer and the closest hit walk a warp's rays together,
``search.cuh::closest_hit_packet``, and their counting entries' output
must equal the timed entries' and their counters, ``hit_stats``, the
plain walk's), with
the render options too (NEE on the lit scenes, QMC, a random half of the
tiles masked), drives the CLI paths (``python -m cudaraytracer_tpu_torch
render`` at 1280x720 with ``--denoise --aov``: ``--scene book2_final
--nee --qmc --adaptive``, the main path, every feature of the scene model
in one render (4,800 triangles, a rect light, an image and a marble
sphere, a subsurface medium ball, a whole-scene fog sphere around the
camera, a moving sphere, ~1000 small spheres) with every render option;
``--scene book2_final`` without options; ``--scene terrain_big``, the largest scene, 20,000 smooth image-textured
triangles; ``--obj`` on an OBJ model written to a temporary directory,
with ``--obj-smooth``; ``--scene rtow_final``; no ``--scene``, the
default scene; and ``--nee`` on mesh_smooth, terrain, terrain_big,
bounce and a smooth OBJ, which the last NEE instantiations serve) with
the launch counts set to 0 before each and read after it (each PNG one
denoised display: four launches of the denoise kernel), checks the
denoise kernel (``csrc/denoise_kernel.cu``) against its plain version
bit for bit on a book2_final frame and its G-buffer (1 and 4 passes,
with and without a variance plane), and times every kernel at the
main-path shapes, the denoise kernel beside its bound, the megakernel on
every scene without options, with QMC, with a random half of its tiles
masked and, where an instantiation serves it, with NEE, with the lane
and CTA utilisation of its path loop (``scripts/megakernel_util.py``'s
cases: a one-thread-per-pixel grid's from the plain version's per-pixel
ray counts, and the refilling kernel's own in the media
instantiations) and the tree walk's box and primitive tests a ray on
terrain_big and rtow_final (the plain replay, phase ``tree_walk``),
and checks the refilling kernel's ragged batches
(cornell_smoke ``--nee --qmc`` at 1277x719, and in a half-masked band
of 333 rows; every output block NaN before the launch).  Between the
CLI paths and the timings, the XLA-path renderers
(``scripts/xla_paths.py``): ``render --accel wavefront --denoise --aov``
on rtow_final and terrain_big at 1280x720 must launch the closest hit
and neither the megakernel nor the G-buffer kernel, ``--accel brute`` on
the default scene and with ``--nee`` on cornell no kernel; one sample at
depth 12 of rtow_final and terrain_big with the sort on and off must
give the same image bit for bit; the closest hit on the sorted loop's
own bounce-2 wavefront of terrain_big must equal its plain walk
(columns, t to rtol 1e-5, counters); the wavefront's 16-spp mean at
160x90 on rtow_final must agree with the megakernel's (channel means
within 0.004, 10x10-pixel block means within 0.0055 on average); and the
wavefront's ms per sample, its closest hit's launches and share, its
sort and shading and the device's idle share, and the brute renderer's
ms per sample are timed; ``render --accel bvh --denoise --aov`` on
rtow_final at 1280x720 must launch the BVH kernel
(``ops/cuda/bvh_kernel.py``) and no other kernel, and the BVH path's ms
per sample, its kernel's launches and share and the device's idle share
are timed on rtow_final and terrain_big.  Then the BVH path's parts
(``scripts/bvh_paths.py``): ``native_build`` (right after the CUDA
build: g++ builds the native library that every table packing below
goes through), ``bvh_build`` (native and NumPy trees of rtow_final and
terrain_big: nodes, seconds, every primitive in one leaf) and
``bvh_check`` (the BVH kernel against its plain walk bit for bit, hit, t,
slot and per-ray counters, on the sorted bounce wavefronts of rtow_final,
every live ray, and terrain_big, its first 2^14, with its ms, nodes
visited per ray and bound).  Then the paths of the earlier slices: row bands and the
multi-device tiling on the one card (book2_final ``--nee --qmc`` and
rtow_final at 1280x720, 4 spp: bands of 180 and 360 rows stitched
against the whole-image launch bit for bit, a band against its plain
version, ``parallel.render_sharded_sample`` over
4 x 1 and 2 x 2 places on cuda:0 against its launches written out,
``sharded_xla``: the brute renderer's ``parallel.render_sharded`` over 2
x 2 and 4 x 1 places of cuda:0 at 320x180, 2 spp, stitched against
``render_radiance``'s whole frame bit for bit, and
``parallel/dryrun.py``), the cull statistic on 16 scenes at 320x180
(entries per ray, the kernel's count equal to the plain version's
replay, the image unchanged) with its cost at 1280x720, and the staging
probe (``scripts/stream_probe.py``: every variant's CTA sums, then its
times, at the table sizes of terrain_big and book2_final, in tiles of
1 x 512, 4 x 448 and 16 x 112 int32s).  Then the streamed table layout
(``stream_b``, the tables of ``pack_stream_tiles``): ``streamed_check``
holds the streamed megakernel and G-buffer against their plain versions
(the walk over the tiles) at 96x54 on rtow_final, terrain, the
all-feature probe with NEE and book2_final, and against the resident
kernels bit for bit (pixels, rays, cluster entries) at 1280x720 on
rtow_final, terrain_big and book2_final ``--nee --qmc`` (unmasked, half
masked, a band); ``streamed_path`` writes a 1,036,800-triangle
heightfield OBJ (``models/scenes.py::heightfield``) whose tables are
twice the card's L2 and renders it through ``render --obj ...
--obj-smooth --denoise`` and ``render --obj ... --obj-smooth --nee`` at
640x360 with the render loop's budget forced to 1 byte (at the card's
own budget such a mesh stays resident and walks the tree): the
streamed launch counts must be above 0 and the resident ones 0; then the kernels of that path on that mesh against their plain
versions (the megakernel without and with NEE in a band of 4 of its
rows, the G-buffer at 32x18; the walk's counters, ``stream_stats``,
printed from a second launch through the counting entries, whose
output must equal the timed entries' bit for bit, and those that are the
rays' own equal to the plain walk's) and the streamed G-buffer against
the resident one at 640x360; every streamed table's group boxes are
held to the exact union of their blocks' boxes; ``pack_check`` (the
native table packer against the NumPy packer bit for bit on every
registered scene it routes, with and without uv rows, and both
packers' host ms on terrain_big and on the mesh);
``streamed_timing`` times both layouts of both kernels at 1280x720 on
terrain_big, book2_final and the mesh, with the walk's counters and the
least time of the work they count (``scripts/stream_util.py::
counted_bound``; the sweep over table sizes behind the route's budgets,
``tables.STREAM_L2_SHARE`` and ``MEDIA_L2_SHARE``, is
``scripts/stream_crossover.py``, the
design parts' readings ``scripts/design_sweep.py``).  Every phase prints
one JSON line, with the seconds since the start (``t_s``); any failure
raises and the script exits non-zero.  The last lines
are the card's name and power limit (nvidia-smi), the per-kernel
summary, and the result object.

Every scene is set up as the render loop sets it up
(``ops/cuda/tables.py::kernel_inputs``, what ``viewer/app.py::
_CudaPipeline`` calls): uv rows and the image atlas where a primitive has
an image texture, vertex-attribute rows where a mesh has vertex normals
or uvs, velocity rows with moving spheres, and the noise, media and
motion flags.

Each kernel's ``bound_ms`` is the least time the card could take for the
work of the timed call: the larger of its bytes (tables and inputs read
once, outputs written once) over 3.35 TB/s and its float operations over
67 TFLOP/s (f32, no tensor cores).  The G-buffer's and the closest hit's
count the work every walk does (``scripts/hit_util.py::walk_bound``):
the primitive tests of the clusters the rays enter, the shading, no box
test, which a walk that culls better would lower in its own bound.  The operations are counted from this
run's data: the plain versions replay the kernels' culled search and
count the box tests each ray runs and the primitive tests it needs in
the clusters it enters, one per primitive, not per padding column; a
medium's test per medium, the moving centre per moving sphere
(``hit_kernel.search_work``), plus the shading per ray (lower bounds,
``render_kernel.SHADE_OPS``, ``gbuffer_kernel.GBUFFER_OPS``, with the
smooth normals, image lookups, NEE scatters with their light slots and
QMC raygens this run's rays made).  The bytes count
the tables, the outputs and, for image hits, three bytes per texel read
(at most the atlas's used texels).  No single PyTorch call computes a
closest hit, a path trace, a G-buffer or the probe's staged walk, so
``library_ms`` is null for all of them.  The BVH kernel's bound counts
the tree and the primitive arrays read once, the rays in and (hit, t,
slot) out, against the box test of every node the rays visit and the
leaf tests by kind, from the kernel's own per-ray counters
(``scripts/bvh_paths.py::work_bound``).  The probe's bound is its
table's bytes over 3.35 TB/s: its 32 int32 adds per tile are nothing
beside them.

Tolerances, and why:

* closest hit: the kernel and the brute-force plain version run the same
  per-primitive arithmetic (``-fmad=false``, correctly rounded division
  and sqrt), so a ray's column must be equal, except where two primitives
  give the same t (a genuine tie, resolved by visit order), and t must
  agree to rtol 1e-5.  Rays past n_alive must report (BIG, -1).  Checked
  on rtow_final (spheres) and on cornell_mesh_light (rects, triangles and
  spheres) with uniform rays, and on the bounce wavefronts and grazing
  rays of those and terrain_big (these against the plain walk: a ray
  through a box's corner may touch a primitive on the box's boundary,
  which every culled walk and brute force may call differently).  The
  walk's counters must equal the plain walk's exactly: a packet test a
  few ulps too tight may move no hit, but it passes another count of
  boxes (the grazing rays put many of them within a few ulps).
* megakernel: both versions draw the same random numbers and round every
  operation alike, but a transcendental's last bit (``sinf`` at checker
  cell edges, ``cosf``/``expf``/``logf`` in the scatter draws) could send
  a path another way, and that pixel would then differ by a whole path's
  radiance.  The limits leave room for a few such pixels and no more: at
  most 0.01% of pixels may differ by more than 1e-3 (absolute, on the
  radiance sum of 4 samples; 5 pixels at 320x180, 92 at 1280x720), and
  the image mean and the ray count must agree to 1e-4 relative.  They
  were set from readings on an H100 (PERF.md): the sound kernel differed
  from its plain version on 0 pixels on rtow_final at both sizes, with
  equal means and ray counts; a planted fault in a rarely taken branch
  moved 0.22-0.38% of pixels (letting a metal ray that points below the
  surface scatter on: 137 of 57,600 and 2,047 of 921,600, rays off by
  0.15%; a Russian-roulette survival floor of 0.04 in place of 0.05: 216
  and 3,199), which the limits catch and a 1% limit would not.  The same
  limits hold on the default scene and on cornell_mesh_light (rects and
  triangles, lights of strength 3-60) at 1280x720, where the sound kernel
  also read 0 pixels differing, equal means and equal ray counts.  They
  hold unchanged for the vertex-attribute and image branches, on
  terrain, mesh_smooth, rtow_image, mirror_room and terrain_big (the
  main path's scene) at 1280x720: the smooth normal and the texel lookup
  are exact float and integer work, and the plain version's atan2/acos
  run on the card, in CUDA's own atan2f/acosf.  They hold unchanged for
  the noise, media and motion branches, on marble, smoke, cornell_smoke,
  bounce and book2_final (this slice's main path) at 1280x720: the
  marble texture's sinf and PyTorch's sin on a CUDA tensor are the same
  CUDA function, the medium test's logf likewise, and the time and
  medium draws are the same integer hashes; five planted faults in these
  branches moved 2,427 to 463,316 pixels (PERF.md).
  The render options hold to the same limits: NEE on cornell,
  cornell_mesh_light and smoke at 640x360 and with QMC on book2_final at
  1280x720 (the light sample and the mixture pdf are f32 products,
  sums, divisions, square roots and ``sinf``/``cosf``, which PyTorch's
  CUDA operations call too), QMC alone on the default scene, and a random
  half of book2_final's tiles masked; the masked launch must also equal
  the unmasked one on its active pixels, be zero on the others, and with
  the launch of the complementary mask add up to the unmasked launch's
  image and ray count.
* G-buffer: the kernel and its plain version do the same float
  operations on the same pixel-centre rays, so the hit masks must be
  equal and each buffer (normal, albedo, depth) must agree to 1e-6
  absolute on every pixel (GBUF_ATOL), on rtow_final (look_at) and on the
  default scene (two_plane) at 1280x720, and on terrain, rtow_image and
  terrain_big (vertex attributes, image textures), and on marble, smoke,
  cornell_smoke, bounce and book2_final (noise albedo, media skipped,
  moving spheres at time 0); its walk's counters equal the plain walk's.
  The sound kernel read
  equal masks and a max abs error of 0 on every buffer of rtow_final and
  default on an H100 (PERF.md); the limit leaves one float32 rounding
  step of room on the unit-scale normal and albedo and nothing on a depth
  above 8.
* the BVH kernel: exact.  It and its plain walk do the same float
  operations in the same order (every dot and cross product written out
  per component, ``-fmad=false``), so hit, t, slot and the per-ray
  counters must be equal bit for bit.
* bands, sharded frames (the megakernel's and the brute renderer's),
  cull statistics and the probe: exact.  A band
  and the whole-image launch with the same stream do the same arithmetic
  on the same pixels, so their rows must be equal bit for bit, and so
  must a sharded frame and its launches summed in the same order; a band
  against its plain version holds to the megakernel's limits.  The cull
  counts must be equal where no pixel differs (a path sent another way
  changes its rays; then they hold to the ray limit, 1e-4).  The probe's
  sums are int32 and must equal ``expected`` on every CTA.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

W_MAIN, H_MAIN, DEPTH, RR, SPP_MAIN = 1280, 720, 12, 2, 4
# registers / spill-store bytes of every instantiation, as the build log
# reads them (nvcc for sm_90a on an NVIDIA H100 80GB HBM3 machine,
# read on the card); the megakernel's instantiations without the media
# bit are those of the tree walk, launch-bounded at six CTAs an SM (the
# two-level walk's before, unbounded, in PERF.md): the template flags
# are (rects, tris[, vattrs, images, features]); the probe's, its
# variant
BASE_PTXAS = {
    "closest_hit_kernel<0,0>": (48, 64), "closest_hit_kernel<1,0>": (48, 152),
    "closest_hit_kernel<1,1>": (64, 64), "gbuffer_kernel<0,0,0,0,0>": (40, 24),
    "gbuffer_kernel<0,0,0,0,1>": (40, 36),
    "gbuffer_kernel<0,0,0,1,0>": (40, 24),
    "gbuffer_kernel<1,0,0,0,0>": (71, 0),
    "gbuffer_kernel<1,0,0,0,3>": (72, 0),
    "gbuffer_kernel<1,0,0,1,0>": (71, 0),
    "gbuffer_kernel<1,1,0,0,0>": (80, 0),
    "gbuffer_kernel<1,1,0,1,0>": (80, 0),
    "gbuffer_kernel<1,1,0,1,3>": (80, 0),
    "gbuffer_kernel<1,1,1,0,0>": (80, 0),
    "gbuffer_kernel<1,1,1,1,0>": (80, 0),
    "gbuffer_kernel_streamed<0,0,0,0,0>": (56, 0),
    "gbuffer_kernel_streamed<1,0,0,0,0>": (48, 0),
    "gbuffer_kernel_streamed<1,0,0,0,3>": (48, 0),
    "gbuffer_kernel_streamed<1,1,0,0,0>": (56, 0),
    "gbuffer_kernel_streamed<1,1,0,1,3>": (56, 0),
    "gbuffer_kernel_streamed<1,1,1,0,0>": (56, 0),
    "gbuffer_kernel_streamed<1,1,1,1,0>": (56, 0),
    "render_kernel<0,0,0,0,0>": (72, 0),
    "render_kernel<0,0,0,0,16>": (80, 0),
    "render_kernel<0,0,0,0,1>": (80, 4),
    "render_kernel<0,0,0,0,48>": (80, 16),
    "render_kernel<0,0,0,1,0>": (72, 0),
    "render_kernel<1,0,0,0,0>": (80, 12),
    "render_kernel<1,0,0,0,15>": (80, 24),
    "render_kernel<1,0,0,0,31>": (80, 40),
    "render_kernel<1,0,0,0,32>": (80, 110),
    "render_kernel<1,0,0,0,39>": (80, 8),
    "render_kernel<1,0,0,0,47>": (80, 16),
    "render_kernel<1,0,0,0,63>": (80, 24),
    "render_kernel<1,0,0,0,7>": (80, 24),
    "render_kernel<1,0,0,1,0>": (72, 0),
    "render_kernel<1,0,0,1,32>": (76, 0),
    "render_kernel<1,1,0,0,0>": (80, 110),
    "render_kernel<1,1,0,0,32>": (80, 158),
    "render_kernel<1,1,0,1,0>": (80, 0),
    "render_kernel<1,1,0,1,23>": (128, 0),
    "render_kernel<1,1,0,1,55>": (128, 0),
    "render_kernel<1,1,1,0,0>": (80, 134),
    "render_kernel<1,1,1,0,32>": (80, 158),
    "render_kernel<1,1,1,1,0>": (80, 0),
    "render_kernel<1,1,1,1,32>": (80, 0),
    "render_kernel_streamed<0,0,0,0,0>": (110, 0),
    "render_kernel_streamed<1,0,0,0,0>": (114, 0),
    "render_kernel_streamed<1,0,0,0,63>": (118, 0),
    "render_kernel_streamed<1,1,0,0,0>": (114, 0),
    "render_kernel_streamed<1,1,0,0,32>": (113, 0),
    "render_kernel_streamed<1,1,0,1,23>": (108, 0),
    "render_kernel_streamed<1,1,0,1,55>": (110, 0),
    "render_kernel_streamed<1,1,1,0,0>": (123, 0),
    "render_kernel_streamed<1,1,1,0,32>": (123, 0),
    "render_kernel_streamed<1,1,1,1,0>": (106, 0),
    "render_kernel_streamed<1,1,1,1,32>": (106, 0),
    "stream_probe_kernel<0>": (42, 0), "stream_probe_kernel<1>": (24, 0),
    "stream_probe_kernel<2>": (24, 0),
}
# the instantiations this slice redesigns (their BASE_PTXAS numbers are
# the parent's, shown beside the new ones): none
REDESIGNED = ()
# megakernel against its plain version (see the module docstring)
MEGA_DIFF_SHARE, MEGA_MEAN_RTOL, MEGA_RAYS_RTOL = 1e-4, 1e-4, 1e-4
GBUF_ATOL = 1e-6
# the card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def bound(nbytes: int, ops: int) -> dict:
    """Least time for ``nbytes`` of traffic and ``ops`` f32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def main():
    import numpy as np
    import torch

    from cudaraytracer_tpu_torch import __main__ as cli
    from cudaraytracer_tpu_torch.viewer import app
    from cudaraytracer_tpu_torch.models import scenes
    from cudaraytracer_tpu_torch.utils import mesh
    from cudaraytracer_tpu_torch.ops.cuda import build
    from cudaraytracer_tpu_torch.ops.cuda.gbuffer_kernel import (
        GBUFFER_OPS, gbuffer, gbuffer_plain)
    from cudaraytracer_tpu_torch.ops.cuda.hit_kernel import (
        HIT_STATS, OPS, PACKET, closest_hit, closest_hit_plain,
        search_ops, search_work)
    from cudaraytracer_tpu_torch.ops.cuda.render_kernel import (
        FEATURES, SHADE_OPS, STREAM_STATS, mask_grid, refills, render_sample,
        render_sample_plain, render_variant)
    from cudaraytracer_tpu_torch.ops.cuda import stream_probe as sp
    from cudaraytracer_tpu_torch.ops.cuda.tables import (
        BIG, kernel_inputs, mask_tile, nee_inputs, pack_camera_np,
        STREAM_GROUP_G, SceneTables, pack_stream_tiles, stream_budget,
        stream_tables_to_torch, streams_on_card, table_bytes)
    from cudaraytracer_tpu_torch.scripts.megakernel_util import (
        one_pixel_per_thread)
    from cudaraytracer_tpu_torch.ops.cuda import denoise_kernel
    from cudaraytracer_tpu_torch.ops.cuda.denoise_kernel import denoise
    from cudaraytracer_tpu_torch.ops.denoise import (atrous_denoise,
                                                     atrous_denoise_plain)
    from cudaraytracer_tpu_torch.parallel import dryrun, tiling
    from cudaraytracer_tpu_torch.scripts import stream_probe as probe_script
    from cudaraytracer_tpu_torch.models.scenes import heightfield
    from cudaraytracer_tpu_torch.scripts.stream_util import (
        counted_bound, group_boxes_off)
    from cudaraytracer_tpu_torch.scripts import (bounce_rays, bvh_paths,
                                                 xla_paths)
    from cudaraytracer_tpu_torch.models.renderer import render_radiance
    from cudaraytracer_tpu_torch.scripts.hit_util import readings, walk_bound
    from cudaraytracer_tpu_torch.viewer.app import tile_activity_plane

    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----
    info = build.build()
    build.load_library()
    ptxas, entry, spill = {}, None, 0
    for ln in info["log"].splitlines():  # nvcc -Xptxas=-v, per instantiation
        m = re.search(r"(render_kernel|closest_hit_kernel|gbuffer_kernel"
                      r"|stream_probe_kernel|bvh_hit_kernel|denoise_pass)"
                      r"(?:_media|_refill)?(_streamed)?"
                      r"(_count)?I((?:L[bi]\d+E)+)E", ln)
        if "Compiling entry function" in ln and m:
            # template flags: rects, tris[, vattrs, images, feature bits];
            # the probe's: its variant; the BVH kernel's: tris, counting
            flags = ",".join(re.findall(r"L[bi](\d+)E", m.group(4)))
            entry = f"{m.group(1)}{m.group(2) or ''}{m.group(3) or ''}" \
                f"<{flags}>"
        elif entry and (m := re.search(r"(\d+) bytes spill stores", ln)):
            spill = int(m.group(1))
        elif entry and (m := re.search(r"Used (\d+) registers", ln)):
            # the static shared memory (no resident kernel asks for
            # dynamic shared memory)
            smem = re.search(r"(\d+) bytes smem", ln)
            ptxas[entry] = {"registers": int(m.group(1)),
                            "spill_store_bytes": spill,
                            "smem_bytes": int(smem.group(1)) if smem else 0}
            entry, spill = None, 0
    # the recorded instantiations against PERF.md (shown, not enforced: a
    # toolchain other than the recorded one may allocate otherwise), and
    # the ones added since
    recorded = {k: {"recorded": list(v),
                    "now": [ptxas.get(k, {}).get("registers"),
                            ptxas.get(k, {}).get("spill_store_bytes")]}
                for k, v in BASE_PTXAS.items()}
    emit({"phase": "build", "seconds": round(info["seconds"], 3),
          "reused": info["seconds"] == 0.0, "library": str(info["path"]),
          "flags": " ".join(build.NVCC_FLAGS), "ptxas": ptxas,
          "base_as_recorded": all(v["recorded"] == v["now"]
                                   for v in recorded.values()),
          "base_changed": sorted(k for k, v in recorded.items()
                                 if v["recorded"] != v["now"]),
          # this slice changes the box gates' compare alone: every
          # instantiation keeps its registers and spills
          "others_as_recorded": all(
              v["recorded"] == v["now"] for k, v in recorded.items()
              if not (REDESIGNED and k.startswith(REDESIGNED))),
          "base_ptxas": recorded,
          "new_ptxas": {k: [v["registers"], v["spill_store_bytes"]]
                        for k, v in ptxas.items() if k not in BASE_PTXAS},
          # each streamed instantiation beside its resident twin
          "streamed_vs_resident": {
              k: [[v["registers"], v["spill_store_bytes"]],
                  [ptxas.get(k.replace("_streamed", ""), {}).get(x)
                   for x in ("registers", "spill_store_bytes")]]
              for k, v in ptxas.items() if "_streamed" in k}})

    # ---- 2b. the native C++ library (g++; the table packer every Setup
    # below packs through, and the BVH builder) ----
    native = bvh_paths.native_build(emit)

    class Setup:
        """A registered scene's tables, flags and camera on the card, set
        up as the render loop sets them up (_CudaPipeline); or ``scene``,
        ``cam`` and ``model`` given."""

        def __init__(self, name, scene=None, cam=None, model=None):
            self.name = name
            self.scene = scene or scenes.SCENES[name][0]()
            self.cam = cam or scenes.SCENES[name][1]()
            self.model = model or scenes.camera_model_for(name)
            self.tb, self.flags = kernel_inputs(self.scene, dev)
            # has_rects/has_tris for the search alone (closest hit)
            self.search_flags = {k: self.flags[k]
                                 for k in ("has_rects", "has_tris")}
            # the texels an image lookup can read: the used atlas slots
            self.atlas_bytes = 0
            if "atlas" in self.flags:
                hw = self.scene.tex_hw
                self.atlas_bytes = 3 * int((hw[:, 0] * hw[:, 1]).sum())
            # the static flags as the checks report them
            self.tags = {k: v for k, v in self.flags.items()
                         if k.startswith("has_")}
            self.tags["has_images"] = self.atlas_bytes > 0
            tb = self.tb
            self.tabs = (tb.S, tb.clusters, tb.supers, tb.n_super)
            # the resident walks' block boxes, and the megakernel's walk:
            # the block boxes and, where it does not refill, the tree
            self.bb = {"block_boxes": tb.block_boxes}
            self.rk = dict(self.bb, tree=tb.tree)
            self.table_bytes = 4 * (tb.S.numel() + tb.P.numel()
                                    + tb.clusters.numel()
                                    + tb.supers.numel() + 38)
            # the NEE light table and the adaptive mask's tiles, as the
            # render loop sets them up, and whether an instantiation
            # serves the scene with NEE
            self.nee = nee_inputs(self.scene, dev)
            self.tile = mask_tile(self.scene, tb)
            fl = self.flags
            # does the scene's instantiation refill lanes (the media ones)?
            self.refills = refills(render_variant(
                fl["has_rects"], fl["has_tris"], fl["has_vattrs"],
                "atlas" in fl, **{name: fl[name] for name, _, _ in FEATURES
                                  if name != "has_nee"}))
            try:
                render_variant(fl["has_rects"], fl["has_tris"],
                               fl["has_vattrs"], "atlas" in fl,
                               **{name: fl[name] for name, _, _ in FEATURES
                                  if name != "has_nee"}, has_nee=True)
                self.serves_nee = True
            except NotImplementedError:
                self.serves_nee = False

        def half_mask(self, w, h):
            """A random half of the scene's tiles over w x h (i32, on
            the card)."""
            gi, gj = mask_grid(w, h, self.tile)
            m = np.random.RandomState(5).permutation(gi * gj) < gi * gj // 2
            return torch.from_numpy(m.astype(np.int32)).to(dev)

        def options(self, nee=False, qmc=False, sample_base=0, mask=None):
            """render_sample's keywords for these render options."""
            kw = {}
            if nee:
                kw.update(self.nee)
            if qmc:
                kw.update(has_qmc=True, sample_base=sample_base)
            if mask is not None:
                kw.update(tile_mask=mask, tile=self.tile)
            return kw

        def texel_bytes(self, work):
            """Three bytes per texel read, at most the used atlas."""
            return min(3 * work.get("image", 0), self.atlas_bytes)

        def cam_vec(self, w, h):
            return torch.from_numpy(pack_camera_np(
                self.cam, self.scene.background_start,
                self.scene.background_end, w, h, 1e-3)).to(dev)

        def frame_args(self, w, h):
            tb = self.tb
            return (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                    self.cam_vec(w, h))

        def stream_args(self, w, h):
            """The streamed layout's tables (pack_stream_tiles, made once,
            their group boxes held to the exact union of their blocks'
            boxes: a box a few ulps small moves no pixel, so no other
            check sees it) and camera, and the stream_b and group_boxes
            keywords."""
            if not hasattr(self, "st"):
                # re-tiled from the resident tables (SceneTables' fields)
                self.st = stream_tables_to_torch(pack_stream_tiles(
                    SceneTables(*(x.cpu().numpy() if torch.is_tensor(x)
                                  else x for x in self.tb))), dev)
                off = group_boxes_off(self.st.block_boxes,
                                      self.st.group_boxes,
                                      self.st.n_blocks, STREAM_GROUP_G)
                if off:
                    raise AssertionError(
                        f"{self.name}: {off} group boxes are not the "
                        "exact union of their blocks' boxes")
            st = self.st
            return (st.tiles, st.block_boxes, st.clusters, st.supers,
                    st.n_blocks, self.cam_vec(w, h)), {
                        "stream_b": st.block_b, "group_boxes": st.group_boxes}

    rtow = Setup("rtow_final")
    default = Setup("default")
    cml = Setup("cornell_mesh_light")
    terrain = Setup("terrain")
    terrain_big = Setup("terrain_big")
    smooth = Setup("mesh_smooth")
    rimage = Setup("rtow_image")
    mirror = Setup("mirror_room")
    marble = Setup("marble")
    smoke = Setup("smoke")
    csmoke = Setup("cornell_smoke")
    bounce = Setup("bounce")
    book2 = Setup("book2_final")
    rtow_big = Setup("rtow_big")
    mesh_demo = Setup("mesh_demo")

    def work_ops(work, shade):
        """Float operations of a plain run's work tally: the search's
        tests (hit_kernel.OPS) and the shading (``shade``)."""
        return (search_ops({k: v for k, v in work.items() if k in OPS})
                + sum(shade[k] * work.get(k, 0) for k in shade))

    def cuda_ms(fn, reps):
        """Median ms of ``reps`` timed calls after one warm-up call."""
        fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1000.0

    # ---- 3. closest hit, kernel against plain ----
    def walk_stats(fn, plain):
        """The walk's counters from the counting entry (fn(hit_stats=)),
        whose output must equal the timed entry's (fn()) bit for bit, and
        whose counters the plain walk's (``plain``, a replay's work
        dict): an exact check of the packet test, whose faults may move
        no result."""
        out = fn()
        ks = torch.zeros(len(HIT_STATS), dtype=torch.int64, device=dev)
        same = all(torch.equal(a, b) for a, b in zip(out, fn(hit_stats=ks)))
        kd = dict(zip(HIT_STATS, ks.tolist()))
        pd = {k: plain[k] for k in HIT_STATS}
        if not same:
            raise AssertionError("the counting entry's output differs from "
                                 "the timed entry's")
        if kd != pd:
            raise AssertionError(
                f"the walk's counters differ from the plain walk's: "
                f"{ {k: (kd[k], pd[k]) for k in kd if kd[k] != pd[k]} }")
        return kd

    def hit_check(su, tag, rays):
        """Kernel against plain on ``rays`` (org, dirn, n_alive: the
        uniform rays, a sorted bounce wavefront or rays grazing block
        corners, scripts/bounce_rays.py), then the counters and times.
        The plain version is brute force, except on the grazing rays:
        there a ray may touch a primitive on its cluster box's boundary,
        which every culled walk (the parent's too) and brute force may
        call differently, so they are held to the plain walk."""
        org_t, dir_t, n_alive = rays
        n_rays = org_t.shape[0]
        kw = dict(**su.search_flags, **su.bb)
        n0 = closest_hit.launches
        hk, tk, ck = closest_hit(*su.tabs, n_alive, org_t, dir_t, **kw)
        torch.cuda.synchronize()
        if closest_hit.launches != n0 + 1:
            raise AssertionError("closest_hit did not count its launch")
        p0 = closest_hit_plain.launches
        hp, tp_, cp = closest_hit_plain(
            *su.tabs, n_alive, org_t, dir_t, **su.search_flags,
            **(su.bb if tag == "grazing" else {}))
        if closest_hit_plain.launches != p0 + 1:
            raise AssertionError("closest_hit_plain did not count its call")
        hk, tk, ck = hk.cpu().numpy(), tk.cpu().numpy(), ck.cpu().numpy()
        hp, tp_, cp = hp.cpu().numpy(), tp_.cpu().numpy(), cp.cpu().numpy()
        if not (hk == hp).all():
            raise AssertionError(
                f"{su.name}: hit masks differ on {(hk != hp).sum()} rays")
        both = hk & hp
        t_err = np.abs(tk[both] - tp_[both])
        if not (t_err <= 1e-5 * np.abs(tp_[both])).all():
            raise AssertionError(
                f"{su.name}: t differs beyond rtol 1e-5: max {t_err.max()}")
        diff = both & (ck != cp)
        # a different winner is allowed only for a genuine t-tie
        if diff.any() and not np.allclose(tk[diff], tp_[diff], rtol=1e-6,
                                          atol=0):
            raise AssertionError(
                f"{su.name}: {diff.sum()} columns differ without a t-tie")
        dead = slice(n_alive, None)
        if not ((tk[dead] == np.float32(BIG)).all()
                and (ck[dead] == -1).all()):
            raise AssertionError("dead rays must report (BIG, -1)")
        # the plain walk's replay: its counters and the tests it needs
        work = search_work(*su.tabs, org_t[:n_alive], dir_t[:n_alive],
                           **kw, warps=torch.arange(n_alive, device=dev)
                           // 32, packet=PACKET)
        stats = walk_stats(
            lambda **x: closest_hit(*su.tabs, n_alive, org_t, dir_t, **kw,
                                    **x), work)
        ms = cuda_ms(lambda: closest_hit(*su.tabs, n_alive, org_t, dir_t,
                                         **kw), 10)
        _, plain_ms = host_ms(lambda: closest_hit_plain(
            *su.tabs, n_alive, org_t, dir_t, **su.search_flags))  # warm
        # the work every walk does (the primitive tests of the clusters
        # the rays enter), the tables once, 24 B in and 8 B (t, col) out
        # per ray
        bd = walk_bound(work, su.table_bytes + 32 * n_rays)
        err = float(t_err.max()) if t_err.size else 0.0
        ptype = su.tb.S[4].cpu().numpy()[ck[both]]
        emit({"phase": "closest_hit", "scene": su.name, "rays": tag,
              **su.search_flags, "n_rays": n_rays, "n_alive": n_alive,
              "hits": int(hk.sum()),
              "hits_by_ptype": {str(int(v)): int((ptype == v).sum())
                                for v in np.unique(ptype)},
              "col_mismatch_t_ties": int(diff.sum()), "max_abs_err_t": err,
              "ms": ms, "plain_ms": plain_ms, "work": work,
              "hit_stats": stats, "readings": readings(stats), **bd})
        return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                "hit_stats": stats, **bd}

    hits = {}
    for su in (rtow, cml):
        hits[f"{su.name}/uniform"] = hit_check(
            su, "uniform", bounce_rays.uniform_rays(su.name, dev))
    wavefronts = {}  # the bounce wavefronts, kept for the BVH kernel's check
    for su in (rtow, terrain_big, cml):
        wavefronts[su.name] = bounce_rays.bounce_wavefront(su.name, dev)
        hits[f"{su.name}/bounce"] = hit_check(
            su, "bounce", wavefronts[su.name])
        hits[f"{su.name}/grazing"] = hit_check(
            su, "grazing", bounce_rays.grazing_rays(su.tb.block_boxes, dev))

    # ---- 4. megakernel, kernel against plain ----
    def mega_check(su, w, h, seed, with_bound=False, util=False,
                   time_plain=False, depth=DEPTH, **opts):
        """Kernel against plain at w x h, SPP_MAIN spp, ``depth``, with the
        render options ``opts`` (Setup.options); raise on a miss.  The output's
        block is first filled with NaN and freed, so that a pixel the
        kernel never writes reads NaN (not finite: a miss).  With
        ``with_bound`` the plain run also tallies the work of the bound;
        with ``util`` it counts each pixel's rays, and the lane and CTA
        utilisation of a one-thread-per-pixel grid and of the kernel (its
        lane and CTA slots) are added.  ``plain_ms`` is the
        plain run's time; with the work tally (which replays the search
        per iteration) it is ``plain_work_ms``, and ``time_plain`` times a
        plain run without it too."""
        args = (*su.frame_args(w, h), seed, depth)
        kw = dict(width=w, height=h, camera_model=su.model, spp=SPP_MAIN,
                  rr_start=RR, with_stats=True, **su.flags, **su.rk,
                  **su.options(**opts))
        torch.full((h, w, 3), float("nan"), device=dev)  # freed at once
        sched = torch.zeros(2, dtype=torch.int64, device=dev)
        img_k, rays_k = render_sample(*args, **kw, **(
            {"sched_stats": sched} if su.refills else {}))
        work = {} if with_bound else None
        pix = torch.zeros(w * h, dtype=torch.int64, device=dev) if util \
            else None
        (img_p, rays_p), plain_ms = host_ms(
            lambda: render_sample_plain(*args, **kw, work=work,
                                        pixel_rays=pix))
        timed = {"plain_ms": plain_ms}
        if with_bound:
            timed = {"plain_work_ms": plain_ms, "plain_ms": host_ms(
                lambda: render_sample_plain(*args, **kw))[1]
                if time_plain else None}
        img_k, img_p = img_k.cpu().numpy(), img_p.cpu().numpy()
        rays_k, rays_p = int(rays_k), int(rays_p)
        if not (np.isfinite(img_k).all() and img_k.shape == (h, w, 3)):
            raise AssertionError("megakernel output is not finite f32[h, w, 3]")
        err = np.abs(img_k - img_p).max(axis=2)
        differing = int((err > 1e-3).sum())
        mean_rel = abs(float(img_k.mean()) / float(img_p.mean()) - 1.0)
        rays_rel = abs(rays_k / rays_p - 1.0)
        res = {"max_abs_err": float(err.max()), **timed}
        if with_bound:
            # tables once (with the light table, the mask and, where the
            # kernel refills, the block boxes), the texels read, the
            # f32[h, w, 3] sum and the ray count written
            extra = sum(4 * kw[k].numel() for k in ("lights", "tile_mask")
                        if k in kw)
            if su.refills:
                extra += 4 * kw["block_boxes"].numel()
            res.update(bound(su.table_bytes + extra + su.texel_bytes(work)
                             + 12 * w * h + 8, work_ops(work, SHADE_OPS)),
                       work=work)
        if util:
            # the kernel's own: its slots where it refills, else the grid
            # of one thread per pixel that it runs
            grid = one_pixel_per_thread(pix.reshape(h, w).cpu().numpy())
            kernel = {"lane": grid["lane"], "cta": grid["cta"]}
            if su.refills:
                lane_slots, cta_slots = (int(v) for v in sched.cpu())
                kernel = {"lane": rays_k / lane_slots,
                          "cta": rays_k / cta_slots,
                          "lane_slots": lane_slots, "cta_slots": cta_slots}
            res["utilisation"] = {"one_pixel_per_thread": grid,
                                  "kernel": kernel,
                                  "refills": su.refills}
        shown = {k: v for k, v in opts.items() if k != "mask"}
        if opts.get("mask") is not None:
            shown["masked_tiles"] = int((opts["mask"] == 0).sum())
        emit({"phase": "megakernel_check", "scene": su.name, **su.tags,
              "options": shown,
              "size": [w, h], "spp": SPP_MAIN, "depth": depth,
              "rr_start": RR, "seed": seed,
              "share_within_1e-3": 1.0 - differing / (w * h),
              "pixels_differing": differing,
              "pixels_allowed": int(MEGA_DIFF_SHARE * w * h),
              "mean_kernel": float(img_k.mean()),
              "mean_plain": float(img_p.mean()), "mean_rel_diff": mean_rel,
              "rays_kernel": rays_k, "rays_plain": rays_p,
              "rays_rel_diff": rays_rel, **res})
        if (differing > MEGA_DIFF_SHARE * w * h or mean_rel > MEGA_MEAN_RTOL
                or rays_rel > MEGA_RAYS_RTOL):
            raise AssertionError(
                f"megakernel disagrees with its plain version on {su.name} "
                f"at {w}x{h} with {shown}")
        return res

    mega_err = mega_check(rtow, 320, 180, 4242)["max_abs_err"]
    # NEE on the light shapes: rects (cornell), triangles
    # (cornell_mesh_light), a sphere through fog (smoke)
    cornell = Setup("cornell")
    for su in (cornell, cml, smoke):
        mega_err = max(mega_err, mega_check(su, 640, 360, 31,
                                            nee=True)["max_abs_err"])
    # NEE on the vertex-attribute, image and motion instantiations (sky-lit
    # scenes: an empty light table, every lambertian hit scatters by the
    # true cosine): mesh_smooth and a smooth OBJ model, terrain and
    # terrain_big, bounce
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "torus.obj")
        mesh.save_obj(obj, *mesh.torus(1.0, 0.35, segments=48, sides=24))
        obj_smooth = Setup(scenes.register_obj_scene(obj, smooth=True))
    nee_new = {}
    for su in (smooth, obj_smooth, terrain, terrain_big, bounce):
        if not su.serves_nee:
            raise AssertionError(f"{su.name}: no NEE instantiation")
        nee_new[su.name] = mega_check(su, 640, 360, 31, nee=True)
        mega_err = max(mega_err, nee_new[su.name]["max_abs_err"])
    # QMC alone, at a sample base past the split of the R2 index
    mega_err = max(mega_err, mega_check(default, W_MAIN, H_MAIN, 32, qmc=True,
                                        sample_base=4096 + 17)["max_abs_err"])

    # ---- 4b. the tile mask on book2_final with the main path's options ----
    def mask_check(su):
        """A random half of su's tiles masked: the active pixels equal to
        the unmasked launch's, the others zero, and the launches of the
        mask and its complement adding up to the unmasked launch; returns
        the mask (the timing phase checks it against the plain version)."""
        gi, gj = mask_grid(W_MAIN, H_MAIN, su.tile)
        mask = su.half_mask(W_MAIN, H_MAIN)
        opts = dict(nee=True, qmc=True, sample_base=8)
        args = (*su.frame_args(W_MAIN, H_MAIN), 7, DEPTH)
        kw = dict(width=W_MAIN, height=H_MAIN, camera_model=su.model,
                  spp=SPP_MAIN, rr_start=RR, with_stats=True, **su.flags,
                  **su.rk)
        full, n_full = render_sample(*args, **kw, **su.options(**opts))
        part, n_part = render_sample(*args, **kw,
                                     **su.options(**opts, mask=mask))
        rest, n_rest = render_sample(*args, **kw,
                                     **su.options(**opts, mask=1 - mask))
        act = tile_activity_plane(mask, (gi, gj),
                                  *su.tile)[:H_MAIN, :W_MAIN] > 0.5
        same = bool(torch.equal(part[act], full[act]))
        zero = bool((part[~act] == 0).all())
        adds = bool(torch.equal(torch.where(act[..., None], part, rest),
                                full))
        rays = (int(n_part), int(n_rest), int(n_full))
        emit({"phase": "mask_check", "scene": su.name, "tile": su.tile,
              "grid": [gi, gj], "masked_tiles": int((mask == 0).sum()),
              "active_equal_unmasked": same, "masked_zero": zero,
              "complement_adds_up": adds, "rays_mask_rest_full": rays})
        if not (same and zero and adds and rays[0] + rays[1] == rays[2]):
            raise AssertionError(f"the tile mask misbehaves on {su.name}")
        return mask

    book2_mask = mask_check(book2)

    # ---- 5. G-buffer, kernel against plain ----
    def gbuf_check(su):
        """Kernel against plain at 1280x720; raise on a miss."""
        w, h = W_MAIN, H_MAIN
        args = su.frame_args(w, h)
        kw = dict(width=w, height=h, camera_model=su.model, **su.flags)
        p0 = gbuffer_plain.launches
        gk = gbuffer(*args, **kw, **su.bb)
        torch.cuda.synchronize()
        if gbuffer_plain.launches != p0:
            raise AssertionError("gbuffer fell back to its plain version")
        gp = gbuffer_plain(*args, **kw)
        hit_k, hit_p = gk.depth > 0, gp.depth > 0
        errs = {k: float((a - b).abs().max())
                for k, a, b in zip(gk._fields, gk, gp)}
        off = sum(int(((a - b).abs().reshape(h, w, -1) > GBUF_ATOL)
                       .any(-1).sum()) for a, b in zip(gk, gp))
        # the plain walk: its counters, and the tests and shading it needs
        work = {}
        gbuffer_plain(*args, **kw, **su.bb, work=work)
        stats = walk_stats(
            lambda **x: gbuffer(*args, **kw, **su.bb, **x), work)
        ms = cuda_ms(lambda: gbuffer(*args, **kw, **su.bb), 10)
        _, plain_ms = host_ms(lambda: gbuffer_plain(*args, **kw))  # warm
        # the work every walk does: the primitive tests of the clusters
        # the rays enter, the shading, the texels, the tables, the output
        bd = walk_bound(work, su.table_bytes + su.texel_bytes(work)
                        + 28 * w * h, GBUFFER_OPS)
        emit({"phase": "gbuffer_check", "scene": su.name, **su.tags,
              "camera_model": su.model, "size": [w, h],
              "hit_share": float(hit_k.float().mean()),
              "hit_masks_differ": int((hit_k != hit_p).sum()),
              "max_abs_err": errs, "pixels_off_by_more_than_atol": off,
              "finite": bool(all(torch.isfinite(v).all() for v in gk)),
              "ms": ms, "plain_ms": plain_ms, "work": work,
              "hit_stats": stats, "readings": readings(stats), **bd})
        if not torch.equal(hit_k, hit_p) or max(errs.values()) > GBUF_ATOL:
            raise AssertionError(
                f"G-buffer kernel disagrees with its plain version on "
                f"{su.name}: {errs}")
        return gk, {"ms": ms, "plain_ms": plain_ms,
                    "max_abs_err": max(errs.values()), "hit_stats": stats,
                    **bd}

    _, gb_rtow = gbuf_check(rtow)
    _, gb_default = gbuf_check(default)
    gb_book2_buf, gb_book2 = gbuf_check(book2)
    gb_new = {su.name: gbuf_check(su)[1]
              for su in (terrain, rimage, terrain_big, marble, smoke, csmoke,
                         bounce)}
    gb_new[book2.name] = gb_book2

    # ---- 6. the CLI paths, counts set to 0 before, read after ----
    counted = (render_sample, render_sample_plain, gbuffer, gbuffer_plain,
               closest_hit, closest_hit_plain, denoise)
    frames = 8

    def cli_path(tag, scene_args, tmp, n_frames=frames):
        """One CLI render with --denoise --aov; under --adaptive it may
        stop before n_frames: the megakernel must launch once per frame
        run."""
        for fn in counted:
            fn.launches = 0
        render_sample.streamed_launches = gbuffer.streamed_launches = 0
        png = os.path.join(tmp, f"{tag}.png")
        npz = os.path.join(tmp, f"{tag}_aov.npz")
        t0 = time.perf_counter()
        rl = cli.main(["render", *scene_args, "--width", str(W_MAIN),
                       "--height", str(H_MAIN), "--frames", str(n_frames),
                       "--denoise", "--aov", npz, "-o", png])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        # the route keeps every registered scene resident on the card
        launches["streamed"] = (render_sample.streamed_launches
                                + gbuffer.streamed_launches)
        run = rl._frame_index
        from PIL import Image

        with Image.open(png) as im:
            size, arr = im.size, np.asarray(im.convert("RGB"))
        with np.load(npz) as z:
            aov = {k: z[k] for k in z.files}
        emit({"phase": "main_path", "path": tag, "args": scene_args,
              "size": list(size), "frames": n_frames, "frames_run": run,
              "active_fraction": rl.pipeline.active_fraction(),
              "spp_done": rl._spp_done, "denoise": True,
              "seconds": round(seconds, 3), "launches": launches,
              "png_mean": float(arr.mean()),
              "png_share_saturated": float((arr == 255).all(axis=2).mean()),
              "aov": {k: list(v.shape) for k, v in aov.items()},
              "aov_hit_share": float((aov["depth"] > 0).mean())})
        # only --adaptive may stop before n_frames
        least = 1 if "--adaptive" in scene_args else n_frames
        if (launches["render_sample"] != run
                or not least <= run <= n_frames
                or launches["gbuffer"] != 1
                # one denoised display (the PNG), one launch a pass
                or launches["denoise"] != 4
                or launches["render_sample_plain"]
                or launches["gbuffer_plain"] or launches["streamed"]):
            raise AssertionError(f"{tag} did not run on the kernels: "
                                 f"{launches}")
        if size != (W_MAIN, H_MAIN):
            raise AssertionError(f"PNG is {size}, not {W_MAIN}x{H_MAIN}")
        if not 10.0 < arr.mean() < 245.0 or (arr == 255).all(axis=2).mean() > 0.5:
            raise AssertionError(f"{tag}: PNG is black or saturated")
        shapes = {k: v.shape for k, v in aov.items()}
        if shapes != {"normal": (H_MAIN, W_MAIN, 3),
                      "albedo": (H_MAIN, W_MAIN, 3),
                      "depth": (H_MAIN, W_MAIN)} \
                or not all(np.isfinite(v).all() for v in aov.values()):
            raise AssertionError(f"{tag}: bad AOVs {shapes}")
        return launches, arr

    with tempfile.TemporaryDirectory() as tmp:
        by_path = {}
        # the main path: every feature of the scene model and every render
        # option in one render; up to 64 frames, so that tiles can
        # converge (each waits 8 launches, and the fog's pixels need ~50
        # at tau 0.016)
        main_tag = "book2_final_nee_qmc_adaptive"
        by_path[main_tag], _ = cli_path(
            main_tag, ["--scene", "book2_final", "--nee", "--qmc",
                       "--adaptive"],
            tmp, n_frames=64)
        # the same scene without render options
        by_path["book2_final"], _ = cli_path(
            "book2_final", ["--scene", "book2_final"], tmp)
        by_path["terrain_big"], _ = cli_path(
            "terrain_big", ["--scene", "terrain_big"], tmp)
        # the model viewer: an OBJ (a torus without normals or uvs, so
        # --obj-smooth computes its vertex normals) written by save_obj
        obj = os.path.join(tmp, "torus.obj")
        mesh.save_obj(obj, *mesh.torus(1.0, 0.35, segments=48, sides=24))
        by_path["obj"], _ = cli_path(
            "obj", ["--obj", obj, "--obj-smooth", "--obj-mat", "metal",
                    "--obj-fuzz", "0.05"], tmp)
        by_path["rtow_final"], _ = cli_path(
            "rtow_final", ["--scene", "rtow_final"], tmp)
        # --nee on the scenes whose NEE instantiations this slice adds
        # (they raised before), 2 frames each
        for name in ("mesh_smooth", "terrain", "terrain_big", "bounce"):
            by_path[f"{name}_nee"], _ = cli_path(
                f"{name}_nee", ["--scene", name, "--nee"], tmp, n_frames=2)
        by_path["obj_nee"], _ = cli_path(
            "obj_nee", ["--obj", obj, "--obj-smooth", "--nee"], tmp,
            n_frames=2)
        by_path["default"], den_png = cli_path("default", [], tmp)
        # the raw mean of the same frames: the denoiser must change it
        raw_png = os.path.join(tmp, "raw.png")
        cli.main(["render", "--width", str(W_MAIN), "--height", str(H_MAIN),
                  "--frames", str(frames), "-o", raw_png])
        from PIL import Image

        with Image.open(raw_png) as im:
            raw = np.asarray(im.convert("RGB"))
        changed = float(np.abs(den_png.astype(np.int16) - raw).mean())
        emit({"phase": "denoise_changes_display", "mean_abs_u8_diff": changed})
        if changed < 0.1:
            raise AssertionError("the denoised image equals the raw mean")

    # ---- 6b. the XLA-path renderers: render --accel wavefront (the
    # closest hit's user path) and --accel brute, sort on and off, the
    # closest hit on the loop's own bounce-2 wavefront, the wavefront's
    # radiance against the megakernel's, and their times
    # (scripts/xla_paths.py) ----
    xla = xla_paths.run(dev, emit)
    # ---- 6c. the BVH path's builders and its kernel against the plain
    # walk on the bounce wavefronts (scripts/bvh_paths.py) ----
    bvh_built = bvh_paths.bvh_build(emit)
    bvh_hits = bvh_paths.bvh_check(dev, emit, wavefronts)
    del wavefronts

    # ---- 7. time and check the megakernel at the main-path shape ----
    timing = {}
    for su, spps, size in ((rtow, (1, SPP_MAIN), (W_MAIN, H_MAIN)),
                           (default, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (cml, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (terrain, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (terrain_big, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (smooth, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (rimage, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (mirror, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (marble, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (smoke, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (csmoke, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (bounce, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (book2, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (rtow_big, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (mesh_demo, (SPP_MAIN,), (W_MAIN, H_MAIN))):
        for s in spps:
            args = (*su.frame_args(*size), 7, DEPTH)
            kw = dict(width=size[0], height=size[1], camera_model=su.model,
                      spp=s, rr_start=RR, **su.flags, **su.rk)
            _, nr = render_sample(*args, **kw, with_stats=True)
            ms = cuda_ms(lambda: render_sample(*args, **kw), 10)
            timing[f"{su.name}/{s}spp"] = {
                "ms": ms, "rays": int(nr),
                "mrays_per_s": int(nr) / (ms * 1e-3) / 1e6,
                # the plain time and the bound come from the checks below
                # (SPP_MAIN only)
                "plain_ms": None, "bound_ms": None, "bound_by": None}
    # each render option alone on every scene (NEE where an instantiation
    # serves it), and the main path's options on book2_final: NEE and
    # QMC, and with half of its tiles masked (mask_check's mask)
    main_opts = dict(nee=True, qmc=True, sample_base=8)
    runs = []
    for su in (rtow, default, cml, terrain, terrain_big, smooth, rimage,
               mirror, marble, smoke, csmoke, bounce, book2, rtow_big,
               mesh_demo):
        runs += [(su, "qmc", dict(qmc=True, sample_base=8)),
                 (su, "half_mask", dict(mask=su.half_mask(W_MAIN, H_MAIN)))]
        if su.serves_nee:
            runs.append((su, "nee", dict(nee=True)))
    runs += [(book2, "nee_qmc", main_opts),
             (book2, "nee_qmc_half_mask", dict(main_opts, mask=book2_mask))]
    for su, tag, opts in runs:
        args = (*su.frame_args(W_MAIN, H_MAIN), 7, DEPTH)
        kw = dict(width=W_MAIN, height=H_MAIN, camera_model=su.model,
                  spp=SPP_MAIN, rr_start=RR, **su.flags, **su.rk,
                  **su.options(**opts))
        _, nr = render_sample(*args, **kw, with_stats=True)
        ms = cuda_ms(lambda: render_sample(*args, **kw), 10)
        timing[f"{su.name}/{tag}/{SPP_MAIN}spp"] = {
            "ms": ms, "rays": int(nr),
            "mrays_per_s": int(nr) / (ms * 1e-3) / 1e6,
            "plain_ms": None, "bound_ms": None, "bound_by": None}
    # the utilisation readings (scripts/megakernel_util.py's cases)
    util_cases = (rtow, default, terrain_big, csmoke)
    checks = {f"{su.name}/{SPP_MAIN}spp": mega_check(
        su, W_MAIN, H_MAIN, 7, with_bound=True, util=su in util_cases)
        for su in (rtow, default, cml, terrain, smooth, rimage, mirror,
                   terrain_big, marble, smoke, csmoke, bounce, book2,
                   rtow_big, mesh_demo)}
    checks[f"book2_final/nee_qmc/{SPP_MAIN}spp"] = mega_check(
        book2, W_MAIN, H_MAIN, 7, with_bound=True, util=True,
        time_plain=True, **main_opts)
    # the half-masked launch against its plain version at depth 4, not 12:
    # a check of the masked tiles, shortened to keep the script's time
    # when the XLA-path phase came (its timing row has no bound)
    mask_d4 = mega_check(book2, W_MAIN, H_MAIN, 7, depth=4, **main_opts,
                         mask=book2_mask)
    mega_err = max(mega_err, mask_d4["max_abs_err"],
                   *(c["max_abs_err"] for c in checks.values()))
    for key, c in checks.items():
        timing[key].update(plain_ms=c["plain_ms"],
                           plain_work_ms=c["plain_work_ms"],
                           bound_ms=c["bound_ms"], bound_by=c["bound_by"])
    util = {k: {**c["utilisation"], "ms": timing[k]["ms"]}
            for k, c in checks.items() if "utilisation" in c}
    emit({"phase": "timing", "shape": [W_MAIN, H_MAIN], "depth": DEPTH,
          "rr_start": RR, "megakernel": timing, "nvidia_smi": smi})
    emit({"phase": "utilisation", "shape": [W_MAIN, H_MAIN], "depth": DEPTH,
          "spp": SPP_MAIN, "by_case": util, "nvidia_smi": smi})
    # the tree walk's engagement (the plain replay of its walk: node and
    # leaf box tests, primitive tests a ray) beside the kernel's time
    tree_walk = {}
    for key in (f"terrain_big/{SPP_MAIN}spp", f"rtow_final/{SPP_MAIN}spp"):
        wk = checks[key]["work"]
        rays = wk["hit"] + wk["miss"] + wk.get("medium", 0)
        tree_walk[key] = {
            "ms": timing[key]["ms"], "rays": rays,
            "box_tests_per_ray": wk["box"] / rays,
            "prim_tests_per_ray": sum(wk.get(k, 0) for k in (
                "sphere", "rect", "tri")) / rays,
            "entered_per_ray": wk["entered"] / rays}
    emit({"phase": "tree_walk", "shape": [W_MAIN, H_MAIN], "depth": DEPTH,
          "spp": SPP_MAIN, "by_case": tree_walk, "nvidia_smi": smi})

    # ---- 7b. the refilling kernel's ragged batches: 1277x719 (a ragged
    # batch closes every batch row and the bottom row), cornell_smoke
    # --nee --qmc against its plain version, and in a band of 333 rows at
    # y0 101 with half its tiles masked; every output block NaN before
    # the launch, so a pixel no lane takes fails
    sched = {}
    w_r, h_r = 1277, 719
    sched["cornell_smoke/nee_qmc"] = mega_check(csmoke, w_r, h_r, 7,
                                                **main_opts)
    gi, gj = mask_grid(w_r, 333, csmoke.tile)
    band_mask = torch.from_numpy((np.random.RandomState(6).permutation(
        gi * gj) < gi * gj // 2).astype(np.int32)).to(dev)
    args = (*csmoke.frame_args(w_r, h_r), 7, DEPTH)
    kw = dict(width=w_r, height=h_r, camera_model=csmoke.model,
              spp=SPP_MAIN, rr_start=RR, with_stats=True,
              with_cull_stats=True, y0=101, band_h=333, tile_mask=band_mask,
              tile=csmoke.tile, **csmoke.flags, **csmoke.rk)
    torch.full((333, w_r, 3), float("nan"), device=dev)  # freed at once
    ik, nk, ck = render_sample(*args, **kw)
    ip, np_, cp = render_sample_plain(*args, **kw)
    sched["cornell_smoke/band_half_mask"] = {
        "pixels_differing": int((~((ik - ip).abs().amax(2) <= 1e-3)).sum()),
        "rays": [int(nk), int(np_)], "cull": [int(ck), int(cp)]}
    emit({"phase": "sched_check", "size": [w_r, h_r], "by_case": sched})
    if sched["cornell_smoke/band_half_mask"]["pixels_differing"] \
            or int(nk) != int(np_) or int(ck) != int(cp):
        raise AssertionError(f"ragged batches: {sched}")
    mega_err = max(mega_err, sched["cornell_smoke/nee_qmc"]["max_abs_err"])

    # ---- 8. the denoiser's kernel against its plain version, on a
    # book2_final frame and its G-buffer, with and without a variance
    # plane: bit for bit ----
    color = render_sample(*book2.frame_args(W_MAIN, H_MAIN), 7, DEPTH,
                          width=W_MAIN, height=H_MAIN,
                          camera_model=book2.model, spp=SPP_MAIN,
                          rr_start=RR, **book2.flags, **book2.rk) / SPP_MAIN
    var_plane = torch.rand((H_MAIN, W_MAIN), device=dev, generator=(
        torch.Generator(device=dev).manual_seed(15))) * 0.5
    den = {}
    for tag, var in (("plain", None), ("variance", var_plane)):
        for iters in (1, 4):
            n0 = denoise.launches
            out = atrous_denoise(color, gb_book2_buf, var,
                                 iterations=iters)
            ref = atrous_denoise_plain(color, gb_book2_buf, var,
                                       iterations=iters)
            torch.cuda.synchronize()
            den[f"{tag}/{iters}"] = {
                "equal": bool(torch.equal(out, ref)),
                "pixels_differing": int((out != ref).any(-1).sum()),
                "launches": denoise.launches - n0}
        ops, nbytes = denoise_kernel.work(W_MAIN, H_MAIN, 4, var is not None)
        den[tag] = {
            "ms": cuda_ms(lambda: atrous_denoise(color, gb_book2_buf, var,
                                                 iterations=4), 20),
            "plain_ms": cuda_ms(lambda: atrous_denoise_plain(
                color, gb_book2_buf, var, iterations=4), 3),
            **bound(nbytes, ops)}
    emit({"phase": "denoise_check", "scene": "book2_final",
          "shape": [W_MAIN, H_MAIN], "iterations": 4, **den,
          "nvidia_smi": smi})
    if not all(v["equal"] and v["launches"] == int(k.split("/")[1])
               for k, v in den.items() if "/" in k):
        raise AssertionError(f"the denoise kernel disagrees with its plain "
                             f"version: {den}")

    # ---- 9. row bands and the multi-device tiling on cuda:0 ----
    def launches_of(fn_run, fns=counted):
        """Run fn_run with the launch counts set to 0 just before it; the
        result and the counts read just after."""
        for fn in fns:
            fn.launches = 0
        out = fn_run()
        torch.cuda.synchronize()
        return out, {fn.__name__: fn.launches for fn in fns}

    bands = {}
    for su, opts in ((book2, main_opts), (rtow, {})):
        args = (*su.frame_args(W_MAIN, H_MAIN), 7, DEPTH)
        kw = dict(width=W_MAIN, height=H_MAIN, camera_model=su.model,
                  spp=SPP_MAIN, rr_start=RR, **su.flags, **su.rk,
                  **su.options(**opts))
        base = kw.pop("sample_base", 0)
        full = render_sample(*args, stream=5, sample_base=base, **kw)
        seams = {}
        for n in (4, 2):
            bh = H_MAIN // n
            parts = [render_sample(*args, stream=5, sample_base=base,
                                   y0=i * bh, band_h=bh, **kw)
                     for i in range(n)]
            seams[f"{n}_bands"] = int((torch.cat(parts) != full).any(2).sum())
        # the second of four bands against its plain version
        band_kw = dict(stream=5, sample_base=base, y0=H_MAIN // 4,
                       band_h=H_MAIN // 4, **kw)
        bk = render_sample(*args, **band_kw)
        bp, band_plain_ms = host_ms(lambda: render_sample_plain(*args,
                                                                **band_kw))
        band_off = int(((bk - bp).abs().amax(2) > 1e-3).sum())
        sharded = {}
        for nr, ns in ((4, 1), (2, 2)):
            mesh_ = tiling.make_mesh(nr, ns, [dev] * (nr * ns))

            def frame():
                return tiling.render_sharded_sample(
                    args[:4], args[4], args[5], 7, DEPTH, mesh=mesh_,
                    sample_base=base, **kw)

            out, launches = launches_of(frame)
            # the places' launches written out: band ri, stream ri * ns +
            # si, QMC base base + si * spp, summed in stream order
            bh = H_MAIN // nr
            want = []
            for ri in range(nr):
                acc = None
                for si in range(ns):
                    img = render_sample(*args, y0=ri * bh, band_h=bh,
                                        stream=ri * ns + si,
                                        sample_base=base + si * SPP_MAIN,
                                        **kw)
                    acc = img if acc is None else acc + img
                want.append(acc)
            off = int((out != torch.cat(want)).any(2).sum())
            sharded[f"{nr}x{ns}"] = {
                "launches": launches, "pixels_off_launch_sum": off,
                "finite": bool(torch.isfinite(out).all()),
                "shape": list(out.shape), "ms": cuda_ms(frame, 3)}
            if (off or list(out.shape) != [H_MAIN, W_MAIN, 3]
                    or not sharded[f"{nr}x{ns}"]["finite"]
                    or launches["render_sample"] != nr * ns
                    or launches["render_sample_plain"]):
                raise AssertionError(f"{su.name}: the {nr}x{ns} sharded frame "
                                     f"misbehaves: {sharded[f'{nr}x{ns}']}")
        bands[su.name] = {"options": {k: v for k, v in opts.items()},
                          "seam_pixels": seams, "band_plain_pixels": band_off,
                          "band_plain_ms": band_plain_ms,
                          "sharded": sharded}
        emit({"phase": "bands", "scene": su.name, "size": [W_MAIN, H_MAIN],
              "spp": SPP_MAIN, **bands[su.name]})
        if any(seams.values()) or band_off > MEGA_DIFF_SHARE * W_MAIN * H_MAIN:
            raise AssertionError(f"{su.name}: bands do not stitch: {seams}, "
                                 f"band against plain {band_off}")
    # the brute renderer over row bands x sample streams: 2 x 2 and 4 x 1
    # places of cuda:0 at 320x180, 2 spp, depth 12, stitched against the
    # whole frame (a band keys its rays by their global pixel ids, and the
    # two streams' one-sample sums add as the whole frame's two samples)
    sx_sd = rtow.scene.device(dev)
    sx_kw = dict(width=320, height=180, camera_model=rtow.model)
    sx_full = render_radiance(sx_sd, rtow.cam, 11, 2, DEPTH, **sx_kw)
    sharded_xla = {}
    for nr, ns in ((2, 2), (4, 1)):
        t0 = time.perf_counter()
        out = tiling.render_sharded(sx_sd, rtow.cam, 11, 2, DEPTH,
                                    mesh=tiling.make_mesh(nr, ns, [dev] * (
                                        nr * ns)), **sx_kw)
        torch.cuda.synchronize()
        sharded_xla[f"{nr}x{ns}"] = {
            "seconds": time.perf_counter() - t0,
            "pixels_off_full_frame": int((out != sx_full).any(2).sum()),
            "max_abs_err": float((out - sx_full).abs().max()),
            "mean": float(out.mean())}
    emit({"phase": "sharded_xla", "scene": "rtow_final", "size": [320, 180],
          "spp": 2, "depth": DEPTH, "by_mesh": sharded_xla})
    if any(v["pixels_off_full_frame"] for v in sharded_xla.values()) \
            or not torch.isfinite(sx_full).all() or sx_full.mean() <= 0:
        raise AssertionError(f"sharded XLA frames differ from the whole "
                             f"frame: {sharded_xla}")
    del sx_sd, sx_full
    render_sample.streamed_launches = 0
    dry, dry_launches = launches_of(lambda: dryrun.dryrun_multichip(4, "cuda"))
    dry_launches["streamed"] = render_sample.streamed_launches
    emit({"phase": "dryrun_multichip", **dry, "launches": dry_launches})
    # two paths of four places, each checked against its four launches,
    # and the streamed shard's four places against the resident frame
    if dry_launches["render_sample"] != 16 or dry_launches["render_sample_plain"] \
            or dry_launches["streamed"] != 4:
        raise AssertionError(f"dryrun launches: {dry_launches}")

    # ---- 10. cull statistics: (ray, cluster) entries per ray ----
    cull = {}
    for su in (rtow, default, cornell, cml, terrain, terrain_big, smooth,
               rimage, mirror, marble, smoke, csmoke, bounce, book2,
               rtow_big, mesh_demo):
        w, h = 320, 180
        args = (*su.frame_args(w, h), 7, DEPTH)
        kw = dict(width=w, height=h, camera_model=su.model, spp=1,
                  rr_start=RR, with_stats=True, **su.flags, **su.rk)
        img_k, rays_k, cull_k = render_sample(*args, with_cull_stats=True,
                                              **kw)
        img_n, _ = render_sample(*args, **kw)
        img_p, rays_p, cull_p = render_sample_plain(
            *args, with_cull_stats=True, **kw)
        off = int(((img_k - img_p).abs().amax(2) > 1e-3).sum())
        rays_k, cull_k, cull_p = int(rays_k), int(cull_k), int(cull_p)
        cull[su.name] = {
            "entries_per_ray": cull_k / rays_k,
            "clusters": int(su.tb.n_super) * su.tb.super_,
            "rays": rays_k, "entries_kernel": cull_k, "entries_plain": cull_p,
            "pixels_differing": off, "image_unchanged": bool(
                torch.equal(img_k, img_n))}
        # the counts agree exactly where the pixels do
        if (not cull[su.name]["image_unchanged"]
                or off > MEGA_DIFF_SHARE * w * h
                or (off == 0 and (cull_k != cull_p or rays_k != int(rays_p)))
                or abs(cull_k / cull_p - 1) > MEGA_RAYS_RTOL):
            raise AssertionError(f"cull statistics on {su.name}: "
                                 f"{cull[su.name]}")
    cull_ms = {}
    for su in (book2, terrain_big):
        args = (*su.frame_args(W_MAIN, H_MAIN), 7, DEPTH)
        kw = dict(width=W_MAIN, height=H_MAIN, camera_model=su.model,
                  spp=SPP_MAIN, rr_start=RR, **su.flags, **su.rk)
        cull_ms[su.name] = {
            "ms": cuda_ms(lambda: render_sample(*args, **kw), 10),
            "ms_with_cull_stats": cuda_ms(lambda: render_sample(
                *args, with_cull_stats=True, **kw), 10)}
    emit({"phase": "cull_stats", "size": [320, 180], "spp": 1,
          "depth": DEPTH, "by_scene": cull, "timing_1280x720_4spp": cull_ms})

    # ---- 11. the staging probe (the port of tools/stream_probe.py) ----
    probe = {}
    probe_fns = (sp.stream_probe, sp.stream_probe_plain)
    for rows, tile_len in ((1, 512), (4, 448), (16, 112)):
        for table, nbytes in (("terrain_big", terrain_big.table_bytes),
                              ("book2_final", book2.table_bytes)):
            hi = max(16, round(nbytes / (4 * rows * tile_len)))
            lo = max(2, hi // 8)
            res, launches = launches_of(
                lambda: probe_script.run(tile_len, lo, hi, rows, "cuda"),
                probe_fns)
            # every variant against its plain version on the hi table
            tab = sp.probe_table(hi, tile_len, rows, dev)
            for v in sp.variants_for(rows):
                k = sp.stream_probe(tab, v)
                p_, plain_ms = host_ms(
                    lambda: sp.stream_probe_plain(tab, v, k.numel()))
                res[v].update(plain_ms=plain_ms, max_abs_err=int(
                    (k.long() - p_.long()).abs().max()))
            key = f"{rows}x{tile_len}/{table}"
            probe[key] = {"lo": lo, "hi": hi, "table_bytes": 4 * hi * rows *
                          tile_len, "reads": 32 * hi, "launches": launches,
                          **res, **bound(4 * hi * rows * tile_len, 0)}
            emit({"phase": "stream_probe", "shape": key, **probe[key],
                  "nvidia_smi": smi})
            if launches["stream_probe_plain"] or not launches["stream_probe"] \
                    or any(res[v]["max_abs_err"]
                           for v in sp.variants_for(rows)):
                raise AssertionError(f"stream probe {key}: {probe[key]}")

    def probe_line(name, rows, variant, replaces):
        """The probe's 1-D (rows 1) or 2-D kernels: launches over their
        runs, timed (``variant`` at --hi) in tiles of ``rows`` rows at
        the terrain_big table size."""
        runs = {k: v for k, v in probe.items()
                if (v["rows"] == 1) == (rows == 1)}
        key = next(k for k in runs
                   if k == f"{rows}x{runs[k]['tile_len']}/terrain_big")
        t = runs[key]
        return {"name": name, "route": "cuda",
                "source": "cudaraytracer_tpu_torch/csrc/stream_probe.cu",
                "replaces": replaces,
                "launches": sum(v["launches"]["stream_probe"]
                                for v in runs.values()),
                "max_abs_err": max(v[x]["max_abs_err"] for v in runs.values()
                                   for x in sp.variants_for(v["rows"])),
                "tolerance": "every CTA's int32 sum equal to expected and to "
                             "the plain version's",
                "ms": t[variant]["ms_hi"], "plain_ms": t[variant]["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None,
                "timed": f"{variant} {key}: {t['hi']} tiles",
                "by_shape": runs}


    # ---- 12. the streamed layout: kernels against plain and resident ----
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    budget = stream_budget(dev)
    probe_su = Setup("all_feature_probe", scenes.all_feature_probe_scene(),
                     scenes.cornell_like_camera(), "two_plane")

    per_ray = (("group_tests", "group"), ("block_tests", "block"),
               ("block_entries", "block_in"), ("ray_pages", "ray_pages"))

    def counters_off(kst, pwork, su):
        """The walk's counters that disagree: those of the rays' own
        against the plain walk's, and the pages entered (each once a
        launch) outside (0, min(pages staged, (ray, page) entries,
        pages of the tables)]."""
        off = [k for k, w in per_ray if kst[k] != pwork[w]]
        if not 0 < kst["pages_entered"] <= min(
                kst["pages"], kst["ray_pages"],
                su.st.n_blocks * su.st.block_b):
            off.append("pages_entered")
        return off

    def stream_plain_check(su, nee=False, size=(96, 54), spp=2, depth=6,
                           band=None, gsize=None, with_gbuffer=True,
                           stats=False):
        """The streamed kernel against its plain version (the walk over
        the tiles), by default at 96x54, 2 spp, depth 6, and unless
        ``with_gbuffer`` is False the G-buffer at ``gsize`` (default
        ``size``): the megakernel limits.  ``band``: (y0, rows) of
        ``size`` that the megakernel renders.  With ``stats`` each kernel
        is launched again through its counting entry (stream_stats): its
        output, rays and cluster entries must equal the timed entry's bit
        for bit, the counters that are the rays' own the plain walk's,
        and the pages entered lie within the pages and the (ray, page)
        entries."""
        w, h = size
        gw, gh = gsize or size
        y0, bh = band or (0, h)
        sargs, skw = su.stream_args(w, h)
        kw = dict(width=w, height=h, camera_model=su.model, spp=spp,
                  rr_start=RR, with_stats=True, with_cull_stats=True,
                  **su.flags, **su.options(nee=nee), **skw)
        if band:
            kw.update(y0=y0, band_h=bh)
        ik, nk, ck = render_sample(*sargs, 7, depth, **kw)
        pwork = {} if stats else None
        (ip, np_, cp), plain_ms = host_ms(
            lambda: render_sample_plain(*sargs, 7, depth, **kw, work=pwork))
        off = int(((ik - ip).abs().amax(2) > 1e-3).sum())
        mean_rel = abs(float(ik.mean()) / float(ip.mean()) - 1.0)
        rays_rel = abs(int(nk) / int(np_) - 1.0)
        g_err = g_masks = 0
        res = {"scene": su.name, "nee": nee, "size": [w, h],
               "rows": [y0, y0 + bh], "spp": spp, "depth": depth,
               "blocks": su.st.n_blocks, "pixels_differing": off,
               "mean_rel_diff": mean_rel,
               "rays": [int(nk), int(np_)], "cull": [int(ck), int(cp)],
               "max_abs_err": float((ik - ip).abs().max()),
               "plain_ms": plain_ms}
        stats_off, entries_same = [], []
        if stats:
            kstats = torch.zeros(len(STREAM_STATS), dtype=torch.int64,
                                 device=dev)
            ic, nc_, cc = render_sample(*sargs, 7, depth, **kw,
                                        stream_stats=kstats)
            res["stream_stats"] = dict(zip(STREAM_STATS, kstats.tolist()))
            stats_off += counters_off(res["stream_stats"], pwork, su)
            entries_same.append(torch.equal(ic, ik) and int(nc_) == int(nk)
                                and int(cc) == int(ck))
        if with_gbuffer:
            gargs = (*sargs[:5], su.cam_vec(gw, gh))
            gkw = dict(width=gw, height=gh, camera_model=su.model,
                       **su.flags, **skw)
            gk_ = gbuffer(*gargs, **gkw)
            gwork = {} if stats else None
            gp_, gplain_ms = host_ms(lambda: gbuffer_plain(*gargs, **gkw,
                                                           work=gwork))
            if stats:
                gstats = torch.zeros(len(STREAM_STATS), dtype=torch.int64,
                                     device=dev)
                gc_ = gbuffer(*gargs, **gkw, stream_stats=gstats)
                res["gbuffer_stream_stats"] = dict(zip(STREAM_STATS,
                                                       gstats.tolist()))
                stats_off += ["gbuffer_" + k for k in counters_off(
                    res["gbuffer_stream_stats"], gwork, su)]
                entries_same.append(all(torch.equal(a, b)
                                        for a, b in zip(gc_, gk_)))
            g_err = max(float((a - b).abs().max())
                        for a, b in zip(gk_, gp_))
            g_masks = int(((gk_.depth > 0) != (gp_.depth > 0)).sum())
            res.update(gbuffer_size=[gw, gh], gbuffer_masks_differ=g_masks,
                       gbuffer_max_abs_err=g_err,
                       gbuffer_plain_ms=gplain_ms)
        res.update(stats_off=stats_off,
                   counting_entries_equal_timed=all(entries_same))
        emit({"phase": "streamed_check", "against": "plain", **res})
        if (off > MEGA_DIFF_SHARE * w * bh or mean_rel > MEGA_MEAN_RTOL
                or rays_rel > MEGA_RAYS_RTOL or g_masks or g_err > GBUF_ATOL
                or (off == 0 and int(ck) != int(cp))
                or (off == 0 and stats_off) or not all(entries_same)):
            raise AssertionError(f"streamed kernel against plain: {res}")
        return res

    stream_plain = [stream_plain_check(rtow), stream_plain_check(terrain),
                    stream_plain_check(probe_su, nee=True),
                    stream_plain_check(book2)]

    def stream_resident_check(su, tag, opts, **band):
        """The streamed launch against the resident launch at 1280x720,
        SPP_MAIN spp, depth 12, with the cull counts: bit for bit."""
        sargs, skw = su.stream_args(W_MAIN, H_MAIN)
        kw = dict(width=W_MAIN, height=H_MAIN, camera_model=su.model,
                  spp=SPP_MAIN, rr_start=RR, with_stats=True,
                  with_cull_stats=True, **su.flags, **su.options(**opts),
                  **band)
        ir, nr, cr = render_sample(*su.frame_args(W_MAIN, H_MAIN), 7, DEPTH,
                                   **kw, **su.rk)
        is_, ns, cs = render_sample(*sargs, 7, DEPTH, **kw, **skw)
        res = {"scene": su.name, "case": tag, "size": [W_MAIN, H_MAIN],
               "spp": SPP_MAIN, "depth": DEPTH,
               "pixels_differing": int((ir != is_).any(2).sum()),
               "rays": [int(nr), int(ns)], "cull": [int(cr), int(cs)],
               "finite": bool(torch.isfinite(is_).all())}
        emit({"phase": "streamed_check", "against": "resident", **res})
        if res["pixels_differing"] or int(nr) != int(ns) \
                or int(cr) != int(cs) or not res["finite"]:
            raise AssertionError(f"streamed != resident: {res}")
        return res

    stream_resident = [
        stream_resident_check(rtow, "no options", {}),
        stream_resident_check(terrain_big, "no options", {}),
        stream_resident_check(book2, "nee qmc", main_opts),
        stream_resident_check(book2, "nee qmc half mask",
                              dict(main_opts, mask=book2_mask)),
        stream_resident_check(book2, "nee qmc band 180..359", main_opts,
                              y0=H_MAIN // 4, band_h=H_MAIN // 4, stream=5)]
    stream_gbuf = {}
    for su in (rtow, terrain_big, book2, default):
        sargs, skw = su.stream_args(W_MAIN, H_MAIN)
        kw = dict(width=W_MAIN, height=H_MAIN, camera_model=su.model,
                  **su.flags)
        gr = gbuffer(*su.frame_args(W_MAIN, H_MAIN), **kw, **su.bb)
        gs = gbuffer(*sargs, **kw, **skw)
        same = all(torch.equal(a, b) for a, b in zip(gr, gs))
        stream_gbuf[su.name] = {
            "equal": same,
            "ms": cuda_ms(lambda: gbuffer(*sargs, **kw, **skw), 10),
            "resident_ms": cuda_ms(lambda: gbuffer(
                *su.frame_args(W_MAIN, H_MAIN), **kw, **su.bb), 10)}
        if not same:
            raise AssertionError(f"streamed G-buffer != resident on "
                                 f"{su.name}")
    emit({"phase": "streamed_check", "against": "resident",
          "gbuffer": stream_gbuf, "nvidia_smi": smi})

    # ---- 13. the streamed path: a mesh beyond the card's L2, via the CLI
    # (smooth, without and with --nee: the flag sets of render --obj),
    # the streamed layout forced by a budget of 1 byte
    hf_n = 720  # 1,036,800 triangles
    w_p, h_p = 640, 360
    path = {"triangles": 2 * hf_n * hf_n, "size": [w_p, h_p], "depth": 4,
            "spp_per_frame": 2, "budget_bytes": 1,
            "card_budget_bytes": budget, "l2_bytes": l2}
    card_budget = app.stream_budget
    app.stream_budget = lambda dev: 1
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "heightfield.obj")
        t0 = time.perf_counter()
        mesh.save_obj(obj, *heightfield(hf_n))  # models/scenes.py
        path["obj_write_s"] = time.perf_counter() - t0
        for tag, extra, frames_p in (("smooth", ["--denoise"], 2),
                                     ("smooth_nee", ["--nee"], 1)):
            for fn in counted:
                fn.launches = 0
            render_sample.streamed_launches = gbuffer.streamed_launches = 0
            png = os.path.join(tmp, f"heightfield_{tag}.png")
            npz = os.path.join(tmp, f"heightfield_{tag}_aov.npz")
            t0 = time.perf_counter()
            rl = cli.main(["render", "--obj", obj, "--obj-smooth", *extra,
                           "--aov", npz, "--width", str(w_p), "--height",
                           str(h_p), "--frames", str(frames_p),
                           "--progressive-spp", "2", "--max-depth", "4",
                           "-o", png])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
            launches.update(
                render_sample_streamed=render_sample.streamed_launches,
                gbuffer_streamed=gbuffer.streamed_launches)
            from PIL import Image

            with Image.open(png) as im:
                size, arr = im.size, np.asarray(im.convert("RGB"))
            with np.load(npz) as z:
                aov_hit = float((z["depth"] > 0).mean())
            pipe = rl.pipeline
            run = {"args": ["--obj-smooth", *extra], "cli_s": cli_s,
                   "frames": frames_p, "stream_b": pipe.stream_b,
                   "table_bytes": pipe._tabs.table_bytes,
                   "launches": launches, "png_mean": float(arr.mean()),
                   "aov_hit_share": aov_hit}
            path[tag] = run
            emit({"phase": "streamed_path", "path": f"heightfield_{tag}",
                  **{k: v for k, v in path.items() if k not in
                     ("smooth", "smooth_nee")}, **run})
            if (run["stream_b"] <= 0 or run["table_bytes"] < 2 * l2
                    or launches["render_sample_streamed"] != frames_p
                    or launches["gbuffer_streamed"] != 1
                    or any(launches[fn.__name__] for fn in counted
                           if fn is not denoise)
                    # one denoised PNG under --denoise: a launch a pass
                    or launches["denoise"] != (4 if "--denoise" in extra
                                               else 0)
                    or size != (w_p, h_p) or not 10.0 < arr.mean() < 245.0
                    or aov_hit < 0.05):
                raise AssertionError(f"the streamed path misbehaves: {run}")
            if tag == "smooth":
                # the mesh packed resident too, for the checks below
                hf_su = Setup("heightfield", rl.scene,
                              scenes.SCENES[rl.cfg.scene][1](), "look_at")
            del rl, pipe
    app.stream_budget = card_budget
    torch.cuda.empty_cache()
    # ---- 13b. the native packer against the NumPy one, and both packers'
    # host ms on terrain_big and on this mesh (scripts/bvh_paths.py) ----
    packed = bvh_paths.pack_check(emit, hf_su.scene)

    # the path's kernels on its own mesh against their plain versions: 4
    # rows of 640x360 that lie on the mesh, 1 spp, depth 2, without and
    # with NEE; the G-buffer (no NEE bit: one instantiation) at 32x18.
    # The plain walk's time grows with the clusters its rays enter, so
    # the shapes are small.  Then the streamed G-buffer against the
    # resident one at 640x360
    stream_plain += [stream_plain_check(hf_su, nee=nee, size=(w_p, h_p),
                                        spp=1, depth=2, band=(296, 4),
                                        gsize=(32, 18), with_gbuffer=not nee,
                                        stats=True)
                     for nee in (False, True)]
    sargs, skw = hf_su.stream_args(w_p, h_p)
    kw = dict(width=w_p, height=h_p, camera_model=hf_su.model,
              **hf_su.flags)
    gr = gbuffer(*hf_su.frame_args(w_p, h_p), **kw, **hf_su.bb)
    gs = gbuffer(*sargs, **kw, **skw)
    stream_gbuf[hf_su.name] = {
        "size": [w_p, h_p], "equal": all(torch.equal(a, b)
                                         for a, b in zip(gr, gs)),
        "ms": cuda_ms(lambda: gbuffer(*sargs, **kw, **skw), 10),
        "resident_ms": cuda_ms(lambda: gbuffer(
            *hf_su.frame_args(w_p, h_p), **kw, **hf_su.bb), 10)}
    emit({"phase": "streamed_check", "against": "resident",
          "gbuffer": {hf_su.name: stream_gbuf[hf_su.name]},
          "nvidia_smi": smi})
    if not stream_gbuf[hf_su.name]["equal"]:
        raise AssertionError("streamed G-buffer != resident on the mesh")

    # ---- 14. resident against streamed, timed on the scenes the route
    # weighs: terrain_big, book2_final --nee --qmc and the beyond-L2 mesh;
    # the walk's counters of a streamed launch of each kernel, and the
    # least time of the work they count (stream_util.counted_bound)
    stream_timing = {}
    for su, opts in ((terrain_big, {}), (book2, main_opts), (hf_su, {})):
        w, h, spp_t, depth_t = W_MAIN, H_MAIN, SPP_MAIN, DEPTH
        sargs, skw = su.stream_args(w, h)
        kw = dict(width=w, height=h, camera_model=su.model, spp=spp_t,
                  rr_start=RR, **su.flags, **su.options(**opts))
        rargs = (*su.frame_args(w, h), 7, depth_t)
        ir, nr = render_sample(*rargs, with_stats=True, **kw, **su.rk)
        is_, ns = render_sample(*sargs, 7, depth_t, with_stats=True, **kw,
                                **skw)
        # parent-child order: resident, streamed, streamed, resident
        ms_r1 = cuda_ms(lambda: render_sample(*rargs, **kw, **su.rk), 5)
        ms_s1 = cuda_ms(lambda: render_sample(*sargs, 7, depth_t, **kw,
                                              **skw), 5)
        ms_s2 = cuda_ms(lambda: render_sample(*sargs, 7, depth_t, **kw,
                                              **skw), 5)
        ms_r2 = cuda_ms(lambda: render_sample(*rargs, **kw, **su.rk), 5)
        kst = torch.zeros(len(STREAM_STATS), dtype=torch.int64, device=dev)
        _, _, ce = render_sample(*sargs, 7, depth_t, with_stats=True,
                                 with_cull_stats=True, stream_stats=kst,
                                 **kw, **skw)
        kst = dict(zip(STREAM_STATS, kst.tolist()))
        gkw = dict(width=w, height=h, camera_model=su.model, **su.flags)
        gst = torch.zeros(len(STREAM_STATS), dtype=torch.int64, device=dev)
        gbuffer(*sargs, **gkw, **skw, stream_stats=gst)
        gst = dict(zip(STREAM_STATS, gst.tolist()))
        geo = dict(block_b=su.st.block_b, super_=su.st.super_,
                   cluster=su.st.cluster)
        key = su.name + ("/nee_qmc" if opts else "")
        stream_timing[key] = {
            "size": [w, h], "spp": spp_t, "depth": depth_t,
            "table_bytes": table_bytes(su.tb),
            "l2_share": table_bytes(su.tb) / l2,
            "streams_on_card": streams_on_card(su.tb, budget),
            "blocks": su.st.n_blocks,
            "groups": int(su.st.group_boxes.shape[1]),
            "resident_ms": [ms_r1, ms_r2], "streamed_ms": [ms_s1, ms_s2],
            "streamed_over_resident": (ms_s1 + ms_s2) / (ms_r1 + ms_r2),
            "rays": int(nr), "pixels_differing": int((ir != is_).any(2).sum()),
            "cull_entries": int(ce), "stream_stats": kst,
            # the least time of the walk's counted work: its box tests,
            # 28 triangle tests per cluster entry, a miss's shading per
            # ray, a raygen per sample; or the bytes of the pages its
            # rays enter, each read once, and of the image
            "streamed_bound": counted_bound(
                kst, int(ns), w * h * spp_t, 12 * w * h, int(ce), **geo),
            "gbuffer": {
                "ms": cuda_ms(lambda: gbuffer(*sargs, **gkw, **skw), 5),
                "resident_ms": cuda_ms(lambda: gbuffer(
                    *su.frame_args(w, h), **gkw, **su.bb), 5),
                "stream_stats": gst,
                # without its cluster entries (the G-buffer counts none)
                "bound": counted_bound(gst, w * h, w * h, 28 * w * h,
                                       gbuffer_pass=True, **geo)}}
        if stream_timing[key]["pixels_differing"] or int(nr) != int(ns):
            raise AssertionError(f"streamed != resident on {key}")
        # the pages entered (the bound's bytes), each once a launch
        for c in (kst, gst):
            if not 0 < c["pages_entered"] <= min(
                    c["pages"], c["ray_pages"],
                    su.st.n_blocks * su.st.block_b):
                raise AssertionError(f"pages entered on {key}: {c}")
    emit({"phase": "streamed_timing", "by_scene": stream_timing,
          "l2_bytes": l2, "budget_bytes": budget, "nvidia_smi": smi})
    del hf_su

    # the streamed kernels' lines: timed on the main path's scene and
    # options (book2_final --nee --qmc, 1280x720, 4 spp), where the
    # resident kernel's work tally (its three-level walk) gives the
    # search's tests: the streamed walk tests every box that walk tests
    # (its block gate is the CTA's, not the ray's), so they bound it
    b2 = checks[f"book2_final/nee_qmc/{SPP_MAIN}spp"]
    b2_sargs, b2_skw = book2.stream_args(W_MAIN, H_MAIN)
    b2_kw = dict(width=W_MAIN, height=H_MAIN, camera_model=book2.model,
                 spp=SPP_MAIN, rr_start=RR, **book2.flags,
                 **book2.options(**main_opts), **b2_skw)
    b2_bytes = 4 * sum(t.numel() for t in b2_sargs[:4]) + 4 * 38 \
        + 4 * book2.nee["lights"].numel() + book2.texel_bytes(b2["work"]) \
        + 12 * W_MAIN * H_MAIN + 8
    b2_bound = bound(b2_bytes, b2["ops"])
    _, b2_plain_ms = host_ms(lambda: render_sample_plain(
        *b2_sargs, 7, DEPTH, **b2_kw))
    b2_ms = stream_timing["book2_final/nee_qmc"]["streamed_ms"]
    gb2_sargs, _ = book2.stream_args(W_MAIN, H_MAIN)
    gb2_kw = dict(width=W_MAIN, height=H_MAIN, camera_model=book2.model,
                  **book2.flags, **b2_skw)
    _, gb2_plain_ms = host_ms(lambda: gbuffer_plain(*gb2_sargs, **gb2_kw))
    # the streamed walk's counted work: the resident two-level walk's
    # (its box tests too) and the streamed walk's sweep
    g2_work = {}
    gbuffer_plain(*book2.frame_args(W_MAIN, H_MAIN), width=W_MAIN,
                  height=H_MAIN, camera_model=book2.model, **book2.flags,
                  work=g2_work)
    gb2_st = stream_timing["book2_final/nee_qmc"]["gbuffer"]["stream_stats"]
    gb2_bound = bound(4 * sum(t.numel() for t in gb2_sargs[:4]) + 4 * 38
                      + 28 * W_MAIN * H_MAIN,
                      work_ops(g2_work, GBUFFER_OPS) + OPS["box"]
                      * (gb2_st["group_tests"] + gb2_st["block_tests"]))
    mesh_t = stream_timing["heightfield"]

    # the main path: render --scene book2_final --nee --qmc --adaptive
    # --denoise --aov
    launches = by_path[main_tag]
    mk = timing[f"book2_final/nee_qmc/{SPP_MAIN}spp"]
    print(smi, flush=True)
    emit({"kernels": [
        {"name": "render_sample", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/render_kernel.cu",
         "replaces": "cudaraytracer_tpu/ops/pallas/render_kernel.py:1406",
         "launches": launches["render_sample"], "max_abs_err": mega_err,
         "tolerance": "<=0.01% of pixels off by >1e-3; mean and rays rtol "
                      "1e-4; rtow_final at 320x180 and 1280x720; default, "
                      "cornell_mesh_light, terrain, mesh_smooth, rtow_image, "
                      "mirror_room, terrain_big, marble, smoke, "
                      "cornell_smoke, bounce and book2_final at 1280x720; "
                      "NEE on cornell, cornell_mesh_light and smoke at "
                      "640x360; QMC on default and NEE+QMC on book2_final, "
                      "unmasked and with half its tiles masked (depth 4), "
                      "at 1280x720; rtow_big and mesh_demo at 1280x720; NEE "
                      "on mesh_smooth, a smooth OBJ, terrain, terrain_big "
                      "and bounce at 640x360; a band of 180 rows of "
                      "book2_final --nee --qmc and rtow_final at 1280x720; "
                      "cull statistics equal (with equal pixels) at "
                      "320x180 on 16 scenes; bands and sharded frames "
                      "bit-identical to their launches; ragged batches: "
                      "cornell_smoke --nee --qmc at 1277x719 and in a "
                      "half-masked band of 333 rows, every pixel written",
         "ms": mk["ms"], "plain_ms": mk["plain_ms"],
         "bound_ms": mk["bound_ms"], "bound_by": mk["bound_by"],
         "library_ms": None,
         "timed": f"book2_final --nee --qmc {W_MAIN}x{H_MAIN} "
                  f"{SPP_MAIN} spp",
         "launches_by_path": {
             **{k: v["render_sample"] for k, v in by_path.items()},
             **{f"sharded_{name}_{k}": v["launches"]["render_sample"]
                for name, b in bands.items()
                for k, v in b["sharded"].items()},
             "dryrun_multichip": dry_launches["render_sample"]},
         "by_scene": {k: v for k, v in timing.items()},
         "utilisation": util,
         "cull_entries_per_ray": {k: v["entries_per_ray"]
                                  for k, v in cull.items()}},
        {"name": "closest_hit", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/hit_kernel.cu",
         "replaces": "cudaraytracer_tpu/ops/pallas/hit_kernel.py:37",
         # its path: render --accel wavefront --scene rtow_final
         # --denoise --aov (2 frames of one sample)
         "launches": xla["paths"]["wavefront_rtow_final"]["launches"][
             "closest_hit"],
         "path": "render --accel wavefront --scene rtow_final --denoise "
                 "--aov",
         "launches_by_path": {
             k: v["launches"]["closest_hit"]
             for k, v in xla["paths"].items()},
         "max_abs_err": max(xla["sort"]["loop_bounce2"]["max_abs_err_t"],
                            *(v["max_abs_err"] for v in hits.values())),
         "tolerance": "columns equal except t-ties; t rtol 1e-5; dead rays "
                      "(BIG, -1); the walk's counters equal the plain "
                      "walk's; on 2^20 uniform rays (rtow_final, "
                      "cornell_mesh_light), the sorted bounce wavefronts of "
                      "1280x720 frames and rays grazing block corners "
                      "(rtow_final, terrain_big, cornell_mesh_light); "
                      "columns equal to the plain walk's, t rtol 1e-5, on "
                      "the wavefront renderer's own bounce-2 wavefront of "
                      "terrain_big",
         "loop_bounce2": xla["sort"]["loop_bounce2"],
         "wavefront": xla["timing"],
         "ms": hits["terrain_big/bounce"]["ms"],
         "plain_ms": hits["terrain_big/bounce"]["plain_ms"],
         "bound_ms": hits["terrain_big/bounce"]["bound_ms"],
         "bound_by": hits["terrain_big/bounce"]["bound_by"],
         "library_ms": None,
         "timed": "terrain_big: the sorted bounce wavefront of a "
                  f"{W_MAIN}x{H_MAIN} frame",
         "by_scene": hits},
        {"name": "gbuffer", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/gbuffer_kernel.cu",
         "replaces": "cudaraytracer_tpu/ops/pallas/gbuffer_kernel.py:62",
         "launches": launches["gbuffer"],
         "max_abs_err": max(gb_rtow["max_abs_err"], gb_default["max_abs_err"],
                            *(v["max_abs_err"] for v in gb_new.values())),
         "tolerance": f"hit masks equal; every buffer within {GBUF_ATOL}; "
                      "the walk's counters equal the plain walk's; "
                      "rtow_final, default, terrain, rtow_image, "
                      "terrain_big, marble, smoke, cornell_smoke, bounce "
                      "and book2_final at 1280x720",
         "ms": gb_new["book2_final"]["ms"],
         "plain_ms": gb_new["book2_final"]["plain_ms"],
         "bound_ms": gb_new["book2_final"]["bound_ms"],
         "bound_by": gb_new["book2_final"]["bound_by"], "library_ms": None,
         "timed": f"book2_final {W_MAIN}x{H_MAIN}",
         "launches_by_path": {k: v["gbuffer"] for k, v in by_path.items()},
         "by_scene": {"rtow_final": gb_rtow, "default": gb_default,
                      **gb_new}},
        {"name": "render_sample_streamed", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/render_stream.cu "
                   "(render_kernel.cu's streamed entry, search.cuh "
                   "closest_hit_streamed)",
         "replaces": "cudaraytracer_tpu/ops/pallas/render_kernel.py:1193",
         "launches": path["smooth"]["launches"]["render_sample_streamed"],
         "max_abs_err": max(r["max_abs_err"] for r in stream_plain),
         "tolerance": "against plain: <=0.01% of pixels off by >1e-3, mean "
                      "and rays rtol 1e-4 at 96x54 (rtow_final, terrain, "
                      "the all-feature probe with NEE, book2_final) and on "
                      "the beyond-L2 mesh, without and with NEE, in 4 rows "
                      "of 640x360; "
                      "against the resident kernel: bit for bit, equal "
                      "rays and cull counts at 1280x720 (rtow_final, "
                      "terrain_big, book2_final --nee --qmc unmasked, half "
                      "masked and a band; terrain_big, book2_final and the "
                      "beyond-L2 mesh in the timing phase); on the mesh the "
                      "walk's counters of the rays' own (group and block "
                      "tests, block and page entries) equal the plain "
                      "walk's",
         "ms": statistics.median(b2_ms), "plain_ms": b2_plain_ms,
         "bound_ms": b2_bound["bound_ms"], "bound_by": b2_bound["bound_by"],
         "library_ms": None,
         "timed": f"book2_final --nee --qmc {W_MAIN}x{H_MAIN} {SPP_MAIN} spp "
                  "(launches: the beyond-L2 OBJ path)",
         "launches_by_path": {
             **{f"heightfield_obj_{k}": path[k]["launches"][
                 "render_sample_streamed"] for k in ("smooth", "smooth_nee")},
             "dryrun_multichip": dry_launches["streamed"]},
         # the beyond-L2 mesh that the launches above render, at 1280x720
         "mesh": {"triangles": path["triangles"],
                  "ms": statistics.median(mesh_t["streamed_ms"]),
                  "resident_ms": statistics.median(mesh_t["resident_ms"]),
                  "launches": path["smooth"]["launches"][
                      "render_sample_streamed"],
                  **{k: mesh_t["streamed_bound"][k] for k in (
                      "bound_ms", "bound_by")},
                  "stream_stats": mesh_t["stream_stats"],
                  "timed": f"{W_MAIN}x{H_MAIN} {SPP_MAIN} spp depth {DEPTH}"},
         "by_scene": stream_timing},
        {"name": "gbuffer_streamed", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/gbuffer_kernel.cu "
                   "(gbuffer_kernel_streamed)",
         "replaces": "cudaraytracer_tpu/ops/pallas/gbuffer_kernel.py:439",
         "launches": path["smooth"]["launches"]["gbuffer_streamed"],
         "launches_by_path": {f"heightfield_obj_{k}": path[k]["launches"][
             "gbuffer_streamed"] for k in ("smooth", "smooth_nee")},
         "max_abs_err": max(r.get("gbuffer_max_abs_err", 0.0)
                            for r in stream_plain),
         "tolerance": f"hit masks equal, buffers within {GBUF_ATOL} of "
                      "plain at 96x54 and on the beyond-L2 mesh at 32x18; "
                      "equal to the resident kernel at 1280x720 "
                      "(rtow_final, terrain_big, book2_final, default) and "
                      "on the mesh at 640x360",
         "ms": stream_gbuf["book2_final"]["ms"], "plain_ms": gb2_plain_ms,
         "bound_ms": gb2_bound["bound_ms"],
         "bound_by": gb2_bound["bound_by"], "library_ms": None,
         "timed": f"book2_final {W_MAIN}x{H_MAIN} (launches: the beyond-L2 "
                  "OBJ path)",
         "mesh": {"triangles": path["triangles"],
                  "ms": mesh_t["gbuffer"]["ms"],
                  "resident_ms": mesh_t["gbuffer"]["resident_ms"],
                  "launches": path["smooth"]["launches"]["gbuffer_streamed"],
                  **{k: mesh_t["gbuffer"]["bound"][k] for k in (
                      "bound_ms", "bound_by")},
                  "stream_stats": mesh_t["gbuffer"]["stream_stats"],
                  "timed": f"{W_MAIN}x{H_MAIN}"},
         "by_scene": stream_gbuf},
        {"name": "bvh_closest_hit", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/bvh_kernel.cu",
         "replaces": "cudaraytracer_tpu/ops/bvh_traverse.py:102",
         # its path: render --accel bvh --scene rtow_final --denoise --aov
         # (2 frames of one sample)
         "launches": xla["paths"]["bvh_rtow_final"]["launches"]["bvh_hit"],
         "path": "render --accel bvh --scene rtow_final --denoise --aov",
         "max_abs_err": max(v["max_abs_err_t"] for v in bvh_hits.values()),
         "tolerance": "bit for bit (hit, t, slot and the per-ray counters) "
                      "against the plain lock-step walk on the sorted "
                      "bounce wavefronts of 1280x720 frames: every live "
                      "ray of rtow_final, the first 2^14 of terrain_big",
         "ms": bvh_hits["rtow_final"]["ms"],
         "plain_ms": bvh_hits["rtow_final"]["plain_ms"],
         "bound_ms": bvh_hits["rtow_final"]["bound_ms"],
         "bound_by": bvh_hits["rtow_final"]["bound_by"],
         "library_ms": None,
         "timed": "rtow_final: the sorted bounce wavefront of a "
                  f"{W_MAIN}x{H_MAIN} frame",
         "by_scene": bvh_hits, "builds": bvh_built,
         "per_sample": {k: v for k, v in xla["timing"].items()
                        if k.startswith("bvh/")},
         "native": {"build": native, "pack_check": packed},
         "sharded_xla": sharded_xla},
        {"name": "denoise", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/denoise_kernel.cu",
         "replaces": "none: cudaraytracer_tpu/ops/denoise.py::"
                     "atrous_denoise is XLA",
         "launches": launches["denoise"],
         "launches_by_path": {k: v["denoise"] for k, v in by_path.items()},
         "max_abs_err": 0.0 if all(
             v["equal"] for k, v in den.items() if "/" in k) else None,
         "tolerance": "bit for bit against the plain version on a "
                      f"book2_final frame at {W_MAIN}x{H_MAIN}, 1 and 4 "
                      "passes, with and without a variance plane",
         "ms": den["plain"]["ms"], "plain_ms": den["plain"]["plain_ms"],
         "bound_ms": den["plain"]["bound_ms"],
         "bound_by": den["plain"]["bound_by"], "library_ms": None,
         "timed": f"book2_final {W_MAIN}x{H_MAIN}, 4 passes",
         "variance": den["variance"]},
        *(probe_line(name, rows_, variant, replaces)
          for name, rows_, variant, replaces in (
              ("stream_probe", 1, "stream", "tools/stream_probe.py:57"),
              ("stream_probe_2d", 4, "stream2d",
               "tools/stream_probe.py:119"))),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
