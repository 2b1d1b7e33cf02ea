"""Resident against streamed tables over mesh sizes: the crossover that
sets the card's table route (``ops/cuda/tables.py``: ``stream_budget``,
``STREAM_L2_SHARE`` for tables that carry the megakernel's tree,
``MEDIA_L2_SHARE`` for those that do not).

    python -m cudaraytracer_tpu_torch.scripts.stream_crossover
        [--sizes 160,320,480,560,640,720,880,1000] [--device cuda]
        [--mesh heightfield|torus] [--flat] [--nee] [--media]

For each size n, a mesh of 2 n^2 triangles on the checkered ground, set
up as ``render --obj --obj-smooth`` sets up an OBJ model: a smooth
heightfield (``models/scenes.py::heightfield_scene``, whose n = 480 is
the registered ``heightfield_460k``) or, with ``--mesh torus``, a torus
of n x n quads (``utils/mesh.py::torus``, normalized as
``register_obj_scene`` normalizes a file); ``--flat`` drops the vertex
normals (``render --obj`` without ``--obj-smooth``), ``--nee`` adds
light sampling (``render --obj --nee``).  ``--media`` makes it a media
scene (``media_scene``): the flat mesh with book2_final's flag set, so
that the resident megakernel refills lanes and walks no tree.  It is
packed resident (``tables.pack_scene_tables``) and streamed (``tables.
pack_stream_tiles``).  Both layouts render the same launches, which
must be equal bit for bit, and are timed in turns (resident, streamed,
streamed, resident; CUDA events, median of 5 launches after a warm-up)
at 640x360 1 spp depth 4 (the beyond-L2 CLI path's shape in
``chip_smoke.py``) and at 1280x720 4 spp depth 12 (the main path's),
Russian roulette from bounce 2; the G-buffer too.  Prints one JSON line
per size: triangles, table bytes and their share of the card's L2,
blocks and superclusters, and per shape the ms of each layout and their
ratio.  The crossover is the largest table size at which the resident
walk is faster at both shapes.  ``--device cpu`` runs the plain versions
at 32x18 (a rehearsal: host times, no device metric).  The card's name
and power limit (``nvidia-smi``) ride along.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from ..models.camera import make_camera_params
from ..models.scene import IMAGE
from ..models.scenes import heightfield_scene, procedural_globe_image
from ..ops.cuda.gbuffer_kernel import gbuffer
from ..ops.cuda.render_kernel import render_sample
from ..ops.cuda.tables import (atlas_to_torch, has_images, kernel_flags,
                               nee_inputs, pack_camera_np, pack_scene_tables,
                               pack_stream_tiles, stream_tables_to_torch,
                               table_bytes, tables_to_torch)

# the camera register_obj_scene gives an OBJ model (models/scenes.py::
# obj_camera) as make_camera_params keywords: design_sweep's child
# imports it from here in older checkouts too
CAMERA = dict(origin=(0.0, 0.9, 2.6), forward=(0.0, -0.22, -1.0),
              fov_deg=50.0)


def media_scene(n: int, mesh: str = "heightfield"):
    """The flat mesh of size ``n`` in a media scene with book2_final's
    flag set (the instantiations that the registered media scene runs):
    a whole-scene thin fog sphere (book2_final's density), a moving
    sphere and an image-textured sphere beside the mesh."""
    scene = heightfield_scene(n, False, mesh)
    scene.add_medium_sphere((0.0, 0.0, 0.0), 50.0, density=0.01,
                            albedo=(1.0, 1.0, 1.0))
    scene.add_moving_sphere((-0.8, 0.2, 0.9), (-0.7, 0.2, 0.9), 0.12,
                            albedo=(0.7, 0.3, 0.1))
    slot = scene.load_image_texture(procedural_globe_image())
    scene.add_sphere((0.8, 0.25, 0.9), 0.15, tex_type=IMAGE, tex_id=slot)
    return scene


def _ms(fn, cuda: bool, reps: int = 5) -> float:
    """Median ms of ``reps`` calls after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure(n: int, shapes, device, mesh: str = "heightfield",
            smooth: bool = True, nee: bool = False,
            media: bool = False) -> dict:
    """One size's row (module docstring)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    scene = media_scene(n, mesh) if media else heightfield_scene(
        n, smooth, mesh)
    images = has_images(scene)
    t0 = time.perf_counter()
    t = pack_scene_tables(scene, with_uv=images)
    pack_s = time.perf_counter() - t0
    tb = tables_to_torch(t, dev)
    st = stream_tables_to_torch(pack_stream_tiles(t), dev)
    flags = dict(kernel_flags(scene), has_vattrs=t.vattrs)
    if images:
        flags.update(zip(("atlas", "tex_hw"), atlas_to_torch(scene, dev)))
    lit = nee_inputs(scene, dev) if nee else {}
    nbytes = table_bytes(t)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size if cuda \
        else None
    row = {"mesh": mesh, "smooth": smooth and not media, "nee": nee,
           "media": media, "tree": t.tree is not None,
           "triangles": 2 * n * n, "table_bytes": nbytes,
           "l2_share": nbytes / l2 if l2 else None, "pack_s": pack_s,
           "blocks": st.n_blocks, "supers": int(t.n_super)}
    cam = make_camera_params(**CAMERA)
    for w, h, spp, depth in shapes:
        cv = torch.from_numpy(pack_camera_np(
            cam, scene.background_start, scene.background_end, w, h,
            1e-3)).to(dev)
        gkw = dict(width=w, height=h, camera_model="look_at",
                   cluster=t.cluster, super_=t.super_, **flags)
        kw = dict(gkw, spp=spp, rr_start=2, **lit)
        res = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv, 7, depth)
        stm = (st.tiles, st.block_boxes, st.clusters, st.supers,
               st.n_blocks, cv, 7, depth)
        bb = dict(block_boxes=tb.block_boxes)
        walk = dict(bb, tree=tb.tree)
        a, na = render_sample(*res, with_stats=True, **kw, **walk)
        skw = dict(stream_b=st.block_b, group_boxes=st.group_boxes)
        b, nb = render_sample(*stm, with_stats=True, **skw, **kw)
        if not torch.equal(a, b) or int(na) != int(nb):
            raise AssertionError(f"streamed != resident at n={n}")
        r1 = _ms(lambda: render_sample(*res, **kw, **walk), cuda)
        s1 = _ms(lambda: render_sample(*stm, **skw, **kw), cuda)
        s2 = _ms(lambda: render_sample(*stm, **skw, **kw), cuda)
        r2 = _ms(lambda: render_sample(*res, **kw, **walk), cuda)
        g_r = _ms(lambda: gbuffer(*res[:6], **gkw, **bb), cuda)
        g_s = _ms(lambda: gbuffer(*stm[:6], **skw, **gkw), cuda)
        row[f"{w}x{h}/{spp}spp/depth{depth}"] = {
            "rays": int(na), "resident_ms": [r1, r2], "streamed_ms": [s1, s2],
            "streamed_over_resident": (s1 + s2) / (r1 + r2),
            "gbuffer_resident_ms": g_r, "gbuffer_streamed_ms": g_s}
    return row


def run(sizes, device="cuda", mesh="heightfield", smooth=True,
        nee=False, media=False) -> dict:
    """Every size's row, printed as it comes."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False "
                           "(pass device='cpu' for the plain versions)")
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    rows = {}
    for n in sizes:
        shapes = ([(640, 360, 1, 4), (1280, 720, 4, 12)]
                  if dev.type == "cuda" else [(32, 18, 1, 2)])
        rows[n] = measure(n, shapes, dev, mesh, smooth, nee, media)
        print(json.dumps({"n": n, **rows[n], "nvidia_smi": smi,
                          "mode": "compiled" if smi else "plain"}),
              flush=True)
    return {"nvidia_smi": smi, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="160,320,480,560,640,720,880,1000",
                    help="comma-separated n (2 n^2 triangles each)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="heightfield",
                    choices=("heightfield", "torus"))
    ap.add_argument("--flat", action="store_true",
                    help="no vertex normals (render --obj without "
                         "--obj-smooth)")
    ap.add_argument("--nee", action="store_true",
                    help="light sampling (render --obj --nee)")
    ap.add_argument("--media", action="store_true",
                    help="the flat mesh in a media scene (media_scene)")
    args = ap.parse_args(argv)
    run([int(v) for v in args.sizes.split(",")], args.device, args.mesh,
        not args.flat, args.nee, args.media)


if __name__ == "__main__":
    main()
