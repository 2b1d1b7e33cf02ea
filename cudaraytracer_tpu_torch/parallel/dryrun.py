"""Dry run of the sharded megakernel paths over an n-device grid.

    python -m cudaraytracer_tpu_torch.parallel.dryrun [--devices 4]
        [--device cuda|cpu]

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (:116) for the
megakernel: builds a rows x samples mesh (two sample streams when
n_devices is even), renders one frame with ``render_sharded_sample`` on
tiny shapes, and checks it, for three paths:

* the resident default scene (two_plane, 128 x 16 * n_rows, depth 3);
* the streamed shard: the same scene in the streamed layout
  (``tables.pack_stream_tiles``, ``stream_b``), which must equal the
  resident frame bit for bit (__graft_entry__.py:185-258);
* the feature shard: ``all_feature_probe_scene`` with every static flag,
  NEE over its lights and QMC from sample base 5.

The resident and feature frames must be f32[H, W, 3], finite, and equal
bit for bit to the sum over the sample streams of single
``render_sample`` launches with the same band, stream and sample base,
made on the mesh's first device.  The places are the first n CUDA
devices, or the one card in every place when there are fewer
(``--device cpu``: the plain versions).
"""

from __future__ import annotations

import argparse

import torch

from ..models import scenes
from ..ops.cuda.render_kernel import render_sample
from ..ops.cuda.tables import (kernel_inputs, nee_inputs, pack_camera_np,
                               pack_scene_tables, pack_stream_tiles,
                               stream_tables_to_torch)
from .tiling import band_launches, make_mesh, render_sharded_sample


def mesh_devices(n_devices: int, device: str = "cuda") -> list:
    """n_devices places: distinct CUDA devices while there are enough,
    else ``device`` in every place."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False "
                               "(pass device='cpu' for the plain versions)")
        if torch.cuda.device_count() >= n_devices:
            return [torch.device("cuda", i) for i in range(n_devices)]
    return [dev] * n_devices


def launch_sum(tb, cv, mesh, seed, max_depth, width, height, spp,
               sample_base, kw):
    """The frame as single launches on the mesh's first device: each
    band the sum, in stream order, of its places' launches."""
    rows = {}
    for ri, si, _, place in band_launches(mesh, height, spp, sample_base):
        img = render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                            cv, seed, max_depth, width=width, height=height,
                            spp=spp, **place, **kw)
        rows[ri] = img if si == 0 else rows[ri] + img
    return torch.cat([rows[ri] for ri in sorted(rows)], 0)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run and check the three sharded paths; returns their means."""
    devices = mesh_devices(n_devices, device)
    n_samples = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_rows = n_devices // n_samples
    mesh = make_mesh(n_rows=n_rows, n_samples=n_samples, devices=devices)
    home = devices[0]
    width, height, seed, depth, spp = 128, 16 * n_rows, 7, 3, 1
    means = {}
    # (tag, scene, camera, NEE and QMC, QMC sample base)
    for tag, scene, cam, options, base in (
            ("resident", scenes.default_scene(),
             scenes.default_scene_camera(), False, 0),
            ("features", scenes.all_feature_probe_scene(),
             scenes.cornell_like_camera(), True, 5)):
        tb, kw = kernel_inputs(scene, home)
        if options:
            kw.update(nee_inputs(scene, home), has_qmc=True)
        kw.update(camera_model="two_plane", cluster=tb.cluster,
                  super_=tb.super_)
        cv = torch.from_numpy(pack_camera_np(
            cam, scene.background_start, scene.background_end, width,
            height, 1e-3)).to(home)
        out = render_sharded_sample(
            (tb.S, tb.P, tb.clusters, tb.supers), tb.n_super, cv, seed,
            depth, width=width, height=height, mesh=mesh, tile_h=16,
            tile_w=128, spp=spp, sample_base=base,
            block_boxes=tb.block_boxes, **kw)
        if out.shape != (height, width, 3) or out.dtype != torch.float32:
            raise AssertionError(f"{tag}: frame is {out.dtype}"
                                 f"{list(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{tag}: frame is not finite")
        want = launch_sum(tb, cv, mesh, seed, depth, width, height, spp,
                          base, dict(kw, block_boxes=tb.block_boxes))
        if not torch.equal(out, want):
            raise AssertionError(f"{tag}: sharded frame != the sum of its "
                                 "launches")
        means[tag] = float(out.mean())
        if tag == "resident":
            # the streamed shard: same scene, seeds and bands
            st = stream_tables_to_torch(pack_stream_tiles(
                pack_scene_tables(scene)), home)
            sout = render_sharded_sample(
                (st.tiles, st.block_boxes, st.clusters, st.supers),
                st.n_blocks, cv, seed, depth, width=width, height=height,
                mesh=mesh, tile_h=16, tile_w=128, spp=spp, sample_base=base,
                **dict(kw, stream_b=st.block_b))
            if not torch.equal(sout, out):
                raise AssertionError("streamed shard != resident shard")
            means["streamed"] = float(sout.mean())
    print(f"dryrun_multichip OK: mesh rows={n_rows} samples={n_samples} "
          f"({home}), resident {(height, width, 3)} mean="
          f"{means['resident']:.4f}, streamed (stream_b={st.block_b}, "
          f"{st.n_blocks} blocks) bit-identical, feature shard "
          f"(nee+noise+media+motion+rotated-boxm+qmc) mean="
          f"{means['features']:.4f}", flush=True)
    return {"rows": n_rows, "samples": n_samples, "device": str(home),
            "means": means}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
