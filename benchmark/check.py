"""The comparison that decides ``correct``: the frames the window showed,
against the plain reference replaying the same traffic.

The reference (``benchmark/reference/``) takes the scene's arrays as the
benchmark built them, the frame log and the seed, and nothing the port
made.  It replays the log on its own fly camera and scene copy, packs its
own tables at each scene state, and computes:

* ``radiance_off``: for every checked frame and a sample of pixels drawn
  from the seed, the radiance sum the port's accumulator held after the
  frame, against the reference's sum of the same launches (every launch
  since the accumulation last restarted; a lane per pixel and launch,
  summed in launch order in float32).  The share of (frame, pixel) pairs
  whose three channels are not all within 1e-4 of the reference's
  (relative, with 1e-6 absolute).  The kernels round as the plain loop
  does, so a pair differs only where a path took another turn on a last
  bit of a transcendental function.
* ``display_off``: for every checked frame, the displayed RGBA8 against the
  reference's display of the port's own state after that frame: its
  radiance accumulator (tonemap and RGBA8) and, under ``denoise``, the
  G-buffer the display used (the reference's a-trous denoiser first).
  The share of pixels with a channel off by a level or more.  Both run
  the same tensor operations on the same inputs and device, so a sound
  display is exact.  The state it starts from is checked by itself:
  the accumulator by ``radiance_off`` on its sampled pixels, the G-buffer
  by ``gbuffer_off``.
* ``gbuffer_off`` (``denoise`` traffic): the G-buffer the display used
  against the reference's (pixel-centre rays, brute force): the share of
  pixels whose normal, albedo or depth is not within 1e-4 relative.

``control=True`` puts the reference, computed in bfloat16 (the step below
the configuration's float32), in the port's place: lane sums and their
accumulation in bfloat16, the display's tonemap and denoiser on bfloat16
copies, the G-buffer rounded to bfloat16.  Its readings set the limits'
upper ends; the port's sound runs set their lower ends.
"""

from __future__ import annotations

import numpy as np
import torch

from . import generator
from .drive import pose_fly
from .reference import camera as ref_camera
from .reference import denoise as ref_denoise
from .reference import pack as ref_pack
from .reference import render as ref_render
from .reference import rng as ref_rng
from .reference import sampling as ref_sampling
from .reference import tables as ref_tables
from .reference.gbuffer import GBuffer

RTOL, ATOL = 1e-4, 1e-6
# lanes (pixel, launch) per reference call
LANE_BLOCK = 1 << 18


def frame_seed(render_seed: int, frame: int) -> int:
    """The launch seed of progressive frame ``frame``: the render loop's
    rule, injective in the frame index."""
    return (render_seed * 2654435761 + frame) & 0x7FFFFFFF


def replay(log: list, ref_scene, pose: dict, named: dict, opts: dict,
           wanted) -> dict:
    """Walk the frame log on the reference's own camera and scene copy.
    Returns, for each frame in ``wanted``: (camera vector f32[38], scene
    state, index of the frame that restarted the accumulation)."""
    fly = ref_camera.FlyCamera()
    pose_fly(fly, pose)
    scene = ref_scene.copy()
    out = {}
    epoch, vec, state = 0, None, scene
    for i, acts in enumerate(log):
        changed = i == 0
        for a in acts:
            changed = True
            if a[0] == "mouse":
                fly.process_mouse(a[1], a[2])
            elif a[0] == "keys":
                fly.process_keys(a[1])
            elif a[0] == "move":
                if scene is state:
                    scene = scene.copy()
                scene.move(named[a[1]], a[2])
        if changed:
            epoch, state = i, scene
            cam = fly.params(aperture=opts["aperture"],
                             focus_dist=opts["focus_dist"])
            vec = ref_tables.pack_camera_np(
                cam, state.background_start, state.background_end,
                opts["width"], opts["height"], opts["t_min"])
        if i in wanted:
            out[i] = (vec, state, epoch)
    return out


class RefTables:
    """The reference's tables of one scene state on ``device``."""

    def __init__(self, scene, device, nee: bool):
        images = ref_tables.has_images(scene)
        S, P, vattrs, _ = ref_tables.pack_tables(scene, with_uv=images)
        self.flags = dict(ref_tables.kernel_flags(scene), has_vattrs=vattrs)
        self.S = torch.from_numpy(S).to(device)
        self.P = torch.from_numpy(P).to(device)
        nbytes = S.nbytes + P.nbytes
        self.atlas = self.tex_hw = None
        if images:
            self.atlas = torch.from_numpy(np.ascontiguousarray(
                scene.atlas)).to(device)
            self.tex_hw = torch.from_numpy(np.ascontiguousarray(
                scene.tex_hw, dtype=np.int32)).to(device)
            nbytes += scene.atlas.nbytes + scene.tex_hw.nbytes
        self.lights = None
        if nee:
            lt = ref_sampling.pack_lights_np(scene)
            self.lights = torch.from_numpy(lt).to(device)
            nbytes += lt.nbytes
        self.nbytes = int(nbytes)

    def render_kw(self) -> dict:
        return dict(self.flags, atlas=self.atlas, tex_hw=self.tex_hw,
                    lights=self.lights)


def _off(cand: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row: not every value within RTOL relative (ATOL absolute)."""
    bad = (cand - ref).abs() > RTOL * ref.abs() + ATOL
    bad = bad | ~torch.isfinite(cand)
    return bad.reshape(bad.shape[0], -1).any(1)


def _display(accum, divisor: int, gb, opts: dict, dtype=torch.float32):
    """The reference's RGBA8 of a radiance sum (display-oriented)."""
    acc = accum.to(dtype)
    if opts["denoise"]:
        g = GBuffer(*(t.to(dtype) for t in gb))
        img = ref_denoise.atrous_denoise(acc / divisor, g, None,
                                         iterations=int(opts["denoise_iters"]))
        out = ref_pack.to_rgba8(ref_pack.tonemap(img, 1))
    else:
        out = ref_pack.to_rgba8(ref_pack.tonemap(acc, divisor))
    out = out.cpu().numpy()
    return out[::-1] if opts["camera_model"] == "two_plane" else out


def run_check(win, rec: dict, device, control: bool = False) -> dict:
    """The numbers compared, the reference's tally of the checked lanes and
    what the roofline reads.  ``win`` is the finished ``drive.Window``."""
    opts = dict(win.opts, denoise_iters=4)
    w, h, spp = opts["width"], opts["height"], int(opts["progressive_spp"])
    snaps = rec["snapshots"]
    steps = replay(win.log, win.ref_scene, win.pose, win.named, opts,
                   {s.frame for s in snaps})
    n_pix = min(int(win.cell.traffic["check_pixels"]), w * h)
    pick = generator.stream(win.seed, "check")
    pix_np = np.sort(pick.choice(w * h, size=n_pix, replace=False))
    pix = torch.from_numpy(pix_np).to(device)
    tally: dict = {}
    lanes = 0
    rad_off = []
    disp_off = []
    gb_off = []
    tables_cache: dict = {}
    table_bytes = 0
    # the launches of each accumulation epoch up to its last checked frame
    by_epoch: dict = {}
    for s in snaps:
        by_epoch.setdefault(steps[s.frame][2], []).append(s)
    acc_dtype = torch.bfloat16 if control else torch.float32
    for epoch, group in by_epoch.items():
        vec, state, _ = steps[group[0].frame]
        key = id(state)
        if key not in tables_cache:
            tables_cache[key] = RefTables(state, device, bool(opts["nee"]))
        tb = tables_cache[key]
        table_bytes = tb.nbytes
        cam = [float(v) for v in vec]
        last = max(s.frame for s in group)
        frames = list(range(epoch, last + 1))
        sums, n = _epoch_sums(win, tb, cam, pix, frames, epoch, opts, device,
                              acc_dtype, tally)
        lanes += n
        ref32 = None
        for s in group:
            ref_sum = sums[s.frame].to(torch.float32)
            prog = s.accum.reshape(-1, 3)[pix].to(torch.float32)
            if control:
                if ref32 is None:
                    ref32, _ = _epoch_sums(win, tb, cam, pix, frames, epoch,
                                           opts, device, torch.float32, None)
                rad_off.append(_off(ref_sum, ref32[s.frame]))
            else:
                rad_off.append(_off(prog, ref_sum))
            divisor = spp * (s.frame - epoch + 1)
            gb_ref = None
            if opts["denoise"]:
                gb_ref = ref_render.gbuffer_image(
                    tb.S, tb.P, cam, width=w, height=h,
                    camera_model=opts["camera_model"],
                    **{k: v for k, v in tb.render_kw().items()
                       if k in ("has_rects", "has_tris", "has_vattrs",
                                "has_media", "has_motion", "atlas",
                                "tex_hw")})
                cand = (GBuffer(*(t.to(torch.bfloat16).to(torch.float32)
                                  for t in gb_ref)) if control
                        else s.gbuffer)
                gb_off.append(_off(
                    torch.cat([cand.normal.reshape(-1, 3),
                               cand.albedo.reshape(-1, 3),
                               cand.depth.reshape(-1, 1)], 1),
                    torch.cat([gb_ref.normal.reshape(-1, 3),
                               gb_ref.albedo.reshape(-1, 3),
                               gb_ref.depth.reshape(-1, 1)], 1)))
            ref_rgba = _display(s.accum, divisor, s.gbuffer, opts)
            shown = (_display(s.accum, divisor, s.gbuffer, opts,
                              dtype=torch.bfloat16) if control else s.rgba)
            diff = np.abs(shown.astype(np.int16) - ref_rgba.astype(np.int16))
            disp_off.append(torch.from_numpy(
                (diff.reshape(-1, 4).max(1) > 0)))
    numbers = {"radiance_off": float(torch.cat(rad_off).float().mean()),
               "display_off": float(torch.cat(disp_off).float().mean())}
    if gb_off:
        numbers["gbuffer_off"] = float(torch.cat(gb_off).float().mean())
    return {"numbers": numbers, "tally": tally, "lanes": lanes,
            "table_bytes": table_bytes, "checked_frames": len(snaps),
            "checked_pixels": n_pix}


def _epoch_sums(win, tb, cam, pix, frames, epoch, opts, device, dtype,
                tally) -> tuple:
    """The reference's radiance sums at the sampled pixels after each of
    ``frames`` (launches since the accumulation restarted at ``epoch``),
    lanes summed and accumulated in ``dtype``; with the lanes run."""
    spp = int(opts["progressive_spp"])
    n_pix = pix.shape[0]
    acc = torch.zeros((n_pix, 3), dtype=dtype, device=device)
    sums = {}
    lanes = 0
    per = max(1, LANE_BLOCK // n_pix)
    for b in range(0, len(frames), per):
        fb = frames[b:b + per]
        keys = torch.tensor([ref_rng.key_for(frame_seed(win.render_seed, f))
                             for f in fb], dtype=torch.int64,
                            device=device).repeat_interleave(n_pix)
        base = torch.tensor([spp * (f - epoch) for f in fb],
                            dtype=torch.int64,
                            device=device).repeat_interleave(n_pix)
        out = ref_render.render_lanes(
            tb.S, tb.P, cam, pix.repeat(len(fb)), keys, base,
            opts["max_depth"], width=opts["width"], height=opts["height"],
            camera_model=opts["camera_model"], spp=spp,
            rr_start=opts["rr_start"], nee_p=opts["nee_p"],
            has_qmc=bool(opts["qmc"]), tally=tally, accum_dtype=dtype,
            **tb.render_kw())
        lanes += out.shape[0]
        out = out.reshape(len(fb), n_pix, 3).to(dtype)
        for k, f in enumerate(fb):
            acc = acc + out[k]
            sums[f] = acc
    return sums, lanes
