"""The closest-hit kernel's ray sets: bounce wavefronts, the rays it
will serve, uniform rays, and rays that graze box corners.

    from cudaraytracer_tpu_torch.scripts.bounce_rays import bounce_wavefront
    org, dirn, n_alive = bounce_wavefront("terrain_big", device)
    org, dirn, n_alive = uniform_rays("cornell_mesh_light", device)
    org, dirn, n_alive = grazing_rays(tables.block_boxes, device)

The wavefront renderer (JAX ``models/wavefront.py::
render_wavefront_sample``, still to be ported) hands its hit step a
bounce's rays compacted and sorted: live rays first, ordered by origin
cell and direction octant (``models/wavefront.py::sort_keys``).  This
builds such a wavefront from one frame's G-buffer: the pixel-centre
rays' first hits are the origins (o + depth * d, the G-buffer's own hit
points), the directions are cosine-weighted about the front-facing
feature normal, drawn by a seeded numpy generator, the misses are dead
and go last (n_alive = the hits, n_rays = width * height), and the live
rays are in ``sort_keys`` order (a stable sort, so ties keep pixel
order).  The G-buffer is the plain version's, with the resident walk
(``gbuffer_plain`` with the block boxes), so the wavefront is the same on
any device and for any build of the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import scenes
from ..models.wavefront import scene_bounds, sort_keys
from ..ops.cuda.gbuffer_kernel import gbuffer_plain
from ..ops.cuda.render_kernel import primary_rays
from ..ops.cuda.tables import kernel_inputs, pack_camera_np

# the scenes whose bounces the closest-hit kernel is timed on: it has
# rects and triangles but no media or motion flags
SCENES = ("rtow_final", "terrain_big", "cornell_mesh_light")
# uniform rays: the box their origins fill and the seed, per scene
UNIFORM = {"rtow_final": ((-12, 0.05, -12), (12, 3.0, 12), 20260101),
           "cornell_mesh_light": ((-2.4, 0.1, -2.4), (2.4, 4.9, 4.0),
                                  20260102)}


def uniform_rays(name: str, device, n: int = 1 << 20) -> tuple:
    """``n`` rays with origins uniform in scene ``name``'s box of
    ``UNIFORM`` and directions uniform on the sphere, from its seed ->
    (org f32[n, 3], dirn f32[n, 3], n_alive = n - 77777) on ``device``:
    the closest hit's checks and timings since it was ported."""
    lo, hi, seed = UNIFORM[name]
    rs = np.random.RandomState(seed)
    org = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    dirn = rs.randn(n, 3).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    return (torch.from_numpy(org).to(device),
            torch.from_numpy(dirn).to(device), n - 77777)


def cosine_directions(normal: np.ndarray, rs: np.random.RandomState):
    """Unit directions f32[R, 3], cosine-weighted about the unit normals
    f32[R, 3] (Malley: a uniform disc point lifted to the hemisphere, in
    an orthonormal frame about each normal; float64, then f32)."""
    n = normal.astype(np.float64)
    u1, u2 = rs.random_sample(len(n)), rs.random_sample(len(n))
    r, phi = np.sqrt(u1), 2.0 * np.pi * u2
    lx, ly, lz = r * np.cos(phi), r * np.sin(phi), np.sqrt(1.0 - u1)
    # a tangent: the axis least aligned with n, crossed with n
    a = np.zeros_like(n)
    a[np.arange(len(n)), np.abs(n).argmin(1)] = 1.0
    t = np.cross(a, n)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    b = np.cross(n, t)
    d = (lx[:, None] * t + ly[:, None] * b + lz[:, None] * n).astype(
        np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def bounce_wavefront(name: str, device, width: int = 1280,
                     height: int = 720, seed: int = 0) -> tuple:
    """The sorted bounce wavefront of registered scene ``name`` at width x
    height -> (org f32[R, 3], dirn f32[R, 3], n_alive) on ``device``, R =
    width * height (module docstring; a dead ray's org is 0 and its
    dirn +z)."""
    sc, cam = scenes.SCENES[name][0](), scenes.SCENES[name][1]()
    model = scenes.camera_model_for(name)
    tb, flags = kernel_inputs(sc, device)
    cv = torch.from_numpy(pack_camera_np(cam, sc.background_start,
                                         sc.background_end, width, height,
                                         1e-3)).to(device)
    gb = gbuffer_plain(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv,
                       width=width, height=height, camera_model=model,
                       block_boxes=tb.block_boxes, **flags)
    n = width * height
    f32 = torch.float32
    pix = torch.arange(n, dtype=torch.int64, device=device)
    zeros = torch.zeros(n, dtype=f32, device=device)
    ox, oy, oz, dx, dy, dz = primary_rays(
        [float(v) for v in cv.cpu().tolist()], (pix % width).to(f32),
        (pix // width).to(f32), 0.5, 0.5, zeros, zeros, width, height,
        model)
    t = gb.depth.reshape(n)
    alive = t > 0
    org = torch.stack([ox + t * dx, oy + t * dy, oz + t * dz], 1)
    org = torch.where(alive[:, None], org, 0.0)
    normal = gb.normal.reshape(n, 3).cpu().numpy()
    live = alive.cpu().numpy()
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    d[live] = cosine_directions(normal[live], np.random.RandomState(seed))
    dirn = torch.from_numpy(d).to(device)
    lo, inv = (torch.from_numpy(v).to(device) for v in scene_bounds(sc))
    order = torch.argsort(sort_keys(org, dirn, alive, lo, inv), stable=True)
    return (org[order].contiguous(), dirn[order].contiguous(),
            int(alive.sum()))


def grazing_rays(boxes: torch.Tensor, device, n_warps: int = 4096,
                 seed: int = 7) -> tuple:
    """Rays through box corners, for an exact check of the packet test:
    warp w's 32 rays are one ray, aimed at the corner of a random used box
    of ``boxes`` (f32[6, N], a point at +BIG when unused) where its far x
    face meets its near y face, from 0.5-4 extents away, in a random
    octant.  Rounding decides whether such a ray enters the box, by a few
    ulps either way, so a packet test a few ulps too tight rejects boxes
    that some ray enters: the walk's counters (``hit_stats``) show it.
    -> (org f32[32 n_warps, 3], dirn, n_alive = all) on ``device``."""
    bx = boxes.cpu().numpy().astype(np.float64)
    used = np.nonzero(bx[0] < 1e30)[0]
    rs = np.random.RandomState(seed)
    b = used[rs.randint(0, len(used), n_warps)]
    lo, hi = bx[0:3, b].T, bx[3:6, b].T
    sign = np.where(rs.random_sample((n_warps, 3)) < 0.5, -1.0, 1.0)
    d = sign * (0.2 + rs.random_sample((n_warps, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    corner = np.stack([np.where(sign[:, 0] > 0, hi[:, 0], lo[:, 0]),
                       np.where(sign[:, 1] > 0, lo[:, 1], hi[:, 1]),
                       lo[:, 2] + rs.random_sample(n_warps)
                       * (hi[:, 2] - lo[:, 2])], 1)
    extent = np.maximum((hi - lo).max(1), 1e-3)
    org = (corner - (0.5 + 3.5 * rs.random_sample(n_warps))[:, None]
           * extent[:, None] * d).astype(np.float32)
    org, d = np.repeat(org, 32, axis=0), np.repeat(d, 32, axis=0)
    return (torch.from_numpy(org).to(device), torch.from_numpy(d).to(device),
            32 * n_warps)
