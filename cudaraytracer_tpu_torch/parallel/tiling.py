"""Multi-device rendering: image rows in bands, samples in streams.

Port of ``cudaraytracer_tpu/parallel/tiling.py``: ``make_mesh`` (:52),
``render_sharded_pallas`` (:122) as ``render_sharded_sample``, and the
XLA renderer's ``render_sharded`` (:67) and ``ShardedRenderer`` (:235).  A ``Mesh`` is a rows x samples grid of torch
devices.  Each place renders one band of image rows with one sample
stream through ``ops/cuda/render_kernel.py::render_sample`` (the
megakernel on a CUDA device, its plain version on the CPU); the streams
of a band are summed on the band's first device (JAX's ``psum`` over the
samples axis) and the bands are stitched on the caller's device.  The
scene tables and the camera are small and copied to every device.  On
one card the same device may fill every place: the launches then run one
after the other on it, as the places of a mesh would run side by side.
``render_sharded`` does the same with the brute renderer
(``models/renderer.py::render_radiance``): each place renders its band
with its own slice of the sample indices, and the scene goes to every
device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..models.renderer import render_radiance
from ..ops.cuda.render_kernel import render_sample

# render_sample's arguments that render_sharded_sample sets per place
_PER_PLACE = ("y0", "band_h", "stream", "tile_mask", "tile", "with_stats",
              "with_cull_stats")


@dataclass(frozen=True)
class Mesh:
    """A rows x samples grid of torch devices (``devices[row][sample]``);
    the counterpart of JAX's ``Mesh(devices, ("rows", "samples"))``."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"rows": len(self.devices), "samples": len(self.devices[0])}


def make_mesh(n_rows: int | None = None, n_samples: int = 1,
              devices=None) -> Mesh:
    """Build a ("rows", "samples") mesh over ``devices`` (torch devices
    or their names, row-major; default: every CUDA device).  The same
    device may fill several places.  Raises ``ValueError`` when
    n_rows x n_samples is not the number of devices."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("no devices for the mesh")
    if n_rows is None:
        n_rows = n // n_samples
    if n_rows * n_samples != n:
        raise ValueError(f"{n_rows}x{n_samples} mesh != {n} devices")
    return Mesh(tuple(tuple(devices[r * n_samples:(r + 1) * n_samples])
                      for r in range(n_rows)))


def band_launches(mesh: Mesh, height: int, spp: int,
                  sample_base: int = 0) -> list:
    """The launch of each place, row-major: (row, sample, device,
    render_sample keywords y0, band_h, stream, sample_base).  Under QMC
    each sample stream draws its own slice of the R2 sequence (base +
    si * spp); every (band, stream) place has its own generator stream
    ri * n_samples + si (JAX tiling.py:218, :221)."""
    n_rows, n_samp = mesh.shape["rows"], mesh.shape["samples"]
    band_h = height // n_rows
    return [(ri, si, mesh.devices[ri][si],
             dict(y0=ri * band_h, band_h=band_h, stream=ri * n_samp + si,
                  sample_base=sample_base + si * spp))
            for ri in range(n_rows) for si in range(n_samp)]


def render_sharded_sample(tables, n_super, cam_vec, seed, max_depth, *,
                          width: int, height: int, mesh: Mesh,
                          tile_h: int = 1, tile_w: int = 1, spp: int = 1,
                          sample_base: int = 0, **kw) -> torch.Tensor:
    """One multi-device megakernel frame -> f32[height, width, 3], the
    radiance SUM over the mesh's sample streams of ``spp`` samples each
    (divide by spp * n_samples to display), on the device of
    ``tables[0]``.

    ``tables`` is (S, P, clusters, supers) (``tables.tables_to_torch``),
    or with ``stream_b`` > 0 in ``kw`` the streamed (tiles, block_boxes,
    clusters, supers) with ``n_super`` the used blocks
    (``tables.stream_tables_to_torch``), as JAX's
    ``render_sharded_pallas`` takes them (tiling.py:144-211); ``kw`` are
    ``render_sample``'s other keywords (camera model, Russian roulette,
    the scene's static flags, the atlas, NEE with its light table, QMC,
    cluster sizes, ``stream_b`` with the streamed ``group_boxes``, or the
    resident ``block_boxes`` and ``tree``), the same at every place.  Band ``ri`` is
    the image rows ri * band_h .. (ri + 1) * band_h - 1 with band_h =
    height / n_rows; the places are ``band_launches``.

    JAX's kernel tiles each band into tile_h x tile_w tiles and needs
    whole ones, so it raises ``ValueError`` when height is not a multiple
    of n_rows * tile_h or width of tile_w; so does this function, for
    the tile it is given.  The CUDA kernel masks its ragged thread
    blocks, so the default 1 x 1 tile only asks that the rows divide
    into bands; pass JAX's tile to hold a frame to JAX's alignment.
    Image textures are sampled in the kernel at every hit, so, unlike
    JAX's, an image scene's frame is the radiance alone, with no
    per-pixel sample counts.
    """
    bad = sorted(set(kw) & set(_PER_PLACE))
    if bad:
        raise TypeError(f"render_sharded_sample sets {bad} per place")
    n_rows = mesh.shape["rows"]
    if height % (n_rows * tile_h):
        raise ValueError(f"height {height} not divisible by rows*tile_h")
    if width % tile_w:
        raise ValueError(f"width {width} not divisible by tile_w {tile_w}")
    home = tables[0].device
    copies = {}

    def on(dev):
        """The tables, camera and tensor keywords on ``dev``, once."""
        if dev not in copies:
            copies[dev] = (
                [t.to(dev) for t in (*tables, cam_vec)],
                {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                 for k, v in kw.items()})
        return copies[dev]

    # every launch first (devices run side by side), then the sums
    outs = {}
    for ri, si, dev, place in band_launches(mesh, height, spp, sample_base):
        (S, P, clusters, supers, cam), dkw = on(dev)
        outs[ri, si] = render_sample(
            S, P, clusters, supers, n_super, cam, seed, max_depth,
            width=width, height=height, spp=spp, **place, **dkw)
    bands = []
    for ri in range(n_rows):
        # the samples axis' psum, on the band's first device
        acc = outs[ri, 0]
        for si in range(1, mesh.shape["samples"]):
            acc = acc + outs[ri, si].to(acc.device)
        bands.append(acc.to(home))
    return torch.cat(bands, 0)


def _scene_on(scene, dev):
    """A ``SceneData`` with every tensor moved to ``dev``."""
    return dataclasses.replace(scene, **{
        f.name: getattr(scene, f.name).to(dev)
        for f in dataclasses.fields(scene)
        if isinstance(getattr(scene, f.name), torch.Tensor)})


def render_sharded(scene, cam, key: int, spp: int, max_depth: int, *,
                   width: int, height: int, mesh: Mesh,
                   camera_model: str = "two_plane", t_min: float = 0.001,
                   block: int = 64) -> torch.Tensor:
    """One frame of the brute renderer over the mesh -> f32[height, width,
    3], the radiance SUM over ``spp`` samples (divide to display), as
    ``render_radiance``, on the device of ``scene`` (a ``SceneData``).

    Place (ri, si) renders the band of rows ri * tile_h .. (ri + 1) *
    tile_h - 1 (tile_h = height / n_rows) with the samples si * local_spp
    .. (si + 1) * local_spp - 1 (local_spp = spp / n_samples), as
    ``render_radiance(y0=, tile_h=, sample_offset=)``; the streams of a
    band are summed on the band's first device (JAX's ``psum``) and the
    bands stitched on the scene's device.  A band keys its rays by their
    pixel ids in the whole image, so with one sample stream the stitched
    frame equals ``render_radiance``'s bit for bit.  Raises
    ``ValueError`` unless the rows divide the height and the samples the
    spp."""
    n_rows, n_samp = mesh.shape["rows"], mesh.shape["samples"]
    if height % n_rows:
        raise ValueError(f"height {height} not divisible by rows axis "
                         f"{n_rows}")
    if spp % n_samp:
        raise ValueError(f"spp {spp} not divisible by samples axis "
                         f"{n_samp}")
    tile_h, local_spp = height // n_rows, spp // n_samp
    home = scene.center.device
    copies = {}
    outs = {}
    for ri in range(n_rows):
        for si in range(n_samp):
            dev = mesh.devices[ri][si]
            if dev not in copies:
                copies[dev] = _scene_on(scene, dev)
            outs[ri, si] = render_radiance(
                copies[dev], cam, key, local_spp, max_depth, width=width,
                height=height, camera_model=camera_model, t_min=t_min,
                block=block, y0=ri * tile_h, tile_h=tile_h,
                sample_offset=si * local_spp)
    bands = []
    for ri in range(n_rows):
        acc = outs[ri, 0]
        for si in range(1, n_samp):
            acc = acc + outs[ri, si].to(acc.device)
        bands.append(acc.to(home))
    return torch.cat(bands, 0)


class ShardedRenderer:
    """The brute frame renderer over a mesh (the scaling analog of
    ``models/renderer.py::Renderer``; JAX tiling.py:235-270).  The default
    mesh puts the bands on every CUDA device, ``n_samples_axis`` streams
    each; pass ``mesh`` (``make_mesh(..., devices=["cpu"] * n)``) for
    another."""

    def __init__(self, width: int, height: int, mesh: Mesh | None = None,
                 n_samples_axis: int = 1, camera_model: str = "two_plane",
                 t_min: float = 0.001, block: int = 64):
        self.width = int(width)
        self.height = int(height)
        self.mesh = mesh if mesh is not None else make_mesh(
            n_samples=n_samples_axis)
        self.camera_model = camera_model
        self.t_min = t_min
        self.block = block

    def render(self, scene, cam, key: int, spp: int = 36,
               max_depth: int = 12) -> torch.Tensor:
        """Radiance sum over ``spp`` samples, f32[H,W,3], on the device of
        the mesh's first place (``replicate`` the scene there first)."""
        return render_sharded(
            scene, cam, key, spp, max_depth, width=self.width,
            height=self.height, mesh=self.mesh,
            camera_model=self.camera_model, t_min=self.t_min,
            block=self.block)

    def replicate(self, scene):
        """The ``SceneData`` on the mesh's first device (the bands copy it
        to their own devices once per frame)."""
        return _scene_on(scene, self.mesh.devices[0][0])
