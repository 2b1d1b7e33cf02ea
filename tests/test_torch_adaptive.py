"""Adaptive sampling in the port: the megakernel's tile mask, the
statistics update (viewer/app.py::adaptive_update) and the mask's tiles,
against the JAX package.

A masked launch must render its active tiles exactly as the unmasked
launch (the generator is keyed by pixel, never by tile) and trace nothing
elsewhere.  ``adaptive_update`` is a line-for-line port of the JAX
pipeline's ``_step_adaptive``; fed the radiance and counts the JAX step
produced (its kernel in interpret mode, as tests/test_adaptive.py runs
it, from a zero accumulator so that its returned sum IS the launch's
radiance), it must reach the same launch counts and mask exactly and the
same moments to rtol 1e-6.  The interpret-mode generator does not depend
on the seed, so the camera moves by 0.03 along x from launch to launch to
give the tiles a nonzero variance (the checkered ground fills the lower
tile of the 128x32 frame: its pixels' display-space error stays near
0.095, the upper tile's near 0), and the launches take 1, 2 and 3
samples.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.ops.pallas import render_kernel as jrk  # noqa: E402
from cudaraytracer_tpu.viewer import app as japp  # noqa: E402

from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.viewer.app import (adaptive_update,  # noqa: E402
                                                tile_activity_plane)


def frame(name, w, h, **opts):
    sc, cam = tscenes.SCENES[name][0](), tscenes.SCENES[name][1]()
    tb, flags = ttab.kernel_inputs(sc, "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, sc.background_start, sc.background_end, w, h, 1e-3))
    return rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                            cv, 5, 4, width=w, height=h, spp=2, rr_start=2,
                            camera_model=tscenes.camera_model_for(name),
                            with_stats=True, cluster=tb.cluster,
                            super_=tb.super_, **flags, **opts)


MASK_W, MASK_H, MASK_TILE = 300, 40, (16, 128)
# not symmetric: a mask read transposed masks other tiles
MASK = torch.tensor([1, 0, 1, 1, 0, 1, 0, 1, 0], dtype=torch.int32)


def masked_launches():
    """The default scene at 300x40 (3 x 3 tiles of 16 x 128) unmasked and
    masked by MASK -> (full, rays, masked, rays, active pixels)."""
    full, n_full = frame("default", MASK_W, MASK_H)
    part, n_part = frame("default", MASK_W, MASK_H, tile_mask=MASK,
                         tile=MASK_TILE)
    grid = rk.mask_grid(MASK_W, MASK_H, MASK_TILE)
    act = tile_activity_plane(MASK, grid, *MASK_TILE)[:MASK_H, :MASK_W] > 0.5
    return full, n_full, part, n_part, act


def masked_mismatch() -> int:
    """Pixels of the masked launch that are not what they must be: the
    unmasked launch's on active tiles, zero on masked ones."""
    full, _, part, _, act = masked_launches()
    return (int((part[act] != full[act]).any(-1).sum())
            + int((part[~act] != 0).any(-1).sum()))


def test_masked_launch_equals_unmasked_on_active_tiles():
    assert rk.mask_grid(MASK_W, MASK_H, MASK_TILE) == (3, 3)
    assert not torch.equal(MASK.reshape(3, 3), MASK.reshape(3, 3).t())
    full, n_full, part, n_part, act = masked_launches()
    assert masked_mismatch() == 0
    assert full[~act].abs().max() > 0  # the masked tiles would render
    # an all-ones mask traces every ray; this one only the active pixels'
    _, n_ones = frame("default", MASK_W, MASK_H,
                      tile_mask=torch.ones(9, dtype=torch.int32),
                      tile=MASK_TILE)
    assert int(n_ones) == int(n_full)
    assert 0 < int(n_part) < int(n_full)


def test_mask_shape_is_checked():
    with pytest.raises(ValueError, match=r"i32\[9\]"):
        frame("default", 300, 40, tile_mask=torch.ones(8, dtype=torch.int32),
              tile=(16, 128))
    # the tile shape is the caller's (tables.mask_tile): no default
    with pytest.raises(ValueError, match="tile shape"):
        frame("default", 300, 40, tile_mask=torch.ones(9, dtype=torch.int32))


def test_tile_activity_plane_equals_jax():
    mask = np.array([1, 0, 2, 0, 3, 1], np.int32)
    ours = tile_activity_plane(torch.from_numpy(mask), (2, 3), 4, 8)
    ref = np.asarray(jrk.tile_activity_plane(mask, (2, 3), 4, 8))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("name", list(tscenes.SCENES))
def test_mask_tile_follows_jax(name):
    """The mask's tiles follow the JAX pipeline's resident/streamed rule
    (fits_megakernel on the packed tables)."""
    ts, js = tscenes.SCENES[name][0](), jscenes.SCENES[name][0]()
    img = ttab.has_images(ts)
    t = ttab.pack_scene_tables(ts, with_uv=img)
    jt = jrk.pack_scene_tables(js, with_uv=img)
    assert ttab.table_smem_bytes(t) == jrk.table_smem_bytes(jt)
    fits = jrk.fits_megakernel(js.num_active, jt.vattrs, tables=jt)
    assert ttab.mask_tile(ts, t) == ((16, 256) if fits else (16, 128))
    # and on the torch tables the pipeline holds
    assert ttab.mask_tile(ts, ttab.tables_to_torch(t, "cpu")) == \
        ttab.mask_tile(ts, t)


@pytest.mark.parametrize("tau", [1.0, 0.05])
def test_adaptive_update_equals_jax_step(tau):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    w, h, tile = 128, 32, (16, 256)
    grid = rk.mask_grid(w, h, tile)
    js, cam = jscenes.default_scene(), jscenes.default_scene_camera()
    jt = jrk.pack_scene_tables(js)
    cv = jrk.pack_camera_np(cam, js.background_start, js.background_end, w,
                            h, 1e-3)
    step = japp._pallas_step(
        w, h, grid[1] * tile[1], grid[0] * tile[0], "two_plane", *tile,
        True, False, 2, jt.cluster, jt.super_, True, adaptive=True)
    nt = grid[0] * grid[1]
    jstate = (jnp.zeros((h, w), jnp.float32), jnp.zeros((h, w), jnp.float32),
              jnp.zeros((nt,), jnp.float32), jnp.ones((nt,), jnp.int32))
    tstate = (torch.zeros((h, w)), torch.zeros((h, w)), torch.zeros(nt),
              torch.ones(nt, dtype=torch.int32))
    nmin, q = 3, 0.95
    masks = []
    with pltpu.force_tpu_interpret_mode():
        for k in range(5):
            spp = 1 + k % 3
            rad, counts, *jstate = step(
                *map(jnp.asarray, (jt.S, jt.P, jt.clusters, jt.supers)),
                np.int32(jt.n_super),
                cv + np.float32(0.03 * k) * (np.arange(cv.size) < 3),
                7 + k, 3, np.int32(spp),
                np.int32(0), jnp.zeros((h, w, 3), jnp.float32),
                jnp.zeros((h, w), jnp.float32), *jstate, np.float32(tau),
                np.float32(nmin), np.float32(q))
            tstate = adaptive_update(
                torch.from_numpy(np.array(rad)),
                torch.from_numpy(np.array(counts)), *tstate, tau, nmin, q,
                grid, tile)
            s1, s2, nl, mask = (np.asarray(v) for v in jstate)
            np.testing.assert_array_equal(tstate[2].numpy(), nl)
            np.testing.assert_array_equal(tstate[3].numpy(), mask)
            np.testing.assert_allclose(tstate[0].numpy(), s1, rtol=1e-6)
            np.testing.assert_allclose(tstate[1].numpy(), s2, rtol=1e-6)
            masks.append(int(mask.sum()))
    # tau 1.0: both tiles converge at their nmin-th launch; 0.05: the
    # ground's tile does not
    assert masks == ([2, 2, 0, 0, 0] if tau == 1.0 else [2, 2, 1, 1, 1])
