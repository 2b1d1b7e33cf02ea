"""Planted faults in the plain versions of the noise, media, motion,
NEE, QMC and tile-mask branches: do the CPU checks against the JAX
package and the oracle catch them?

The faults ``cudaraytracer_tpu_torch/scripts/planted_faults.py`` plants
in the CUDA sources (where the card's kernel-against-plain check catches
them) are planted here in the plain PyTorch code, one line of a module
edited in a copy of that module, and each must fail the check named
beside it.  ``test_scene_matches_xla_path`` (the radiance against the
XLA renderer, statistically) catches only the isotropic one of the
first five; the other four move its statistics less than its limits, so
each is held by a sharper check: the scatter distance and the box chord
against tests/oracle.py, the marble factor against the JAX noise, and a
moving ball whose middle keeps albedo x sky only if a path keeps its
shutter time.  The NEE faults (the light pdf not averaged over the
lights, the cosine pdf without 1/pi) fail the mixture's integral of the
cosine lobe; the QMC ones (the x and y rotations swapped, the sample base
ignored) fail the sky render against the XLA renderer; the mask read
transposed fails the masked launch's check.  The pixel key taken from
the band's row instead of the image's fails the band seams; two sample
streams of a band sharing one generator stream fail the sharded frame
against its launches; the probe's streamrows waiting on its first row
only fails the sum against the JAX kernels'; the streamed layout's
payload read from the wrong page of its tile fails the tiles' columns
against the resident tables; the streamed walk's sweep dropping a
candidate block and a page read from the wrong offset of its tile fail
the walk against the resident walks and brute force, and a group box
shrunk by one ulp fails the exact union of its blocks.  The packet walk
of the resident G-buffer and the closest hit: its packet test rounded
inward, its tfar one ulp short and a mixed-sign axis culled on fail the
packet test's conservativeness on corner-grazing packets and on
packets whose directions differ in sign on one axis; a candidate block dropped and the last block skipped fail the
walk against the two-level walk and brute force.  The megakernel's tree
walk: its leaf boxes left unpadded fail the walk against the two-level
walk on rays that graze sphere poles, and a missed node's skip taken one
node too far fails it on rays from inside the scene.  (The card's
other streamed faults, a block dropped where one ray of a warp enters
it, a page re-gated under a tighter or a stale best_t, are in the
kernel's votes and gates, which the plain walk does not have.)

    PYTHONPATH=.:tests python tests/test_torch_planted_faults.py

prints the radiance check's readings (the largest channel-mean error,
the mean and the largest 4x4 block-mean error, against its limits) on
each of the first five faults' scenes, sound and with the fault planted,
one JSON line each, the moving ball's middle, and each later fault's own
check's reading, sound and planted.
"""

import contextlib
import inspect
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import test_torch_adaptive as adaptive_tests  # noqa: E402
import test_torch_media as media  # noqa: E402
import test_torch_noise as noise_tests  # noqa: E402
import test_torch_packet as packet_tests  # noqa: E402
import test_torch_parallel as parallel_tests  # noqa: E402
import test_torch_qmc as qmc_tests  # noqa: E402
import test_torch_render_media as render_media  # noqa: E402
import test_torch_sampling as sampling_tests  # noqa: E402
import test_torch_stream as stream_tests  # noqa: E402
import test_torch_stream_probe as probe_tests  # noqa: E402
import test_torch_stream_walk as walk_tests  # noqa: E402
import test_torch_tree_walk as tree_tests  # noqa: E402

from cudaraytracer_tpu_torch.ops import noise as tnoise  # noqa: E402
from cudaraytracer_tpu_torch.ops import sampling as tsampling  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import stream_probe as sp  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.parallel import tiling  # noqa: E402
from cudaraytracer_tpu_torch.scripts import planted_faults as card_faults  # noqa: E402


def edited(mod, old: str, new: str):
    """A copy of module ``mod`` with the one occurrence of ``old`` in its
    source replaced by ``new``."""
    src = inspect.getsource(mod)
    assert src.count(old) == 1, old
    copy = types.ModuleType(mod.__name__ + "_planted")
    copy.__package__ = mod.__package__
    sys.modules[copy.__name__] = copy  # dataclasses look their module up
    exec(compile(src.replace(old, new), mod.__file__, "exec"), copy.__dict__)
    return copy


# name -> (module, the function replaced by its edited copy, text,
#          replacement, the check that must fail, the scenes of the
#          radiance check whose readings the script prints)
FAULTS = {
    # the medium uniform decorrelated by the column, not by the centre
    "medium_u_by_column": (
        hk, "_medium_tests",
        "uj = u_med + (cx * 0.7548777 + cy * 0.5698403 + cz * 0.3287281)",
        "uj = u_med + torch.arange(cx.shape[-1], dtype=cx.dtype) * 0.618034",
        lambda: media.test_medium_chord_and_scatter_distance_match_oracle(
            "sphere"), ("smoke", "cornell_smoke")),
    # the shutter time drawn anew at every bounce, not once per path
    "time_every_bounce": (
        rk, "render_sample_plain",
        "        time = shutter[ia] if has_motion else None\n",
        "        if has_motion:\n"
        "            shutter[ia] = rng.uniform(pk_all[ia], it, rng.SLOT_TIME)\n"
        "        time = shutter[ia] if has_motion else None\n",
        render_media.test_moving_ball_keeps_its_shutter_time_across_bounces,
        ("bounce",)),
    # a yawed box medium rotated the other way
    "yaw_sine_flipped": (
        hk, "_medium_tests", "cyr, syr = S[S_DN], S[S_D1]",
        "cyr, syr = S[S_DN], -S[S_D1]",
        lambda: media.test_medium_chord_and_scatter_distance_match_oracle(
            "rotated_box"), ("cornell_smoke",)),
    # six turbulence octaves instead of seven
    "six_octaves": (
        tnoise, "turbulence", "octaves: int = TURB_OCTAVES",
        "octaves: int = TURB_OCTAVES - 1",
        lambda: noise_tests.test_marble_factor_matches_jax(np), ("marble",)),
    # a medium hit (packed as mat 0) scatters as a lambertian surface
    "isotropic_as_lambertian": (
        rk, "render_sample_plain", "is_iso = ((packc >> 4) & 7) == 5",
        "is_iso = torch.zeros_like(packc, dtype=torch.bool)",
        lambda: render_media.test_scene_matches_xla_path("cornell_smoke"),
        ("smoke", "cornell_smoke")),
    # the light pdf summed over the tabled lights, not averaged
    "pdf_not_averaged": (
        tsampling, "lights_pdf",
        "    return lsum / torch.clamp(tab[0], min=1.0)", "    return lsum",
        lambda: sampling_tests.test_mixture_integrates_the_cosine_lobe_to_one(
            "rects_sphere", 0.5), ()),
    # the cosine density without its 1/pi
    "cosine_pdf_without_inv_pi": (
        tsampling, "nee_lambertian",
        "scat = torch.clamp(cosd, min=0.0) * _INV_PI",
        "scat = torch.clamp(cosd, min=0.0)",
        lambda: sampling_tests.test_mixture_integrates_the_cosine_lobe_to_one(
            "rects_sphere", 0.5), ()),
    # the QMC rotation's x and y channels swapped
    "qmc_rotation_swapped": (
        rk, "render_sample_plain",
        "qrx, qry = qmc.pixel_rotation(xs_all, ys_all)",
        "qry, qrx = qmc.pixel_rotation(xs_all, ys_all)",
        lambda: qmc_tests.test_sky_matches_xla_renderer(0), ()),
    # the launch's sample base ignored: every launch restarts the sequence
    "sample_base_ignored": (
        rk, "render_sample_plain",
        "fx, fy = qmc.r2_frac(sample_base + done[ib])",
        "fx, fy = qmc.r2_frac(done[ib])",
        lambda: qmc_tests.test_sky_matches_xla_renderer(5), ()),
    # the tile mask indexed by (x, y) transposed
    "mask_transposed": (
        rk, "render_sample_plain",
        "act = tile_mask[(pix // width // th) * gj + (pix % width) // tw] != 0",
        "act = tile_mask[((pix % width) // tw) * gi + pix // width // th] != 0",
        adaptive_tests.test_masked_launch_equals_unmasked_on_active_tiles,
        ()),
    # the pixel key from the band's row, not the image's
    "band_key_without_y0": (
        rk, "render_sample_plain",
        "pk_all = rng.pixel_keys(key, pix + y0 * width)",
        "pk_all = rng.pixel_keys(key, pix)",
        lambda: parallel_tests.test_bands_stitch_bit_for_bit(
            parallel_tests.book2_frame(), 4), ()),
    # two sample streams of a band drawing the same generator stream
    "stream_shared": (
        tiling, "band_launches", "stream=ri * n_samp + si,",
        "stream=ri * n_samp,",
        lambda: parallel_tests.test_sharded_frame_is_the_sum_of_its_launches(
            parallel_tests.book2_frame()), ()),
    # streamrows' wait covering the first row only
    "streamrows_first_row_only": (
        sp, "stream_probe_plain", "waited = rows", "waited = 1",
        lambda: probe_tests.test_plain_probe_equals_the_jax_kernels(
            4, "streamrows", 9), ()),
    # the streamed payload read from the wrong page of its tile
    "stream_page_offset": (
        ttab, "tile_columns", "page_col = (si % block_b) * 128 + j % span",
        "page_col = (si % block_b) * span + j % span",
        stream_tests.test_tile_columns_read_the_resident_columns, ()),
    # the streamed walk's candidate sweep dropping the first block of
    # every bitmask word
    "stream_candidate_bit_dropped": (
        hk, "stream_sweep", "            if rb.numel():\n                cand",
        "            if rb.numel() and b % 32:\n                cand",
        lambda: walk_tests.test_streamed_walk_equals_resident_walks(
            "book2_final", 16), ()),
    # a page's columns read from the wrong offset in its block's tile
    "stream_page_wrong_offset": (
        hk, "streamed_closest", "l0 = s * 128 + c * cluster",
        "l0 = s * span + c * cluster",
        lambda: walk_tests.test_streamed_walk_equals_resident_walks(
            "terrain_big", 16), ()),
    # every group box shrunk by one ulp on its low side
    "stream_group_box_shrunk": (
        ttab, "group_boxes",
        "    return block_boxes(boxes, n_used, -(-int(n_blocks) // group_g), "
        "group_g)",
        "    g = block_boxes(boxes, n_used, -(-int(n_blocks) // group_g), "
        "group_g)\n"
        "    g[0:3] = np.nextafter(g[0:3], np.float32(BIG))\n    return g",
        lambda: walk_tests.test_group_boxes_are_the_union_of_their_blocks(
            "terrain_big", 16), ()),
    # the packet interval rounded inward: tnear up, tfar down
    "packet_rounded_wrong_way": (
        hk, "packet_pass",
        "        tnk = _mul_directed(nn, torch.where(nn >= 0.0, ivlo, ivhi), "
        "False)\n"
        "        tfk = _mul_directed(ff, torch.where(ff >= 0.0, ivhi, ivlo), "
        "True)",
        "        tnk = _mul_directed(nn, torch.where(nn >= 0.0, ivlo, ivhi), "
        "True)\n"
        "        tfk = _mul_directed(ff, torch.where(ff >= 0.0, ivhi, ivlo), "
        "False)",
        lambda: packet_tests.test_packet_test_passes_every_box_a_ray_enters(
            "corners"), ()),
    # the packet's tfar one ulp short
    "packet_shrunk_one_ulp": (
        hk, "packet_pass", "tf = torch.where(cull, torch.fmin(tf, tfk), tf)",
        "tf = torch.where(cull, torch.fmin(tf, _next_down(tfk)), tf)",
        lambda: packet_tests.test_packet_test_passes_every_box_a_ray_enters(
            "corners"), ()),
    # an axis whose rays' directions differ in sign culled on
    "packet_mixed_sign_culled": (
        hk, "make_packets",
        'red["cull"] = (bad == 0) & ((red["ivlo"] > 0.0) | (red["ivhi"] < '
        '0.0))',
        'red["cull"] = bad == 0',
        lambda: packet_tests.test_packet_test_passes_every_box_a_ray_enters(
            "one_mixed_axis"), ()),
    # the first candidate block of every 32 dropped
    "packet_candidate_bit_dropped": (
        hk, "_packet_walk", "for k in range(cb.shape[1]):",
        "for k in range(1, cb.shape[1]):",
        lambda: packet_tests.
        test_packet_walks_equal_two_level_walk_and_brute_force(
            "terrain_big"), ()),
    # the last block never walked
    "packet_block_skipped": (
        hk, "_packet_walk", "n_b = min(32, nb - b0)",
        "n_b = min(32, nb - b0 - 1)",
        lambda: packet_tests.
        test_packet_walks_equal_two_level_walk_and_brute_force(
            "book2_final"), ()),
    # the tree's leaf boxes not padded
    "tree_leaf_unpadded": (
        ttab, "tree_nodes", "margin = f32(TREE_MARGIN * scale)",
        "margin = f32(0.0)",
        lambda: tree_tests.test_tree_walk_equals_two_level(
            "rtow_final", "grazing"), ()),
    # a missed node's skip one node too far
    "tree_skip_one_past": (
        hk, "tree_walk", "at[r[~inside]] = v >> 1",
        "at[r[~inside]] = (v >> 1) + 1",
        lambda: tree_tests.test_tree_walk_equals_two_level(
            "terrain", "inside"), ()),
}

# the later faults' checks as readings (name, function)
READINGS = {
    "pdf_not_averaged": ("cosine-lobe integral (1 +- 0.01)",
                         lambda: sampling_tests.lobe_integral(
                             "rects_sphere", 0.5)),
    "cosine_pdf_without_inv_pi": ("cosine-lobe integral (1 +- 0.01)",
                                  lambda: sampling_tests.lobe_integral(
                                      "rects_sphere", 0.5)),
    "qmc_rotation_swapped": ("sky max abs error (< 1e-4)",
                             lambda: qmc_tests.sky_error(0)),
    "sample_base_ignored": ("sky max abs error at base 5 (< 1e-4)",
                            lambda: qmc_tests.sky_error(5)),
    "mask_transposed": ("masked-launch pixels wrong (0)",
                        adaptive_tests.masked_mismatch),
    "band_key_without_y0": ("band seam pixels wrong (0)",
                            parallel_tests.band_mismatch),
    "stream_shared": ("sharded pixels off its launches' sum (0)",
                      parallel_tests.shard_mismatch),
    "stream_page_offset": (
        "terrain payload columns off the resident P at block_b 4 (0)",
        stream_tests.payload_mismatch),
    "stream_candidate_bit_dropped": (
        "book2_final rays off the brute-force hit (0)",
        lambda: walk_tests.walk_mismatch("book2_final")),
    "stream_page_wrong_offset": (
        "terrain_big rays off the brute-force hit (0)",
        lambda: walk_tests.walk_mismatch("terrain_big")),
    "stream_group_box_shrunk": (
        "terrain_big group boxes off their blocks' union (0)",
        lambda: walk_tests.group_box_mismatch("terrain_big")),
    "streamrows_first_row_only": (
        "streamrows sum at 9 tiles of 4 x 64 (expected)",
        lambda: [int(sp.stream_probe(sp.probe_table(9, 64, 4),
                                     "streamrows")[0]),
                 sp.expected(9, 64, 4)]),
}


@contextlib.contextmanager
def planted(name):
    """Fault ``name`` planted for the duration of the block."""
    mod, fn, old, new = FAULTS[name][:4]
    sound = getattr(mod, fn)
    setattr(mod, fn, getattr(edited(mod, old, new), fn))
    try:
        yield
    finally:
        setattr(mod, fn, sound)


@pytest.mark.parametrize("name", list(card_faults.FAULTS))
def test_card_fault_edits_one_place(name):
    """Each fault scripts/planted_faults.py plants in a copy of the
    package replaces text found exactly once in its file, so the copy it
    builds on the card holds that fault and no other edit."""
    for rel, old, _ in card_faults.FAULTS[name][0]:
        assert (card_faults.PKG / rel).read_text().count(old) == 1, rel


@pytest.mark.parametrize("name", list(FAULTS))
def test_planted_fault_fails_its_check(name):
    """The check passes on the sound code (it is a test of its own) and
    fails with the fault planted."""
    check = FAULTS[name][4]
    with planted(name), pytest.raises(AssertionError):
        check()


def radiance_readings(ours, ref) -> dict:
    err = render_media.block_errors(ours, ref)
    return {"channel": float(np.abs(ours.mean((0, 1))
                                    - ref.mean((0, 1))).max()),
            "block_mean": float(err.mean()), "block_max": float(err.max())}


if __name__ == "__main__":
    import json

    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({"limits": {"channel": render_media.CHAN_ATOL,
                                 "block_mean": render_media.BLOCK_MEAN,
                                 "block_max": render_media.BLOCK_MAX}}))
    for name, (*_, scenes) in FAULTS.items():
        if name in READINGS:
            what, reading = READINGS[name]
            row = {"fault": name, "check": what, "sound": reading()}
            with planted(name):
                row["planted"] = reading()
            print(json.dumps(row), flush=True)
        for scene in scenes:
            row = {"fault": name, "scene": scene,
                   "sound": radiance_readings(
                       *render_media.xla_path_renders(scene))}
            with planted(name):
                row["planted"] = radiance_readings(
                    *render_media.xla_path_renders(scene))
            print(json.dumps(row), flush=True)
    # the moving ball's middle (ours, the XLA renderer's)
    row = {"fault": "time_every_bounce", "scene": "moving_ball",
           "sound": render_media.moving_ball_middles()}
    with planted("time_every_bounce"):
        row["planted"] = render_media.moving_ball_middles()
    print(json.dumps(row), flush=True)
