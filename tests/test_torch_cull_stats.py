"""The megakernel's cull statistic (``render_sample(with_cull_stats=
True)``) on the CPU, in its plain version.

The port culls per ray, so its statistic is the number of (ray, cluster)
entries: for every ray traced, the clusters whose box it entered (JAX's
``with_cull_stats`` counted, per tile wave, the clusters whose primitive
loop ran for any lane).  Counting must not change the image; the count
is positive and at most (rays x clusters); and it equals a replay of the
culled search (``hit_kernel.search_work``) over the rays the launch
traced, here rebuilt from the generator at depth 1, where every
iteration traces one fresh primary ray per pixel.  On the card the
kernel's count must equal this plain count (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.utils import rng  # noqa: E402

W, H = 24, 16


def frame(name, nee=False):
    scene, cam = tscenes.SCENES[name][0](), tscenes.SCENES[name][1]()
    tb, kw = ttab.kernel_inputs(scene, "cpu")
    if nee:
        kw.update(ttab.nee_inputs(scene, "cpu"))
    kw.update(width=W, height=H, camera_model=tscenes.camera_model_for(name),
              rr_start=2, cluster=tb.cluster, super_=tb.super_)
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, W, H, 1e-3))
    return (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv), kw, tb


@pytest.mark.parametrize("name, nee", [
    ("rtow_final", False), ("default", True), ("cornell_mesh_light", True),
    ("terrain", False), ("smoke", True), ("bounce", False),
    ("book2_final", True)])
def test_cull_stats_leave_the_image_unchanged(name, nee):
    a, kw, tb = frame(name, nee)
    img = rk.render_sample(*a, 7, 6, spp=2, **kw)
    img2, rays, cull = rk.render_sample(*a, 7, 6, spp=2, with_stats=True,
                                        with_cull_stats=True, **kw)
    assert torch.equal(img, img2)
    img3, cull3 = rk.render_sample(*a, 7, 6, spp=2, with_cull_stats=True,
                                   **kw)
    assert torch.equal(img, img3) and int(cull3) == int(cull)
    assert cull.dtype == torch.int64 and cull.dim() == 0
    n_clusters = int(tb.n_super) * tb.super_
    assert 0 < int(cull) <= int(rays) * n_clusters \
        <= 2 * 6 * n_clusters * W * H


@pytest.mark.parametrize("name", ["rtow_final", "cornell_mesh_light",
                                  "terrain", "book2_final"])
def test_cull_count_equals_a_replay_of_the_search(name):
    """Depth 1, 3 spp: iteration ``it`` traces the primary ray of every
    pixel's sample ``it`` (thin-lens draws from the same slots); their
    search's entries, replayed by ``search_work``, are the count.
    book2_final's fog and moving sphere take the medium uniform and the
    shutter time of the same slots."""
    a, kw, tb = frame(name)
    spp = 3
    _, cull = rk.render_sample(*a, 7, 1, spp=spp, with_cull_stats=True, **kw)
    cam = [float(v) for v in a[5]]
    pix = torch.arange(W * H)
    pk = rng.pixel_keys(rng.key_for(7, 0), pix)
    xs, ys = (pix % W).float(), (pix // W).float()
    flags = {k: kw[k] for k in ("has_rects", "has_tris", "has_media",
                                "has_boxm", "has_rotm")}
    want = 0
    for it in range(spp):
        lx, ly = rng.unit_disk(rng.uniform(pk, it, rng.SLOT_LENS_R),
                               rng.uniform(pk, it, rng.SLOT_LENS_TH), cam[18])
        ray = rk.primary_rays(cam, xs, ys, rng.uniform(pk, it, rng.SLOT_JX),
                              rng.uniform(pk, it, rng.SLOT_JY), lx, ly, W, H,
                              kw["camera_model"])
        u_med = rng.uniform(pk, it, rng.SLOT_MED) if kw["has_media"] \
            else None
        time = rng.uniform(pk, it, rng.SLOT_TIME) if kw["has_motion"] \
            else None
        want += hk.search_work(
            tb.S, tb.clusters, tb.supers, tb.n_super,
            torch.stack(ray[:3], 1).contiguous(),
            torch.stack(ray[3:], 1).contiguous(), cam[28], u_med=u_med,
            time=time, cluster=tb.cluster, super_=tb.super_,
            **flags)["entered"]
    assert int(cull) == want > 0
