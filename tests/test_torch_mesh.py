"""The port's mesh utilities (cudaraytracer_tpu_torch/utils/mesh.py)
against the JAX package's: the procedural generators, the transform, the
vertex normals and the OBJ writer and reader in all four face forms must
give exactly the same arrays (both are the same NumPy code)."""

import numpy as np
import pytest

from cudaraytracer_tpu.utils import mesh as jmesh

from cudaraytracer_tpu_torch.utils import mesh as tmesh


def assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,args", [
    ("icosphere", (0,)), ("icosphere", (2,)), ("torus", ()),
    ("torus", (0.9, 0.32, 20, 10)), ("box", ()), ("box", ((1.0, 1.6, 0.25),)),
])
def test_generators_match_jax(name, args):
    assert_same(getattr(tmesh, name)(*args), getattr(jmesh, name)(*args))


def test_transformed_rot_y_and_vertex_normals_match_jax():
    v, f = jmesh.torus(0.9, 0.32, segments=20, sides=10)
    for kw in ({}, dict(scale=0.85, translate=(-1.6, 0.35, -2.2)),
               dict(rotate_y=0.6, translate=(1.4, 0.0, -2.6))):
        assert_same(tmesh.transformed(v, **kw), jmesh.transformed(v, **kw))
    assert_same(tmesh.rot_y(-0.4), jmesh.rot_y(-0.4))
    assert_same(tmesh.vertex_normals(v, f), jmesh.vertex_normals(v, f))


def _attrs(form, v, f):
    """(uvs, normals) of one OBJ face form: v, v/vt, v//vn, v/vt/vn."""
    rs = np.random.RandomState(3)
    uvs = rs.uniform(0, 1, (len(v), 2)).astype(np.float32)
    nrm = jmesh.vertex_normals(v, f)
    return {"v": (None, None), "v/vt": (uvs, None), "v//vn": (None, nrm),
            "v/vt/vn": (uvs, nrm)}[form]


@pytest.mark.parametrize("form", ["v", "v/vt", "v//vn", "v/vt/vn"])
def test_obj_round_trip_matches_jax(tmp_path, form):
    """save_obj of the port writes the file the JAX package writes, and
    load_obj_full / load_obj of both read it into the same arrays."""
    v, f = jmesh.icosphere(1)
    uvs, nrm = _attrs(form, v, f)
    ours, ref = tmp_path / "ours.obj", tmp_path / "ref.obj"
    tmesh.save_obj(str(ours), v, f, uvs=uvs, normals=nrm)
    jmesh.save_obj(str(ref), v, f, uvs=uvs, normals=nrm)
    assert ours.read_text() == ref.read_text()
    first_face = next(ln for ln in ours.read_text().splitlines()
                      if ln.startswith("f "))
    tok = first_face.split()[1]
    assert tok.count("/") == form.count("/") and ("//" in tok) == ("//" in form)
    m_t, m_j = tmesh.load_obj_full(str(ours)), jmesh.load_obj_full(str(ours))
    assert isinstance(m_t, tmesh.MeshData)
    for field in ("vertices", "faces", "uvs", "uv_faces", "normals",
                  "normal_faces"):
        a, b = getattr(m_t, field), getattr(m_j, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert_same(a, b)
    assert (m_t.uvs is not None) == (uvs is not None)
    assert (m_t.normals is not None) == (nrm is not None)
    assert sorted(m_t.attrs()) == sorted(m_j.attrs())
    assert_same(tmesh.load_obj(str(ours)), jmesh.load_obj(str(ours)))
    np.testing.assert_allclose(m_t.vertices, v, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(m_t.faces, f)
