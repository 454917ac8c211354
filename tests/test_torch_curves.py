"""Port parity for the swept-sphere curves:
tpu_pt_torch.intersect.curves against tpu_pt.intersect.curves on the same
numpy rays and segments.

Tolerances: the power-basis tables are equal (the same numpy operations);
hit / miss equal except on rays grazing a silhouette, where the cone
quadratic's discriminant changes sign with the rounding (at most 0.2% of
rays); winning segment equal except on ties between
neighbouring pieces (at most 1% of rays, each then a hit at the same t);
t to 1e-4 relative (the rounded-cone quadratic cancels catastrophically
for rays that start ~1,000 units away, and XLA fuses it differently: up to
0.075 units here); normals to 2e-2 where the segments agree (the hit point
moves by that |dt| on strands of radius 6 to 18, and the normal with it:
0.009 measured); the curve parameter u to 1e-2 for the same reason (0.0044
measured), a single cone's axis parameter to 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt.intersect import curves as jcurves  # noqa: E402
from tpu_pt.vec3 import V3  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import curves, get_intersectors  # noqa: E402
from test_torch_intersect import _rays, _t  # noqa: E402

STRANDS = [
    dict(basis="cubic_bspline", points=[[120, 40, 120], [160, 200, 180],
                                        [260, 340, 240], [380, 200, 300],
                                        [440, 60, 360], [460, 30, 380]],
         radii=[18, 16, 14, 12, 10, 9]),
    dict(basis="catmullrom", points=[[420, 20, 120], [400, 150, 140],
                                     [430, 290, 170], [380, 420, 200]],
         radii=[14, 12, 9, 6]),
    dict(basis="linear", points=[[100, 548, 300], [140, 420, 290],
                                 [110, 300, 280]], radii=8),
    dict(basis="quadratic_bspline", points=[[250, 30, 400], [300, 120, 420],
                                            [350, 30, 440], [400, 120, 460]],
         radii=[12, 12, 12, 12]),
]
MAT_BSDF = np.array([0, 1, 2, 0], np.int32)     # material 2 refracts
T_RTOL, N_ATOL, U_ATOL, S_ATOL = 1e-4, 2e-2, 1e-2, 1e-3


def _segments(mod):
    segs = []
    for m, spec in enumerate(STRANDS):
        segs.extend(mod.expand_curve_spec(spec, m))
    return segs


@pytest.fixture(scope="module")
def both():
    return (jcurves.make_curves(_segments(jcurves), mat_bsdf=MAT_BSDF),
            curves.make_curves(_segments(curves), mat_bsdf=MAT_BSDF))


@pytest.fixture(scope="module")
def rays(mixed_scene):
    """Camera rays aimed near the strands' control points, and bounce
    rays."""
    o, d, p, ld, tmax = _rays(mixed_scene, 1024, seed=41)
    r = np.random.default_rng(42)
    pts = np.concatenate([np.asarray(s["points"], np.float32)
                          for s in STRANDS])
    aim = pts[r.integers(0, len(pts), 1024)] + r.normal(size=(1024, 3)) * 12
    d[:1024] = aim - o[:1024]
    d[:1024] /= np.linalg.norm(d[:1024], axis=1, keepdims=True)
    return o, d.astype(np.float32)


def test_make_curves_matches_reference(both):
    ref, ours = both
    assert ours.count == ref.count == 8
    for k in ("k0", "k1", "k2", "k3", "mat"):
        a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert ours.occludes == ref.occludes
    assert ours.occludes == (True,) * 4 + (False,) * 2 + (True,) * 2
    for a, b in zip(_segments(curves), _segments(jcurves)):
        assert a["kind"] == b["kind"] and a["mat"] == b["mat"]
        np.testing.assert_array_equal(a["points"], b["points"])
        np.testing.assert_array_equal(a["radii"], b["radii"])
    with pytest.raises(ValueError, match="basis"):
        curves.expand_curve_spec(dict(basis="bezier", points=[[0, 0, 0]]), 0)
    with pytest.raises(ValueError, match="points"):
        curves.expand_curve_spec(dict(points=[[0, 0, 0]] * 3), 0)
    with pytest.raises(ValueError, match="radii"):
        curves.expand_curve_spec(dict(points=[[0, 0, 0]] * 4, radii=[1, 2]),
                                 0)


def test_rounded_cone_matches_reference(rays):
    o, d = rays
    pa = np.array([160, 200, 180], np.float32)
    pb = np.array([260, 340, 240], np.float32)
    jt, js = jcurves._rounded_cone_t(
        V3(*(jnp.asarray(o[:, k]) for k in range(3))),
        V3(*(jnp.asarray(d[:, k]) for k in range(3))), pa, pb,
        jnp.float32(40.0), jnp.float32(25.0), 0.01, 1e16)
    t, s = curves._rounded_cone_t(_t(o), _t(d), _t(pa), _t(pb),
                                  torch.tensor(40.0), torch.tensor(25.0),
                                  0.01, 1e16)
    hit = np.asarray(jt) < 1e15
    assert 0.02 < hit.mean() < 0.9
    np.testing.assert_array_equal((t < 1e15).numpy(), hit)
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jt)[hit],
                               rtol=T_RTOL)
    np.testing.assert_allclose(s.numpy()[hit], np.asarray(js)[hit],
                               atol=S_ATOL)


def test_intersect_curves_matches_reference(both, rays):
    ref, ours = both
    o, d = rays
    j = jcurves.intersect_curves(ref, jnp.asarray(o), jnp.asarray(d),
                                 index_offset=700)
    h = curves.intersect_curves(ours, _t(o), _t(d), index_offset=700)
    hit = np.asarray(j.hit)
    assert 0.05 < hit.mean() < 0.9
    assert (h.hit.numpy() != hit).mean() <= 0.002
    hit = hit & h.hit.numpy()
    np.testing.assert_allclose(h.t.numpy()[hit], np.asarray(j.t)[hit],
                               rtol=T_RTOL)
    same = hit & (h.tri.numpy() == np.asarray(j.tri))
    assert (hit & ~same).mean() <= 0.01
    assert set(np.unique(h.tri.numpy()[hit])) <= set(range(700, 708))
    assert len(np.unique(h.tri.numpy()[hit])) >= 6
    np.testing.assert_array_equal(h.mat.numpy()[same],
                                  np.asarray(j.mat)[same])
    np.testing.assert_allclose(h.normal.numpy()[same],
                               np.asarray(j.normal.to_array())[same],
                               atol=N_ATOL)
    np.testing.assert_allclose(h.u.numpy()[same], np.asarray(j.u)[same],
                               atol=U_ATOL)
    n = h.normal.numpy()[hit]
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-4)
    assert not h.normal.numpy()[~h.hit.numpy()].any() and not h.v.any()


def test_occluded_curves_matches_reference(both):
    ref, ours = both
    r = np.random.default_rng(43)
    a = r.uniform(50, 500, (2048, 3)).astype(np.float32)
    b = r.uniform(50, 500, (2048, 3)).astype(np.float32)
    dist = np.linalg.norm(b - a, axis=1)
    sd = ((b - a) / dist[:, None]).astype(np.float32)
    tm = (dist - 0.01).astype(np.float32)
    tm[:8] = 0.0
    occ = curves.occluded_curves(ours, _t(a), _t(sd), _t(tm))
    jocc = np.asarray(jcurves.occluded_curves(
        ref, jnp.asarray(a), jnp.asarray(sd), jnp.asarray(tm)))
    assert (occ.numpy() != jocc).mean() <= 0.002    # grazing segments
    assert 0.02 < jocc.mean() < 0.9 and not occ[:8].any()
    # Refractive segments pass light.
    glass = curves.make_curves(_segments(curves)[4:6], mat_bsdf=MAT_BSDF)
    assert glass.occludes == (False, False)
    assert not curves.occluded_curves(glass, _t(a), _t(sd), _t(tm)).any()


def test_get_intersectors_binds_curves(assets_dir, rays):
    """Curve ids lie past the padded triangles (the scene has no
    primitives); hits and flags agree with the JAX package's."""
    path = str(assets_dir / "cornell_curves.json")
    scene, jscene = tp.load_scene(path, device="cpu"), tpu_pt.load_scene(path)
    assert scene.curves.count == 8 and scene.prims is None
    o, d = rays
    cfg = dict(width=8, height=8, spp=1, intersector="bruteforce")
    closest, occluded = get_intersectors(scene, tp.RenderConfig(**cfg))
    jclosest, joccluded = tpu_pt.intersect.get_intersectors(
        jscene, tpu_pt.RenderConfig(**cfg))
    h, j = closest(_t(o), _t(d)), jclosest(jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(j.hit))
    differ = h.tri.numpy() != np.asarray(j.tri)
    assert differ.mean() <= 0.01
    np.testing.assert_allclose(h.t.numpy()[~differ], np.asarray(j.t)[~differ],
                               rtol=T_RTOL)
    n_pad = scene.num_tris_padded
    assert (h.tri.numpy() >= n_pad).mean() > 0.05 and h.tri.max() < n_pad + 8
    tmax = torch.full((o.shape[0],), 400.0)
    occ = occluded(_t(o), _t(d), tmax)
    jocc = np.asarray(joccluded(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tmax.numpy())))
    assert (occ.numpy() != jocc).mean() <= 0.002
