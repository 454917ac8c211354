"""Port parity for the analytic primitives:
tpu_pt_torch.intersect.primitives against tpu_pt.intersect.primitives on
the same numpy rays and primitives.

Tolerances: hit / miss, winning primitive id and material equal; t to
2e-5 relative (the quadratic's square root and the parallelogram's
normalisation round differently under XLA); normals to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt.intersect import primitives as jprims  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import (get_fused_closest_nee,  # noqa: E402
                                    get_intersectors, primitives)
from test_torch_intersect import _rays, _t  # noqa: E402

SPECS = [
    dict(kind=primitives.PRIM_SPHERE_SHELL, mat=2, center=[190, 320, 169],
         radius1=55.0, radius2=65.0),
    dict(kind=primitives.PRIM_SPHERE, mat=1, center=[400, 90, 120],
         radius=60.0),
    dict(kind=primitives.PRIM_PARALLELOGRAM, mat=0, anchor=[120, 230, 420],
         v1=[130.0, 0.0, -40.0], v2=[0.0, 110.0, 0.0]),
]
MAT_BSDF = np.array([0, 1, 2], np.int32)       # material 2 refracts
T_RTOL, N_ATOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def rays(mixed_scene):
    o, d, p, ld, tmax = _rays(mixed_scene, 1024, seed=31)
    # Aim half of the camera rays at the primitives.
    r = np.random.default_rng(32)
    targets = np.array([[190, 320, 169], [400, 90, 120], [185, 285, 400]],
                       np.float32)
    aim = targets[r.integers(0, 3, 512)] + r.normal(size=(512, 3)) * 30
    d[:512] = aim - o[:512]
    d[:512] /= np.linalg.norm(d[:512], axis=1, keepdims=True)
    return o, d.astype(np.float32), p, ld, tmax


@pytest.fixture(scope="module")
def both():
    return (jprims.make_primitives(SPECS, mat_bsdf=MAT_BSDF),
            primitives.make_primitives(SPECS, mat_bsdf=MAT_BSDF))


def test_make_primitives_matches_reference(both):
    ref, ours = both
    assert ours.kind == ref.kind and ours.occludes == ref.occludes
    assert ours.occludes == (False, True, True) and ours.count == 3
    np.testing.assert_array_equal(ours.params.numpy(), np.asarray(ref.params))
    np.testing.assert_array_equal(ours.mat.numpy(), np.asarray(ref.mat))
    assert primitives.make_primitives(SPECS).occludes == (True,) * 3
    with pytest.raises(ValueError):
        primitives.make_primitives([dict(kind=7)])


@pytest.mark.parametrize("index", [0, 1, 2])
def test_each_primitive_matches_reference(both, rays, index):
    """t and normal of every ray against one primitive."""
    ref, ours = both
    o, d = rays[0], rays[1]
    one_ref = jprims.make_primitives([SPECS[index]])
    one = primitives.make_primitives([SPECS[index]])
    j = jprims.intersect_primitives(one_ref, jnp.asarray(o), jnp.asarray(d))
    t, n = primitives._prim_t(one, 0, _t(o), _t(d), 0.01, 1e16)
    hit = np.asarray(j.hit)
    assert 0.02 < hit.mean() < 0.9
    np.testing.assert_array_equal((t < 1e15).numpy(), hit)
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(j.t)[hit],
                               rtol=T_RTOL)
    np.testing.assert_allclose(n.numpy()[hit],
                               np.asarray(j.normal.to_array())[hit],
                               atol=N_ATOL)


def test_intersect_and_occluded_match_reference(both, rays):
    ref, ours = both
    o, d, p, ld, tmax = rays
    j = jprims.intersect_primitives(ref, jnp.asarray(o), jnp.asarray(d),
                                    index_offset=512)
    h = primitives.intersect_primitives(ours, _t(o), _t(d), index_offset=512)
    hit = np.asarray(j.hit)
    np.testing.assert_array_equal(h.hit.numpy(), hit)
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(j.tri))
    np.testing.assert_array_equal(h.mat.numpy(), np.asarray(j.mat))
    assert set(np.unique(h.tri.numpy()[hit])) == {512, 513, 514}
    np.testing.assert_allclose(h.t.numpy(), np.asarray(j.t), rtol=T_RTOL)
    np.testing.assert_allclose(h.normal.numpy(),
                               np.asarray(j.normal.to_array()), atol=N_ATOL)
    assert not h.u.any() and not h.v.any()
    # Shadow rays across the box; the refractive shell passes light.
    r = np.random.default_rng(33)
    a = r.uniform(50, 500, (1024, 3)).astype(np.float32)
    b = r.uniform(50, 500, (1024, 3)).astype(np.float32)
    dist = np.linalg.norm(b - a, axis=1)
    sd = ((b - a) / dist[:, None]).astype(np.float32)
    tm = (dist - 0.01).astype(np.float32)
    occ = primitives.occluded_primitives(ours, _t(a), _t(sd), _t(tm))
    jocc = jprims.occluded_primitives(ref, jnp.asarray(a), jnp.asarray(sd),
                                      jnp.asarray(tm))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert 0.02 < occ.float().mean() < 0.9
    shell_only = primitives.make_primitives(SPECS[:1], mat_bsdf=MAT_BSDF)
    assert not primitives.occluded_primitives(shell_only, _t(a), _t(sd),
                                              _t(tm)).any()


def test_combine_hits_matches_reference(both, rays, mixed_scene, assets_dir):
    """Min-t combination of a triangle hit and a primitive hit."""
    ref, ours = both
    o, d = rays[0], rays[1]
    tscene = tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"),
                           device="cpu")
    jtri = tpu_pt.intersect.intersect_closest(mixed_scene, jnp.asarray(o),
                                              jnp.asarray(d))
    ttri = tp.intersect.intersect_closest(tscene, _t(o), _t(d))
    j = jprims.combine_hits(jtri, jprims.intersect_primitives(
        ref, jnp.asarray(o), jnp.asarray(d), index_offset=512))
    h = primitives.combine_hits(ttri, primitives.intersect_primitives(
        ours, _t(o), _t(d), index_offset=512))
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(j.hit))
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(j.tri))
    np.testing.assert_array_equal(h.mat.numpy(), np.asarray(j.mat))
    np.testing.assert_allclose(h.t.numpy(), np.asarray(j.t), rtol=T_RTOL)
    assert (h.tri.numpy() >= 512).mean() > 0.1


@pytest.mark.parametrize("backend", ["bruteforce", "dense", "bvh"])
def test_get_intersectors_binds_primitives(assets_dir, rays, backend):
    """Whichever backend the scene takes, its primitives join by min-t with
    ids past the padded triangles; the fused kernels step aside."""
    scene = tp.load_scene(str(assets_dir / "cornell_prims.json"),
                          device="cpu")
    jscene = tpu_pt.load_scene(str(assets_dir / "cornell_prims.json"))
    o, d, p, ld, tmax = rays
    cfg = tp.RenderConfig(width=8, height=8, spp=1, intersector=backend,
                          fused_nee=True, use_direct_lighting=True)
    assert get_fused_closest_nee(scene, cfg) is None
    closest, occluded = get_intersectors(scene, cfg, want_uv=False)
    jcfg = tpu_pt.RenderConfig(width=8, height=8, spp=1,
                               intersector="bruteforce")
    jclosest, joccluded = tpu_pt.intersect.get_intersectors(jscene, jcfg)
    h, j = closest(_t(o), _t(d)), jclosest(jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(j.hit))
    differ = h.tri.numpy() != np.asarray(j.tri)
    assert differ.mean() <= 0.01           # ties between coplanar triangles
    np.testing.assert_allclose(h.t.numpy(), np.asarray(j.t), rtol=T_RTOL)
    n_pad = scene.num_tris_padded
    assert (h.tri.numpy() >= n_pad).any() and h.tri.max() < n_pad + 3
    occ = occluded(_t(p), _t(ld), _t(tmax))
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(joccluded(jnp.asarray(p), jnp.asarray(ld),
                                          jnp.asarray(tmax))))
