"""Port parity: vector math, BSDFs, camera and film of tpu_pt_torch against
tpu_pt on the same numpy inputs.

Tolerances: float results agree to rtol 1e-5 / atol 1e-6, because XLA
and PyTorch round sin, cos, rsqrt and pow differently by an ulp on the
CPU (and XLA fuses multiply-adds). Quantised colours agree exactly
except off-by-one at quantisation edges on at most 1e-4 of the values.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt import bsdf as jbsdf, film as jfilm, vec3 as jv, vmath  # noqa: E402
from tpu_pt.render import CameraArrays as JCam, camera_rays as jcamera_rays  # noqa: E402
from tpu_pt.vec3 import V3  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import bsdf as tbsdf, film as tfilm, vec3 as tv  # noqa: E402
from tpu_pt_torch.render import CameraArrays as TCam, camera_rays as tcamera_rays  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def _rng(seed):
    return np.random.default_rng(seed)


def _unit(seed, n=N):
    x = _rng(seed).normal(size=(n, 3)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _close(j, t):
    if isinstance(j, V3):
        j = j.to_array()
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=RTOL, atol=ATOL)


def _v(a):
    return V3.from_array(jnp.asarray(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_vec3_ops():
    a = _rng(0).normal(size=(N, 3)).astype(np.float32) * 10
    b = _rng(1).normal(size=(N, 3)).astype(np.float32)
    n = _unit(2)
    _close(jv.dot(_v(a), _v(b)), tv.dot(_t(a), _t(b)))
    _close(jv.cross(_v(a), _v(b)), tv.cross(_t(a), _t(b)))
    _close(jv.length(_v(a)), tv.length(_t(a)))
    _close(jv.normalize(_v(a)), tv.normalize(_t(a)))
    _close(vmath.normalize(jnp.asarray(a)), tv.normalize(_t(a)))
    _close(jv.reflect(_v(b), _v(n)), tv.reflect(_t(b), _t(n)))
    _close(jv.faceforward(_v(n), _v(b), _v(a)),
           tv.faceforward(_t(n), _t(b), _t(a)))
    _close(jv.luminance(_v(np.abs(a))), tv.luminance(_t(np.abs(a))))
    den = np.where(_rng(3).random(N) < 0.2, 0.0,
                   _rng(4).uniform(0.1, 2.0, N)).astype(np.float32)
    _close(jv.safe_divide(_v(a), jnp.asarray(den)),
           tv.safe_divide(_t(a), _t(den)))
    # Zero vectors normalise to zero.
    assert tv.normalize(torch.zeros(2, 3)).abs().max() == 0.0


def test_onb_and_refract():
    n = _unit(5)
    i = _unit(6)
    loc = _unit(7)
    for jx, tx in zip(jv.onb_from_normal(_v(n)), tv.onb_from_normal(_t(n))):
        _close(jx, tx)
    jt, jb, jn = jv.onb_from_normal(_v(n))
    tt, tb, tn = tv.onb_from_normal(_t(n))
    _close(jv.onb_transform(_v(loc), jt, jb, jn),
           tv.onb_transform(_t(loc), tt, tb, tn))
    ior = _rng(8).uniform(1.0, 2.0, N).astype(np.float32)
    jr, jok = jv.refract(_v(i), _v(n), jnp.asarray(ior))
    tr, tok = tv.refract(_t(i), _t(n), _t(ior))
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert (~tok).any() and tok.any()       # both TIR and refraction occur
    _close(jr, tr)


def test_bsdf_sampling():
    u1 = _rng(10).random(N).astype(np.float32)
    u2 = _rng(11).random(N).astype(np.float32)
    n = _unit(12)
    n[:64] = [0.0, 0.0, 1.0]                # the GGX frame's pole branch
    _close(jbsdf.cosine_sample_hemisphere(jnp.asarray(u1), jnp.asarray(u2)),
           tbsdf.cosine_sample_hemisphere(_t(u1), _t(u2)))
    _close(jbsdf.uniform_sample_hemisphere(jnp.asarray(u1), jnp.asarray(u2)),
           tbsdf.uniform_sample_hemisphere(_t(u1), _t(u2)))
    for importance in (False, True):
        _close(jbsdf.sample_hemisphere_world(_v(n), jnp.asarray(u1),
                                             jnp.asarray(u2), importance),
               tbsdf.sample_hemisphere_world(_t(n), _t(u1), _t(u2),
                                             importance))
    rough = _rng(13).uniform(0.0, 1.2, N).astype(np.float32)
    _close(jbsdf.sample_ggx(jnp.asarray(u1), jnp.asarray(u2),
                            jnp.asarray(rough), _v(n)),
           tbsdf.sample_ggx(_t(u1), _t(u2), _t(rough), _t(n)))


def test_fresnel():
    cos = _rng(14).uniform(-1.0, 1.0, N).astype(np.float32)
    eta, k = jbsdf.metal_eta_k((N,))
    teta, tk = tbsdf.metal_eta_k()
    _close(jbsdf.fresnel_conductor(jnp.abs(jnp.asarray(cos)), eta, k),
           tbsdf.fresnel_conductor(_t(np.abs(cos)), teta, tk))
    ior = np.where(_rng(15).random(N) < 0.1, 0.0,
                   _rng(16).uniform(1.0, 2.5, N)).astype(np.float32)
    _close(jbsdf.fr_dielectric(jnp.asarray(cos), 1.0, jnp.asarray(ior)),
           tbsdf.fr_dielectric(_t(cos), 1.0, _t(ior)))


def test_camera_frame_and_rays():
    for aspect in (1.0, 1.5):
        jc = tpu_pt.Camera(eye=[1.0, 2.0, 3.0], lookat=[0.5, 0.0, -1.0],
                           fov_y=50.0, aspect=aspect)
        tc = tp.Camera(eye=[1.0, 2.0, 3.0], lookat=[0.5, 0.0, -1.0],
                       fov_y=50.0, aspect=aspect)
        for a, b in zip(jc.uvw_frame(), tc.uvw_frame()):
            np.testing.assert_array_equal(a, b)
    cam_j = JCam.from_camera(tpu_pt.cornell_default_camera())
    cam_t = TCam.from_camera(tp.cornell_default_camera())
    w, h = 64, 48
    pix = (np.arange(N, dtype=np.uint32) * 37) % (w * h)
    jx = _rng(17).random(N).astype(np.float32)
    jy = _rng(18).random(N).astype(np.float32)
    jo, jd = jcamera_rays(cam_j, jnp.asarray(pix), w, h, jnp.asarray(jx),
                          jnp.asarray(jy))
    to, td = tcamera_rays(cam_t, _t(pix.astype(np.int64)), w, h, _t(jx),
                          _t(jy))
    np.testing.assert_array_equal(np.asarray(jo.to_array()), to.numpy())
    _close(jd, td)


def test_film_accumulate_and_color():
    prev = _rng(19).uniform(0.0, 2.0, (32, 32, 3)).astype(np.float32)
    cur = _rng(20).uniform(0.0, 2.0, (32, 32, 3)).astype(np.float32)
    for k in (0, 1, 5):
        np.testing.assert_array_equal(
            np.asarray(jfilm.accumulate(jnp.asarray(prev), jnp.asarray(cur),
                                        k)),
            tfilm.accumulate(_t(prev), _t(cur), k).numpy())
    c = _rng(21).uniform(-0.2, 1.3, (256, 256, 3)).astype(np.float32)
    _close(jfilm.to_srgb(jnp.asarray(c)), tfilm.to_srgb(_t(c)))
    ju = np.asarray(jfilm.make_color(jnp.asarray(c))).astype(np.int32)
    tu = tfilm.make_color(_t(c))
    assert tu.dtype == torch.uint8
    diff = np.abs(ju - tu.numpy().astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4, (diff > 0).mean()


def test_png_roundtrip_and_goldens(tmp_path):
    img = _rng(22).integers(0, 256, (17, 23, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    tfilm.write_png(path, img)
    np.testing.assert_array_equal(tfilm.read_png(path), img)
    np.testing.assert_array_equal(jfilm.read_png(path), img)
    import pathlib
    goldens = pathlib.Path(__file__).resolve().parent / "goldens"
    for name in ("importance-with-direct", "16-bounce"):
        p = str(goldens / f"{name}.png")
        np.testing.assert_array_equal(tfilm.read_png(p), jfilm.read_png(p))
    a = _rng(23).random((8, 8, 3))
    assert tfilm.rmse(a, a + 0.5) == pytest.approx(0.5)
