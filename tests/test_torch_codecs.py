"""Port parity for the image codecs: tpu_pt_torch.jpeg (baseline and
progressive decode, baseline encode), the EXR PIZ codec of
tpu_pt_torch.film, and JPEG / PPM textures in the glTF loader, each
against the JAX package's own (both are host-side numpy, so the bound is
equality: decoded pixels equal, encoded files byte for byte).
"""

import base64
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt import film as jfilm, jpeg as jjpeg  # noqa: E402
from tpu_pt.scene import gltf as jgltf  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import film, jpeg  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"


def _test_image(h=72, w=104):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 17), 128 + 90 * np.cos(y / 11),
                    np.clip(x + y, 0, 255)], axis=2)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", ["prog444_q85", "prog420_q60"])
def test_progressive_fixture_decode(name):
    """The committed libjpeg-encoded progressive files decode exactly to
    the committed expectation, as tests/test_jpeg.py holds the JAX
    package's decoder."""
    blob = (DATA / f"{name}.jpg").read_bytes()
    assert b"\xff\xc2" in blob                  # really SOF2
    ours = jpeg.decode_jpeg(blob)
    np.testing.assert_array_equal(
        ours, film.read_png(str(DATA / f"{name}.expected.png")))
    np.testing.assert_array_equal(ours, jjpeg.decode_jpeg(blob))


@pytest.mark.parametrize("quality", [60, 90, 100])
def test_encode_matches_reference_bytes(quality):
    """``encode_jpeg`` byte for byte against ``tpu_pt.jpeg.encode_jpeg``,
    colour and grayscale, and the decode of it equal too."""
    img = _test_image()
    for src in (img, img[:, :, 0], img[:37, :51]):
        ours = jpeg.encode_jpeg(src, quality=quality)
        assert ours == jjpeg.encode_jpeg(src, quality=quality)
        np.testing.assert_array_equal(jpeg.decode_jpeg(ours),
                                      jjpeg.decode_jpeg(ours))
    back = jpeg.decode_jpeg(jpeg.encode_jpeg(img, quality=quality))
    assert back.shape == img.shape
    assert np.abs(back.astype(int) - img.astype(int)).mean() < 14.0


def test_jpeg_film_wrappers(tmp_path):
    img = _test_image(40, 56)
    film.write_jpeg(str(tmp_path / "x.jpg"), img, quality=95)
    jfilm.write_jpeg(str(tmp_path / "y.jpg"), img, quality=95)
    assert (tmp_path / "x.jpg").read_bytes() == (tmp_path / "y.jpg").read_bytes()
    back = film.read_jpeg(str(tmp_path / "x.jpg"))
    np.testing.assert_array_equal(back, jfilm.read_jpeg(str(tmp_path / "y.jpg")))
    assert np.abs(back.astype(int) - img.astype(int)).mean() < 8.0


@pytest.mark.parametrize("h,w", [(64, 64), (33, 17), (70, 41), (1, 5)])
def test_exr_piz_matches_reference_and_roundtrips(tmp_path, h, w):
    """``write_exr(..., "piz")`` files byte-identical to tpu_pt.film's,
    float and half, and a bit-exact round trip through either reader,
    including sizes that leave a partial last block."""
    rng = np.random.RandomState(11)
    img = rng.rand(h, w, 3).astype(np.float32) * 4.0
    img[::3, ::2] = 0.25               # runs for the run-length symbol
    for half in (False, True):
        ours, ref = str(tmp_path / "a.exr"), str(tmp_path / "b.exr")
        film.write_exr(ours, img, half=half, compression="piz")
        jfilm.write_exr(ref, img, half=half, compression="piz")
        assert open(ours, "rb").read() == open(ref, "rb").read()
        want = img.astype(np.float16).astype(np.float32) if half else img
        np.testing.assert_array_equal(film.read_exr(ours), want)
        np.testing.assert_array_equal(film.read_exr(ref), want)
        np.testing.assert_array_equal(jfilm.read_exr(ours), want)


def test_exr_piz_huffman_fuzz():
    """The PIZ Huffman coder round-trips adversarial symbol streams
    (uniform u16, tiny alphabets, all zero, long runs), and its output
    equals the JAX package's (tests/test_film.py's cases)."""
    rng = np.random.RandomState(5)
    for trial in range(24):
        n = int(rng.randint(1, 5000))
        mode = trial % 4
        if mode == 0:
            raw = rng.randint(0, 65536, n).astype(np.uint16)
        elif mode == 1:
            raw = rng.randint(0, 7, n).astype(np.uint16)
        elif mode == 2:
            raw = np.zeros(n, np.uint16)
        else:
            raw = np.repeat(rng.randint(0, 300, max(1, n // 50)),
                            50)[:n].astype(np.uint16)
        enc = film._piz_huf_compress(raw)
        assert enc == jfilm._piz_huf_compress(raw)
        np.testing.assert_array_equal(
            film._piz_huf_decompress(enc, raw.size), raw)
    with pytest.raises(ValueError):
        raw = np.arange(64, dtype=np.uint16) % 7
        film._piz_huf_decompress(film._piz_huf_compress(raw)[:-2] + b"\0\0",
                                 4 * raw.size)


def test_exr_piz_wavelet_exact_inverse():
    """The 14- and 16-bit 2-D wavelets invert exactly at every shape,
    single rows and columns and odd remainders included."""
    rng = np.random.RandomState(0)
    for _ in range(60):
        ny, nx = int(rng.randint(1, 33)), int(rng.randint(1, 33))
        mx = int(rng.choice([100, 10000, 20000, 65535]))
        a = rng.randint(0, mx + 1, (ny, nx)).astype(np.uint16)
        b, c = a.copy(), a.copy()
        film._piz_wav2(b, mx, encode=True)
        jfilm._piz_wav2(c, mx, encode=True)
        np.testing.assert_array_equal(b, c)
        film._piz_wav2(b, mx, encode=False)
        np.testing.assert_array_equal(a, b)


def _textured_gltf(tmp_path, image: dict) -> str:
    """A minimal .gltf: one textured quad whose base colour comes from
    ``image`` (an entry of ``images``), with a non-default sampler."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16).reshape(-1, 1)
    blob, views, accs = b"", [], []
    for arr, target, ctype, atype in ((pos, 34962, 5126, "VEC3"),
                                      (nrm, 34962, 5126, "VEC3"),
                                      (uv, 34962, 5126, "VEC2"),
                                      (idx, 34963, 5123, "SCALAR")):
        views.append(dict(buffer=0, byteOffset=len(blob),
                          byteLength=arr.nbytes, target=target))
        blob += arr.tobytes() + b"\0" * (-arr.nbytes % 4)
        acc = dict(bufferView=len(views) - 1, componentType=ctype,
                   count=arr.shape[0], type=atype)
        if atype == "VEC3":
            acc.update(min=[float(v) for v in arr.min(0)],
                       max=[float(v) for v in arr.max(0)])
        accs.append(acc)
    doc = dict(
        asset=dict(version="2.0"), scene=0, scenes=[dict(nodes=[0])],
        nodes=[dict(mesh=0)],
        meshes=[dict(primitives=[dict(
            attributes=dict(POSITION=0, NORMAL=1, TEXCOORD_0=2), indices=3,
            material=0)])],
        materials=[dict(pbrMetallicRoughness=dict(
            baseColorTexture=dict(index=0)))],
        textures=[dict(source=0, sampler=0)],
        samplers=[dict(wrapS=33071, wrapT=33648)], images=[image],
        buffers=[dict(byteLength=len(blob),
                      uri="data:application/octet-stream;base64,"
                          + base64.b64encode(blob).decode())],
        bufferViews=views, accessors=accs)
    path = tmp_path / "tex.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("kind", ["jpeg-data-uri", "ppm-file", "ppm-ascii"])
def test_gltf_jpeg_and_ppm_textures(tmp_path, kind):
    """A glTF whose texture is a JPEG (data URI) or a PPM (external file,
    binary and ascii) loads, its texture equal to the JAX loader's."""
    tex = np.zeros((16, 16, 3), np.uint8)
    tex[:8, :8] = [255, 0, 0]
    tex[8:, 8:] = [255, 0, 0]
    if kind == "jpeg-data-uri":
        image = dict(uri="data:image/jpeg;base64," + base64.b64encode(
            jpeg.encode_jpeg(tex, quality=100)).decode())
    elif kind == "ppm-file":
        film.write_ppm(str(tmp_path / "t.ppm"), tex)
        image = dict(uri="t.ppm")
    else:
        (tmp_path / "t.ppm").write_text(
            "P3\n# ascii\n16 16\n255\n"
            + " ".join(str(v) for v in tex.reshape(-1)) + "\n")
        image = dict(uri="t.ppm")
    path = _textured_gltf(tmp_path, image)
    ours = tp.load_gltf(path, device="cpu")
    ref = jgltf.load_gltf(path)
    assert len(ours.textures) == 1 and ours.tex_wrap == ((33071, 33648),)
    got = ours.textures[0].numpy()
    assert got.shape == (16, 16, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref.textures[0]))
    assert np.abs(got[..., :3] - tex.astype(np.float32) / 255.0).mean() < 0.08
    assert got[2, 2, 0] > 0.7 and got[2, 10, 0] < 0.3 and (got[..., 3] == 1).all()
