"""On the card: the RNG kernel (``csrc/rng.cu``) is bitwise equal to the
plain int64 version, and a pixelq frame draws through it alone. Run on a
machine with a CUDA device (it has no JAX, which ``tests/conftest.py``
imports) with ``python -m pytest tests/test_torch_rng_card.py -m card
--noconftest``."""

import pytest

torch = pytest.importorskip("torch")

from tpu_pt_torch import rng  # noqa: E402

COUNTER_EDGES = [0, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5, -1, -(2 ** 40) - 3]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _lanes(edge: int, n: int) -> torch.Tensor:
    return edge + torch.arange(n, dtype=torch.int64) * 7919


def _counters(edge: int, n: int, kind: str):
    """(pixel, sample, frame, stream or depth) on the CPU: per-lane
    pixels; sample and depth per lane ("lanes"), ints ("ints") or one
    element broadcast ("one"); "offset" per-lane tensors that start 8
    bytes past a 16-byte boundary (the kernel's scalar loads)."""
    pix = _lanes(edge, n)
    if kind == "lanes":
        return pix, _lanes(edge + 3, n), edge + 1, _lanes(edge - 11, n)
    if kind == "ints":
        return pix, edge + 3, edge + 1, edge - 11
    if kind == "one":
        return pix, torch.tensor(edge + 3), edge + 1, torch.tensor([edge])
    return (_lanes(edge, n + 1)[1:], _lanes(edge + 3, n + 1)[1:], edge + 1,
            _lanes(edge - 11, n + 1)[1:])


def _cuda(counters):
    return [c.cuda() if isinstance(c, torch.Tensor) else c for c in counters]


@pytest.mark.card
@pytest.mark.parametrize("draw", ["uniform2", "uniform4", "bounce_uniforms"])
@pytest.mark.parametrize("kind", ["lanes", "ints", "one", "offset"])
@pytest.mark.parametrize("n", [1, 4099, 65536])
def test_kernel_is_the_plain_draw(draw, kind, n):
    """Every counter edge, a ragged lane count and unaligned inputs: the
    kernel's rows equal the plain version's bit for bit, one launch a
    draw."""
    _need_card()
    for edge in COUNTER_EDGES:
        counters = _counters(edge, n, kind)
        want = getattr(rng, draw)(*counters)
        before = dict(rng.LAUNCHES)
        got = getattr(rng, draw)(*_cuda(counters))
        torch.cuda.synchronize()
        name = "bounce_uniforms" if draw == "bounce_uniforms" else "uniform"
        assert rng.LAUNCHES[name] == before[name] + 1
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and a.dtype == torch.float32
            assert torch.equal(a.cpu(), b), (draw, kind, n, edge)


@pytest.mark.card
def test_pixelq_frame_draws_through_the_kernel():
    """A small pixelq frame: one bounce draw a round, one jitter draw a
    round plus the first fill's, every one a launch of the kernel."""
    _need_card()
    import pathlib

    import tpu_pt_torch as tp
    from tpu_pt_torch.render import CameraArrays
    root = pathlib.Path(__file__).resolve().parents[1]
    scene = tp.load_scene(str(root / "assets" / "cornell_box_mixed.obj"))
    cam = CameraArrays.from_camera(tp.cornell_default_camera(),
                                   device=scene.device)
    cfg = tp.RenderConfig(width=32, height=32, spp=2, max_depth=6,
                          use_direct_lighting=True,
                          use_importance_sampling=True)
    accum = tp.init_accum(cfg)
    before = dict(rng.LAUNCHES)
    _, _, stats = tp.render_frame(scene, cam, cfg, 3, accum)
    rounds = int(stats.wavefront_iterations)
    assert rounds > 0
    assert rng.LAUNCHES == {"uniform": before["uniform"] + rounds + 1,
                            "bounce_uniforms":
                                before["bounce_uniforms"] + rounds}
