"""Port parity: the counter RNG of tpu_pt_torch is bitwise equal to tpu_pt's."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt import rng as jrng  # noqa: E402
from tpu_pt_torch import rng as trng  # noqa: E402

EDGES = np.array([0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 31 - 1, 2 ** 31,
                  2 ** 31 + 1, 2 ** 32 - 2, 2 ** 32 - 1], np.uint64)


def _counters(seed: int, n: int = 20000) -> np.ndarray:
    """[4, n] uint32 counters over the whole range, half of them >= 2**31,
    with the edge values mixed into every row."""
    c = np.random.default_rng(seed).integers(0, 2 ** 32, size=(4, n),
                                             dtype=np.uint64)
    c[:, :EDGES.size] = EDGES
    c[1, :EDGES.size] = EDGES[::-1]
    return c.astype(np.uint32)


def _both(fn_j, fn_t, c):
    j = fn_j(*(jnp.asarray(x) for x in c))
    t = fn_t(*(torch.from_numpy(x.astype(np.int64)) for x in c))
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


@pytest.mark.parametrize("seed", [0, 1])
def test_pcg4d_bitwise(seed):
    j, t = _both(jrng.pcg4d, trng.pcg4d, _counters(seed))
    for a, b in zip(j, t):
        assert b.dtype == np.int64 and b.min() >= 0 and b.max() < 2 ** 32
        np.testing.assert_array_equal(a.astype(np.int64), b)


@pytest.mark.parametrize("seed", [2, 3])
def test_uniform4_bitwise(seed):
    j, t = _both(jrng.uniform4, trng.uniform4, _counters(seed))
    for a, b in zip(j, t):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_uniform2_bitwise():
    j, t = _both(jrng.uniform2, trng.uniform2, _counters(4))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)


def test_scalar_counters_broadcast():
    """Render calls mix per-lane tensors with Python ints (sample, frame)."""
    pix = np.arange(5000, dtype=np.uint32) * 7919
    for sample, frame, stream in [(0, 0, 0), (3, 7, 1), (11, 2 ** 31, 9)]:
        j = jrng.uniform4(jnp.asarray(pix), sample, np.uint32(frame), stream)
        t = trng.uniform4(torch.from_numpy(pix.astype(np.int64)), sample,
                          frame, stream)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert trng.bounce_streams(3) == jrng.bounce_streams(3)


# Counters at the edges of the uint32 range and beyond it: an int64 counter
# enters the hash as its low 32 bits.
COUNTER_EDGES = [0, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5, -1, -(2 ** 40) - 3]


def _lanes(edge: int, n: int = 1031) -> torch.Tensor:
    return edge + torch.arange(n, dtype=torch.int64) * 7919


@pytest.mark.parametrize("depth_kind", ["int", "tensor"])
@pytest.mark.parametrize("sample_kind", ["int", "tensor"])
@pytest.mark.parametrize("edge", COUNTER_EDGES)
def test_bounce_uniforms_is_the_two_draws(edge, sample_kind, depth_kind,
                                          monkeypatch):
    """``bounce_uniforms`` equals the two ``uniform4`` calls of the bounce
    it replaced (streams 1 + 2 depth and 2 + 2 depth, depth as a tensor),
    for int and per-lane sample and depth; a CPU draw launches nothing."""
    monkeypatch.setattr(trng, "LAUNCHES", dict.fromkeys(trng.LAUNCHES, 0))
    pix = _lanes(edge)
    sample = edge if sample_kind == "int" else _lanes(edge + 3)
    depth = edge if depth_kind == "int" else _lanes(edge - 11)
    frame = edge + 1
    depth_t = torch.as_tensor(depth, dtype=torch.int64)
    sa = trng.STREAM_BOUNCE_A + 2 * depth_t
    sb = trng.STREAM_BOUNCE_B + 2 * depth_t
    z1, z2, z3, _ = trng.uniform4(pix, sample, frame, sa)
    lz1, lz2, z_rr, _ = trng.uniform4(pix, sample, frame, sb)
    got = trng.bounce_uniforms(pix, sample, frame, depth)
    for a, b in zip(got, (z1, z2, z3, lz1, lz2, z_rr)):
        assert a.dtype == torch.float32 and a.shape == pix.shape
        assert torch.equal(a, b)
    assert trng.LAUNCHES == {"uniform": 0, "bounce_uniforms": 0}


def _read_counter(ptr, stride, value, n):
    """A counter as ``csrc/rng.cu`` reads it: int64 tensor of n values."""
    if ptr is None:
        return torch.full((n,), value, dtype=torch.int64)
    m = n if stride else 1
    vals = np.frombuffer((ctypes.c_int64 * m).from_address(ptr), np.int64)
    return torch.from_numpy(vals.copy()).expand(n)


def _emulated_kernel(name, *args):
    """The entry points of ``csrc/rng.cu`` on CPU memory: the plain hash
    of the counters as the kernel reads them, written to ``out`` as rows
    ``ld`` floats apart."""
    from tpu_pt_torch import _kernels
    assert len(args) == len(_kernels._SIGNATURES["rng"][name])
    counters, rest = args[:12], args[12:]
    k = 6 if name == "tpt_bounce_uniforms" else rest[0]
    n, ld, out_ptr, _ = rest[-4:]
    assert k in (2, 4, 6) and ld % 4 == 0 and ld >= n and out_ptr % 16 == 0
    a, b, c, d = (_read_counter(*counters[i:i + 3], n) for i in (0, 3, 6, 9))
    if k == 6:
        rows = (trng.pcg4d(a, b, c, 1 + 2 * d)[:3]
                + trng.pcg4d(a, b, c, 2 + 2 * d)[:3])
    else:
        rows = trng.pcg4d(a, b, c, d)[:k]
    out = np.frombuffer((ctypes.c_float * (k * ld)).from_address(out_ptr),
                        np.float32).reshape(k, ld)
    for r, row in enumerate(rows):
        out[r, :n] = trng._to_unit_float(row).numpy()


CARD_CASES = {
    # (pixel, sample, frame, stream or depth) as lane counts; "s" a Python
    # int, "0d" a 0-d tensor, "1" a [1] tensor, "v" a non-contiguous view.
    "pixelq": (1031, 1031, "s", 1031),
    "scan": (1031, "s", "s", "s"),
    "debug": (1, 1, "s", 1),
    "broadcast": (64, "0d", "s", "1"),
    "view": ("v", 1031, "s", "s"),
    "scalars": ("0d", "s", "s", "s"),
    "empty": (0, 0, "s", "s"),
}


def _counter(kind, edge, lane_shift):
    if kind == "s":
        return edge + lane_shift
    if kind == "0d":
        return torch.tensor(edge + lane_shift)
    if kind == "1":
        return torch.tensor([edge - lane_shift])
    if kind == "v":
        return _lanes(edge, 2062)[::2]
    return _lanes(edge + lane_shift, kind)


@pytest.mark.parametrize("draw", ["uniform2", "uniform4", "bounce_uniforms"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_card_draw_passes_its_counters(case, draw, monkeypatch):
    """The card side of a draw, its kernel emulated on the CPU: ints go by
    value as their low 32 bits, one-element tensors broadcast, per-lane
    tensors by pointer; the rows it returns equal the plain draw, in the
    counters' broadcast shape; each launch is counted."""
    from tpu_pt_torch import _kernels
    edge = 2 ** 32 - 2
    counters = [_counter(kind, edge, shift)
                for kind, shift in zip(CARD_CASES[case], (0, 3, 1, -5))]
    want = getattr(trng, draw)(*counters)
    monkeypatch.setattr(trng, "LAUNCHES", dict.fromkeys(trng.LAUNCHES, 0))
    monkeypatch.setattr(trng, "_card", lambda c: torch.device("cpu"))
    monkeypatch.setattr(trng, "_stream", lambda dev: None)
    monkeypatch.setattr(_kernels, "launch", _emulated_kernel)
    got = getattr(trng, draw)(*counters)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.is_contiguous() and a.shape == b.shape
        assert torch.equal(a, b)
    name = "bounce_uniforms" if draw == "bounce_uniforms" else "uniform"
    launched = int(case != "empty")
    assert trng.LAUNCHES == {"uniform": 0, "bounce_uniforms": 0,
                             name: launched}
