"""Port parity: the counter RNG of tpu_pt_torch is bitwise equal to tpu_pt's."""

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
