"""Port parity for the f32 / bf16 throughput probe (K16):
``tools/microbench_bf16_torch.py`` against ``tools/microbench_bf16.py``.

The plain chain (the CPU path of ``chain_f32`` / ``chain_bf16``) is held
bit for bit against a numpy float32 chain, and against the JAX tool's
``_kernel`` run through ``pl.pallas_call(..., interpret=True)`` at small
ROWS / COLS / STEPS (both tools loaded by file path; nothing edited):
within 1e-6 relative in f32, since XLA on the CPU may fuse a multiply and
an add, and within one bf16 ulp in bf16.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tools(monkeypatch):
    """The two tools at [16, 128] (two programs of [8, 128])."""
    ours, ref = _load("microbench_bf16_torch"), _load("microbench_bf16")
    monkeypatch.setattr(ours, "ROWS", 8)
    monkeypatch.setattr(ours, "COLS", 128)
    monkeypatch.setattr(ours, "GRID", 2)
    monkeypatch.setattr(ref, "ROWS", 8)
    monkeypatch.setattr(ref, "COLS", 128)
    return ours, ref


def _jax_chain(ref, a, b, dtype, steps, monkeypatch):
    monkeypatch.setattr(ref, "STEPS", steps)
    call = pl.pallas_call(
        functools.partial(ref._kernel, dtype=dtype), grid=(2,),
        in_specs=[pl.BlockSpec((ref.ROWS, ref.COLS), lambda i: (i, 0))] * 2,
        out_specs=pl.BlockSpec((ref.ROWS, ref.COLS), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((2 * ref.ROWS, ref.COLS), dtype),
        interpret=True)
    return call(jnp.asarray(a.float().numpy()).astype(dtype),
                jnp.asarray(b.float().numpy()).astype(dtype))


@pytest.mark.parametrize("steps", [4, 128])
def test_f32_chain_matches_numpy_and_reference(tools, monkeypatch, steps):
    ours, ref = tools
    a, b = ours.make_inputs(torch.float32, "cpu")
    out = ours.chain_f32(a, b, steps)
    an, bn = a.numpy(), b.numpy()
    acc = np.zeros_like(an)
    for _ in range(steps):
        t = an * bn + acc
        u = t * an - bn
        v = u * bn + t
        acc = v * an - u
    np.testing.assert_array_equal(out.numpy(), acc)
    assert np.isfinite(acc).all() and 0.5 < acc.mean() < 1.0
    jout = np.asarray(_jax_chain(ref, a, b, jnp.float32, steps, monkeypatch))
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-6)


@pytest.mark.parametrize("steps", [4, 128])
def test_bf16_chain_matches_reference(tools, monkeypatch, steps):
    ours, ref = tools
    a, b = ours.make_inputs(torch.bfloat16, "cpu")
    out = ours.chain_bf16(a, b, steps)
    assert out.dtype == torch.bfloat16 and out.shape == (16, 128)
    jout = _jax_chain(ref, a, b, jnp.bfloat16, steps, monkeypatch)
    theirs = torch.as_tensor(np.array(jout.astype(jnp.float32))).to(
        torch.bfloat16)
    # Same-sign bf16 values one ulp apart differ by one in their bits.
    assert bool((out.float() > 0).all())
    ulps = (out.view(torch.int16).int() - theirs.view(torch.int16).int()).abs()
    assert int(ulps.max()) <= 1
    # Every operation rounds to bf16: the chain is not the f32 chain.
    f32 = ours.plain_chain(a.float(), b.float(), steps)
    assert not torch.equal(out.float(), f32)


def test_chain_wrappers_take_cpu_or_cuda_only(tools):
    ours, _ = tools
    meta = torch.empty((16, 128), device="meta")
    for fn in (ours.chain_f32, ours.chain_bf16):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(meta, meta)
    assert ours.LAUNCHES == {"chain_f32": 0, "chain_bf16": 0}
    assert ours.operations() == 16 * 128 * 128 * 8
    assert ours.shape() == (16, 128)
