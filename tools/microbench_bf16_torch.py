#!/usr/bin/env python3
"""The f32 / bf16 throughput probe of the PyTorch + CUDA port: the twin of
``tools/microbench_bf16.py``, whose Pallas kernel (K16) asks whether packed
bf16 elementwise math beats f32 on the TPU's vector unit.

Here the question is put to the card's ALUs without tensor cores: 128
steps of the 8 dependent mul / add operations of the JAX tool's ``_kernel``
(``t = a*b + acc; u = t*a - b; v = u*b + t; acc = v*a - u``) per element
over [ROWS * GRID, COLS] = [2,048, 1,024], in ``float`` and in packed
``__nv_bfloat162`` (two elements an instruction), every operation its own
instruction (``tpu_pt_torch/csrc/microbench_bf16.cu``, built at first use
by ``tpu_pt_torch._kernels`` with the other kernels).

``chain_f32`` / ``chain_bf16`` launch the kernels for CUDA tensors, run
``plain_chain`` (the same chain in PyTorch, one rounding per operation) for
CPU tensors and raise for any other device. ``bench`` chains each call's
output into the next call's input, as the JAX tool does, and times 200
calls with CUDA events.

Run on a machine with a CUDA device, from the repository root:
``python3 tools/microbench_bf16_torch.py``. Prints one JSON line per dtype:
ms per call, Tops/s, the bound (the operations over the card's instruction rate
for the type: SMs x 128 f32 lanes x the maximum SM clock that
``nvidia-smi`` reports, twice that for packed bf16) and, on the bf16
line, the bf16 / f32 rate ratio; with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ROWS, COLS = 256, 1024      # the JAX tool's per-program tile
GRID = 8                    # its programs per call
STEPS = 128                 # op-chain repeats per element
OPS_PER_STEP = 8
F32_LANES = 128             # f32 results per clock per SM (sm_90)

# Kernel launches per wrapper. Plain-version calls on CPU tensors do not
# count.
LAUNCHES = {"chain_f32": 0, "chain_bf16": 0}


def shape() -> tuple[int, int]:
    return ROWS * GRID, COLS


def make_inputs(dtype, device, seed: int = 0):
    """(a, b) as the JAX tool makes them: a uniform in [0.9, 1.0) in
    ``dtype``, b = a / 2, from ``numpy.random.default_rng(seed)``."""
    import numpy as np
    import torch
    a = torch.as_tensor(np.random.default_rng(seed).random(
        shape(), dtype=np.float32), device=device).to(dtype) * 0.1 + 0.9
    return a, (a * 0.5).to(dtype)


def plain_chain(a, b, steps: int = STEPS):
    """The chain in PyTorch, in the inputs' dtype: every multiply and add
    rounded on its own, in the kernel's order."""
    import torch
    acc = torch.zeros_like(a)
    for _ in range(steps):
        t = a * b + acc
        u = t * a - b
        v = u * b + t
        acc = v * a - u
    return acc


def _launch(name: str, dtype, a, b, steps: int):
    import torch
    from tpu_pt_torch import _kernels
    from tpu_pt_torch.intersect import dense
    if dense._on_cpu(a):
        return plain_chain(a, b, steps)
    for what, x in (("a", a), ("b", b)):
        dense._check(what, x, dtype, tuple(a.shape), a.device)
    out = torch.empty_like(a)
    n = a.numel()
    if dtype == torch.bfloat16:
        if n % 2 or a.data_ptr() % 4 or b.data_ptr() % 4:
            raise ValueError("the bf16 chain takes an even number of "
                             "4-byte-aligned values")
        n //= 2
    _kernels.launch("tpt_" + name, a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), n, steps, dense._stream(a.device))
    LAUNCHES[name] += 1
    return out


def chain_f32(a, b, steps: int = STEPS):
    """K16 f32: ``steps`` steps of the chain per element of f32 ``a``,
    ``b`` (same shape, contiguous). Returns acc."""
    import torch
    return _launch("chain_f32", torch.float32, a, b, steps)


def chain_bf16(a, b, steps: int = STEPS):
    """K16 bf16: the chain on bf16 ``a``, ``b`` in packed pairs, every
    operation rounded to bf16. Returns acc."""
    import torch
    return _launch("chain_bf16", torch.bfloat16, a, b, steps)


def op_rates() -> dict:
    """The card's instruction rate for each type (operations per second), from
    its SM count and the maximum SM clock ``nvidia-smi`` reports."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32 = sms * F32_LANES * mhz * 1e6
    return dict(sms=sms, max_sm_mhz=mhz, f32=f32, bf16=2 * f32)


def operations() -> int:
    rows, cols = shape()
    return rows * cols * STEPS * OPS_PER_STEP


def bench(dtype, iters: int = 200, device="cuda"):
    """ms per call and Tops/s of ``iters`` chained calls (each call's
    output is the next one's ``a``), device time from CUDA events after
    one warm-up call."""
    import torch
    fn = chain_bf16 if dtype == torch.bfloat16 else chain_f32
    a, b = make_inputs(dtype, device)
    fn(a, b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    out = a
    start.record()
    for _ in range(iters):
        out = fn(out, b)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / iters
    return ms, operations() / (ms * 1e-3) / 1e12


def run(smi: str | None = None, say=None) -> list[dict]:
    """Both dtypes through ``bench``; one payload per dtype."""
    import torch
    if smi is None:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    rates = op_rates()
    out = []
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ms, tops = bench(dtype)
        payload = dict(metric=f"chain {name} [{shape()[0]}, {shape()[1]}] x "
                              f"{STEPS} x {OPS_PER_STEP} ops",
                       dtype=name, ms_per_call=ms, tops=tops,
                       bound_ms=operations() / rates[name] * 1e3,
                       bound_tops=rates[name] / 1e12,
                       sms=rates["sms"], max_sm_mhz=rates["max_sm_mhz"],
                       device=smi)
        if name == "bf16":
            payload["bf16_over_f32"] = tops / out[0]["tops"]
        out.append(payload)
        if say is not None:
            say(payload)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe times the card's ALUs")
    run(say=lambda payload: print(json.dumps(payload), flush=True))


if __name__ == "__main__":
    main()
