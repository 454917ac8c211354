"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface. At first use each is
compiled by ``nvcc`` for ``sm_90a`` into a shared library of its own under
``build/tpu_pt_torch/`` beside the package, all sources at once in
parallel processes, and loaded with ``ctypes``. A library's file name
carries a hash of every file under ``csrc/`` (headers included) and of the
flags, so an edit to any of them rebuilds. Nothing is built when this
module is imported, and nothing here falls back to another path: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_pt_torch"

# No --use_fast_math: the kernels rely on IEEE inf/NaN. --fmad=false keeps
# every multiply and add separately rounded, as the plain PyTorch versions
# are (see csrc/pe_block.cuh). -Xptxas -v records registers and spills in
# the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Source stem -> {C entry point: argument types}.
_SIGNATURES = {
    "dense_intersect": {
        "tpt_closest_lean": (_P, _P, _P, _I, _I, _F, _P, _P, _P),
        "tpt_closest_full": (_P, _P, _P, _I, _I, _F, _F, _I, _P, _P, _P, _P,
                             _P, _P, _P),
        "tpt_occluded": (_P, _P, _P, _P, _I, _I, _F, _P, _P),
        "tpt_closest_nee_lean": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _F,
                                 _P, _P, _P, _P),
        "tpt_closest_nee_full": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _F,
                                 _F, _P, _I, _F, _F, _P, _P, _P, _P, _P, _I,
                                 _P),
        "tpt_closest_nee_full_dense": (_P, _P, _P, _P, _P, _I, _P, _I, _F, _F,
                                       _P, _P, _P, _P, _P, _P),
    },
    "clustered_intersect": {
        "tpt_closest_clustered": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                                  _F, _P, _P, _I, _P),
        "tpt_occluded_clustered": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                   _F, _P, _I, _P),
        "tpt_closest_clustered_full": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                       _F, _F, _I, _P, _P, _P, _P, _P, _P,
                                       _I, _P),
        "tpt_closest_clustered_flat": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                                       _F, _P, _P, _P),
        "tpt_occluded_clustered_flat": (_P, _P, _P, _P, _P, _I, _I, _I, _F,
                                        _F, _F, _P, _P),
        "tpt_closest_clustered_full_flat": (_P, _P, _P, _P, _I, _I, _I, _F,
                                            _F, _F, _F, _I, _P, _P, _P, _P,
                                            _P, _P, _P),
    },
    "clustered_build": {
        "tpt_closest_clustered_b": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                                    _F, _P, _P, _P),
        "tpt_closest_clustered_full_b": (_P, _P, _P, _P, _I, _I, _I, _F, _F,
                                         _F, _F, _I, _P, _P, _P, _P, _P, _P,
                                         _P),
        "tpt_occluded_clustered_b": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                     _F, _P, _P),
    },
    "ablations_intersect": {
        "tpt_closest_rotated": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                                _F, _F, _P, _P, _P),
        "tpt_closest_streamed": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _F, _F, _F, _F, _I, _P, _P, _P),
        "tpt_occluded_streamed": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _F, _F, _F, _I, _P, _P),
        "tpt_closest_cbin": (_P, _P, _P, _I, _I, _I, _F, _P, _P, _P),
        "tpt_occluded_cbin": (_P, _P, _P, _I, _I, _I, _F, _P, _P),
    },
    "ablations_binned": {
        "tpt_closest_binned": (_P, _P, _P, _P, _I, _I, _I, _F, _P, _P),
        "tpt_occluded_binned": (_P, _P, _P, _P, _I, _I, _I, _F, _P, _P),
        "tpt_closest_grp": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _F, _F, _F, _F, _P, _P, _P),
        "tpt_occluded_grp": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _F, _F, _P, _P),
    },
    "microbench_bf16": {
        "tpt_chain_f32": (_P, _P, _P, _I, _I, _P),
        "tpt_chain_bf16": (_P, _P, _P, _I, _I, _P),
    },
    "instanced_intersect": {
        "tpt_closest_inst": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                             _F, _F, _P, _P, _P, _I, _P),
        "tpt_closest_inst_flat": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                  _F, _F, _P, _P, _P, _P),
        "tpt_occluded_inst": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                              _F, _P, _P),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of tpu_pt_torch are "
                       "compiled at first use with the CUDA toolkit's nvcc")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_paths() -> dict[str, pathlib.Path]:
    """Source stem -> path of its built library for the current files
    under ``csrc/`` and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    digest = h.hexdigest()[:16]
    return {src.stem: BUILD_DIR / f"lib{src.stem}_{digest}.so"
            for src in sources()}


def build() -> list[pathlib.Path]:
    """Compile every kernel library that is not built yet (one ``nvcc``
    process per source, all started together); returns the libraries.
    Each compiler's output (ptxas register and spill report) is kept in a
    ``.log`` file beside its library."""
    paths = library_paths()
    jobs = []
    for src in sources():
        out = paths[src.stem]
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n"
                          f"{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return list(paths.values())


@functools.cache
def _entry_points() -> dict:
    build()
    paths = library_paths()
    fns = {}
    for stem, signatures in _SIGNATURES.items():
        lib = ctypes.CDLL(str(paths[stem]))
        for name, args in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def launch(name: str, *args) -> None:
    """Call the C entry point ``name`` (which launches its kernel on the
    stream passed last) and raise if the launch reported an error."""
    err = _entry_points()[name](*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
