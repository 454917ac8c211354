"""Build and bind the hand-written CUDA kernels.

``csrc/dense_intersect.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/tpu_pt_torch/`` beside the package (rebuilt whenever the source or
the flags change: the file name carries their hash) and loaded with
``ctypes``. Nothing is built when this module is imported, and nothing
here falls back to another path: a missing ``nvcc`` or a failed build
raises.
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
SOURCE = _PKG / "csrc" / "dense_intersect.cu"
BUILD_DIR = _PKG.parent / "build" / "tpu_pt_torch"

# No --use_fast_math: the kernels rely on IEEE inf/NaN. --fmad=false keeps
# every multiply and add separately rounded, as the plain PyTorch versions
# are (see the note at the top of the source). -Xptxas -v records registers
# and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "tpt_closest_lean": (_P, _P, _P, _I, _I, _F, _P, _P, _P),
    "tpt_closest_full": (_P, _P, _P, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P,
                         _P, _P),
    "tpt_occluded": (_P, _P, _P, _P, _I, _I, _F, _P, _P),
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


def library_path() -> pathlib.Path:
    """Path of the built library for the current source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdense_intersect_{digest}.so"


def build() -> pathlib.Path:
    """Compile the kernel library unless it is already built; returns it.
    The compiler's output (ptxas register and spill report) is kept in a
    ``.log`` file beside the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call the C entry point ``name`` (which launches its kernel on the
    stream passed last) and raise if the launch reported an error."""
    err = getattr(_library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
