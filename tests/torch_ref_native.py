"""The JAX package's native host library for the port's parity tests.

``tpu_pt.native`` builds ``libtpt_native.so`` with ``make`` in place, the
first time it is asked, and caches a failed load for the life of the
process. Under ``pytest -n`` every worker asks at about the same moment,
so a worker that looks while another worker's ``g++`` is still writing
the file keeps no library: its OBJ parser falls back to Python and its
host LBVH build raises. ``reference_native`` gives such a worker its
library back before a test holds the port against the reference's native
output. It builds and writes nothing itself: only the reference's own
loader runs ``make``.
"""

import importlib
import shutil
import time

import pytest

DEADLINE_S = 60.0   # long enough for another worker's g++ to finish
RETRY_S = 0.5


def reference_native(deadline_s: float = DEADLINE_S):
    """``tpu_pt.native`` with its library loaded. When its loader has
    cached a failure and ``g++`` is on the PATH, the module is reloaded
    (which clears ``_lib`` and ``_tried`` in the module object that
    ``tpu_pt.scene.objloader`` and ``tpu_pt.intersect.lbvh`` import at
    call time) and asked again, every RETRY_S seconds up to
    ``deadline_s``. Skips without ``g++``, as the tests' ``needs_native``
    does; fails if the library still does not load by the deadline."""
    from tpu_pt import native
    if native.available():
        return native
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable")
    end = time.monotonic() + deadline_s
    while True:
        native = importlib.reload(native)
        if native.available():
            return native
        if time.monotonic() > end:
            pytest.fail(f"tpu_pt.native did not load within {deadline_s} s")
        time.sleep(RETRY_S)
