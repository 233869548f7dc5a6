"""Make sure this process's ``habitat_tpu.native`` has its C++ library
loaded before a port test builds scenes, navgrids or episodes through
``habitat_tpu``.

The JAX package builds ``libhabitat_native.so`` with ``make`` on its first
use and, if that fails, falls back to numpy for the rest of the process
(``_tried`` stays set). The numpy rasterizer gives other navgrids than the
C++ one, and the port always uses its own C++ copy, so a parity test run
against the fallback compares two different scenes. Several pytest workers
that start on a checkout without the library run ``make`` at once; a worker
that loads the half-written file, or sees ``make`` fail, keeps the fallback.

``ensure_loaded()`` repairs that without touching the package: under an
``fcntl`` lock on the library's directory it builds a missing library with
the package's Makefile rule in a directory of its own and renames it into
place, clears ``_tried``, and loads the library, retrying while another
process's ``make`` finishes (and rebuilding once, in the same way, if the
file stays unloadable). If the library cannot be loaded it raises; it
never lets a test go on with the fallback. Each port test file that builds through ``habitat_tpu`` imports the
autouse module fixture ``_jax_native``, which calls it.
"""

import fcntl
import os
import shutil
import subprocess
import tempfile
import time

import pytest

from habitat_tpu import native

ATTEMPTS = 20
WAIT_S = 0.25


def _build_atomically() -> None:
    """Run the package's own Makefile rule in a directory of its own beside
    the library, then rename the result into place."""
    makefile = os.path.join(os.path.dirname(os.path.abspath(native.__file__)), "Makefile")
    tmp = tempfile.mkdtemp(prefix=".build-", dir=native._DIR)
    try:
        subprocess.run(["make", "-s", "-B", "-f", makefile, "-C", tmp, f"VPATH={native._DIR}",
                        os.path.basename(native._SO)], check=True, capture_output=True, timeout=300)
        os.replace(os.path.join(tmp, os.path.basename(native._SO)), native._SO)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ensure_loaded():
    """The loaded ``ctypes.CDLL`` of ``habitat_tpu.native``; raises
    ``RuntimeError`` if it cannot be built or loaded."""
    if native._lib is not None:
        return native._lib
    fd = os.open(native._DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if not os.path.exists(native._SO):
            _build_atomically()
        for attempt in range(ATTEMPTS):
            native._tried = False
            lib = native.get_lib()
            if lib is not None:
                return lib
            time.sleep(WAIT_S)  # another process's make may still be writing the file
            if attempt == ATTEMPTS // 2:
                _build_atomically()  # replace a file left broken
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
    raise RuntimeError(
        f"tests/torch_jax_native.py: habitat_tpu.native could not load {native._SO} after {ATTEMPTS} attempts; "
        "a port parity test must not run against the JAX package's numpy fallback")


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """habitat_tpu.native's library loaded, never its numpy fallback; a test
    module takes it with ``from tests.torch_jax_native import _jax_native``."""
    ensure_loaded()
