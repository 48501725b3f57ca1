"""Build the port's CUDA sources into a shared library at first use.

``nvcc`` compiles ``mogp_tpu_torch/csrc/*.cu`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The library goes into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``);
its file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  The build writes a
temporary file and renames it, so concurrent first uses do not collide.

Nothing here runs at import time: the CPU-only test environment has no
``nvcc``, and only a launch on a CUDA tensor calls :func:`library`.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["library", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib = None
# seconds spent in nvcc by the last build in this process (None: the
# library was already on disk), and the compiler's output, which with
# ``-Xptxas -v`` lists each kernel's registers and shared memory
build_seconds = None
build_log = ""


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("cannot build the CUDA kernels: no CUDA toolkit found")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / "libmogp_kernels_{}.so".format(h.hexdigest()[:16])


def _build(path):
    global build_seconds, build_log
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(path.parent))
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp] + [
        str(s) for s in _sources() if s.suffix == ".cu"
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            "nvcc failed ({}):\n{}".format(proc.returncode, build_log)
        )
    os.replace(tmp, path)


def library():
    """The loaded kernel library, built first if it is not on disk."""
    global _lib
    if _lib is None:
        path = _library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        fn = lib.mogp_kernel_matrix
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mogp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mogp_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
