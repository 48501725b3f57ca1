"""Build the port's CUDA sources into a shared library at first use.

``nvcc`` compiles each ``mogp_tpu_torch/csrc/*.cu`` into an object, all
sources at once in parallel processes, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library goes into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``); its file name carries a hash of the sources and flags, so
an edited source is rebuilt and a stale library is never loaded.  The
build works in a temporary directory and renames the library into place,
so concurrent first uses do not collide.

Nothing here runs at import time: the CPU-only test environment has no
``nvcc``, and only a launch on a CUDA tensor calls :func:`library`.

A failed build, and a failed launch in any wrapper, raise
:class:`KernelError`, a ``RuntimeError`` that callers which retry on
numerical failures (``uq/sequential_design.py``) let through.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

# guards every wrapper's launch counter; it lives with the program's recorder
# of spans and counters, which it guards too
from ..utils.metrics import count_lock

__all__ = ["library", "KernelError", "NVCC_FLAGS", "count_lock"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib = None
_lib_lock = threading.Lock()


class KernelError(RuntimeError):
    """The CUDA kernels could not be built, or a launch failed."""

# seconds spent in nvcc by the last build in this process (None: the
# library was already on disk), and the compiler's output, which with
# ``-Xptxas -v`` lists each kernel's registers and shared memory
build_seconds = None
build_log = ""


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError("cannot build the CUDA kernels: no CUDA toolkit found")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / "libmogp_kernels_{}.so".format(h.hexdigest()[:16])


def _run(cmds):
    """Run the commands in parallel; raise with the output of a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise KernelError("nvcc failed ({}): {}\n{}".format(
                proc.returncode, " ".join(cmd), out))
    return "".join(outs)


def _build(path):
    global build_seconds, build_log
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=str(path.parent))
    try:
        nvcc = _nvcc()
        cus = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp, s.stem + ".o") for s in cus]
        t0 = time.perf_counter()
        log = _run([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o] for s, o in zip(cus, objs)])
        lib = os.path.join(tmp, path.name)
        log += _run([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                      "-o", lib, *objs]])
        build_seconds = time.perf_counter() - t0
        build_log = log
        os.replace(lib, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library():
    """The loaded kernel library, built first if it is not on disk."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load()
    return _lib


def _load():
    path = _library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    fn = lib.mogp_kernel_matrix
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mogp_predict_fused
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mogp_predict_fused_occupancy
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    fn = lib.mogp_predict_fused_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    fn = lib.mogp_cholesky_batched
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mogp_cholesky_blocked
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mogp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mogp_cuda_error_string.restype = ctypes.c_char_p
    return lib
