"""Where K1 and the fused prediction spend their time, by taking parts away.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mogp_tpu_torch.tools.km_variants

It builds ``mogp_tpu_torch/csrc/kernel_matrix.cu`` as it is and a few
copies of it with one part of a kernel removed, each into its own shared
library under ``build/km_variants/`` (one ``nvcc`` each, all at once), and
times every library's K1 at (64, 210, 4864, 14) float32 and its fused
prediction at the same shape (M = 0, with and without variances), on the
same inputs, in turns (each library, then all again in reverse order; CUDA
events).  The copies compute wrong results on purpose: only their times
mean anything.  They are

* ``k1_nostore``: K1 without its stores (the build of the tiles alone);
* ``k1_nobuild``: K1 without the build (the stores alone);
* ``fused_nolook``: the fused kernel without the part of warps 0-1 in the
  substitution (the look-ahead update of panel p + 1 and its diagonal
  solve);
* ``fused_nodiag``: without the diagonal solves alone;
* ``fused_nobulk``: without the bulk of the trailing update (warps 2-7);
* ``fused_nostrip``: without loading the factor's strips after the first
  two.

It prints one line per library and kernel: the times in ms, then the card's
name and power limit.  Without a CUDA device it exits with an error.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(_ROOT))

from chip_smoke import K1_SHAPE, fused_problem, time_ms  # noqa: E402
from mogp_tpu_torch.ops._build import NVCC_FLAGS, _nvcc  # noqa: E402

_SRC = _ROOT / "mogp_tpu_torch" / "csrc" / "kernel_matrix.cu"
_OUT = _ROOT / "build" / "km_variants"

# (text in the source, its replacement) per variant
VARIANTS = {
    "k1_nostore": [("  for (int k = threadIdx.x; k < rows * kChunks; k += kThreads) {",
                    "  if (rows < 0) for (int k = threadIdx.x; k < rows * kChunks; "
                    "k += kThreads) {")],
    "k1_nobuild": [("  build_tile<T, Base, kK1Cols>(x1", "  if (n < 0) build_tile<T, Base, kK1Cols>(x1")],
    "fused_nolook": [("    if (t < kQ) {\n      const T* next", "    if (t < 0) {\n      const T* next")],
    "fused_nodiag": [("      diag_solve(v, next, bw, ss);", "")],
    "fused_nobulk": [("    } else if (q0 + kPanel < n) {", "    } else if (n < 0) {")],
    "fused_nostrip": [("      load_strip(Lk_lane, n, ldl, q0 + kPanel,",
                       "      if (n < 0) load_strip(Lk_lane, n, ldl, q0 + kPanel,")],
}


def build():
    """Compile the source and its variants; returns ``{name: CDLL}``."""
    _OUT.mkdir(parents=True, exist_ok=True)
    src = _SRC.read_text()
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, edits in [("base", [])] + list(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError("variant {}: the source no longer has {!r} once".format(
                    name, old))
            text = text.replace(old, new)
        cu = _OUT / (name + ".cu")
        cu.write_text(text)
        procs[name] = subprocess.Popen([_nvcc(), *flags, "-shared", "-o",
                                        str(_OUT / (name + ".so")), str(cu)])
    if any(p.wait() != 0 for p in procs.values()):
        raise RuntimeError("nvcc failed")
    libs = {}
    for name in procs:
        lib = ctypes.CDLL(str(_OUT / (name + ".so")))
        lib.mogp_kernel_matrix.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.mogp_predict_fused.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print("km_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build()
    L, n, m, D = K1_SHAPE
    args, _ = fused_problem(K1_SHAPE, 0, "sqexp", 7, torch.float32)
    ldl = -(-n // 4) * 4  # the factor's rows padded to 16 bytes, as the wrapper does
    args[4] = torch.nn.functional.pad(args[4], (0, ldl - n))
    ptrs = (ctypes.c_void_p * 11)(*[t.data_ptr() for t in args])
    out = torch.empty(L, n, m, device="cuda")
    mu, var = torch.empty(L, m, device="cuda"), torch.empty(L, m, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def k1(lib):
        if lib.mogp_kernel_matrix(*[a.data_ptr() for a in args[:4]], out.data_ptr(),
                                  L, n, m, D, 0, 0, stream):
            raise RuntimeError("K1 launch failed")

    def fused(lib, unc):
        if lib.mogp_predict_fused(ptrs, mu.data_ptr(), var.data_ptr(), L, n, ldl, m, D, 0, unc,
                                  0, 0, stream):
            raise RuntimeError("fused launch failed")

    times = {}
    names = list(libs)
    for name in names + names[::-1]:
        lib = libs[name]
        if not name.startswith("fused"):
            times.setdefault((name, "k1"), []).append(time_ms(lambda: k1(lib)))
        if not name.startswith("k1"):
            for unc, label in ((1, "fused"), (0, "fused_nounc")):
                times.setdefault((name, label), []).append(
                    time_ms(lambda: fused(lib, unc)))
    for (name, kernel), ms in times.items():
        print("km_variants: {} {} {} ms".format(name, kernel, ms))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
