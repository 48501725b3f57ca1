"""Where the Cholesky kernels spend their time, phase by phase, on the card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mogp_tpu_torch.tools.chol_phases [--csrc DIR]

It builds ``csrc/cholesky_blocked.cu`` and ``csrc/cholesky_batched.cu`` (or
those of ``DIR``, another checkout's ``mogp_tpu_torch/csrc``, to measure it
beside this one) a second time, with ``-DMOGP_PHASE_STAMPS``
(``csrc/chol_common.cuh``), into ``build/phases/``: thread 0 of block 0 of
each kernel then adds the
``clock64()`` cycles of each of its phases to a device counter.  Small C
entry points, written here, launch one step of the blocked factorization at
a time.  For float32 and float64 it prints, in microseconds at the SM clock
it measures, the phases of

* the diag step of K4 (variant 2) alone on a (1, 128, 128) matrix (load,
  the four 32 x 32 tiles, the rows below them, the trailing updates,
  store), and its time from CUDA events less that of the copy that resets
  its input;
* steps 1 and 2 of K3 (variant 1) and of K5 (variant 3) at the first panel
  of a (1, 4096, 4096) matrix (float32 also 8192): their time from CUDA
  events less that of the reset, the kernels they launch
  (``torch.profiler``), and block 0's phases: for K3 load, rank-1 steps
  (also in cycles per column) and store; for K5 load, then warp 0's chain
  of tiles (each tile's update, rank-1 factorization and Newton inverse,
  and its rows' product with the inverse), its waits for the other warps,
  and store;
* the rows step and both launches of the update at the first panel of a
  (1, 4096, 4096) matrix (float32 also 8192), with the update's rate over
  the flops of its full tiles;
* K2 at (960, 210, 210) (load, tiles, rows, trailing updates, store), and
  ``torch.linalg.cholesky_ex`` on the same batch.

Block 0's phases are one block's view: blocks that share an SM with others
take longer than alone.  Without a CUDA device it exits with an error.
"""

import argparse
import ctypes
import hashlib
import subprocess
import sys
import time
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parents[2]
_CSRC = _ROOT / "mogp_tpu_torch" / "csrc"
_OUT = _ROOT / "build" / "phases"

_BLOCKED = r'''
#include "%s/cholesky_blocked.cu"
template <typename T>
int diag(void* out, void* status, int n, int base, cudaStream_t s) {
  Steps<T, 2>::prepare();
  blk_diag32_kernel<T><<<1, Diag32<T>::kThreads, Steps<T, 2>::kDiagSmem, s>>>(
      (T*)out, (int*)status, n, base);
  return (int)cudaGetLastError();
}
template <typename T>
int rows(void* out, void* status, int n, int base, cudaStream_t s) {
  Steps<T, 2>::prepare();
  const int tiles = (n - base - kNB + kRowTile2 - 1) / kRowTile2;
  blk_rows32_kernel<T><<<tiles, kPanelThreads, Steps<T, 2>::kRowsSmem, s>>>(
      (T*)out, (int*)status, n, base, tiles);
  return (int)cudaGetLastError();
}
// Steps<T, V>::panel for one matrix.  Sources whose variant 3 still takes a
// scratch of tile inverses after status (two launches a panel) get inv, a
// (128, 16) tile of T; the overload without it is taken where it compiles.
template <typename S, typename T>
auto panel_of(T* o, int* st, T*, int n, int base, cudaStream_t s, int)
    -> decltype(S::panel(o, st, 1, n, base, s)) {
  return S::panel(o, st, 1, n, base, s);
}
template <typename S, typename T>
cudaError_t panel_of(T* o, int* st, T* inv, int n, int base, cudaStream_t s, long) {
  return S::panel(o, st, inv, 1, n, base, s);
}
template <typename T, int V>
int panel(void* o, void* st, void* inv, int n, int base, cudaStream_t s) {
  Steps<T, V>::prepare();
  return (int)panel_of<Steps<T, V>>((T*)o, (int*)st, (T*)inv, n, base, s, 0);
}
__global__ void clock_kernel(long long* o) {
  const long long c0 = clock64();
  unsigned long long g0, g1;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g0));
  long long c = c0;
  while (c - c0 < 200000000LL) c = clock64();
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g1));
  o[0] = c - c0;
  o[1] = (long long)(g1 - g0);
}
extern "C" {
int ph_reset() {
  long long z[64] = {0};
  return (int)cudaMemcpyToSymbol(mogp_phase_cycles, z, sizeof(z));
}
int ph_read(long long* h) {
  return (int)cudaMemcpyFromSymbol(h, mogp_phase_cycles, 64 * sizeof(long long));
}
int ph_diag(void* o, void* st, int n, int base, int dbl, void* s) {
  cudaStream_t cs = (cudaStream_t)s;
  return dbl ? diag<double>(o, st, n, base, cs) : diag<float>(o, st, n, base, cs);
}
int ph_rows(void* o, void* st, int n, int base, int dbl, void* s) {
  cudaStream_t cs = (cudaStream_t)s;
  return dbl ? rows<double>(o, st, n, base, cs) : rows<float>(o, st, n, base, cs);
}
int ph_panel(void* o, void* st, void* inv, int n, int base, int dbl, int v, void* s) {
  cudaStream_t cs = (cudaStream_t)s;
  if (dbl) {
    return v == 1 ? panel<double, 1>(o, st, inv, n, base, cs)
                  : panel<double, 3>(o, st, inv, n, base, cs);
  }
  return v == 1 ? panel<float, 1>(o, st, inv, n, base, cs)
                : panel<float, 3>(o, st, inv, n, base, cs);
}
int ph_update(void* o, void* st, int n, int base, int first, int dbl, void* s) {
  cudaStream_t cs = (cudaStream_t)s;
  if (dbl) {
    Steps<double, 2>::prepare();
    return (int)update<double>((double*)o, (int*)st, 1, n, base, first, cs);
  }
  Steps<float, 2>::prepare();
  return (int)update<float>((float*)o, (int*)st, 1, n, base, first, cs);
}
int ph_clock_ghz(double* ghz) {
  long long* d; long long h[2];
  cudaMalloc(&d, sizeof(h)); clock_kernel<<<1, 1>>>(d);
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost); cudaFree(d);
  *ghz = (double)h[0] / (double)h[1];
  return (int)cudaGetLastError();
}
}
'''

_BATCHED = r'''
#include "%s/cholesky_batched.cu"
extern "C" {
int ph_reset() {
  long long z[64] = {0};
  return (int)cudaMemcpyToSymbol(mogp_phase_cycles, z, sizeof(z));
}
int ph_read(long long* h) {
  return (int)cudaMemcpyFromSymbol(h, mogp_phase_cycles, 64 * sizeof(long long));
}
}
'''


def _build(csrc):
    from ..ops._build import NVCC_FLAGS, _nvcc

    dest = _OUT / hashlib.sha1(str(csrc).encode()).hexdigest()[:12]
    dest.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, text in (("blocked", _BLOCKED), ("batched", _BATCHED)):
        src = dest / "phases_{}.cu".format(name)
        src.write_text(text % csrc)
        cmd = [_nvcc(), *NVCC_FLAGS, "-DMOGP_PHASE_STAMPS", "-shared",
               "-o", str(dest / "libphases_{}.so".format(name)), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)))
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError("nvcc failed: {}\n{}".format(" ".join(cmd), out))
    libs = [ctypes.CDLL(str(dest / "libphases_{}.so".format(n))) for n in ("blocked", "batched")]
    V, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs:
        lib.ph_read.argtypes = [V]
    libs[0].ph_diag.argtypes = libs[0].ph_rows.argtypes = [V, V, I, I, I, V]
    libs[0].ph_panel.argtypes = [V, V, V, I, I, I, I, V]
    libs[0].ph_update.argtypes = [V, V, I, I, I, I, V]
    libs[0].ph_clock_ghz.argtypes = [V]
    libs[1].mogp_cholesky_batched.argtypes = [V, V, I, I, I, V]
    return libs


def _check(err):
    if err:
        raise RuntimeError("CUDA error {}".format(err))


def _us(fn, reps=20):
    """Mean microseconds of ``fn()`` from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def _spd(B, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(B, n, n, generator=g, dtype=torch.float64, device="cuda")
    return (X @ X.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64, device="cuda")).to(dtype)


def _kernels_launched(fn):
    """Names of the device kernels ``fn()`` launches, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]


def _panel(blocked, ghz, stream, dtype, n, reps, variant):
    """Steps 1 and 2 of K3 (``variant`` 1) or K5 (3) at the first panel of a
    (1, n, n) matrix."""
    name, dbl = str(dtype)[6:], int(dtype == torch.float64)
    A = torch.tril(_spd(1, n, dtype, 3))
    out, status = A.clone(), torch.zeros(1, dtype=torch.int32, device="cuda")
    inv = torch.empty(128, 16, dtype=dtype, device="cuda")  # for sources that take it

    def reset():
        out.copy_(A)
        status.zero_()

    def panel():
        _check(blocked.ph_panel(out.data_ptr(), status.data_ptr(), inv.data_ptr(), n, 0, dbl,
                                variant, stream))

    reset()
    names = _kernels_launched(panel)
    _check(blocked.ph_reset())
    t_panel, t_reset = _us(lambda: (reset(), panel()), reps), _us(reset, reps)
    h = (ctypes.c_longlong * 64)()
    _check(blocked.ph_read(ctypes.addressof(h)))
    calls = reps + 1

    def us(i):
        return h[i] / calls / ghz / 1e3

    head = "{} n={} K{} panel (steps 1-2 at base 0): {:.3f} us; {} launch(es): {}; block 0 (us " \
           "per call): ".format(name, n, 2 + variant, t_panel - t_reset, len(names), names)
    if variant == 1:
        steps = h[6] + h[12] + h[13]  # the flush moves the lap counter, so 6 is the rest
        print(head + "load {:.3f} rank-1 steps {:.3f} (warp 0's work {:.3f}, barrier waits "
              "{:.3f}) store {:.3f}; {:.1f} cycles per column".format(
                  us(5), steps / calls / ghz / 1e3, us(12), us(13), us(7), steps / calls / 128))
    else:
        print(head + "load {:.3f}; warp 0's chain of tiles: updates {:.3f} factorizations {:.3f} "
              "Newton inverses {:.3f} products M X^T {:.3f}; waits for the other warps {:.3f}; "
              "store {:.3f}; {:.1f} cycles per tile factorization, {:.1f} per inverse".format(
                  us(19), us(25), us(24), us(20), us(21), us(22), us(23),
                  h[24] / calls / 8, h[20] / calls / 8))
    if int(status.item()) != 0:
        raise RuntimeError("K{}'s panel reported a bad pivot on an SPD matrix".format(2 + variant))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=_CSRC,
                    help="the kernel sources to build (default: this checkout's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chol_phases: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    blocked, batched = _build(args.csrc.resolve())
    ghz = ctypes.c_double()
    _check(blocked.ph_clock_ghz(ctypes.byref(ghz)))
    ghz = ghz.value
    print("chol_phases: {} ({} s to build from {}); SM clock {} GHz".format(
        torch.cuda.get_device_name(0), time.perf_counter() - t0, args.csrc, ghz))
    stream = torch.cuda.current_stream().cuda_stream
    reps = 20

    def phases(lib, slots, calls):
        h = (ctypes.c_longlong * 64)()
        _check(lib.ph_read(ctypes.addressof(h)))
        return " ".join("{} {:.3f}".format(name, h[i] / calls / ghz / 1e3) for i, name in slots)

    for dtype in (torch.float32, torch.float64):
        name, dbl = str(dtype)[6:], int(dtype == torch.float64)
        A = torch.tril(_spd(1, 128, dtype, 0))
        out, status = A.clone(), torch.zeros(1, dtype=torch.int32, device="cuda")

        def reset():
            out.copy_(A)
            status.zero_()

        def diag():
            reset()
            _check(blocked.ph_diag(out.data_ptr(), status.data_ptr(), 128, 0, dbl, stream))

        _check(blocked.ph_reset())
        t_diag, t_reset = _us(diag, reps), _us(reset, reps)
        print("{} diag step alone (1, 128): {:.3f} us; block 0 (us per call): {}".format(
            name, t_diag - t_reset, phases(blocked, [(0, "load"), (1, "tiles"), (2, "rows"),
                                                     (3, "update"), (4, "store")], reps + 1)))
        for n in ((4096, 8192) if dtype == torch.float32 else (4096,)):
            for variant in (1, 3):
                _panel(blocked, ghz, stream, dtype, n, reps, variant)
            A = torch.tril(_spd(1, n, dtype, 1))
            out = A.clone()
            _check(blocked.ph_diag(out.data_ptr(), status.data_ptr(), n, 0, dbl, stream))
            state = out.clone()

            def rows():
                out.copy_(state)
                _check(blocked.ph_rows(out.data_ptr(), status.data_ptr(), n, 0, dbl, stream))

            _check(blocked.ph_reset())
            t_rows, t_copy = _us(rows, reps), _us(lambda: out.copy_(state), reps)
            print("{} n={} rows step ({} blocks): {:.3f} us; block 0 (us per call): {}".format(
                name, n, (n - 128 + 63) // 64, t_rows - t_copy,
                phases(blocked, [(8, "load"), (9, "products"), (10, "substitutions"),
                                 (11, "store")], reps + 1)))
            nt = (n - 128 + 127) // 128
            for first, tiles, rows_per in ((1, (n - 128 + 31) // 32, 32),
                                           (0, nt * (nt - 1) // 2, 128)):
                _check(blocked.ph_reset())
                t = _us(lambda: _check(blocked.ph_update(out.data_ptr(), status.data_ptr(), n, 0,
                                                         first, dbl, stream)), reps)
                print("{} n={} update, {} ({} tiles of {} x 128): {:.3f} us = {:.3f} TFLOP/s; "
                      "block 0 (us per call): {}".format(
                          name, n, "first column block" if first else "the rest", tiles,
                          rows_per, t, tiles * rows_per * 128 * 128 * 2 / t / 1e6,
                          phases(blocked, [(16, "stage waits"), (17, "products"),
                                           (18, "epilogue")], reps + 1)))
            del A, out, state
            torch.cuda.empty_cache()
        A = _spd(960, 210, dtype, 2)
        L = torch.empty_like(A)
        _check(batched.ph_reset())
        t = _us(lambda: _check(batched.mogp_cholesky_batched(A.data_ptr(), L.data_ptr(), 960, 210,
                                                            dbl, stream)), reps)
        t_ex = _us(lambda: torch.linalg.cholesky_ex(A), reps)
        print("{} K2 (960, 210, 210): {:.3f} us, cholesky_ex {:.3f} us; block 0 (us per call): "
              "{}".format(name, t, t_ex, phases(batched, [(0, "load"), (1, "tile"), (2, "rows"),
                                                          (3, "update"), (4, "store")],
                                                reps + 1)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
