#!/usr/bin/env python3
"""mogp_tpu's own float32-vs-float64 gap on the CPU for the quantities that
``chip_smoke.py`` phases 9b and 9c hold the port to.

Run from the root of a checkout (JAX on the CPU, no card needed):

    python3 scripts/gkdr_reference_gap.py

9b: the cross-validated L1 losses of ``benchmarks/benchmark_kdr_GP.py``
(``chip_smoke.kdr_bench_losses``) for K = 1, 2, 4.  9c: ``kernel_deriv``
and ``kernel_hessian`` of the five kernels at phase 3's inputs, ``K(x,
x)`` at ``(210, 210)`` with 14 correlation lengths (``chip_smoke.
deriv_problem``).  Each is computed by ``mogp_tpu`` twice, in a child
process with JAX's x64 mode off (float32) and one with it on (float64);
the script prints the gaps (each K's loss relative, the derivatives as the
largest difference over the largest entry) and ten times them, the limits
phases 9b and 9c state.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))


def _child(x64, out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    sys.path.insert(0, ROOT)
    import mogp_tpu
    from mogp_tpu.ops.kernels import get_kernel
    from chip_smoke import KERNEL_NAMES, deriv_problem, kdr_bench_losses

    arrays = {"losses": np.array(kdr_bench_losses(mogp_tpu))}
    for name in KERNEL_NAMES:
        kernel = get_kernel(name)
        x, theta = deriv_problem(kernel)
        arrays[name + "_deriv"] = np.asarray(kernel.kernel_deriv(x, x, theta), np.float64)
        arrays[name + "_hessian"] = np.asarray(kernel.kernel_hessian(x, x, theta), np.float64)
    np.savez(out, **arrays)


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        _child(sys.argv[2] == "64", sys.argv[3])
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu", MOGP_TPU_DISABLE_PALLAS="1")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for bits in ("32", "64"):
            out = os.path.join(tmp, bits + ".npz")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--child", bits, out],
                           check=True, env=env, cwd=ROOT)
            with np.load(out) as f:
                res[bits] = dict(f)
    a, b = res["32"], res["64"]
    gaps = {"losses_rel": (np.abs(a["losses"] - b["losses"]) / np.abs(b["losses"])).tolist()}
    for key in sorted(k for k in b if k != "losses"):
        gaps[key] = float(np.max(np.abs(a[key] - b[key])) / np.max(np.abs(b[key])))
    print("mogp_tpu float32 vs float64 on the CPU, phases 9b and 9c's problems:")
    print("  losses float32 {}, float64 {}".format(a["losses"].tolist(), b["losses"].tolist()))
    print("  gaps:", json.dumps(gaps))
    print("  limits (ten times):", json.dumps({k: (10 * np.asarray(v)).tolist()
                                               for k, v in gaps.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
