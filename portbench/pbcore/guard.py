"""What a run states about where it ran, and what it must not have loaded."""

import subprocess
import sys

# the JAX package and JAX itself, by whole top-level module name: the port's
# name begins with the JAX package's, so a prefix would be wrong
FORBIDDEN = ("jax", "jaxlib", "flax", "mogp_tpu")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def power_limit_w(index=0):
    """The card's power limit in watts as ``nvidia-smi`` reads it, or
    ``None`` where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(count, peak_bytes):
    """The result's ``device`` entry for ``count`` cards."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(count),
            "memory_peak_bytes": int(peak_bytes), "power_limit_w": power_limit_w(0)}
