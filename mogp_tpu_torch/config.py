"""Device and dtype policy for the PyTorch port.

Counterpart of ``mogp_tpu/config.py:51-57``.  Every constructor in the
port takes an explicit ``device=`` and ``dtype=``; when ``dtype`` is not
given it follows the device:

* CPU: float64, where the parity tests against ``mogp_tpu`` run;
* CUDA: float32, the production dtype of the JAX package.

Precision policy: TF32 is switched off for matmuls and cuDNN when this
module is imported.  On the TPU, bf16 matmul passes destroyed the
conditioning of the kernel matrix (``mogp_tpu/ops/kernels.py:95-101``,
``mogp_tpu/ops/linalg.py:30-39``); TF32 keeps the same ten mantissa bits
and is the same hazard on an NVIDIA card.  There is no switch back.

There is no environment variable that routes work to the plain PyTorch
versions of the kernels: a CUDA tensor gets the CUDA kernel or an error.
"""

import torch

__all__ = ["default_dtype", "resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None):
    """``torch.device`` for a device argument; ``None`` means the CPU.

    Raises instead of falling back to the CPU when CUDA is asked for and
    no CUDA device is available.
    """
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {!r} requested but torch.cuda.is_available() is False".format(
                str(device)
            )
        )
    return device


def default_dtype(device=None):
    """float64 on the CPU, float32 on CUDA."""
    return torch.float32 if resolve_device(device).type == "cuda" else torch.float64
