"""Device and dtype policy for the PyTorch port.

Counterpart of ``mogp_tpu/config.py:51-57``.  Every constructor in the
port takes ``device=`` and ``dtype=``.  The device defaults to the card
(``"cuda"``): the port runs on the CPU only where the caller asks for it
(``device="cpu"``, as the tests do), and when there is no card a default
or explicit ``"cuda"`` raises; nothing falls back to the CPU.  When
``dtype`` is not given it follows the device:

* CUDA: float32, the production dtype of the JAX package;
* CPU: float64, where the parity tests against ``mogp_tpu`` run.

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
    """``torch.device`` for a device argument; ``None`` means the card
    (``"cuda"``).

    Raises instead of falling back to the CPU when CUDA is asked for, or
    defaulted to, and no CUDA device is available.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {!r} requested but torch.cuda.is_available() is False".format(
                str(device)
            )
        )
    return device


def default_dtype(device=None):
    """float32 on CUDA (the default device), float64 on the CPU."""
    return torch.float32 if resolve_device(device).type == "cuda" else torch.float64
