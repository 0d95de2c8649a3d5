"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present (there is no quiet fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           f"available; pass the CPU explicitly to run there")
    return dev


def set_numerics() -> None:
    """Full-fp32 matrix products, as the JAX encoder runs (nn/gcmc.py:116-117
    of the JAX package): TF32 off for matmuls and for cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def as_tensor(x, dtype, device=None) -> torch.Tensor:
    """``x`` (numpy, list or tensor) as a ``dtype`` tensor: on ``device``
    when given, else where a tensor already lies, else on the card."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device if device is not None
                    else x.device)
    return torch.as_tensor(np.asarray(x)).to(
        dtype=dtype, device=resolve_device(device if device is not None
                                           else "cuda"))
