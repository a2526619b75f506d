"""Device resolution for the port's entry points.

The default device is the card.  Without one, resolving the default raises:
the port never falls back to the CPU on its own.  The CPU runs the plain
PyTorch versions of the kernels, and only when a caller asks for it.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def ieee_f32() -> None:
    """Keep float32 products in full IEEE float32 on the card.

    TF32 keeps about three decimal digits, which the parity tolerances
    (2e-6 on attention) cannot absorb.  Matmuls default to full float32 in
    PyTorch, but cuDNN convolutions default to TF32; set both explicitly.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for and
    none is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        ieee_f32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
