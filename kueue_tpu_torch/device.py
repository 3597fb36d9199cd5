"""Device selection: entry points run on the card unless the caller
names another device."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The card. Raises when no CUDA device is visible: nothing falls
    back to the CPU unless the caller asks for it with device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "kueue_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions of the kernels")
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means default_device()."""
    return default_device() if device is None else torch.device(device)
