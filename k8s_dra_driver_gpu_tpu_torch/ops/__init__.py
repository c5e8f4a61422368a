"""CUDA compute ops: attention and the hand-written Hopper kernels."""

from __future__ import annotations

import torch


def is_cuda_backend() -> bool:
    """True when a CUDA device of compute capability 9.x (Hopper) is
    present: the target the kernels in ``csrc/`` are built for."""
    return torch.cuda.is_available() and \
        torch.cuda.get_device_capability()[0] == 9


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card by default.

    Raises when a CUDA device is asked for (or defaulted to) and none is
    present; running on the host takes an explicit ``"cpu"``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return device
