"""The port's entry points run on "cuda" unless the caller names a
device; without a card that is an error, never a silent CPU run."""

from __future__ import annotations

import torch


def resolve_device(device, caller: str) -> torch.device:
    """`device` as a torch.device; None means "cuda", and raises a
    RuntimeError naming CUDA when there is no CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{caller}: no CUDA device; it runs on 'cuda' by default "
                f"(pass device='cpu' to run it on the CPU)")
        device = "cuda"
    return torch.device(device)
