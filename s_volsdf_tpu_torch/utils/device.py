"""The port's entry points run on "cuda" unless the caller names a
device; without a card that is an error, never a silent CPU run. Its
float32 work runs in full float32 there (`full_float32`)."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products and convolutions in full float32 on the
    card while the block runs: TF32 off for cuBLAS
    (`torch.backends.cuda.matmul.allow_tf32`) and for cuDNN
    (`torch.backends.cudnn.allow_tf32`, True by default), both set back
    on exit. The JAX package's float32 paths are float32; TF32 keeps
    about three decimal digits. bfloat16 products are untouched."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def card_name(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, for
    a CUDA device (every number timed on it belongs beside them); the
    device type ("cpu") otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    import subprocess
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return lines[min(dev.index or 0, len(lines) - 1)]
