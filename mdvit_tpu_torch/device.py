"""Device choice and fp32 precision for the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when a CUDA
    device is asked for (or defaulted to) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """fp32 convolutions (cuDNN) and matrix products (cuBLAS) in full fp32
    inside, as the reference computes them; the caller's flags come back on
    exit. PyTorch's default lets cuDNN round fp32 conv inputs to TF32."""
    conv_tf32 = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        torch.set_float32_matmul_precision(matmul)
