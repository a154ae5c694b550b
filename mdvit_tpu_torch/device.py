"""Device choice, fp32 precision and determinism for the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.utils.deterministic


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


@contextlib.contextmanager
def deterministic() -> Iterator[None]:
    """Ops that give the same bits on every run inside, as XLA's do on a TPU:
    ``torch.use_deterministic_algorithms(True)`` (an op with no deterministic
    CUDA implementation raises), cuDNN's deterministic algorithms and no
    autotuning; the caller's flags come back on exit. Deterministic cuBLAS
    needs ``CUBLAS_WORKSPACE_CONFIG``, which importing ``mdvit_tpu_torch``
    sets. Uninitialised memory is not filled with NaN: every op of the port
    writes what it allocates, and a fill is one more device pass a tensor."""
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        torch.backends.cudnn.deterministic = flags[2]
        torch.backends.cudnn.benchmark = flags[3]
        torch.utils.deterministic.fill_uninitialized_memory = flags[4]
