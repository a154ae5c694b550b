"""mdvit_tpu_torch: the PyTorch and CUDA port of ``mdvit_tpu`` for NVIDIA Hopper.

The serving forward of MDViT (Sup domain gate, MLPFM debranches, eval mode,
``aux_mode="none"``) with hand-written CUDA kernels for factorized attention,
CPE and CRPE (``ops/``). Layouts follow the JAX package: NHWC images and
``(B, N, C)`` tokens. Parameter names follow the original torch MDViT
``state_dict``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""
import os

# The entry points run under torch.use_deterministic_algorithms(True)
# (device.deterministic), with which every cuBLAS call raises unless this is
# set; cuBLAS reads it when PyTorch creates its first handle, so it is set
# here, before anything of the port touches the card. A caller's own value
# stands.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from mdvit_tpu_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
