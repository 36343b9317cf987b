"""Kernels of the port (hand-written CUDA for Hopper) and their plain
PyTorch versions; counterpart of ``deepspeed_tpu/ops``."""

from .decode_attention import decode_attention  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
