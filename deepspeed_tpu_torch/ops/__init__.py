"""Kernels of the port (hand-written CUDA for Hopper) and their plain
PyTorch versions; counterpart of ``deepspeed_tpu/ops``."""

from .decode_attention import decode_attention  # noqa: F401
from .flash_attention import flash_attention, flash_attention_bwd  # noqa: F401
from .fused_adam import fused_adam  # noqa: F401
