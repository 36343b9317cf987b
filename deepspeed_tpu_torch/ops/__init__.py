"""Kernels of the port (hand-written CUDA for Hopper) and their plain
PyTorch versions; counterpart of ``deepspeed_tpu/ops``."""

from .block_sparse_attention import block_sparse_attention  # noqa: F401
from .decode_attention import decode_attention  # noqa: F401
from .dropout import dropout_apply  # noqa: F401
from .flash_attention import flash_attention, flash_attention_bwd  # noqa: F401
from .fused_adam import fused_adam  # noqa: F401
from .fused_lamb import fused_lamb  # noqa: F401
from .layernorm import fused_layer_norm  # noqa: F401
from .paged_attention import paged_attention  # noqa: F401
from .quantizer import dequantize, quantize  # noqa: F401
from .wo_int8_matmul import wo_int8_matmul  # noqa: F401
