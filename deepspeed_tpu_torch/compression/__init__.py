"""Compression-aware training (counterpart of
``deepspeed_tpu/compression``): weight fake-quantization on the quantize
kernels and the pruning masks, as in-place parameter projections."""

from .compress import (Compressor, fake_quantize, init_compression,
                       keystr, param_paths, redundancy_clean)
from .config import CompressionConfig
from .scheduler import CompressionScheduler

__all__ = ["Compressor", "fake_quantize", "init_compression", "keystr",
           "param_paths", "redundancy_clean", "CompressionConfig",
           "CompressionScheduler"]
