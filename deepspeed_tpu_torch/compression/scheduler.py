"""Compression scheduler (counterpart of
``deepspeed_tpu/compression/scheduler.py``; reference: compression/
scheduler.py, stepped at engine.py:1885): counts optimizer steps and
applies the Compressor's projection in place at each
gradient-accumulation boundary."""

from .compress import Compressor, NamedParams


class CompressionScheduler:
    def __init__(self, compressor: Compressor):
        self.compressor = compressor
        self.training_steps = 0

    def step(self, params: NamedParams):
        """Call once per optimizer step; projects ``params`` (keystr path,
        tensor pairs) in place and returns them."""
        self.training_steps += 1
        return self.compressor.apply(params, self.training_steps)
