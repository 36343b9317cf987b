"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu`` for an
NVIDIA H100 (Hopper).

The port mirrors the JAX package's layout module for module; each TPU
(Pallas) kernel on a ported path is a hand-written CUDA kernel here,
built with ``nvcc`` at first use (``ops/op_builder.py``), with its plain
PyTorch version beside it. Entry points run on the card unless the
caller passes ``device="cpu"``. This package never imports JAX or
``deepspeed_tpu``.
"""

__version__ = "0.1.0"


def init_inference(model=None, **kwargs):
    """Create an inference engine (counterpart of
    ``deepspeed_tpu.init_inference``)."""
    from .inference.engine import InferenceEngine
    return InferenceEngine(model, **kwargs)
