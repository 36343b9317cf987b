"""Weight-only int8 quantization for serving (counterpart of
``deepspeed_tpu/module_inject/module_quantize.py``: ``_quantize_array``
:31, ``quantize_param_tree`` :45, ``quantize_for_serving`` :80 in its
direct mode, ``quantized_nbytes`` :145).

Every ``QDense`` kernel [in, out] of at least ``min_size`` elements is
stored int8 with symmetric per-output-channel scales [1, out] (reduced
over the contraction dim), and the layer's product runs through the
``wo_int8_matmul`` kernels, which read the int8 bytes directly. Only
matmul kernels quantize (the JAX ``only_kernels=True`` mode, which
``GPT`` selects by declaring ``supports_quantized_kernels``):
embeddings, biases and LayerNorm stay as they are, so the tied LM head
stays a dense GEMM. The transform mode of the JAX package (any module,
dequantized per step) comes with the checkpoint-injection slice.
"""

import copy
from typing import Dict

import torch

from ..models.layers import QDense


def _quantize_array(w: torch.Tensor):
    """Symmetric per-channel int8 of a kernel ``[..., in, out]``: ``scale
    = max(max|w| / 127, 1e-12)`` reduced over the contraction dim (the
    one before the last) with keepdim, ``q = clip(round(w / scale), -127,
    127)`` — a true division and round-half-even, bit for bit the JAX
    rule. Returns (int8 q, fp32 scale [..., 1, out])."""
    w32 = w.detach().float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def is_quantized(module: torch.nn.Module) -> bool:
    """True when any ``QDense`` of ``module`` holds int8 weights."""
    return any(isinstance(m, QDense) and m.quantized
               for m in module.modules())


def quantize_param_tree(module: torch.nn.Module, *,
                        min_size: int = 4096) -> torch.nn.Module:
    """Quantize, in place, every ``QDense`` kernel of at least
    ``min_size`` elements; returns ``module``. Layers already int8 are
    left as they are."""
    for m in module.modules():
        if (isinstance(m, QDense) and not m.quantized
                and m.kernel.numel() >= min_size):
            m.set_int8(*_quantize_array(m.kernel))
    return module


def quantize_for_serving(module: torch.nn.Module, *,
                         min_size: int = 4096) -> torch.nn.Module:
    """The weight-only int8 serving step shared by
    ``init_inference(quantize_weights=True)`` and the serving engine's
    ``serving.quantize.weights``: returns an int8 copy of ``module`` (the
    caller's module is not touched), or ``module`` itself when it is
    already quantized (quantizing twice would compound the rounding)."""
    if is_quantized(module):
        return module
    if not getattr(type(module), "supports_quantized_kernels", False):
        raise NotImplementedError(
            f"int8 serving of {type(module).__name__}: modules without "
            "QDense kernels (the per-step dequantizing transform mode) "
            "come with the checkpoint-injection slice of the port")
    return quantize_param_tree(copy.deepcopy(module), min_size=min_size)


def adopt_int8_layout(module: torch.nn.Module, state_dict) -> torch.nn.Module:
    """Give every ``QDense`` whose ``<name>.q`` is in ``state_dict`` the
    int8 layout (zeroed buffers of the stored shapes), so that
    ``load_state_dict`` takes a quantized state dict (for example
    ``models.convert.params_from_jax`` of a JAX-quantized tree)."""
    for name, m in module.named_modules():
        key = f"{name}.q" if name else "q"
        if isinstance(m, QDense) and key in state_dict and not m.quantized:
            q = state_dict[key]
            m.set_int8(torch.zeros(q.shape, dtype=torch.int8,
                                   device=m.kernel.device),
                       torch.zeros((1, q.shape[-1]), device=m.kernel.device))
    return module


def quantized_nbytes(module: torch.nn.Module) -> Dict[str, int]:
    """{'quantized': bytes, 'dense_equivalent': bytes}: int8 weights
    count their q bytes plus 4 bytes a scale, against 2 bytes a weight
    dense; every other parameter counts its own bytes in both."""
    qb = db = 0
    for m in module.modules():
        if isinstance(m, QDense) and m.quantized:
            qb += m.q.numel() + m.scale.numel() * 4
            db += m.q.numel() * 2
    for p in module.parameters():
        qb += p.numel() * p.element_size()
        db += p.numel() * p.element_size()
    return {"quantized": int(qb), "dense_equivalent": int(db)}
