"""Weight-only int8 quantization for serving (counterpart of
``deepspeed_tpu/module_inject/module_quantize.py``: ``_quantize_array``
:31, ``quantize_param_tree`` :45, ``quantize_for_serving`` :80,
``dequantize_param_tree`` :133, ``quantized_nbytes`` :145).

Direct mode (modules declaring ``supports_quantized_kernels``: ``GPT``,
``BertEncoder``, ``BertForPreTraining``): every ``QDense`` kernel [in,
out] of at least ``min_size`` elements is stored int8 with symmetric
per-output-channel scales [1, out] (reduced over the contraction dim),
and the layer's product runs through the ``wo_int8_matmul`` kernels,
which read the int8 bytes directly. Only matmul kernels quantize (the
JAX ``only_kernels=True`` mode): embeddings, biases and LayerNorm stay as
they are, so a tied LM head stays a dense GEMM.

Transform mode (any other module): every floating parameter of at least
two dims and ``min_size`` elements is replaced by int8 buffers
``<name>_q`` and ``<name>_scale`` (the same rule, the last dim taken as
the output channels), and a forward pre-hook dequantizes them,
``(q * scale)`` in fp32 cast to the parameter's dtype, in front of each
step; the dense copy is dropped after the step, so between steps the
module holds the int8 bytes alone.
"""

import copy
from typing import Dict

import torch
from torch import nn

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
    """True when any ``QDense`` of ``module`` holds int8 weights, or any
    submodule holds transform-mode int8 parameters."""
    return any(isinstance(m, QDense) and m.quantized
               or getattr(m, "int8_params", None)
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
    already quantized (quantizing twice would compound the rounding).
    Direct mode for modules declaring ``supports_quantized_kernels``,
    transform mode for the rest."""
    if is_quantized(module):
        return module
    if getattr(type(module), "supports_quantized_kernels", False):
        return quantize_param_tree(copy.deepcopy(module), min_size=min_size)
    return quantize_transform(copy.deepcopy(module), min_size=min_size)


def quantize_transform(module: nn.Module, *,
                       min_size: int = 4096) -> nn.Module:
    """Transform mode, in place: every floating parameter with at least
    two dims and ``min_size`` elements becomes int8 buffers ``<name>_q``
    and ``<name>_scale``, dequantized to its own dtype in front of each
    forward of its module (``dequantize_params``) and dropped after it;
    returns ``module``."""
    for m in module.modules():
        int8 = {}
        for name, p in list(m.named_parameters(recurse=False)):
            if (p.is_floating_point() and p.dim() >= 2
                    and p.numel() >= min_size):
                q, scale = _quantize_array(p)
                del m._parameters[name]
                m.register_buffer(name + "_q", q)
                m.register_buffer(name + "_scale", scale)
                int8[name] = p.dtype
        if int8:
            m.int8_params = int8
            m.int8_hooks = (m.register_forward_pre_hook(dequantize_params),
                            m.register_forward_hook(_drop_dequantized))
    return module


def dequantize_params(m: nn.Module, args=None):
    """Set each transform-mode parameter of ``m`` to its dense value,
    ``(q * scale)`` in fp32 cast to its dtype (JAX ``dequantize_param_tree``
    :133)."""
    for name, dt in m.int8_params.items():
        q, scale = getattr(m, name + "_q"), getattr(m, name + "_scale")
        object.__setattr__(m, name, (q.float() * scale).to(dt))


def _drop_dequantized(m, args, out):
    for name in m.int8_params:
        object.__delattr__(m, name)


def dequantize_param_tree(module: nn.Module, dtype=None) -> nn.Module:
    """Dense weights again, in place: every int8 ``QDense`` kernel and
    every transform-mode parameter becomes ``(q * scale)`` in fp32, cast
    to ``dtype`` (default: fp32 for a ``QDense`` kernel, the parameter's
    own dtype in transform mode); returns ``module``."""
    for m in module.modules():
        if isinstance(m, QDense) and m.quantized:
            w = (m.q.float() * m.scale).to(dtype or torch.float32)
            m.q = m.scale = None
            m.kernel = nn.Parameter(w)
        int8 = getattr(m, "int8_params", None)
        if int8:
            for name, dt in int8.items():
                w = getattr(m, name + "_q").float() * getattr(
                    m, name + "_scale")
                delattr(m, name + "_q")
                delattr(m, name + "_scale")
                m.register_parameter(name, nn.Parameter(w.to(dtype or dt)))
            for handle in m.int8_hooks:
                handle.remove()
            del m.int8_params, m.int8_hooks
    return module


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
        for name in getattr(m, "int8_params", ()):
            q = getattr(m, name + "_q")
            qb += q.numel() + getattr(m, name + "_scale").numel() * 4
            db += q.numel() * 2
    for p in module.parameters():
        qb += p.numel() * p.element_size()
        db += p.numel() * p.element_size()
    return {"quantized": int(qb), "dense_equivalent": int(db)}
