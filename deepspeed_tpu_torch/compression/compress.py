"""Compression-aware training as parameter projections (counterpart of
``deepspeed_tpu/compression/compress.py``).

As in the JAX package, quantization-aware training and pruning are a
projection of the parameters at the gradient-accumulation boundary (the
straight-through estimator is "project after the step"): ``fake_quantize``
snaps matched weights to their bits-wide grid, the masks prune by
magnitude, and ``redundancy_clean`` bakes the final projection in. The
port projects the fp32 master weights in place (``Tensor.copy_``), so the
optimizer's tables keep pointing at the same storage.

``fake_quantize`` runs on the quantize and dequantize kernels
(``ops.quantizer``; plain versions on the CPU): the per-channel groups run
along the last axis, made contiguous by a transpose, and a 1-D leaf (or
``per_channel=False``) is one group, as the JAX function reduces over
``axis=None``. The masks are plain torch, as the JAX ones are jnp.

Module patterns are path substrings (``_matches`` :26). JAX matches them
against ``jax.tree_util.keystr`` paths such as
``['params']['layers_0']['inter_w']``; ``param_paths`` builds the same
string from the port's parameter names (``layers.0.inter_w``), so a
pattern with brackets or separators selects the same leaves in both.

Activation quantization (``fake_quantize_activation``) and layer
reduction (``apply_layer_reduction``, ``student_initialization``) come
with a later slice; their config blocks raise.
"""

import re
from typing import Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.quantizer import dequantize, quantize
from ..runtime.config import refuse_later_compression
from ..runtime.config_utils import logger
from .config import CompressionConfig

FAKE_QUANT_FLOOR = float(np.float32(1e-8))   # fake_quantize's scale floor

_INDEX = re.compile(r"\d+")

NamedParams = Union[Mapping[str, torch.Tensor],
                    Iterable[Tuple[str, torch.Tensor]]]


def keystr(name: str) -> str:
    """The ``jax.tree_util.keystr`` path of a port parameter name under a
    ``params`` collection: ``layers.0.inter_w`` ->
    ``['params']['layers_0']['inter_w']`` (a list index joins its
    module's name, as the flax unrolled layers are named)."""
    keys = []
    for part in name.split("."):
        if _INDEX.fullmatch(part) and keys:
            keys[-1] = f"{keys[-1]}_{part}"
        else:
            keys.append(part)
    return "['params']" + "".join(f"['{k}']" for k in keys)


def param_paths(module: torch.nn.Module):
    """[(keystr path, parameter)] of the module's trainable parameters."""
    return [(keystr(n), p) for n, p in module.named_parameters()
            if p.requires_grad]


def _pairs(params: NamedParams):
    return list(params.items()) if isinstance(params, Mapping) \
        else list(params)


def _matches(path: str, patterns) -> bool:
    return any(p == "*" or p in path for p in patterns)


def fake_quantize(w, bits: int = 8, symmetric: bool = True,
                  per_channel: bool = True):
    """Uniform fake quantization (JAX :30): the values of w snapped to
    their 2^bits grid, per channel (groups along the last axis) or per
    tensor. Symmetric: scale = max(absmax / (2^(bits-1) - 1), 1e-8);
    asymmetric: scale = max((max - min) / (2^bits - 1), 1e-8), zero point
    min. Returns a tensor like w (computed in fp32 from fp32 or bf16 w;
    the JAX function computes a bf16 leaf in bf16). bits: 2-15."""
    if per_channel and w.dim() > 1:
        c = w.shape[-1]
        groups, x = c, w.reshape(-1, c).t()
    else:
        groups, x = 1, w.reshape(1, -1)
    snapped = dequantize(*quantize(x, groups, asymmetric=not symmetric,
                                   bits=bits, scale_floor=FAKE_QUANT_FLOOR),
                         dtype=w.dtype)
    if groups > 1:
        snapped = snapped.t()
    return snapped.reshape(w.shape)


def _prune_count(n: int, ratio: float):
    k = int(n * ratio)
    return k if ratio > 0 and k > 0 else 0


def magnitude_mask(w, ratio: float):
    """Unstructured pruning: zero the smallest |w| fraction (JAX :58)."""
    k = _prune_count(w.numel(), ratio)
    if not k:
        return torch.ones_like(w, dtype=torch.bool)
    thresh = torch.sort(w.abs().reshape(-1)).values[k - 1]
    return w.abs() > thresh


def row_mask(w, ratio: float):
    """Structured row pruning: drop the output columns (last axis) with
    the smallest L2 norm (JAX :70)."""
    if w.dim() < 2:
        return torch.ones_like(w, dtype=torch.bool)
    norms = torch.sqrt((w * w).sum(dim=tuple(range(w.dim() - 1))))
    k = _prune_count(norms.shape[0], ratio)
    if not k:
        return torch.ones_like(w, dtype=torch.bool)
    thresh = torch.sort(norms).values[k - 1]
    return torch.broadcast_to(norms > thresh, w.shape)


def channel_mask(w, ratio: float):
    """Structured input-channel pruning: drop the rows of the first axis
    with the smallest L2 norm (JAX :83)."""
    if w.dim() < 2:
        return torch.ones_like(w, dtype=torch.bool)
    norms = torch.sqrt((w * w).sum(dim=tuple(range(1, w.dim()))))
    k = _prune_count(norms.shape[0], ratio)
    if not k:
        return torch.ones_like(w, dtype=torch.bool)
    thresh = torch.sort(norms).values[k - 1]
    keep = (norms > thresh).reshape((w.shape[0],) + (1,) * (w.dim() - 1))
    return torch.broadcast_to(keep, w.shape)


def head_mask(w, ratio: float, num_heads: int):
    """Structured head pruning on a projection whose last axis is heads x
    head_dim: drop whole heads by L2 norm (JAX :97)."""
    out_dim = w.shape[-1]
    if ratio <= 0 or num_heads <= 1 or out_dim % num_heads:
        return torch.ones_like(w, dtype=torch.bool)
    head_dim = out_dim // num_heads
    grouped = w.reshape(*w.shape[:-1], num_heads, head_dim)
    norms = torch.sqrt((grouped * grouped).sum(
        dim=tuple(range(grouped.dim() - 2)) + (grouped.dim() - 1,)))
    k = int(num_heads * ratio)
    if k == 0:
        return torch.ones_like(w, dtype=torch.bool)
    thresh = torch.sort(norms).values[k - 1]
    keep = torch.repeat_interleave(norms > thresh, head_dim)
    return torch.broadcast_to(keep, w.shape)


class Compressor:
    """Schedule-driven projection of named parameters (JAX :116); call
    ``apply`` after each optimizer step (nothing happens before the
    techniques' schedule offsets)."""

    def __init__(self, config: CompressionConfig):
        self.config = config

    def _project_leaf(self, path: str, w, step: int):
        """The projected leaf, or ``w`` itself when nothing applies."""
        if w.dim() == 0 or not w.is_floating_point():
            return w
        c = self.config
        out = w
        for tech, mask in (
                (c.sparse_pruning, lambda o, g: magnitude_mask(
                    o, float(g.params.get("dense_ratio_delta", 0)
                             or 1 - g.params.get("dense_ratio", 1)))),
                (c.row_pruning, lambda o, g: row_mask(
                    o, 1 - g.params.get("dense_ratio", 1))),
                (c.channel_pruning, lambda o, g: channel_mask(
                    o, 1 - g.params.get("dense_ratio", 1))),
                (c.head_pruning, lambda o, g: head_mask(
                    o, 1 - g.params.get("dense_ratio", 1),
                    num_heads=int(g.params.get("num_heads", 1))))):
            if tech.enabled and step >= tech.schedule_offset:
                for g in tech.groups.values():
                    if _matches(path, g.modules):
                        out = out * mask(out, g)
        wq = c.weight_quantization
        if wq.enabled and step >= wq.schedule_offset:
            for g in wq.groups.values():
                if _matches(path, g.modules):
                    out = fake_quantize(
                        out, bits=int(g.params.get("start_bits",
                                                   g.params.get("bits", 8))),
                        symmetric=g.params.get("quantization_type",
                                               "symmetric") == "symmetric")
        return out

    def active(self, step: int) -> bool:
        c = self.config
        return any(t.enabled and step >= t.schedule_offset
                   for t in (c.weight_quantization, c.sparse_pruning,
                             c.row_pruning, c.head_pruning,
                             c.channel_pruning))

    @torch.no_grad()
    def apply(self, params: NamedParams, step: int):
        """Project the (keystr path, tensor) pairs (or a {path: tensor}
        mapping) in place for ``step``; returns them."""
        pairs = _pairs(params)
        if self.active(step):
            for path, w in pairs:
                out = self._project_leaf(path, w, step)
                if out is not w:
                    w.copy_(out)
        return params


def init_compression(config: Optional[dict]) -> Optional[Compressor]:
    """A Compressor from the ``compression_training`` block (JAX :194),
    or None when nothing is enabled."""
    refuse_later_compression(config)
    cc = CompressionConfig.from_dict(config)
    if not cc.any_enabled():
        return None
    logger.info("compression-aware training enabled: " + ", ".join(
        f for f in cc.__dataclass_fields__ if getattr(cc, f).enabled))
    return Compressor(cc)


def redundancy_clean(params: NamedParams, config: Optional[dict]):
    """The final projection for serving (JAX :206), in place."""
    comp = init_compression(config)
    if comp is None:
        return params
    return comp.apply(params, step=1 << 30)


__all__ = ["Compressor", "channel_mask", "fake_quantize", "head_mask",
           "init_compression", "keystr", "magnitude_mask", "param_paths",
           "redundancy_clean", "row_mask"]
