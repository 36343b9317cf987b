"""Training-time mixed-precision quantization, MoQ (counterpart of
``deepspeed_tpu/runtime/quantize.py``).

MoQ anneals the weights' precision from ``quantize_bits_start`` to
``quantize_bits_target``, one bit per ``quantize_period`` steps with the
period doubling at each drop (``bits_at`` :61), and snaps every floating
leaf of at least two dimensions to its current grid after each optimizer
step (``quantize`` :72) with ``compression.compress.fake_quantize``, on
the quantize and dequantize kernels. Leaves at 16 bits or more are left
alone, as in JAX. ``quantize_groups``, ``fp16_mixed_quantize`` and
``quantize_change_ratio`` are read and unused, as in JAX; the eigenvalue
mode (``eigenvalue_enabled``) comes with the compression slice's
eigenvalue item and raises.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..compression.compress import NamedParams, _pairs, fake_quantize
from .config_utils import logger


@dataclass
class MoQConfig:
    """The ``quantize_training`` config block (JAX :21)."""
    enabled: bool = False
    quantize_verbose: bool = False
    quantizer_kernel: bool = False
    quantize_type: str = "symmetric"        # symmetric | asymmetric
    quantize_bits_start: int = 16
    quantize_bits_target: int = 8
    quantize_period: int = 100
    quantize_groups: int = 1
    fp16_mixed_quantize: bool = False
    quantize_change_ratio: float = 0.001
    eigenvalue_enabled: bool = False


class MoQQuantizer:
    """Stepwise bit-annealing quantizer (JAX :37). ``layer_ratios`` maps a
    parameter-path substring to its ratio in (0, 1]: a smaller ratio means
    a longer period, so that layer quantizes more slowly."""

    def __init__(self, config: MoQConfig,
                 layer_ratios: Optional[Dict[str, float]] = None):
        if config.eigenvalue_enabled:
            raise NotImplementedError(
                "quantize_training.eigenvalue_enabled comes with the "
                "eigenvalue item of the compression slice of the port")
        self.config = config
        self.layer_ratios = dict(layer_ratios or {})

    def _ratio_for(self, path: str) -> float:
        for pattern, r in self.layer_ratios.items():
            if pattern in path:
                return float(r)
        return 1.0

    def bits_at(self, step: int, ratio: float = 1.0) -> int:
        c = self.config
        bits = c.quantize_bits_start
        period = max(int(c.quantize_period / max(ratio, 1e-3)), 1)
        t = step
        while bits > c.quantize_bits_target and t >= period:
            t -= period
            period *= 2   # each precision drop holds twice as long
            bits = max(bits - 1, c.quantize_bits_target)
        return bits

    @torch.no_grad()
    def quantize(self, params: NamedParams, step: int):
        """Snap the floating weight matrices among the (keystr path,
        tensor) pairs to their current bit grid, in place; returns the
        pairs."""
        if not self.config.enabled:
            return params
        sym = self.config.quantize_type == "symmetric"
        pairs = _pairs(params)
        leaf_bits = [self.bits_at(step, self._ratio_for(p)) for p, _ in pairs]
        if all(b >= 16 for b in leaf_bits):   # fp16-mixed region: no snap
            return params
        if self.config.quantize_verbose:
            logger.info(f"MoQ: step {step} -> bits {sorted(set(leaf_bits))}")
        for (_, w), b in zip(pairs, leaf_bits):
            if b < 16 and w.dim() >= 2 and w.is_floating_point():
                w.copy_(fake_quantize(w, bits=b, symmetric=sym))
        return params
