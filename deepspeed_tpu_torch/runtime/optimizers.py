"""Optimizer registry (counterpart of ``deepspeed_tpu/runtime/optimizers.py``
``build_optimizer`` :50).

Every Adam flavour of the registry runs on the one multi-tensor fused
kernel (``ops.fused_adam``); what differs is host arithmetic:

- ``FusedAdam`` is the JAX package's ``fused_adamw``: decoupled weight
  decay, and the learning rate of step t (t = 1, 2, ...) is
  ``schedule(t)`` (``count = state.count + 1``, fused_adam.py:91-92).
- ``Adam``/``AdamW``/``CPUAdam`` are optax's ``adamw``/``adam`` there:
  ``scale_by_schedule`` reads the count before incrementing it, so the
  learning rate of step t is ``schedule(t - 1)``. ``Adam`` with
  ``adam_w_mode: false`` and a weight decay adds L2 (``wd * p``) to the
  gradient before the step (optimizers.py:72-73).

Gradient clipping is optax's ``clip_by_global_norm``, folded into the
same kernel: the engine hands the step the global grad norm on the device.
LAMB, Adagrad, SGD and the 1-bit optimizers come with later slices.
"""

from typing import Callable, Optional, Union

import numpy as np

from ..ops.fused_adam import AdamScalars, FusedAdamState, fused_adam

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "cpuadam"
LATER = {
    "lamb": "the LAMB slice (fused_lamb kernel)",
    "fusedlamb": "the LAMB slice (fused_lamb kernel)",
    "onebitadam": "the multi-GPU slice (compressed communication)",
    "onebitlamb": "the multi-GPU slice (compressed communication)",
    "zerooneadam": "the multi-GPU slice (compressed communication)",
    "adagrad": "a later optimizer slice",
    "sgd": "a later optimizer slice",
}


class Adam:
    """Adam or AdamW on the fused kernel.

    learning_rate: a float or a schedule step -> lr. decoupled: weight
    decay added to the update (AdamW) rather than to the gradient (L2).
    one_based: the schedule index of step t is t (FusedAdam) rather than
    t - 1 (optax).
    """

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True,
                 one_based: bool = True):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.decoupled, self.one_based = decoupled, one_based

    def lr_at(self, count: int) -> float:
        """The learning rate of optimizer step ``count`` (1-based)."""
        if not callable(self.learning_rate):
            return float(self.learning_rate)
        return float(self.learning_rate(count if self.one_based
                                        else count - 1))

    def scalars(self, count: int) -> AdamScalars:
        """The kernel's scalars for step ``count``; the bias corrections
        c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t) in fp32, as the JAX package
        computes them."""
        f32, t = np.float32, np.float32(count)
        c1 = f32(1.0) / (f32(1.0) - f32(self.b1) ** t)
        c2 = f32(1.0) / (f32(1.0) - f32(self.b2) ** t)
        wd = self.weight_decay
        return AdamScalars(self.lr_at(count), self.b1, self.b2, float(c1),
                           float(c2), self.eps, wd if self.decoupled else 0.0,
                           0.0 if self.decoupled else wd)

    def init(self, params, grads) -> FusedAdamState:
        """State over ``params`` whose gradients accumulate in ``grads``."""
        return FusedAdamState(params, grads)

    def step(self, state: FusedAdamState, grad_norm=None,
             max_norm: float = 0.0):
        """One step in place: one kernel launch on a card."""
        state.count += 1
        fused_adam(state, self.scalars(state.count), grad_norm, max_norm)


def build_optimizer(opt_type: str, params: dict,
                    lr_schedule: Optional[Union[float, Callable]] = None
                    ) -> Adam:
    """The optimizer of a config ``optimizer`` block; ``lr_schedule``
    overrides params["lr"] when given (the engine wires the scheduler
    block here)."""
    name = opt_type.lower().replace("deepspeed", "").replace("_", "")
    lr = lr_schedule if lr_schedule is not None else params.get("lr", 1e-3)
    wd = params.get("weight_decay", 0.0)
    b1, b2 = params.get("betas", (0.9, 0.999))
    kw = dict(b1=b1, b2=b2, eps=params.get("eps", 1e-8), weight_decay=wd)
    if name == FUSED_ADAM:
        return Adam(lr, decoupled=True, one_based=True, **kw)
    if name in (ADAM_OPTIMIZER, CPU_ADAM):
        decoupled = not (wd > 0 and not params.get("adam_w_mode", True))
        return Adam(lr, decoupled=decoupled, one_based=False, **kw)
    if name == ADAMW_OPTIMIZER:
        return Adam(lr, decoupled=True, one_based=False, **kw)
    if name in LATER:
        raise NotImplementedError(
            f"optimizer {opt_type!r} comes with {LATER[name]} of the port")
    raise ValueError(f"Unknown optimizer type '{opt_type}' (valid: "
                     f"{[ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM, CPU_ADAM, *LATER]})")
