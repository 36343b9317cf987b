"""Optimizer registry (counterpart of ``deepspeed_tpu/runtime/optimizers.py``
``build_optimizer`` :50).

Every Adam flavour of the registry runs on the one multi-tensor fused
Adam kernel (``ops.fused_adam``), both LAMB flavours on the fused LAMB
kernels (``ops.fused_lamb``); what differs is host arithmetic:

- ``FusedAdam`` is the JAX package's ``fused_adamw``: decoupled weight
  decay, and the learning rate of step t (t = 1, 2, ...) is
  ``schedule(t)`` (``count = state.count + 1``, fused_adam.py:91-92).
- ``Adam``/``AdamW``/``CPUAdam`` are optax's ``adamw``/``adam`` there:
  ``scale_by_schedule`` reads the count before incrementing it, so the
  learning rate of step t is ``schedule(t - 1)``. ``Adam`` with
  ``adam_w_mode: false`` and a weight decay adds L2 (``wd * p``) to the
  gradient before the step (optimizers.py:72-73).
- ``FusedLamb`` is the JAX package's ``fused_lamb``: the learning rate of
  step t is ``schedule(t)`` (fused_lamb.py:101-102) and eps defaults to
  1e-6 (optimizers.py:84). ``Lamb`` is ``optax.lamb`` there: the learning
  rate of step t is ``schedule(t - 1)`` and eps defaults to 1e-8
  (``_adam_args``). Weight decay covers every tensor.

- ``Adagrad`` and ``SGD`` are optax's ``adagrad`` (accumulator starting
  at 0.1, eps 1e-10 unless the config says otherwise) and ``sgd`` (a
  momentum trace even at momentum 0, optionally Nesterov) there
  (optimizers.py:91-97). optax computes them in jnp with no Pallas
  kernel, so here they are plain ``torch._foreach_*`` updates in optax's
  order of operations; the learning rate of step t is ``schedule(t - 1)``.

Gradient clipping is optax's ``clip_by_global_norm``, folded into the
same kernels (and into the plain updates of Adagrad and SGD): the engine
hands the step the global grad norm on the device. The 1-bit optimizers
come with the multi-GPU slice.
"""

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..ops.fused_adam import AdamScalars, FusedAdamState, fused_adam
from ..ops.fused_lamb import FusedLambState, LambScalars, fused_lamb

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "cpuadam"
LAMB_OPTIMIZER = "lamb"
FUSED_LAMB = "fusedlamb"
ADAGRAD_OPTIMIZER = "adagrad"
SGD_OPTIMIZER = "sgd"
LATER = {
    "onebitadam": "the multi-GPU slice (compressed communication)",
    "onebitlamb": "the multi-GPU slice (compressed communication)",
    "zerooneadam": "the multi-GPU slice (compressed communication)",
}


class Optimizer:
    """What every optimizer of the registry shares: the learning rate (a
    float or a schedule step -> lr) and the schedule index of step t, t
    (``one_based``, the JAX package's fused kernels) or t - 1 (optax)."""

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3,
                 one_based: bool = True):
        self.learning_rate = learning_rate
        self.one_based = one_based

    def lr_at(self, count: int) -> float:
        """The learning rate of optimizer step ``count`` (1-based)."""
        if not callable(self.learning_rate):
            return float(self.learning_rate)
        return float(self.learning_rate(count if self.one_based
                                        else count - 1))


class FusedOptimizer(Optimizer):
    """The fused kernels' optimizers: betas, eps and weight decay too."""

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, one_based: bool = True):
        super().__init__(learning_rate, one_based)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)

    def bias_corrections(self, count: int):
        """c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t) in fp32, as the JAX
        package computes them."""
        f32, t = np.float32, np.float32(count)
        c1 = f32(1.0) / (f32(1.0) - f32(self.b1) ** t)
        c2 = f32(1.0) / (f32(1.0) - f32(self.b2) ** t)
        return float(c1), float(c2)


class Adam(FusedOptimizer):
    """Adam or AdamW on the fused kernel. decoupled: weight decay added to
    the update (AdamW) rather than to the gradient (L2)."""

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True,
                 one_based: bool = True):
        super().__init__(learning_rate, b1, b2, eps, weight_decay, one_based)
        self.decoupled = decoupled

    def scalars(self, count: int) -> AdamScalars:
        """The kernel's scalars for step ``count``."""
        c1, c2 = self.bias_corrections(count)
        wd = self.weight_decay
        return AdamScalars(self.lr_at(count), self.b1, self.b2, c1, c2,
                           self.eps, wd if self.decoupled else 0.0,
                           0.0 if self.decoupled else wd)

    def init(self, params, grads) -> FusedAdamState:
        """State over ``params`` whose gradients accumulate in ``grads``."""
        return FusedAdamState(params, grads)

    def step(self, state: FusedAdamState, grad_norm=None,
             max_norm: float = 0.0):
        """One step in place: one kernel launch on a card."""
        state.count += 1
        fused_adam(state, self.scalars(state.count), grad_norm, max_norm)


class Lamb(FusedOptimizer):
    """LAMB on the fused kernels: ``FusedLamb`` with ``one_based`` (the
    JAX ``fused_lamb``), ``optax.lamb`` without."""

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0, one_based: bool = True):
        super().__init__(learning_rate, b1, b2, eps, weight_decay, one_based)

    def scalars(self, count: int) -> LambScalars:
        """The kernels' scalars for step ``count``."""
        c1, c2 = self.bias_corrections(count)
        return LambScalars(self.lr_at(count), self.b1, self.b2, c1, c2,
                           self.eps, self.weight_decay)

    def init(self, params, grads) -> FusedLambState:
        """State over ``params`` whose gradients accumulate in ``grads``."""
        return FusedLambState(params, grads)

    def step(self, state: FusedLambState, grad_norm=None,
             max_norm: float = 0.0):
        """One step in place: two kernel launches on a card."""
        state.count += 1
        fused_lamb(state, self.scalars(state.count), grad_norm, max_norm)


class SlotState:
    """Per-parameter slots of a plain optimizer (``SLOTS`` names them, each
    a list of tensors like the parameters, filled with its initial value)
    and the step count. ``grads`` are the engine's gradient buffers."""

    def __init__(self, params, grads, slots: dict):
        self.params, self.grads = list(params), list(grads)
        self.SLOTS = tuple(slots)
        for name, fill in slots.items():
            setattr(self, name, [torch.full_like(p, fill)
                                 for p in self.params])
        self.count = 0          # optimizer steps taken


def _clipped(grads, grad_norm, max_norm):
    """optax's ``clip_by_global_norm``: g where norm < max_norm, else
    g / norm * max_norm (the fused kernels' formula)."""
    if grad_norm is None:
        return grads
    keep = grad_norm < max_norm
    return [torch.where(keep, g, g / grad_norm * max_norm) for g in grads]


class Adagrad(Optimizer):
    """optax's ``adagrad``: s += g², p -= lr g / sqrt(s + eps) (0 where
    s = 0), s starting at ``initial_accumulator_value``."""

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3,
                 eps: float = 1e-10, initial_accumulator_value: float = 0.1):
        super().__init__(learning_rate, one_based=False)
        self.eps = float(eps)
        self.initial_accumulator_value = float(initial_accumulator_value)

    def init(self, params, grads) -> SlotState:
        return SlotState(params, grads, {
            "sum_of_squares": self.initial_accumulator_value})

    @torch.no_grad()
    def step(self, state: SlotState, grad_norm=None, max_norm: float = 0.0):
        state.count += 1
        g = _clipped(state.grads, grad_norm, max_norm)
        torch._foreach_add_(state.sum_of_squares, torch._foreach_mul(g, g))
        inv = [torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0)
               for s in state.sum_of_squares]
        torch._foreach_add_(state.params, torch._foreach_mul(
            torch._foreach_mul(inv, g), -self.lr_at(state.count)))


class SGD(Optimizer):
    """optax's ``sgd``: trace = g + momentum trace; the update is the
    trace, or g + momentum trace with ``nesterov``; p -= lr update."""

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3,
                 momentum: float = 0.0, nesterov: bool = False):
        super().__init__(learning_rate, one_based=False)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)

    def init(self, params, grads) -> SlotState:
        return SlotState(params, grads, {"trace": 0.0})

    @torch.no_grad()
    def step(self, state: SlotState, grad_norm=None, max_norm: float = 0.0):
        state.count += 1
        g = _clipped(state.grads, grad_norm, max_norm)
        torch._foreach_mul_(state.trace, self.momentum)
        torch._foreach_add_(state.trace, g)
        update = state.trace
        if self.nesterov:
            update = torch._foreach_add(
                g, torch._foreach_mul(state.trace, self.momentum))
        torch._foreach_add_(state.params, torch._foreach_mul(
            update, -self.lr_at(state.count)))


def build_optimizer(opt_type: str, params: dict,
                    lr_schedule: Optional[Union[float, Callable]] = None
                    ) -> Optimizer:
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
    if name == FUSED_LAMB:
        return Lamb(lr, b1, b2, params.get("eps", 1e-6), wd, one_based=True)
    if name == LAMB_OPTIMIZER:
        return Lamb(lr, one_based=False, **kw)
    if name == ADAGRAD_OPTIMIZER:
        return Adagrad(lr, eps=params.get("eps", 1e-10))
    if name == SGD_OPTIMIZER:
        return SGD(lr, momentum=params.get("momentum", 0.0),
                   nesterov=params.get("nesterov", False))
    if name in LATER:
        raise NotImplementedError(
            f"optimizer {opt_type!r} comes with {LATER[name]} of the port")
    raise ValueError(f"Unknown optimizer type '{opt_type}' (valid: "
                     f"{[ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM, CPU_ADAM, LAMB_OPTIMIZER, FUSED_LAMB, ADAGRAD_OPTIMIZER, SGD_OPTIMIZER, *LATER]})")
