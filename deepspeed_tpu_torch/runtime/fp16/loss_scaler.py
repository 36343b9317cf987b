"""Static and dynamic loss scaling (counterpart of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

The state is four 0-dim tensors on the engine's device, updated with
``torch.where`` in the JAX package's branch order, so the step never waits
on the card for the scale itself. The engine reads the finite flag once a
step to decide whether the optimizer runs (its step count and learning
rate live on the host).
"""

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: torch.Tensor            # current loss scale (fp32)
    growth_tracker: torch.Tensor   # consecutive non-overflow steps (int32)
    overflows: torch.Tensor        # total overflowed (skipped) steps (int32)
    hysteresis_left: torch.Tensor  # overflows tolerated before a shrink


def init_loss_scale(static_scale: float = 0.0, initial_scale_power: int = 16,
                    hysteresis: int = 2, device=None) -> LossScaleState:
    """``static_scale`` > 0 fixes the scale; 0 starts the dynamic scale at
    2 ** ``initial_scale_power``."""
    scale = static_scale if static_scale > 0 else 2.0 ** initial_scale_power
    i32 = dict(dtype=torch.int32, device=device)
    return LossScaleState(
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        growth_tracker=torch.zeros((), **i32),
        overflows=torch.zeros((), **i32),
        hysteresis_left=torch.tensor(hysteresis, **i32))


def grads_finite(grads) -> torch.Tensor:
    """True (a 0-dim bool tensor) when every element of every gradient is
    finite (JAX :32-41). Each element is tested with ``isfinite``, not the
    norm: a finite gradient whose square overflows is not an overflow."""
    grads = list(grads)
    if not grads:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def update_scale(state: LossScaleState, finite: torch.Tensor, *,
                 dynamic: bool = True, scale_window: int = 1000,
                 hysteresis: int = 2, consecutive_hysteresis: bool = False,
                 min_scale: float = 1.0,
                 scale_factor: float = 2.0) -> LossScaleState:
    """The JAX package's policy (DynamicLossScaler.update_scale): an
    overflow spends one unit of hysteresis and halves the scale (not
    below ``min_scale``) only once hysteresis is down to 1, where it stays
    until a refill; the refill comes on every clean step with
    ``consecutive_hysteresis``, else only on the step that grows the scale
    (after ``scale_window`` clean steps). A static scale only counts the
    overflows."""
    one = torch.ones_like(state.overflows)
    zero = torch.zeros_like(state.overflows)
    overflows = state.overflows + torch.where(finite, zero, one)
    if not dynamic:
        return state._replace(overflows=overflows)
    # overflow branch
    exhausted = state.hysteresis_left <= 1
    shrunk = torch.where(exhausted,
                         torch.clamp_min(state.scale / scale_factor,
                                         min_scale), state.scale)
    hyst_over = torch.where(exhausted, state.hysteresis_left,
                            state.hysteresis_left - 1)
    # clean branch
    tracker = state.growth_tracker + 1
    grow = tracker >= scale_window
    grown = torch.where(grow, state.scale * scale_factor, state.scale)
    full = torch.full_like(state.hysteresis_left, hysteresis)
    hyst_clean = (full if consecutive_hysteresis
                  else torch.where(grow, full, state.hysteresis_left))
    return LossScaleState(
        scale=torch.where(finite, grown, shrunk),
        growth_tracker=torch.where(finite, torch.where(grow, zero, tracker),
                                   zero),
        overflows=overflows,
        hysteresis_left=torch.where(finite, hyst_clean, hyst_over))
