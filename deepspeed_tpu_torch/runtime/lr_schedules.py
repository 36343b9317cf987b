"""LR schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``).

Reference: deepspeed/runtime/lr_schedules.py: LRRangeTest (:308),
OneCycle (:415), WarmupLR (:704), WarmupDecayLR (:800). Each schedule is
a pure function step -> lr on host Python floats (the engine computes the
step's lr on the host and hands it to the optimizer kernel by value), plus
a registry used by the config's ``scheduler`` block.
"""

import math
from typing import Callable

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Callable:
    """LR sweep for finding usable ranges (reference :308)."""
    def schedule(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)
    return schedule


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: int = None,
              decay_step_size: int = 0,
              decay_lr_rate: float = 0.0,
              cycle_first_stair_count: int = 0,
              cycle_second_stair_count: int = None,
              **_ignored) -> Callable:
    """Triangular cyclic LR with optional post-cycle decay (reference :415)."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        step = float(step)
        up_frac = _clip(step / cycle_first_step_size, 0.0, 1.0)
        down_frac = _clip((step - cycle_first_step_size) / second, 0.0, 1.0)
        if step <= cycle_first_step_size:
            in_cycle_lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up_frac
        else:
            in_cycle_lr = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down_frac
        if decay_step_size > 0 and decay_lr_rate > 0 and step > total_cycle:
            decay_steps = max(step - total_cycle, 0.0) / decay_step_size
            return cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
        return in_cycle_lr
    return schedule


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_ignored) -> Callable:
    """Warm up then hold (reference :704; log warmup is its default)."""
    warmup_num_steps = max(warmup_num_steps, 2)

    def schedule(step):
        step = float(step)
        if step >= warmup_num_steps:
            return warmup_max_lr
        if warmup_type == "log":
            frac = math.log1p(min(step, warmup_num_steps)) / math.log(warmup_num_steps + 1)
        else:
            frac = min(step, warmup_num_steps) / warmup_num_steps
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac
    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_ignored) -> Callable:
    """Warm up then linear decay to zero (reference :800)."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
    warmup_num_steps_ = max(warmup_num_steps, 2)

    def schedule(step):
        step = float(step)
        if step < warmup_num_steps_:
            return base(step)
        decay_frac = _clip(
            (total_num_steps - step) / max(total_num_steps - warmup_num_steps_, 1),
            0.0, 1.0)
        return warmup_max_lr * decay_frac
    return schedule


SCHEDULE_REGISTRY = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
}


def get_lr_schedule(name: str, params: dict) -> Callable:
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"Unknown scheduler '{name}'. Valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_REGISTRY[name](**params)
