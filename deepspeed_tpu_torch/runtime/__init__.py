"""Training runtime of the port (counterpart of ``deepspeed_tpu/runtime``):
config, LR schedules, optimizers and the engine."""
