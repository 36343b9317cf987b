"""fp16 loss scaling (counterpart of ``deepspeed_tpu/runtime/fp16``)."""
