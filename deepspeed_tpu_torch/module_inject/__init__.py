"""Model transformations for serving (counterpart of
``deepspeed_tpu/module_inject``): weight-only int8 quantization."""
