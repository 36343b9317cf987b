"""Observability of the port (counterpart of ``deepspeed_tpu/
observability/``): so far the memory accountant and the OOM forensics the
serving engine's fault containment reads (``memory.py``)."""
