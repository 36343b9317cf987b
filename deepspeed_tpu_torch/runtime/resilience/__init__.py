"""Checkpoint integrity (counterpart of ``deepspeed_tpu/runtime/resilience``):
the manifest, the atomic ``latest`` tag and the integrity policy. The
sentinel, preemption and fault injection come with the resilience slice;
an enabled ``resilience`` config block raises until then."""
