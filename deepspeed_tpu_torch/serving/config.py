"""Serving engine configuration (counterpart of
``deepspeed_tpu/serving/config.py`` ``ServingConfig``), contiguous slots
only: a ``paging``, ``qos``, ``quantize``, ``fleet`` or ``speculation``
block raises ``NotImplementedError``.
"""

from dataclasses import dataclass
from typing import Any, Optional, Tuple

_LATER_BLOCKS = {
    "paging": "the paged-serving slice (paged_attention)",
    "qos": "the QoS slice",
    "quantize": "the int8 serving slice (wo_int8_matmul)",
    "fleet": "the fleet slice",
    "speculation": "the speculation slice",
}


@dataclass
class ServingConfig:
    """Continuous-batching knobs. The engine owns ``num_slots`` KV-cache
    rows of ``max_len`` tokens; prompts are right-padded to a multiple of
    ``prefill_bucket`` before prefill."""
    num_slots: int = 8
    max_len: int = 1024              # per-request token budget (prompt+output)
    prefill_bucket: int = 128        # bucket quantum for prompt padding
    max_queue: Optional[int] = None  # submit() raises past this depth
    eos_token_id: Optional[int] = None
    default_max_new_tokens: int = 128
    temperature: float = 0.0         # engine-wide sampling (greedy default)
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    pipeline_depth: int = 1          # decode dispatches in flight before the
                                     # host reads tokens back
    default_deadline_steps: Optional[int] = None
                                     # queue TTL in engine iterations
    seed: int = 0
    paging: Any = None
    qos: Any = None
    quantize: Any = None
    fleet: Any = None
    speculation: Any = None

    def validate(self):
        for name, slice_name in _LATER_BLOCKS.items():
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"serving.{name} comes with {slice_name} of the port")
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")
        if self.prefill_bucket < 1:
            raise ValueError(
                f"prefill_bucket must be >= 1, got {self.prefill_bucket}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 (or null for unbounded), got "
                f"{self.max_queue}")
        if self.default_max_new_tokens < 1:
            raise ValueError("default_max_new_tokens must be >= 1, got "
                             f"{self.default_max_new_tokens}")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {self.pipeline_depth}")
        if (self.default_deadline_steps is not None
                and self.default_deadline_steps < 1):
            raise ValueError(
                f"default_deadline_steps must be >= 1 (or null), got "
                f"{self.default_deadline_steps}")
        return self

    @property
    def cache_len(self) -> int:
        """Slot capacity. The decode kernel takes any capacity, so unlike
        the JAX package (which rounds up to 128 for its Pallas tiling)
        this is ``max_len`` itself."""
        return self.max_len

    def bucket_lengths(self) -> Tuple[int, ...]:
        """The prefill-length set: multiples of ``prefill_bucket`` up to
        the cache capacity (capacity itself included when unaligned)."""
        step = self.prefill_bucket
        out = list(range(step, self.cache_len + 1, step))
        if not out or out[-1] != self.cache_len:
            out.append(self.cache_len)
        return tuple(out)

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest bucket >= prompt_len."""
        for b in self.bucket_lengths():
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill "
            f"bucket ({self.bucket_lengths()[-1]})")
