"""Serving engine configuration (counterpart of
``deepspeed_tpu/serving/config.py``: ``QuantizeConfig`` :16,
``ServingConfig`` with its ``paged`` / ``weights_int8`` / ``kv_int8``
flags :231-244 and the nested-dict lifting :175-187). A ``qos``,
``fleet`` or ``speculation`` block raises ``NotImplementedError``.
"""

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from .paging.config import PagingConfig

_LATER_BLOCKS = {
    "qos": "the QoS slice",
    "fleet": "the fleet slice",
    "speculation": "the speculation slice",
}


@dataclass
class QuantizeConfig:
    """Serving quantization knobs (the ``serving.quantize`` sub-block).

    ``weights``: "int8" stores every ``QDense`` kernel of at least
    ``min_size`` elements int8 with per-output-channel scales at engine
    build (``module_inject.module_quantize``); the matmuls read them
    through the ``wo_int8_matmul`` kernels. ``kv``: "int8" stores the
    paged KV pool int8 with per-token-per-head scale planes (quantized on
    scatter, dequantized in the paged-attention kernel's page loop or on
    gather); it requires the ``paging`` block.
    """
    weights: Optional[str] = None    # None | "int8"
    kv: Optional[str] = None         # None | "int8" (paged engines only)
    min_size: int = 4096             # smallest weight (elements) to
                                     # quantize

    def validate(self, paged: bool):
        for field_name, val in (("weights", self.weights), ("kv", self.kv)):
            if val not in (None, "int8"):
                raise ValueError(
                    f"serving.quantize.{field_name} must be null or "
                    f"'int8', got {val!r}")
        if self.kv is not None and not paged:
            raise ValueError(
                "serving.quantize.kv requires the block-paged KV cache "
                "(serving.paging) — per-page scales live in the page "
                "pool")
        if self.min_size < 1:
            raise ValueError(
                f"serving.quantize.min_size must be >= 1, got "
                f"{self.min_size}")
        return self


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
    paging: Optional[PagingConfig] = None
                                     # block-paged KV cache (serving/paging/);
                                     # absent or enabled=False keeps the
                                     # contiguous slot pool
    qos: Any = None
    quantize: Optional[QuantizeConfig] = None
                                     # int8 weights and int8 KV pages
    fleet: Any = None
    speculation: Any = None

    def __post_init__(self):
        # nested blocks arrive as dicts from a JSON or dict config
        if isinstance(self.paging, dict):
            self.paging = PagingConfig(**self.paging)
        if isinstance(self.quantize, dict):
            self.quantize = QuantizeConfig(**self.quantize)

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
        if self.paging is not None:
            self.paging.validate(self.cache_len)
        if self.quantize is not None:
            self.quantize.validate(self.paged)
        return self

    @property
    def paged(self) -> bool:
        """True when the block-paged KV cache is configured AND enabled."""
        return self.paging is not None and self.paging.enabled

    @property
    def weights_int8(self) -> bool:
        """True when serving should int8-quantize weights at build."""
        return self.quantize is not None and self.quantize.weights == "int8"

    @property
    def kv_int8(self) -> bool:
        """True when the paged KV pool stores int8 pages."""
        return self.quantize is not None and self.quantize.kv == "int8"

    @property
    def cache_len(self) -> int:
        """Slot capacity: ``max_len`` plus the speculation headroom
        ``pad``, rounded up to a multiple of 128, as the JAX package
        computes it, so page tables, the pool size, the prefill buckets
        and the paging validation are the JAX engine's at every
        ``max_len``. ``pad`` is 0 until speculative decoding is ported.
        Admission and the per-request budget read ``max_len``; the
        kernels read only the valid tokens of a slot."""
        pad = 0
        return (self.max_len + pad + 127) // 128 * 128

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
