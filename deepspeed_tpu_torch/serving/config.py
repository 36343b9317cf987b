"""Serving engine configuration (counterpart of
``deepspeed_tpu/serving/config.py``: ``QuantizeConfig`` :16,
``SpeculationConfig`` :62, ``ServingConfig`` with its ``paged`` /
``weights_int8`` / ``kv_int8`` / ``qos_enabled`` / ``spec_enabled`` flags
:231-259, the speculation headroom of ``cache_len`` :262 and the
nested-dict lifting :175-187). A ``fleet`` block raises
``NotImplementedError``.
"""

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from .paging.config import PagingConfig
from .qos import QosConfig

_LATER_BLOCKS = {
    "fleet": "the fleet slice",
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
class SpeculationConfig:
    """Token-exact self-speculative decoding (the ``serving.speculation``
    sub-block): a host-side n-gram proposer (``serving/speculation.py``)
    matches the tail of each slot's ``prompt + generated`` sequence
    against its own history and proposes up to ``max_spec_tokens``
    continuation tokens an iteration; one batched verification step checks
    them all and accepts the longest prefix that agrees with greedy
    argmax, so the output stays the non-speculative engine's.

    Greedy only: the acceptance rule is greedy argmax, so ``validate``
    refuses the block on a sampling engine (temperature > 0)."""
    enabled: bool = True
    max_spec_tokens: int = 4         # k: proposals per slot an iteration
                                     # (the QoS ladder sheds this to 0
                                     # under pressure, before any request)
    ngram_max: int = 3               # longest tail n-gram matched first
    ngram_min: int = 1               # shortest n-gram worth matching

    def validate(self, temperature: float) -> "SpeculationConfig":
        if self.max_spec_tokens < 1:
            raise ValueError(
                f"serving.speculation.max_spec_tokens must be >= 1, got "
                f"{self.max_spec_tokens}")
        if self.ngram_min < 1:
            raise ValueError(
                f"serving.speculation.ngram_min must be >= 1, got "
                f"{self.ngram_min}")
        if self.ngram_max < self.ngram_min:
            raise ValueError(
                f"serving.speculation.ngram_max ({self.ngram_max}) must "
                f"be >= ngram_min ({self.ngram_min})")
        if self.enabled and temperature != 0.0:
            raise ValueError(
                "serving.speculation requires greedy sampling "
                f"(temperature=0.0, got {temperature}): the acceptance "
                "rule is greedy argmax, and speculating under a sampling "
                "engine would silently change the output distribution")
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
    qos: Optional[QosConfig] = None  # priority classes, SLO shedding, the
                                     # degradation ladder, the watchdog
                                     # (serving/qos.py); absent or
                                     # enabled=False keeps the FIFO engine
    quantize: Optional[QuantizeConfig] = None
                                     # int8 weights and int8 KV pages
    fleet: Any = None
    speculation: Optional[SpeculationConfig] = None
                                     # self-speculative decoding (serving/
                                     # speculation.py); absent or
                                     # enabled=False keeps one token a step

    def __post_init__(self):
        # nested blocks arrive as dicts from a JSON or dict config
        if isinstance(self.paging, dict):
            self.paging = PagingConfig(**self.paging)
        if isinstance(self.qos, dict):
            self.qos = QosConfig(**self.qos)
        if isinstance(self.quantize, dict):
            self.quantize = QuantizeConfig(**self.quantize)
        if isinstance(self.speculation, dict):
            self.speculation = SpeculationConfig(**self.speculation)

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
        if self.qos is not None:
            self.qos.validate()
        if self.quantize is not None:
            self.quantize.validate(self.paged)
        if self.speculation is not None:
            self.speculation.validate(self.temperature)
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
    def qos_enabled(self) -> bool:
        """True when the QoS layer is configured AND enabled."""
        return self.qos is not None and self.qos.enabled

    @property
    def spec_enabled(self) -> bool:
        """True when self-speculative decoding is configured AND enabled."""
        return self.speculation is not None and self.speculation.enabled

    @property
    def cache_len(self) -> int:
        """Slot capacity: ``max_len`` plus the speculation headroom
        ``pad`` (``max_spec_tokens`` when speculation is on, else 0),
        rounded up to a multiple of 128, as the JAX package computes it,
        so page tables, the pool size, the prefill buckets and the paging
        validation are the JAX engine's at every ``max_len``. The
        verification step writes k + 1 candidate tokens at a slot's
        frontier before acceptance decides how many are real; the
        headroom keeps those writes from clamping back into a live slot's
        valid prefix (an active slot holds at most ``max_len - 2``
        tokens). Admission and the per-request budget read ``max_len``;
        the kernels read only the valid tokens of a slot."""
        pad = self.speculation.max_spec_tokens if self.spec_enabled else 0
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
