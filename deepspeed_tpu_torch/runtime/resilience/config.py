"""The checkpoint integrity policy (counterpart of
``deepspeed_tpu/runtime/resilience/config.py`` ``IntegrityConfig`` :24).

Only the defaults are used in this slice: the engine's checkpoints take
them whenever the config has no ``resilience`` block, as the JAX
package's ``_integrity_config`` does (manifests are not opt-in). An
enabled ``resilience`` block raises until the resilience slice.
"""

from dataclasses import dataclass

from ..config_utils import DeepSpeedConfigError

_DIGESTS = ("crc32", "sha256")


@dataclass
class IntegrityConfig:
    """Every save writes a ``manifest.json`` (per-file sizes and digests);
    loads verify it and fall back along the retained-tag chain on
    mismatch instead of restoring corrupt state."""
    enabled: bool = True
    algorithm: str = "crc32"          # crc32 (fast) | sha256 (cryptographic)
    verify_on_load: bool = True
    fallback_on_corruption: bool = True
    keep_last_n: int = 0              # 0 = retain every tag (no GC)

    def __post_init__(self):
        if self.algorithm not in _DIGESTS:
            raise DeepSpeedConfigError(
                f"resilience.integrity.algorithm must be one of {_DIGESTS}, "
                f"got {self.algorithm!r}")
        if self.keep_last_n < 0:
            raise DeepSpeedConfigError(
                "resilience.integrity.keep_last_n must be >= 0, got "
                f"{self.keep_last_n}")
