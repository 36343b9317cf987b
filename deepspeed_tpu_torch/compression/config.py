"""Compression config schema (a copy of
``deepspeed_tpu/compression/config.py``, stdlib only).

Reference: compression/config.py + constants.py — the
``compression_training`` block with per-technique sub-blocks
(weight_quantization, activation_quantization, sparse_pruning,
row_pruning, head_pruning, channel_pruning), each with
shared_parameters (schedule_offset, enabled) and different_groups
(per-module-pattern overrides). The schema is preserved; "modules"
patterns match flax param-tree path substrings instead of torch module
names (in the port: the ``keystr`` form of each parameter's flax path,
``compression.compress.param_paths``).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class TechniqueGroup:
    """One ``different_groups`` entry: params + module patterns."""
    params: Dict = field(default_factory=dict)
    modules: List[str] = field(default_factory=lambda: ["*"])
    related_modules: Optional[List[str]] = None


@dataclass
class TechniqueConfig:
    enabled: bool = False
    schedule_offset: int = 0          # step at which the technique kicks in
    shared_parameters: Dict = field(default_factory=dict)
    groups: Dict[str, TechniqueGroup] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "TechniqueConfig":
        shared = dict(d.get("shared_parameters", {}))
        groups = {}
        for name, g in d.get("different_groups", {}).items():
            groups[name] = TechniqueGroup(
                params=dict(g.get("params", {})),
                modules=list(g.get("modules", ["*"])),
                related_modules=g.get("related_modules"))
        return cls(enabled=shared.get("enabled", bool(groups)),
                   schedule_offset=shared.get("schedule_offset", 0),
                   shared_parameters=shared, groups=groups)


@dataclass
class CompressionConfig:
    weight_quantization: TechniqueConfig = field(default_factory=TechniqueConfig)
    activation_quantization: TechniqueConfig = field(default_factory=TechniqueConfig)
    sparse_pruning: TechniqueConfig = field(default_factory=TechniqueConfig)
    row_pruning: TechniqueConfig = field(default_factory=TechniqueConfig)
    head_pruning: TechniqueConfig = field(default_factory=TechniqueConfig)
    channel_pruning: TechniqueConfig = field(default_factory=TechniqueConfig)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "CompressionConfig":
        d = d or {}
        kw = {}
        for f in cls.__dataclass_fields__:
            if f in d:
                kw[f] = TechniqueConfig.from_dict(d[f])
        return cls(**kw)

    def any_enabled(self) -> bool:
        return any(getattr(self, f).enabled for f in self.__dataclass_fields__)
