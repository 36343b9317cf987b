"""The training config (counterpart of ``deepspeed_tpu/runtime/config.py``).

The same JSON schema and key names: ``DeepSpeedConfig.from_dict`` reads
the blocks this slice of the port runs (batch sizes, ``optimizer``,
``scheduler``, ``bf16``, ``gradient_clipping``, ``zero_optimization``
stage 0/1, ``data_types`` fp32, ``sparse_attention`` stored unread as
in the JAX package, ``compression_training`` weight quantization and
pruning, ``quantize_training`` MoQ) and resolves the reference's batch
arithmetic (train_batch_size = micro_batch * gradient_accumulation_steps
* dp_world_size) with dp_world_size = 1: the port trains on one card.

A block that a later slice of the port brings raises
``NotImplementedError`` naming that slice when it is enabled or set to
anything but its default (``LATER_SLICES``); a key that does nothing in
this slice warns with its reason (``NO_EFFECT``), and an unknown key
warns, so nothing in a config is silently ignored. ZeRO stage 1 on one
card partitions nothing and is taken as stage 0, as the JAX package does
on a one-device mesh.
"""

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .config_utils import (DeepSpeedConfigError, dataclass_to_dict,
                           dict_to_dataclass, logger)


@dataclass
class FP16Config:
    """fp16 block: ``enabled: true`` raises (loss scaling comes with a
    later slice); its loss-scale keys come with it and warn until then."""
    enabled: bool = False


@dataclass
class BF16Config:
    enabled: bool = False


@dataclass
class ZeroConfig:
    """zero_optimization block: stage 0 or 1 (one card). Its bucket,
    overlap and stage-3 keys shape cross-card traffic that one card does
    not have: they warn as unknown keys."""
    stage: int = 0

    def __post_init__(self):
        if self.stage not in (0, 1, 2, 3):
            raise DeepSpeedConfigError(
                f"zero_optimization.stage must be 0-3, got {self.stage}")


@dataclass
class OptimizerConfig:
    type: str = "Adam"
    params: Dict[str, Any] = field(default_factory=dict)
    legacy_fusion: bool = False


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataTypesConfig:
    """data_types block: gradient accumulation in fp32 (bf16 accumulation
    comes with a later slice)."""
    grad_accum_dtype: Optional[str] = None

    def resolve(self):
        v = (self.grad_accum_dtype or "fp32").lower()
        if v in ("fp32", "float32"):
            return "float32"
        if v in ("bf16", "bfloat16"):
            return "bfloat16"
        raise DeepSpeedConfigError(
            f"data_types.grad_accum_dtype must be fp32 or bf16, got "
            f"{self.grad_accum_dtype!r}")


def _on(block, key="enabled"):
    return isinstance(block, dict) and bool(block.get(key, False))


def _offload(zero):
    if not isinstance(zero, dict):
        return False
    return bool(zero.get("cpu_offload")) or any(
        isinstance(zero.get(k), dict)
        and zero[k].get("device", "none") not in ("none", None)
        for k in ("offload_param", "offload_optimizer"))


def _mesh_wide(mesh):
    return isinstance(mesh, dict) and any(
        int(mesh.get(axis, 1)) > 1
        for axis in ("data", "stage", "expert", "fsdp", "seq", "model"))


# top-level key -> (is it asked for?, the later slice of the port that
# brings it); a key that is present with its default value is accepted
LATER_SLICES = {
    "fp16": (_on, "the fp16 loss-scaling slice"),
    "zero_optimization": (
        lambda z: isinstance(z, dict) and int(z.get("stage", 0)) >= 2,
        "the multi-GPU ZeRO slice (stage >= 2)"),
    "activation_checkpointing": (lambda b: b is not None,
                                 "the remat slice"),
    "tiering": (_on, "the offload and tiering slice"),
    "pipeline": (lambda b: isinstance(b, dict)
                 and int(b.get("stages", 1)) > 1, "the pipeline slice"),
    "mesh": (_mesh_wide, "the multi-GPU slice (mesh axes > 1, MoE)"),
    "resilience": (_on, "the resilience slice"),
    "observability": (_on, "the observability slice"),
    "curriculum_learning": (_on, "the data-efficiency slice"),
    "data_efficiency": (lambda b: bool(b), "the data-efficiency slice"),
    "progressive_layer_drop": (_on, "the data-efficiency slice (PLD)"),
    "eigenvalue": (_on, "the compression slice (eigenvalue)"),
    "flops_profiler": (_on, "the observability slice"),
    "comms_logger": (_on, "the observability slice"),
    "tensorboard": (_on, "the observability slice (monitors)"),
    "wandb": (_on, "the observability slice (monitors)"),
    "csv_monitor": (_on, "the observability slice (monitors)"),
    "serving": (lambda b: b is not None,
                "init_inference(...).serve(config), not initialize()"),
    "elasticity": (lambda b: bool(b), "the multi-GPU slice (elasticity)"),
    "autotuning": (lambda b: bool(b), "the autotuning slice"),
    "checkpoint": (lambda b: bool(b), "the checkpointing slice"),
    "communication_data_type": (lambda b: b is not None,
                                "the multi-GPU slice"),
    "validate_sharding": (bool, "the multi-GPU slice"),
    "sparse_gradients": (bool, "the multi-GPU slice"),
    "wall_clock_breakdown": (bool, "the observability slice (timers)"),
    "memory_breakdown": (bool, "the observability slice (memory report)"),
    "dump_state": (bool, "the observability slice"),
}

# top-level keys that are read but do nothing in this slice: each warns
# with its reason instead of the unknown-key warning
NO_EFFECT = {
    "steps_per_print": "the engine prints no step log until the "
                       "observability slice",
    "prescale_gradients": "one card reduces no gradients",
    "gradient_predivide_factor": "one card reduces no gradients",
    "zero_allow_untested_optimizer": "ZeRO stage 1 on one card "
                                     "partitions nothing",
}


def refuse_later_compression(block: Optional[dict]):
    """Raise for the ``compression_training`` sub-blocks that come with a
    later slice of the port."""
    block = block or {}
    for key in ("activation_quantization", "layer_reduction"):
        sub = block.get(key)
        if not isinstance(sub, dict):
            continue
        shared = sub.get("shared_parameters", sub)
        if shared.get("enabled", bool(sub.get("different_groups"))):
            raise NotImplementedError(
                f"compression_training.{key} comes with a later slice of the "
                "port (activation quantization and layer reduction are "
                "queued with the compression slice)")


def _later_slice_check(d: dict):
    refuse_later_compression(d.get("compression_training"))
    for key, (asked, where) in LATER_SLICES.items():
        if key in d and asked(d[key]):
            raise NotImplementedError(
                f"config block {key!r} = {d[key]!r} comes with {where} of "
                "the port")
    if _offload(d.get("zero_optimization")):
        raise NotImplementedError(
            "zero_optimization offload (offload_param / offload_optimizer "
            "/ cpu_offload) comes with the offload and tiering slice of "
            "the port")
    opt = d.get("optimizer")
    if isinstance(opt, dict) and opt.get("legacy_fusion"):
        raise NotImplementedError(
            "optimizer.legacy_fusion has no counterpart in the port")
    dt = d.get("data_types")
    if isinstance(dt, dict) and dict_to_dataclass(
            DataTypesConfig, dt, "data_types").resolve() != "float32":
        raise NotImplementedError(
            "data_types.grad_accum_dtype = bf16 comes with a later slice "
            "of the port (gradients accumulate in fp32)")


@dataclass
class DeepSpeedConfig:
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None

    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None

    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    data_types: DataTypesConfig = field(default_factory=DataTypesConfig)

    gradient_clipping: float = 0.0
    # stored as the JAX config does (config.py:412); nothing reads it: a
    # model takes its pattern from its own config's sparsity_config
    sparse_attention: Optional[Dict[str, Any]] = None
    # the weight projections at each optimizer step (compression/,
    # runtime/quantize.py MoQ), read by the engine as the JAX one does
    compression_training: Optional[Dict[str, Any]] = None
    quantize_training: Optional[Dict[str, Any]] = None

    _raw: Dict[str, Any] = field(default_factory=dict, repr=False)

    _SUBCONFIGS = {
        "optimizer": OptimizerConfig,
        "scheduler": SchedulerConfig,
        "fp16": FP16Config,
        "bf16": BF16Config,
        "zero_optimization": ZeroConfig,
        "data_types": DataTypesConfig,
    }

    @classmethod
    def from_dict(cls, d: dict) -> "DeepSpeedConfig":
        d = dict(d or {})
        _later_slice_check(d)
        kwargs: Dict[str, Any] = {"_raw": dict(d)}
        field_names = {f for f in cls.__dataclass_fields__}
        for k, v in d.items():
            if k in cls._SUBCONFIGS:
                if not isinstance(v, dict):
                    raise DeepSpeedConfigError(
                        f"Config section '{k}' must be a dict (e.g. "
                        f"{{\"enabled\": true}}), got {type(v).__name__}: "
                        f"{v!r}")
                kwargs[k] = dict_to_dataclass(cls._SUBCONFIGS[k], v, k)
            elif k in field_names and not k.startswith("_"):
                kwargs[k] = v
            elif k in NO_EFFECT:
                logger.warning(f"config key '{k}' has no effect in this "
                               f"slice of the port: {NO_EFFECT[k]}")
            elif k not in LATER_SLICES:
                logger.warning(f"Unknown top-level config key '{k}' ignored")
        cfg = cls(**kwargs)
        cfg.resolve_batch_sizes(1)
        cfg.validate()
        return cfg

    @classmethod
    def from_file(cls, path: str) -> "DeepSpeedConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def resolve_batch_sizes(self, dp_world_size: int):
        """Reference batch arithmetic (JAX config.py :477): any two of
        {train_batch, micro_batch, gas} determine the third given
        dp_world_size; lone values fill with 1s."""
        tb, mb, gas = (self.train_batch_size,
                       self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is None:
            gas = tb // (mb * dp_world_size)
        elif tb is not None and mb is None and gas is not None:
            mb = tb // (gas * dp_world_size)
        elif tb is None and mb is not None and gas is not None:
            tb = mb * gas * dp_world_size
        elif tb is not None and mb is None and gas is None:
            gas = 1
            mb = tb // dp_world_size
        elif tb is None and mb is not None and gas is None:
            gas = 1
            tb = mb * dp_world_size
        elif tb is None and mb is None and gas is not None:
            mb = 1
            tb = gas * dp_world_size
        elif tb is None and mb is None and gas is None:
            tb, mb, gas = dp_world_size, 1, 1
        (self.train_batch_size, self.train_micro_batch_size_per_gpu,
         self.gradient_accumulation_steps) = tb, mb, gas
        if tb != mb * gas * dp_world_size:
            raise DeepSpeedConfigError(
                f"Batch arithmetic check failed: train_batch_size={tb} != "
                f"micro_batch={mb} * gas={gas} * dp_world={dp_world_size}")

    def validate(self):
        if self.gradient_clipping < 0:
            raise DeepSpeedConfigError("gradient_clipping must be >= 0")

    def to_dict(self):
        d = dataclass_to_dict(self)
        d.pop("_raw", None)
        return d
