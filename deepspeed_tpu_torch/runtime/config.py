"""The training config (counterpart of ``deepspeed_tpu/runtime/config.py``).

The same JSON schema and key names: ``DeepSpeedConfig.from_dict`` reads
the blocks this slice of the port runs (batch sizes, ``optimizer``,
``scheduler``, ``fp16`` with static or dynamic loss scaling, ``bf16``,
``gradient_clipping``, ``zero_optimization`` stage 0/1, ``data_types``
fp32 or bf16 gradient accumulation, ``activation_checkpointing``,
``progressive_layer_drop``, ``sparse_attention`` stored unread as in the
JAX package, ``compression_training`` weight quantization and pruning,
``quantize_training`` MoQ, ``serving`` for ``ServingEngine.from_config``)
and resolves the reference's batch
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
    """fp16 block (JAX config.py:32-45): ``loss_scale`` 0 means dynamic
    scaling from 2 ** ``initial_scale_power``. ``auto_cast`` is stored and,
    as in the JAX package, read by nothing."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0           # 0 -> dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0

    @property
    def dynamic_loss_scale(self):
        return self.loss_scale == 0


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
class ActivationCheckpointingConfig:
    """activation_checkpointing block (JAX config.py:185-205):
    ``remat_policy`` picks what a checkpointed block saves (None: the
    model's own policy, or ``full`` when it has none)."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    remat_policy: Optional[str] = None

    def __post_init__(self):
        # the models' table is the one list of names; "offload" is known
        # and refused by name at config read (_later_slice_check)
        from ..models.layers import REMAT_POLICIES
        names = (*REMAT_POLICIES, "offload")
        if self.remat_policy is not None and self.remat_policy not in names:
            raise DeepSpeedConfigError(
                f"activation_checkpointing.remat_policy must be one of "
                f"{names}, got {self.remat_policy!r}")


@dataclass
class ProgressiveLayerDropConfig:
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


@dataclass
class DataTypesConfig:
    """data_types block: gradient accumulation in fp32 (the default) or
    bf16."""
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
    "zero_optimization": (
        lambda z: isinstance(z, dict) and int(z.get("stage", 0)) >= 2,
        "the multi-GPU ZeRO slice (stage >= 2)"),
    "tiering": (_on, "the offload and tiering slice"),
    "pipeline": (lambda b: isinstance(b, dict)
                 and int(b.get("stages", 1)) > 1, "the pipeline slice"),
    "mesh": (_mesh_wide, "the multi-GPU slice (mesh axes > 1, MoE)"),
    "resilience": (_on, "the resilience slice"),
    "observability": (_on, "the observability slice"),
    "curriculum_learning": (_on, "the data-efficiency slice"),
    "data_efficiency": (lambda b: bool(b), "the data-efficiency slice"),
    "eigenvalue": (_on, "the compression slice (eigenvalue)"),
    "flops_profiler": (_on, "the observability slice"),
    "comms_logger": (_on, "the observability slice"),
    "tensorboard": (_on, "the observability slice (monitors)"),
    "wandb": (_on, "the observability slice (monitors)"),
    "csv_monitor": (_on, "the observability slice (monitors)"),
    "elasticity": (lambda b: bool(b), "the multi-GPU slice (elasticity)"),
    "autotuning": (lambda b: bool(b), "the autotuning slice"),
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
    "checkpoint": "the JAX config stores the block and nothing reads it; "
                  "engine.save_checkpoint and load_checkpoint take their "
                  "arguments",
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
    ac = d.get("activation_checkpointing")
    if isinstance(ac, dict) and (ac.get("cpu_checkpointing")
                                 or ac.get("remat_policy") == "offload"):
        raise NotImplementedError(
            "activation_checkpointing cpu_checkpointing / remat policy "
            "'offload' (saved activations in host memory) comes with the "
            "offload and tiering slice of the port")


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
    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig)
    progressive_layer_drop: ProgressiveLayerDropConfig = field(
        default_factory=ProgressiveLayerDropConfig)

    gradient_clipping: float = 0.0
    # stored as the JAX config does (config.py:412); nothing reads it: a
    # model takes its pattern from its own config's sparsity_config
    sparse_attention: Optional[Dict[str, Any]] = None
    # the weight projections at each optimizer step (compression/,
    # runtime/quantize.py MoQ), read by the engine as the JAX one does
    compression_training: Optional[Dict[str, Any]] = None
    quantize_training: Optional[Dict[str, Any]] = None
    # the continuous-batching serving engine's block (serving/config.py
    # ``ServingConfig``, nested blocks lifted there), read by
    # ``ServingEngine.from_config``; absent means "not serving"
    serving: Any = None

    _raw: Dict[str, Any] = field(default_factory=dict, repr=False)

    _SUBCONFIGS = {
        "optimizer": OptimizerConfig,
        "scheduler": SchedulerConfig,
        "fp16": FP16Config,
        "bf16": BF16Config,
        "zero_optimization": ZeroConfig,
        "data_types": DataTypesConfig,
        "activation_checkpointing": ActivationCheckpointingConfig,
        "progressive_layer_drop": ProgressiveLayerDropConfig,
    }

    @classmethod
    def from_dict(cls, d: dict) -> "DeepSpeedConfig":
        d = dict(d or {})
        _later_slice_check(d)
        kwargs: Dict[str, Any] = {"_raw": dict(d)}
        field_names = {f for f in cls.__dataclass_fields__}
        for k, v in d.items():
            if k == "serving" and v is not None:
                # imported here: the serving package pulls in the model
                # and kernel modules, which this module must not need
                from ..serving.config import ServingConfig
                kwargs[k] = dict_to_dataclass(ServingConfig, v, k)
            elif k in cls._SUBCONFIGS:
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
        fp16 = d.get("fp16")
        if isinstance(fp16, dict) and not fp16.get("enabled", False):
            for k in fp16:
                if k != "enabled" and k in FP16Config.__dataclass_fields__:
                    logger.warning(f"config key 'fp16.{k}' has no effect: "
                                   "fp16 is not enabled")
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
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        if self.fp16.enabled and self.data_types.resolve() != "float32":
            raise DeepSpeedConfigError(
                "data_types.grad_accum_dtype=bf16 is incompatible with fp16 "
                "loss scaling (unscale needs fp32 headroom)")
        if self.gradient_clipping < 0:
            raise DeepSpeedConfigError("gradient_clipping must be >= 0")
        if self.serving is not None:
            # at parse time, not at ServingEngine construction (JAX
            # config.py:539-546); a fleet block still raises
            # NotImplementedError from here
            try:
                self.serving.validate()
            except ValueError as e:
                raise DeepSpeedConfigError(f"serving: {e}") from e

    def to_dict(self):
        d = dataclass_to_dict(self)
        d.pop("_raw", None)
        return d
