"""User-facing activation-checkpointing API (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

The reference's Megatron-compatible surface on
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
``configure()`` reads the ``activation_checkpointing`` block,
``checkpoint(function, *args)`` recomputes the region in the backward,
``set_remat_policy`` picks what a region saves (the models' policy names,
``models.layers.REMAT_POLICIES``):

- ``full`` (the default, the reference's semantics): only the region's
  inputs are kept;
- ``none``: everything is kept (the region is not checkpointed);
- ``dots`` / ``dots_no_batch``: the outputs of the region's matmuls
  (aten ``mm``/``addmm``/``bmm``/``baddbmm``, resp. those without a batch
  dimension) are kept through selective checkpointing;
- ``attn_out``: in a user's region nothing names the attention output, so
  it recomputes like ``full``; the models' blocks place their regions
  around attention instead (``models.layers.Block``).

One card: ``partition_activations`` has no model-parallel axis to shard
over and is a no-op; a model-parallel ``mpu`` raises. CPU checkpointing
(``checkpoint_in_cpu``, the ``offload`` policy) comes with the offload and
tiering slice and raises.

RNG: the port's dropout draws its keep mask from a counter hash of the
seed words, so a recomputed region drops the same elements with no state
saved. The tracker hands out named ``torch.Generator`` streams for ported
code that draws its own numbers: ``fork(name)`` returns a generator seeded
from the named stream, which it advances.
"""

import functools

import torch
import torch.utils.checkpoint

from ..config_utils import logger

# module-level knobs (the reference keeps the same module-global pattern)
_CONFIGURED = False
PARTITION_ACTIVATIONS = False
CONTIGUOUS_CHECKPOINTING = False
SYNCHRONIZE = False
PROFILE_TIME = False
REMAT_POLICY = None      # a models.layers.REMAT_POLICIES key; None = full
_NUM_LAYERS = None
_MPU = None


def _refuse_offload(what):
    raise NotImplementedError(
        f"{what} (saved activations in host memory) comes with the offload "
        "and tiering slice of the port")


def set_remat_policy(name):
    """Select what a checkpointed region saves: a
    ``models.layers.REMAT_POLICIES`` key, or None for the default
    (``full``)."""
    global REMAT_POLICY
    if name is not None:
        from ...models.layers import remat_policy
        remat_policy(name)          # refuses "offload" and unknown names
    REMAT_POLICY = name


def checkpoint(function, *args, **kwargs):
    """``function(*args, **kwargs)``, recomputed in the backward instead
    of keeping its internals (reference: checkpointing.py:743); what it
    keeps follows ``set_remat_policy``."""
    name = REMAT_POLICY or "full"
    if name == "none":
        return function(*args, **kwargs)
    from ...models.layers import checkpointed, remat_policy
    policy = remat_policy(name)
    fn = functools.partial(function, **kwargs) if kwargs else function
    if PROFILE_TIME:
        with torch.profiler.record_function("act_checkpoint"):
            return checkpointed(policy, fn, *args)
    return checkpointed(policy, fn, *args)


def checkpoint_wrapper(function):
    """Decorator form: ``layer = checkpoint_wrapper(layer_fn)``."""
    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        return checkpoint(function, *args, **kwargs)
    return wrapped


def partition_activations_in_checkpoint(partition_activation):
    """Reference: checkpointing.py:755. Recorded; a no-op on one card (no
    model-parallel axis to shard the saved activations over)."""
    global PARTITION_ACTIVATIONS
    PARTITION_ACTIVATIONS = bool(partition_activation)


def set_num_layers(nlayers):
    global _NUM_LAYERS
    _NUM_LAYERS = nlayers


def _model_parallel_size(mpu):
    get = getattr(mpu, "get_model_parallel_world_size", None)
    return int(get()) if callable(get) else 1


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None,
              remat_policy=None):
    """Reference: checkpointing.py:825, plus ``remat_policy``. Knobs with
    no counterpart on one card (contiguous buffers, explicit synchronize,
    partitioning) are recorded and change nothing."""
    global _CONFIGURED, _MPU, PARTITION_ACTIVATIONS
    global CONTIGUOUS_CHECKPOINTING, SYNCHRONIZE, PROFILE_TIME, _NUM_LAYERS

    if mpu_ is not None and _model_parallel_size(mpu_) > 1:
        raise NotImplementedError(
            "activation checkpointing over a model-parallel group comes "
            "with the multi-GPU slice of the port")
    if deepspeed_config is not None:
        block = deepspeed_config
        if not isinstance(block, dict):
            from ..config import DeepSpeedConfig
            cfg = (block if isinstance(block, DeepSpeedConfig)
                   else DeepSpeedConfig.from_file(block))
            acfg = cfg.activation_checkpointing
            block = {
                "partition_activations": acfg.partition_activations,
                "cpu_checkpointing": acfg.cpu_checkpointing,
                "contiguous_memory_optimization":
                    acfg.contiguous_memory_optimization,
                "synchronize_checkpoint_boundary":
                    acfg.synchronize_checkpoint_boundary,
                "profile": acfg.profile,
                "number_checkpoints": acfg.number_checkpoints,
                "remat_policy": acfg.remat_policy,
            }
        else:
            block = block.get("activation_checkpointing", block)
        if block.get("cpu_checkpointing"):
            _refuse_offload("activation_checkpointing.cpu_checkpointing")
        PARTITION_ACTIVATIONS = bool(block.get("partition_activations", False))
        if block.get("remat_policy") is not None:
            set_remat_policy(block["remat_policy"])
        CONTIGUOUS_CHECKPOINTING = bool(
            block.get("contiguous_memory_optimization", False))
        SYNCHRONIZE = bool(block.get("synchronize_checkpoint_boundary", False))
        PROFILE_TIME = bool(block.get("profile", False))
        if block.get("number_checkpoints"):
            _NUM_LAYERS = block["number_checkpoints"]

    if partition_activations is not None:
        PARTITION_ACTIVATIONS = bool(partition_activations)
    if contiguous_checkpointing is not None:
        CONTIGUOUS_CHECKPOINTING = bool(contiguous_checkpointing)
    if num_checkpoints is not None:
        _NUM_LAYERS = num_checkpoints
    if checkpoint_in_cpu:
        _refuse_offload("checkpoint_in_cpu")
    if synchronize is not None:
        SYNCHRONIZE = bool(synchronize)
    if profile is not None:
        PROFILE_TIME = bool(profile)
    if remat_policy is not None:
        set_remat_policy(remat_policy)
    if PARTITION_ACTIVATIONS:
        logger.warning("partition_activations: one card has no "
                       "model-parallel axis to shard saved activations "
                       "over; no-op")
    _MPU = mpu_
    _CONFIGURED = True


def is_configured():
    return _CONFIGURED


def reset():
    """Reference: checkpointing.py:768 — clear the configured state."""
    global _CONFIGURED, _MPU, PARTITION_ACTIVATIONS
    global CONTIGUOUS_CHECKPOINTING, SYNCHRONIZE, PROFILE_TIME, _NUM_LAYERS
    global REMAT_POLICY
    _CONFIGURED = False
    _MPU = None
    PARTITION_ACTIVATIONS = False
    CONTIGUOUS_CHECKPOINTING = SYNCHRONIZE = PROFILE_TIME = False
    REMAT_POLICY = None
    _NUM_LAYERS = None


class RNGStatesTracker:
    """Named random streams (reference: CudaRNGStatesTracker,
    checkpointing.py:122) on explicit ``torch.Generator``s: ``add`` seeds
    a stream once, ``fork(name)`` returns a fresh generator seeded from it
    and advances it."""

    def __init__(self):
        self._states = {}

    def reset(self):
        self._states.clear()

    def get_states(self):
        return {name: gen.get_state() for name, gen in self._states.items()}

    def set_states(self, states):
        self._states = {}
        for name, state in states.items():
            gen = torch.Generator()
            gen.set_state(state)
            self._states[name] = gen

    def add(self, name, seed):
        if name in self._states:
            raise ValueError(f"rng state {name} already exists")
        self._states[name] = torch.Generator().manual_seed(int(seed))

    def fork(self, name="model-parallel-rng"):
        if name not in self._states:
            raise ValueError(f"rng state {name} was never added")
        seed = int(torch.randint(0, 2 ** 62, (), generator=self._states[name]))
        return torch.Generator().manual_seed(seed)


_RNG_TRACKER = RNGStatesTracker()


def get_rng_tracker():
    return _RNG_TRACKER


# reference-name alias (get_cuda_rng_tracker, checkpointing.py:193)
get_cuda_rng_tracker = get_rng_tracker


def model_parallel_seed(seed, mesh=None):
    """Reference: model_parallel_cuda_manual_seed (checkpointing.py:198):
    the data-parallel stream takes ``seed``, the model-parallel one
    ``seed + 2718`` (one card: rank 0's offset). Returns the tracker."""
    if mesh is not None:
        raise NotImplementedError(
            "model_parallel_seed over a mesh comes with the multi-GPU slice "
            "of the port")
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("data-parallel-rng", seed)
    _RNG_TRACKER.add("model-parallel-rng", seed + 2718)
    return _RNG_TRACKER


model_parallel_cuda_manual_seed = model_parallel_seed
