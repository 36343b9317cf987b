"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``
``InferenceEngine``): injects a HuggingFace model or config into one of
the port's models (``module_inject``), loads its checkpoint, places it on
its device in the requested compute dtype, and fronts ``forward``,
``generate`` and ``serve``."""

import dataclasses
from collections.abc import Mapping

import torch

from ..ops._common import resolve_device
from ..ops.decode_attention import HEAD_DIMS as DECODE_HEAD_DIMS
from ..ops.flash_attention import FWD_HEAD_DIMS
from ..ops.paged_attention import HEAD_DIMS as PAGED_HEAD_DIMS

# the head dims every serving kernel takes: the flash forward (prefill),
# decode and paged attention
SERVING_HEAD_DIMS = tuple(d for d in FWD_HEAD_DIMS
                          if d in DECODE_HEAD_DIMS and d in PAGED_HEAD_DIMS)
# the compute dtypes every serving kernel has an instance of: the flash
# forward, decode and paged attention and the int8 matmul
SERVING_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


class InferenceEngine:
    """Serve a ``deepspeed_tpu_torch`` model. Construct via
    ``deepspeed_tpu_torch.init_inference``.

    model: a ``models.GPT`` (or any module with a ``config`` carrying
        ``dtype`` and ``max_seq_len``), or, with
        ``replace_with_kernel_inject=True``, a HuggingFace model (read
        through ``.config`` and ``.state_dict()``) or its config (a
        ``transformers`` config or ``module_inject.read_hf_config``'s
        namespace), converted by an injection policy.
    dtype: compute dtype; None keeps the model's (bf16 for an injected
        model, whose parameters are then held in it too). A different
        dtype rebuilds a port model with it.
    params: optional state dict to load (e.g. ``models.convert.
        params_from_jax``, int8 ``q``/``scale`` buffers included).
    checkpoint: weights to load (``module_inject.load_checkpoint``): a HF
        directory or file, a json descriptor, a numpy state dict, or the
        port's engine checkpoint directory.
    injection_policy: an ``InjectionPolicy`` subclass overriding the
        ``model_type`` lookup.
    quantize_weights: serve an int8 copy of the model (weight-only, per
        output channel, every ``QDense`` kernel of at least
        ``quantize_min_size`` elements, or the transform mode for other
        modules; JAX engine.py:77-97), after any checkpoint load; the
        caller's model is not changed.
    device: None means CUDA (raises without a card); "cpu" runs the
        kernels' plain versions. Keyword only: the port's own argument.
        On CUDA a head dim that a serving kernel does not take
        (``SERVING_HEAD_DIMS``) raises a ``ValueError``, and a compute
        dtype that one has no instance of (``SERVING_DTYPES``: fp32,
        bf16, fp16) a ``TypeError``, before any weight is built or
        moved.

    The positional parameters are the JAX engine's, in its order
    (``deepspeed_tpu/inference/engine.py`` ``InferenceEngine.__init__``).
    ``mesh`` does nothing at its default (None) or with a model axis of
    1; ``mp_size > 1``, a wider model axis and ``offload_params`` raise
    ``NotImplementedError`` naming the slice of the port that brings
    them. Other keyword arguments are accepted and ignored, as the JAX
    engine ignores them.
    """

    def __init__(self, model, mp_size: int = 1, dtype=None, params=None,
                 checkpoint=None, replace_with_kernel_inject: bool = False,
                 injection_policy=None, max_tokens: int = 1024, mesh=None,
                 quantize_weights: bool = False,
                 quantize_min_size: int = 4096,
                 offload_params: bool = False, *, device=None, **kwargs):
        later = {
            "mp_size > 1": (mp_size > 1, "the multi-GPU slice"),
            "a mesh with a model axis > 1": (_model_axis(mesh) > 1,
                                             "the multi-GPU slice"),
            "offload_params": (offload_params,
                               "the offload and tiering slice"),
        }
        for name, (asked, slice_name) in later.items():
            if asked:
                raise NotImplementedError(
                    f"init_inference({name}) comes with {slice_name} of the "
                    "port")
        # imported here: module_inject imports the models, which import
        # this package's cache
        from ..module_inject.module_quantize import (adopt_int8_layout,
                                                     quantize_for_serving)
        from ..module_inject.replace_module import (
            _resolve_policy, is_port_model, replace_transformer_layer,
            serving_config)
        self.device = resolve_device(device)
        inject = replace_with_kernel_inject and not is_port_model(model)
        if inject:
            hf_config = getattr(model, "config", model)
            cfg = serving_config(_resolve_policy(hf_config, injection_policy),
                                 hf_config, dtype or torch.bfloat16)
        else:
            cfg = model.config
        if self.device.type == "cuda":
            check_head_dim(cfg)
            check_dtype(dtype if dtype is not None
                        else getattr(cfg, "dtype", None))
        if inject:
            model, params = replace_transformer_layer(
                model, params=params, policy=injection_policy,
                dtype=dtype or torch.bfloat16, checkpoint=checkpoint)
            params = None          # loaded into the injected model
        elif params is None and checkpoint is not None:
            from ..module_inject.load_checkpoint import load_model_checkpoint
            params = load_model_checkpoint(
                model, checkpoint, dtype=dtype or model.config.dtype,
                policy=injection_policy)
        if dtype is not None and dtype != model.config.dtype:
            rebuilt = type(model)(dataclasses.replace(model.config,
                                                      dtype=dtype))
            state = model.state_dict()
            adopt_int8_layout(rebuilt, state)
            rebuilt.load_state_dict(state)
            model = rebuilt
        if params is not None:
            adopt_int8_layout(model, params)
            model.load_state_dict(params)
        if quantize_weights:
            model = quantize_for_serving(model, min_size=quantize_min_size)
        self.injected = inject
        self.module = model.to(self.device).eval().requires_grad_(False)
        self.max_tokens = max_tokens

    @torch.no_grad()
    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    __call__ = forward

    def generate(self, input_ids, max_new_tokens: int = 32, **kwargs):
        """Greedy/sampled generation with a preallocated KV cache sized to
        the engine's ``max_tokens`` (clamped to the model's limit)."""
        import numpy as np
        from .generation import generate as _generate
        width = np.shape(input_ids)[-1]
        prompt_lengths = kwargs.get("prompt_lengths")
        pad_only_ragged = (prompt_lengths is None
                           and kwargs.get("pad_token_id") is not None)
        if not pad_only_ragged:
            prompt_len = (int(np.max(np.asarray(prompt_lengths)))
                          if prompt_lengths is not None else width)
            needed = prompt_len + max_new_tokens
            model_max = self.module.config.max_seq_len
            if needed > model_max:
                raise ValueError(
                    f"prompt_len ({prompt_len}) + max_new_tokens "
                    f"({max_new_tokens}) = {needed} exceeds the model's "
                    f"max_seq_len {model_max}; shorten the prompt or reduce "
                    "max_new_tokens")
            kwargs.setdefault("max_len", min(max(self.max_tokens, needed),
                                             model_max))
        return _generate(self.module, input_ids,
                         max_new_tokens=max_new_tokens, **kwargs)

    def serve(self, config=None, **kwargs):
        """Continuous-batching serving over this engine's model (slot-based
        KV cache, FIFO request queue). ``config`` is a
        ``serving.ServingConfig`` or dict; extra kwargs override knobs."""
        from ..serving.engine import ServingEngine
        return ServingEngine(self.module, config, **kwargs)


def check_head_dim(cfg):
    """A ``ValueError`` naming the head dim when a serving kernel does not
    take it (``SERVING_HEAD_DIMS``: the flash forward's, decode's and
    paged attention's in common)."""
    if not hasattr(cfg, "d_model") or not hasattr(cfg, "n_heads"):
        return
    head_dim = cfg.d_model // cfg.n_heads
    if head_dim not in SERVING_HEAD_DIMS:
        raise ValueError(
            f"head_dim {head_dim} (d_model {cfg.d_model} / {cfg.n_heads} "
            f"heads): the serving kernels take head dims "
            f"{SERVING_HEAD_DIMS} (device='cpu' runs their plain versions, "
            "which take any)")


def check_dtype(dtype):
    """A ``TypeError`` naming ``dtype`` when a serving kernel has no
    instance of it (``SERVING_DTYPES``); None (no compute dtype) passes."""
    if dtype is not None and dtype not in SERVING_DTYPES:
        raise TypeError(
            f"compute dtype {dtype}: the serving kernels take "
            f"{[str(d).replace('torch.', '') for d in SERVING_DTYPES]} "
            "(device='cpu' runs their plain versions)")


def _model_axis(mesh) -> int:
    """The width of ``mesh``'s model axis: a mesh's ``shape`` mapping
    (``jax.sharding.Mesh``), a mapping of axis sizes, or a ``MeshSpec``'s
    ``model``; 1 for None."""
    if mesh is None:
        return 1
    shape = getattr(mesh, "shape", mesh)
    if isinstance(shape, Mapping):
        return int(shape.get("model", 1))
    return int(getattr(mesh, "model", 1))
