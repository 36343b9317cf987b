"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``
``InferenceEngine``): places a model on its device, in the requested
compute dtype, and fronts ``forward``, ``generate`` and ``serve``."""

import dataclasses
from collections.abc import Mapping

import torch

from ..module_inject.module_quantize import (adopt_int8_layout,
                                             quantize_for_serving)
from ..ops._common import resolve_device


class InferenceEngine:
    """Serve a ``deepspeed_tpu_torch`` model. Construct via
    ``deepspeed_tpu_torch.init_inference``.

    model: a ``models.GPT`` (or any module with a ``config`` carrying
        ``dtype`` and ``max_seq_len``).
    dtype: compute dtype; None keeps the model's. A different dtype
        rebuilds the model with it (master weights stay fp32).
    params: optional state dict to load (e.g. ``models.convert.
        params_from_jax``, int8 ``q``/``scale`` buffers included).
    quantize_weights: serve an int8 copy of the model (weight-only, per
        output channel, every ``QDense`` kernel of at least
        ``quantize_min_size`` elements; JAX engine.py:77-97); the caller's
        model is not changed.
    device: None means CUDA (raises without a card); "cpu" runs the
        kernels' plain versions. Keyword only: the port's own argument.

    The positional parameters are the JAX engine's, in its order
    (``deepspeed_tpu/inference/engine.py`` ``InferenceEngine.__init__``).
    ``checkpoint``, ``injection_policy`` and ``mesh`` do nothing at their
    default (None), and a ``mesh`` whose model axis is 1 does nothing
    either; other values raise ``NotImplementedError`` naming the slice of
    the port that brings them. Other keyword arguments are accepted and
    ignored, as the JAX engine ignores them.
    """

    def __init__(self, model, mp_size: int = 1, dtype=None, params=None,
                 checkpoint=None, replace_with_kernel_inject: bool = False,
                 injection_policy=None, max_tokens: int = 1024, mesh=None,
                 quantize_weights: bool = False,
                 quantize_min_size: int = 4096,
                 offload_params: bool = False, *, device=None, **kwargs):
        later = {
            "mp_size > 1": (mp_size > 1, "the multi-GPU slice"),
            "checkpoint": (checkpoint is not None,
                           "the checkpoint-injection slice"),
            "replace_with_kernel_inject": (replace_with_kernel_inject,
                                           "the checkpoint-injection slice"),
            "injection_policy": (injection_policy is not None,
                                 "the checkpoint-injection slice"),
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
        self.device = resolve_device(device)
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
