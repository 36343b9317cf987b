"""Kernel injection: a HuggingFace model, or its config and a checkpoint,
re-expressed as one of the port's models (counterpart of
``deepspeed_tpu/module_inject/replace_module.py``).

The whole HF model becomes the port's ``GPT`` or ``BertEncoder`` (whose
layers run the hand-written kernels), with the HF weights converted by
an architecture policy (``replace_policy.py``). A HuggingFace model is
read duck-typed, through ``.config`` and ``.state_dict()``; the port never
imports ``transformers``. Tensor-parallel slicing (JAX's
``shard_params_for_inference``) comes with the multi-GPU slice.
"""

import dataclasses

import numpy as np
import torch

from ..models.bert import BertEncoder, BertForPreTraining
from ..models.convert import params_from_jax
from ..models.gpt import GPT
from ..runtime.config_utils import logger
from .replace_policy import POLICY_REGISTRY

# the port's own models: injection hands them back unchanged
PORT_MODELS = (GPT, BertEncoder, BertForPreTraining)


def is_port_model(model) -> bool:
    return isinstance(model, PORT_MODELS)


def _resolve_policy(hf_config, policy=None):
    if policy is not None:
        return policy
    mt = getattr(hf_config, "model_type", None)
    if mt in POLICY_REGISTRY:
        return POLICY_REGISTRY[mt]
    raise ValueError(
        f"no injection policy for model_type={mt!r}; available: "
        f"{sorted(POLICY_REGISTRY)} (pass policy= explicitly for custom "
        f"architectures, reference: injection_policy kwarg of init_inference)")


def _state_dict_numpy(model) -> dict:
    """torch state dict -> plain numpy dict (fp32 host copies)."""
    out = {}
    for k, v in model.state_dict().items():
        arr = v.detach().cpu()
        out[k] = np.asarray(arr.float().numpy() if arr.is_floating_point()
                            else arr.numpy())
    return out


def serving_config(pol, hf_config, dtype):
    """The policy's config with the serving dtype as the parameter dtype
    too (JAX :91): serving holds no fp32 master copy, so a bf16
    Pythia-1.4B holds 2.8 GB of weights, not 5.6 GB, and no dense layer
    casts its weight on every call. Configs without ``param_dtype`` (BERT)
    keep fp32 parameters."""
    cfg = pol.build_config(hf_config, dtype)
    if dtype is not None and getattr(cfg, "param_dtype", None) is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    return cfg


def build_model(pol, cfg, state=None):
    """The policy's model class at ``cfg``: holding ``state`` (a port
    state dict) when given, else weights drawn from seed 0."""
    if state is None:
        return pol.model_class(cfg)
    model = pol.model_class(cfg, seed=None)
    model.load_state_dict(state)
    return model


def replace_transformer_layer(model, params=None, policy=None,
                              dtype=torch.bfloat16, checkpoint=None,
                              device=None):
    """A HF model (weights converted), a HF config (weights from
    ``checkpoint``, else drawn from seed 0) or one of the port's models
    (returned unchanged) -> (the port's model holding the weights, its
    state dict or None).

    params: a port state dict to load instead of converting weights.
    policy: an ``InjectionPolicy`` subclass (default: by ``model_type``).
    device: where to place the model (default: the CPU)."""
    if is_port_model(model):
        return model, params

    hf_config = getattr(model, "config", model)
    pol = _resolve_policy(hf_config, policy)
    cfg = serving_config(pol, hf_config, dtype)

    if params is None:
        sd = None
        if hasattr(model, "state_dict"):
            sd = _state_dict_numpy(model)
        elif checkpoint is not None:
            from .load_checkpoint import load_state_dict_from_checkpoint
            sd = load_state_dict_from_checkpoint(checkpoint)
        if sd is not None:
            params = params_from_jax(pol.convert(sd, cfg), cfg)
            del sd
            logger.info(f"injected {pol.__name__}: {cfg.n_layers} layers "
                        f"d_model={cfg.d_model} heads={cfg.n_heads}")
    module = build_model(pol, cfg, params)
    if device is not None:
        module = module.to(device)
    return module, params
