"""The port's GPT against the JAX package's GPT on the same weights.

A JAX ``GPT`` is initialised from a seed, its params go through
``params_from_jax`` into the port's ``GPT``, and the same numpy token ids
go through both. fp32 on the CPU; tolerance atol 1e-4 on the logits (two
fp32 evaluations of a 2-layer model whose matmuls and softmax sum in
different orders). The helpers here are shared by the other
``test_torch_*`` parity files.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.core import meta, unfreeze

from deepspeed_tpu.inference.generation import _prefill_impl as jax_prefill
from deepspeed_tpu.inference.generation import init_cache as jax_init_cache
from deepspeed_tpu.models.gpt import GPT as JaxGPT
from deepspeed_tpu.models.gpt import GPTConfig as JaxGPTConfig
from deepspeed_tpu_torch.inference.generation import init_cache
from deepspeed_tpu_torch.models import GPT, GPTConfig
from deepspeed_tpu_torch.models.convert import params_from_jax

LOGIT_ATOL = 1e-4
TINY = dict(vocab_size=97, max_seq_len=128, d_model=128, n_layers=2,
            n_heads=2)
VARIANTS = {
    "gpt2": {},
    "bloom": dict(alibi=True, learned_pos=False, embed_ln=True),
    "neox": dict(parallel_residual=True, use_bias=False),
    "gptj": dict(parallel_residual=True, shared_parallel_ln=True,
                 attn_use_bias=False, tie_embeddings=False,
                 lm_head_bias=True),
}


def jax_gpt(seed=0, scan_layers=True, **overrides):
    """(JAX module, params) for the tiny fp32 config."""
    cfg = JaxGPTConfig(**{**TINY, **overrides}, dtype=jnp.float32,
                       scan_layers=scan_layers)
    m = JaxGPT(cfg)
    params = m.init(jax.random.PRNGKey(seed),
                    jnp.ones((1, 8), jnp.int32))["params"]
    return m, params


def port_gpt(jax_module, params):
    """The port's fp32 GPT on the CPU holding the JAX params."""
    jc = jax_module.config
    assert jc.activation == "gelu" and not jc.rotary
    cfg = GPTConfig(**{f: getattr(jc, f) for f in (
        "vocab_size", "max_seq_len", "d_model", "n_layers", "n_heads",
        "d_ff", "use_bias", "ln_epsilon", "tie_embeddings", "learned_pos",
        "parallel_residual", "shared_parallel_ln", "attn_use_bias", "alibi",
        "embed_ln", "lm_head_bias")}, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, unfreeze(meta.unbox(params)))
    model = GPT(cfg)
    model.load_state_dict(params_from_jax(tree, cfg))
    return model.eval().requires_grad_(False)


def tokens(shape, seed=0, vocab=TINY["vocab_size"]):
    return np.random.RandomState(seed).randint(1, vocab, size=shape).astype(
        np.int32)


@pytest.mark.parametrize("variant,scan_layers", [
    ("gpt2", True), ("gpt2", False), ("bloom", True), ("neox", False),
    ("gptj", False)])
def test_full_forward_logits_match(variant, scan_layers):
    jm, params = jax_gpt(scan_layers=scan_layers, **VARIANTS[variant])
    model = port_gpt(jm, params)
    ids = tokens((2, 24))
    mask = np.ones((2, 24), np.int32)
    mask[1, 17:] = 0                                    # a padded row
    ref = jm.apply({"params": params}, jnp.asarray(ids),
                   attention_mask=jnp.asarray(mask))
    out = model(torch.from_numpy(ids).long(),
                attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL, rtol=0)


def test_params_from_jax_covers_every_parameter():
    jm, params = jax_gpt(scan_layers=True)
    model = port_gpt(jm, params)
    tree = jax.tree.map(np.asarray, unfreeze(meta.unbox(params)))
    sd = params_from_jax(tree, model.config)
    assert set(sd) == set(model.state_dict())
    # kernels keep the flax [in, out] orientation and the qkv column order
    np.testing.assert_array_equal(sd["h.1.attn.qkv.kernel"].numpy(),
                                  tree["h"]["attn"]["qkv"]["kernel"][1])


@pytest.mark.parametrize("variant", ["gpt2", "bloom"])
def test_prefill_then_decode_logits_match(variant):
    """Prefill a prompt into the cache, then 4 single-token steps: every
    step's logits match JAX ``apply(decode=True)``."""
    jm, params = jax_gpt(**VARIANTS[variant])
    model = port_gpt(jm, params)
    b, s, max_len = 2, 20, 128
    ids = tokens((b, s), seed=1)
    steps = tokens((4, b), seed=2)

    jcache = jax_init_cache(jm, params, b, max_len)
    ref, jcache = jax_prefill(jm, params, jcache, jnp.asarray(ids),
                              jnp.arange(s))
    cache = init_cache(model, b, max_len)
    out = model(torch.from_numpy(ids).long(),
                positions=torch.arange(s), cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL, rtol=0)
    jax_step = jax.jit(lambda c, t, p: jm.apply(
        {"params": params, "cache": c}, t, decode=True, positions=p,
        mutable=["cache"]))
    for i, tok in enumerate(steps):
        pos = s + i
        ref, vars_out = jax_step(jcache, jnp.asarray(tok)[:, None],
                                 jnp.asarray([pos]))
        jcache = vars_out["cache"]
        out = model(torch.from_numpy(tok).long()[:, None],
                    positions=torch.tensor([pos]), cache=cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"decode step {i}")
    assert cache.index == s + len(steps)
