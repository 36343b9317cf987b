"""The port's rotary embedding and the GPT knobs that come with it
(``rotary``, ``rotary_dim``, ``activation``, ``param_dtype``) against the
JAX package, on the CPU.

``apply_rotary_pos_emb`` takes the same numpy q/k (seeded) in both
packages: fp32 within 1e-6, bf16 within 2e-2, for [s] and [b, s]
positions and rotary_dim below and equal to head_dim. A rotary GPT (2
layers, d_model 128, 2 heads of 64, rotary dim 16) holds JAX's
parameters: its logits within 1e-4 (fp32, ``test_torch_model.py``'s
tolerance), its cache holds JAX's post-rotary K after a prefill
(within 1e-5), decode steps match, and positions past ``max_seq_len``
reach rotary unclamped (the learned-position gather clamps them).
"""

import dataclasses
import functools

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
from deepspeed_tpu.ops.transformer.rotary import \
    apply_rotary_pos_emb as jax_rotary
from deepspeed_tpu_torch.inference.generation import init_cache
from deepspeed_tpu_torch.models import GPT, GPTConfig
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.transformer.rotary import apply_rotary_pos_emb
from tests.torch_threads import share_cores

share_cores()

TINY = dict(vocab_size=97, max_seq_len=64, d_model=128, n_layers=2,
            n_heads=2)
ROTARY = dict(rotary=True, rotary_dim=16, learned_pos=False,
              parallel_residual=True, use_bias=True)
LOGIT_ATOL = 1e-4
TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _qk(shape, seed):
    r = np.random.RandomState(seed)
    return (r.standard_normal(shape).astype(np.float32),
            r.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rotary_dim", [16, 64])
@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rotary_pos_emb_matches_jax(dtype, rotary_dim, per_row):
    b, s, h, d = 2, 12, 3, 64
    q, k = _qk((b, s, h, d), seed=rotary_dim + per_row)
    r = np.random.RandomState(5)
    pos = (r.randint(0, 3000, (b, s)) if per_row
           else np.arange(7, 7 + s)).astype(np.int32)
    jq, jk = jax_rotary(jnp.asarray(q, JNP[dtype]), jnp.asarray(k, JNP[dtype]),
                        rotary_dim=rotary_dim, positions=jnp.asarray(pos))
    pq, pk = apply_rotary_pos_emb(torch.from_numpy(q).to(dtype),
                                  torch.from_numpy(k).to(dtype),
                                  rotary_dim=rotary_dim,
                                  positions=torch.from_numpy(pos))
    assert pq.dtype == pk.dtype == dtype
    for got, ref in ((pq, jq), (pk, jk)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=TOL[dtype], rtol=0)
    if rotary_dim < d:      # the tail passes through untouched
        np.testing.assert_array_equal(
            pq[..., rotary_dim:].float().numpy(),
            torch.from_numpy(q[..., rotary_dim:]).to(dtype).float().numpy())


def test_default_positions_are_arange():
    q, k = _qk((1, 9, 2, 64), seed=3)
    a = apply_rotary_pos_emb(torch.from_numpy(q), torch.from_numpy(k), 32)
    b = apply_rotary_pos_emb(torch.from_numpy(q), torch.from_numpy(k), 32,
                             positions=torch.arange(9))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@functools.lru_cache(maxsize=None)
def jax_rotary_gpt(seed=3, **overrides):
    cfg = JaxGPTConfig(**{**TINY, **ROTARY, **overrides}, dtype=jnp.float32)
    m = JaxGPT(cfg)
    params = m.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))
    return m, params["params"]


def port_of(jm, params, **extra):
    jc = jm.config
    cfg = GPTConfig(**{f: getattr(jc, f) for f in (
        "vocab_size", "max_seq_len", "d_model", "n_layers", "n_heads",
        "d_ff", "use_bias", "ln_epsilon", "tie_embeddings", "learned_pos",
        "parallel_residual", "shared_parallel_ln", "attn_use_bias", "alibi",
        "embed_ln", "lm_head_bias", "rotary", "rotary_dim", "activation")},
        dtype=torch.float32, **extra)
    tree = jax.tree.map(np.asarray, unfreeze(meta.unbox(params)))
    model = GPT(cfg, seed=None)
    model.load_state_dict(params_from_jax(tree, cfg))
    return model.eval().requires_grad_(False)


def _ids(shape, seed):
    return np.random.RandomState(seed).randint(
        1, TINY["vocab_size"], size=shape).astype(np.int32)


def test_rotary_gpt_logits_match_jax():
    """SiLU: the activation knob reaches the MLP (the injected models
    hold the tanh and exact GELUs)."""
    jm, params = jax_rotary_gpt(activation="silu")
    model = port_of(jm, params)
    assert model.h[0].mlp.act is torch.nn.functional.silu
    ids = _ids((2, 20), seed=1)
    ref = jm.apply({"params": params}, jnp.asarray(ids))
    out = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL, rtol=0)


def test_positions_past_the_table_reach_rotary_unclamped():
    """A rotary model without learned positions at positions 100.. of a
    64-position model: JAX rotates at the raw positions, and so does the
    port (the clamp lives in the learned-position gather only)."""
    jm, params = jax_rotary_gpt(activation="silu")
    model = port_of(jm, params)
    ids = _ids((1, 10), seed=2)
    pos = np.arange(100, 110)
    ref = jm.apply({"params": params}, jnp.asarray(ids),
                   positions=jnp.asarray(pos))
    out = model(torch.from_numpy(ids).long(), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL, rtol=0)
    clamped = model(torch.from_numpy(ids).long(),
                    positions=torch.full((10,), 63))
    assert not torch.allclose(out, clamped)


def test_learned_positions_clamp_to_the_table():
    model = GPT(GPTConfig(**TINY, dtype=torch.float32), seed=0).eval()
    ids = torch.from_numpy(_ids((1, 4), seed=3)).long()
    with torch.no_grad():
        far = model(ids, positions=torch.tensor([61, 62, 63, 90]))
        last = model(ids, positions=torch.tensor([61, 62, 63, 63]))
    assert torch.equal(far, last)


def test_the_cache_holds_post_rotary_k_and_decode_matches_jax():
    jm, params = jax_rotary_gpt(activation="silu")
    model = port_of(jm, params)
    b, s, max_len = 2, 20, 64
    ids = _ids((b, s), seed=4)
    jcache = jax_init_cache(jm, params, b, max_len)
    ref, jcache = jax_prefill(jm, params, jcache, jnp.asarray(ids),
                              jnp.arange(s))
    cache = init_cache(model, b, max_len)
    out = model(torch.from_numpy(ids).long(), positions=torch.arange(s),
                cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL, rtol=0)
    # JAX's cache is [layers, b, heads, head_dim, len] (K^T layout)
    jk = np.asarray(jcache["h"]["attn"]["cached_key"])
    np.testing.assert_allclose(
        cache.k[:, :, :, :s].numpy(),
        jk.transpose(0, 1, 2, 4, 3)[:, :, :, :s], atol=1e-5, rtol=0)
    step = jax.jit(lambda c, t, p: jm.apply(
        {"params": params, "cache": c}, t, decode=True, positions=p,
        mutable=["cache"]))
    for i, tok in enumerate(_ids((3, b), seed=5)):
        ref, var = step(jcache, jnp.asarray(tok)[:, None],
                        jnp.asarray([s + i]))
        jcache = var["cache"]
        out = model(torch.from_numpy(tok).long()[:, None],
                    positions=torch.tensor([s + i]), cache=cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"decode step {i}")


def test_param_dtype_holds_dense_weights_and_embeddings():
    """param_dtype bf16: embeddings and every dense kernel and bias in
    bf16, LayerNorms fp32 (JAX's LayerNorm params are fp32 whatever the
    param_dtype); the forward equals the fp32-held model's after the
    same rounding of its weights."""
    cfg = GPTConfig(**TINY, **ROTARY, dtype=torch.bfloat16)
    ref = GPT(cfg, seed=0)
    held = GPT(dataclasses.replace(cfg, param_dtype=torch.bfloat16), seed=0)
    dtypes = {n: p.dtype for n, p in held.named_parameters()}
    assert dtypes["wte"] == dtypes["h.0.attn.qkv.kernel"] == torch.bfloat16
    assert dtypes["h.0.mlp.fc_in.bias"] == torch.bfloat16
    assert dtypes["h.0.ln_1.scale"] == dtypes["ln_f.bias"] == torch.float32
    with torch.no_grad():
        for name, p in ref.named_parameters():
            p.copy_(p.to(dtypes[name]).float())
        ids = torch.from_numpy(_ids((2, 16), seed=6)).long()
        assert torch.equal(held.eval()(ids), ref.eval()(ids))


def test_params_from_jax_takes_a_bf16_tree():
    jm, params = jax_rotary_gpt(activation="silu")
    tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                        unfreeze(meta.unbox(params)))
    cfg = port_of(jm, params).config
    model = GPT(dataclasses.replace(cfg, param_dtype=torch.bfloat16),
                seed=None)
    sd = params_from_jax(tree, cfg)
    model.load_state_dict(sd)
    np.testing.assert_array_equal(
        model.h[1].attn.qkv.kernel.detach().float().numpy(),
        np.asarray(tree["h"]["attn"]["qkv"]["kernel"][1], np.float32))
