"""The KV-cache attention forms beyond plain causal decode, against the
JAX package on the CPU in fp32 (logits and layer outputs within 1e-5,
tokens exact).

- An external mask with the cache: a chunk-wide mask is scattered into the
  cache's key space at the write position, a capacity-wide one is taken
  as it is; both ANDed with the cache mask ``col <= idx + i``. A row whose
  every visible key is masked gives 0 in the port (the flash kernels'
  NEG_INF encoding) and the mean of every cached value in JAX
  (``finfo.min`` masking): such rows are held to be finite and left out
  of the comparison, and nothing downstream reads them.
- A sparse GPT served through the cache: the trained block pattern (at
  ``max_seq_len``) gathered per position, one token included.
- A bidirectional attention layer through the cache, served causally as
  JAX serves it.
- The refusals: ALiBi, an external mask and a sparse pattern on per-row
  decode, and a mask on the paged pool.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.core import meta, unfreeze

from deepspeed_tpu.inference.cache import set_cache_index as jax_set_index
from deepspeed_tpu.inference.generation import generate as jax_generate
from deepspeed_tpu.inference.generation import init_cache as jax_init_cache
from deepspeed_tpu.models.gpt import GPT as JaxGPT
from deepspeed_tpu.models.gpt import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models.layers import SelfAttention as JaxSelfAttention
from deepspeed_tpu.ops.sparse_attention import \
    FixedSparsityConfig as JaxFixed
from deepspeed_tpu_torch.inference.cache import (PagedLayer,
                                                 set_cache_index)
from deepspeed_tpu_torch.inference.generation import generate, init_cache
from deepspeed_tpu_torch.models import layers as layers_mod
from deepspeed_tpu_torch.models.layers import SelfAttention
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from tests.test_torch_model import TINY, VARIANTS, jax_gpt, port_gpt
from tests.test_torch_rotary import port_of
from tests.torch_threads import share_cores

share_cores()

VOCAB = TINY["vocab_size"]
ATOL = 1e-5


def _ids(shape, seed):
    return np.random.RandomState(seed).randint(
        1, VOCAB, size=shape).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    jm, params = jax_gpt(seed=9)
    return jm, params, port_gpt(jm, params)


def _jax_step(jm, params):
    return jax.jit(lambda c, t, p, m: jm.apply(
        {"params": params, "cache": c}, t, attention_mask=m, decode=True,
        positions=p, mutable=["cache"]))


# ---------------------------------------------------------------------------
# an external mask with the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["middle", "left_pad"])
def test_external_mask_with_the_cache_matches_jax(models, case):
    """Prefill 2 rows of 12 under a chunk-wide mask, then 3 decode steps:
    ``middle`` masks one mid-prompt token (chunk-wide masks of ones at
    decode, which see it again, as JAX's do); ``left_pad`` masks row 1's
    first 3 tokens (capacity-wide masks at decode keep them masked; the
    prefill's rows 0-2 of row 1 see no key)."""
    jm, params, model = models
    b, s, cap = 2, 12, 32
    ids = _ids((b, s), seed=1)
    mask = np.ones((b, s), np.int32)
    if case == "middle":
        mask[0, 5] = 0
    else:
        mask[1, :3] = 0
    step = _jax_step(jm, params)
    jcache = jax_init_cache(jm, params, b, cap)
    jlogits, var = step(jcache, jnp.asarray(ids), jnp.arange(s),
                        jnp.asarray(mask))
    jcache = var["cache"]
    cache = init_cache(model, b, cap)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask),
                       positions=torch.arange(s), cache=cache)
    keep = np.ones((b, s), bool)
    if case == "left_pad":
        keep[1, :3] = False          # rows with no visible key
    assert np.isfinite(logits.numpy()).all()
    np.testing.assert_allclose(logits.numpy()[keep], np.asarray(jlogits)[keep],
                               atol=ATOL, rtol=0)
    full = np.ones((b, cap), np.int32)
    full[:, :s] = mask
    for i, tok in enumerate(_ids((3, b), seed=2)):
        m = np.ones((b, 1), np.int32) if case == "middle" else full
        jlogits, var = step(jcache, jnp.asarray(tok)[:, None],
                            jnp.asarray([s + i]), jnp.asarray(m))
        jcache = var["cache"]
        with torch.no_grad():
            logits = model(torch.from_numpy(tok).long()[:, None],
                           attention_mask=torch.from_numpy(m),
                           positions=torch.tensor([s + i]), cache=cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0, err_msg=f"step {i}")


def test_a_masked_token_takes_the_flash_path_not_the_decode_kernel(
        models, monkeypatch):
    """One token with a mask leaves the decode kernel for the masked flash
    forward (JAX's ``s == 1 and mask is None and pattern is None``)."""
    _, _, model = models
    calls = []
    monkeypatch.setattr(layers_mod, "decode_attention",
                        lambda *a, **k: calls.append(1))
    cache = init_cache(model, 1, 16)
    with torch.no_grad():
        model(torch.ones(1, 4, dtype=torch.long), cache=cache)
        model(torch.ones(1, 1, dtype=torch.long),
              attention_mask=torch.ones(1, 1), positions=torch.tensor([4]),
              cache=cache)
    assert calls == []


# ---------------------------------------------------------------------------
# a sparse GPT through the cache
# ---------------------------------------------------------------------------

def test_sparse_gpt_served_through_the_cache_matches_jax(monkeypatch):
    kw = dict(num_heads=TINY["n_heads"], block=16, num_local_blocks=2,
              attention="unidirectional")
    jm = JaxGPT(JaxGPTConfig(**TINY, sparsity_config=JaxFixed(**kw),
                             dtype=jnp.float32, scan_layers=False))
    params = jm.init(jax.random.PRNGKey(4), jnp.ones((1, 16), jnp.int32))[
        "params"]
    model = port_of(jm, params, sparsity_config=FixedSparsityConfig(**kw))
    calls = []
    monkeypatch.setattr(layers_mod, "decode_attention",
                        lambda *a, **k: calls.append(1))
    ids = _ids((2, 40), seed=3)
    got = generate(model, ids, max_new_tokens=24).numpy()
    want = np.asarray(jax_generate(jm, params, jnp.asarray(ids),
                                   max_new_tokens=24))
    np.testing.assert_array_equal(got, want)
    assert calls == []            # every step took the masked flash path
    # the step logits: a prefill past a block edge and decode steps that
    # cross the next one
    b, s, cap = 2, 40, 64
    step = _jax_step(jm, params)
    jcache = jax_init_cache(jm, params, b, cap)
    jlogits, var = step(jcache, jnp.asarray(ids), jnp.arange(s), None)
    cache = init_cache(model, b, cap)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long(),
                       positions=torch.arange(s), cache=cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    jcache = var["cache"]
    for i, tok in enumerate(_ids((10, b), seed=5)):
        jlogits, var = step(jcache, jnp.asarray(tok)[:, None],
                            jnp.asarray([s + i]), None)
        jcache = var["cache"]
        with torch.no_grad():
            logits = model(torch.from_numpy(tok).long()[:, None],
                           positions=torch.tensor([s + i]), cache=cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0, err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# a bidirectional layer through the cache
# ---------------------------------------------------------------------------

def test_bidirectional_attention_through_the_cache_matches_jax():
    b, d, heads, cap, s = 2, 128, 2, 32, 10
    jsa = JaxSelfAttention(n_heads=heads, d_model=d, causal=False,
                           dtype=jnp.float32)
    variables = jsa.init(jax.random.PRNGKey(0), jnp.zeros((b, cap, d)),
                         decode=True)
    params = jax.tree.map(np.asarray, unfreeze(meta.unbox(
        variables["params"])))
    jcache = variables["cache"]
    sa = SelfAttention(heads, d, dtype=torch.float32, causal=False).eval()
    with torch.no_grad():
        for name in ("qkv", "out"):
            getattr(sa, name).kernel.copy_(torch.tensor(
                params[name]["kernel"]))
            getattr(sa, name).bias.copy_(torch.tensor(params[name]["bias"]))
    kc = torch.zeros(b, heads, cap, d // heads)
    vc = torch.zeros_like(kc)
    r = np.random.RandomState(6)
    apply = jax.jit(lambda c, x: jsa.apply(
        {"params": variables["params"], "cache": c}, x, decode=True,
        mutable=["cache"]))
    for n, idx in ((s, 0), (1, s), (1, s + 1), (3, s + 2)):
        x = r.standard_normal((b, n, d)).astype(np.float32)
        want, var = apply(jcache, jnp.asarray(x))
        jcache = var["cache"]
        with torch.no_grad():
            got = sa(torch.from_numpy(x), kv_cache=(kc, vc),
                     cache_index=idx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=f"at {idx}")
    # served causally: the prefill's first row sees only its own key
    with torch.no_grad():
        cache_free = sa(torch.from_numpy(x))
    assert not torch.allclose(cache_free, got, atol=1e-3)


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

def test_alibi_per_row_multi_token_decode_refused_as_in_jax():
    jm, params = jax_gpt(seed=2, **VARIANTS["bloom"])
    model = port_gpt(jm, params)
    b, cap = 2, 32
    idx = np.array([3, 7], np.int32)
    toks = _ids((b, 2), seed=7)
    pos = idx[:, None] + np.arange(2)[None]
    jcache = jax_set_index(jax_init_cache(jm, params, b, cap),
                           jnp.asarray(idx))
    with pytest.raises(NotImplementedError, match="ALiBi"):
        jm.apply({"params": params, "cache": jcache}, jnp.asarray(toks),
                 decode=True, positions=jnp.asarray(pos), mutable=["cache"])
    cache = set_cache_index(init_cache(model, b, cap), idx)
    with pytest.raises(NotImplementedError, match="ALiBi"):
        model(torch.from_numpy(toks).long(),
              positions=torch.from_numpy(pos).long(), cache=cache)
    # one token a row takes the decode kernel with the slopes, as JAX's
    jlogits, _ = jm.apply({"params": params, "cache": jcache},
                          jnp.asarray(toks[:, :1]), decode=True,
                          positions=jnp.asarray(pos[:, :1]),
                          mutable=["cache"])
    logits = model(torch.from_numpy(toks[:, :1]).long(),
                   positions=torch.from_numpy(pos[:, :1]).long(),
                   cache=set_cache_index(init_cache(model, b, cap), idx))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)


def test_masks_and_patterns_refused_on_per_row_and_paged_decode():
    sa = SelfAttention(2, 128, dtype=torch.float32).eval()
    x = torch.zeros(2, 2, 128)
    kv = (torch.zeros(2, 2, 16, 64), torch.zeros(2, 2, 16, 64))
    with pytest.raises(NotImplementedError, match="external masks"):
        sa(x, mask=torch.ones(2, 1, 1, 2, dtype=torch.bool), kv_cache=kv,
           cache_index=torch.tensor([1, 2]))
    sparse = SelfAttention(2, 128, dtype=torch.float32,
                           sparsity_config=FixedSparsityConfig(
                               2, block=16, attention="unidirectional"))
    with pytest.raises(NotImplementedError, match="block-sparse"):
        sparse.eval()(x[:, :1], kv_cache=kv,
                      cache_index=torch.tensor([1, 2]))
    layer = PagedLayer(torch.zeros(3, 2, 16, 64), torch.zeros(3, 2, 16, 64),
                       None, None, torch.zeros(2, 1, dtype=torch.int32),
                       torch.tensor([1, 2]), [])
    with pytest.raises(NotImplementedError, match="paged-pool"):
        sa(x[:, :1], mask=torch.ones(2, 1, 1, 1, dtype=torch.bool),
           kv_cache=layer)
