"""Head dims 80 and 96 in the port's attention kernels, the slot capacity
``cache_len`` as the JAX package computes it, and the source-level
agreement of the wrappers with their CUDA dispatch.

The plain versions (what a CPU tensor runs, and what the CUDA kernels are
held to on the card) against the JAX package at head_dim 80 (GPT-2 2.7B's)
and 96 (GPT-2 760M's): the flash forward with dropout and its LSE, the
flash backward against ``jax.vjp``, decode and paged attention, and the
block-sparse forward and gradients. The JAX side runs its Pallas kernels
in interpret mode, as tests/unit/test_pallas_ops.py runs them. Same numpy
inputs, same seed words; the tolerances of the head_dim 64 tests these
reuse (test_torch_flash_bwd.py, test_torch_kernels.py,
test_torch_paged_attention.py, test_torch_sparse_attention.py): fp32
atol 1e-5 (2e-5 block-sparse forward; gradients 2e-5 of the largest),
bf16 atol 2e-2.

The paged engine at ``max_len`` 200 (not a multiple of 128) against the
JAX paged engine: the same page lists, chunk counts, prefix stats and
129-page pool.
"""

import importlib
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.layers import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import decode_attention as jax_decode
from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu.ops.pallas.flash_attention import (
    _flash_fwd as jax_flash_fwd, pack_dropout_seeds)
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_attention as jax_paged_attention
from deepspeed_tpu.ops.sparse_attention import sparse_attention as jax_sparse
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.engine import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.paging import PagingConfig as JaxPagingConfig
from deepspeed_tpu_torch.inference.generation import generate
from deepspeed_tpu_torch.models.layers import alibi_slopes
from deepspeed_tpu_torch.ops import decode_attention, paged_attention
from deepspeed_tpu_torch.ops.flash_attention import (BLOCK_K,
                                                     flash_attention)
from deepspeed_tpu_torch.ops.paged_attention import paged_attention_reference
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention
from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine
from tests.test_torch_flash_bwd import _bias, _inputs, _words
from tests.test_torch_model import TINY, jax_gpt, port_gpt
from tests.test_torch_paging import _drive_lockstep, _prompts
from tests.test_torch_sparse_attention import pair, qkv, to_t
from tests.torch_threads import share_cores

share_cores()

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WIDE = (80, 96)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "deepspeed_tpu_torch", "ops", "csrc")


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# flash attention: forward with dropout, backward against jax.vjp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate,bias_kind", [(0.0, None), (0.1, "padding"),
                                            (0.5, "alibi")])
def test_flash_forward_matches_jax(d, dtype, rate, bias_kind):
    b, h, sq, sk = 2, 2, 128, 128
    q, k, v, _, rng = _inputs(b, sq, sk, h, d, 0)
    bias = _bias(bias_kind, b, h, sq, sk, rng)
    key = jax.random.PRNGKey(3)
    jq, jk, jv = (jnp.asarray(x, _JNP[dtype]) for x in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    ref = jax_flash(jq, jk, jv, bias=jb, causal=True, dropout_rate=rate,
                    dropout_rng=key if rate else None, block_q=64)
    _, ref_lse = jax_flash_fwd(
        *(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)), jb,
        pack_dropout_seeds(key) if rate else None, d ** -0.5, True, rate,
        h, 64)
    tq, tk, tv = (torch.from_numpy(x).to(_TORCH[dtype]) for x in (q, k, v))
    out, lse = flash_attention(
        tq, tk, tv, bias=None if bias is None else torch.from_numpy(bias),
        causal=True, dropout_rate=rate, dropout_seed=_words(3),
        return_lse=True)
    assert out.shape == (b, sq, h, d) and out.dtype == _TORCH[dtype]
    _close(out.float().numpy(), ref, TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=TOL["float32"], rtol=1e-6)


@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate,sq,bias_kind", [(0.0, 128, None),
                                               (0.3, 64, "padding")])
def test_flash_backward_matches_jax_vjp(d, dtype, rate, sq, bias_kind):
    b, h, sk = 2, 2, 128
    q, k, v, g, rng = _inputs(b, sq, sk, h, d, 1)
    bias = _bias(bias_kind, b, h, sq, sk, rng)
    key = jax.random.PRNGKey(5)

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_,
                         bias=None if bias is None else jnp.asarray(bias),
                         causal=True, dropout_rate=rate,
                         dropout_rng=key if rate else None, bias_grad=False,
                         block_q=64)

    o, vjp = jax.vjp(f, *(jnp.asarray(x, _JNP[dtype]) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g, _JNP[dtype]))
    tq, tk, tv = (torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_()
                  for x in (q, k, v))
    out = flash_attention(
        tq, tk, tv, bias=None if bias is None else torch.from_numpy(bias),
        causal=True, dropout_rate=rate, dropout_seed=_words(5))
    out.backward(torch.from_numpy(g).to(_TORCH[dtype]))
    _close(out.detach().float().numpy(), o, TOL[dtype])
    for r, t in zip(ref, (tq, tk, tv)):
        assert t.grad.dtype == _TORCH[dtype]
        _close(t.grad.float().numpy(), r, TOL[dtype])


# ---------------------------------------------------------------------------
# decode and paged attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(d, dtype):
    B, H, S = 4, 2, 256
    rng = np.random.RandomState(2)
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, S, d)).astype(np.float32)
            for _ in range(2))
    lengths = np.asarray([0, 1, 77, S], np.int32)
    jq, jk, jv = (jnp.asarray(x, _JNP[dtype]) for x in (q, k, v))
    ref = jax_decode(jq, jnp.swapaxes(jk, 2, 3), jnp.swapaxes(jv, 2, 3),
                     jnp.asarray(lengths), alibi_slopes=jax_alibi_slopes(H),
                     block_k=128)
    out = decode_attention(*(torch.from_numpy(x).to(_TORCH[dtype])
                             for x in (q, k, v)),
                           torch.from_numpy(lengths),
                           alibi_slopes=alibi_slopes(H))
    assert out.shape == (B, 1, H, d) and out.dtype == _TORCH[dtype]
    _close(out.float().numpy(), ref, TOL[dtype])
    assert not out[0].float().any()          # length 0 -> zeros


@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("dtype,quant", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", False)])
def test_paged_matches_jax_kernel(d, dtype, quant):
    """The plain paged version against JAX ``paged_attention`` as its
    Pallas kernel, pools in each package's layout, NaN on the null page."""
    page, heads, max_pages = 16, 2, 8
    lengths = np.array([0, 1, 23, 47, 16], np.int32)
    r = np.random.RandomState(d)
    owned = [-(-int(n) // page) for n in lengths]
    num_pages = sum(owned) + 1
    perm = r.permutation(np.arange(1, num_pages))
    table = np.zeros((len(lengths), max_pages), np.int32)
    at = 0
    for b, own in enumerate(owned):
        table[b, :own] = perm[at:at + own]
        at += own
    shape = (num_pages, heads, page, d)
    q, kn, vn = (r.randn(len(lengths), heads, d).astype(np.float32)
                 for _ in range(3))
    if quant:
        k, v = (r.randint(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (r.rand(*shape[:3]).astype(np.float32) * 0.05
                  for _ in range(2))
        ks[0] = vs[0] = np.nan
    else:
        k, v = (r.randn(*shape).astype(np.float32) for _ in range(2))
        k[0] = v[0] = np.nan
        ks = vs = None
    jd = _JNP[dtype]
    pool = lambda x: jnp.asarray(x.transpose(0, 1, 3, 2)).astype(
        jnp.int8 if quant else jd)
    ref = jax_paged_attention(
        jnp.asarray(q, jnp.float32).astype(jd)[:, None], pool(k), pool(v),
        jnp.asarray(table), jnp.asarray(lengths),
        jnp.asarray(kn, jnp.float32).astype(jd),
        jnp.asarray(vn, jnp.float32).astype(jd),
        alibi_slopes=jax_alibi_slopes(heads),
        k_scale=None if ks is None else jnp.asarray(ks[:, :, None, :]),
        v_scale=None if vs is None else jnp.asarray(vs[:, :, None, :]),
        impl="kernel")
    t = lambda x: torch.from_numpy(np.array(x))
    td = _TORCH[dtype]
    out = paged_attention(
        t(q).to(td), t(k) if quant else t(k).to(td),
        t(v) if quant else t(v).to(td), t(table), t(lengths), t(kn).to(td),
        t(vn).to(td), alibi_slopes=alibi_slopes(heads),
        k_scale=None if ks is None else t(ks),
        v_scale=None if vs is None else t(vs))
    assert out.shape == (len(lengths), heads, d) and out.dtype == td
    assert np.isfinite(out.float().numpy()).all()
    _close(out.float().numpy(), ref[:, 0].astype(jnp.float32), TOL[dtype])


def test_paged_wrapper_is_its_plain_version_on_cpu():
    """At head_dim 96 the CPU wrapper and the plain version agree."""
    r = np.random.RandomState(1)
    q, kn, vn = (torch.from_numpy(r.randn(2, 2, 96).astype(np.float32))
                 for _ in range(3))
    k, v = (torch.from_numpy(r.randn(3, 2, 16, 96).astype(np.float32))
            for _ in range(2))
    table = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    lengths = torch.tensor([20, 0], dtype=torch.int32)
    torch.testing.assert_close(
        paged_attention(q, k, v, table, lengths, kn, vn),
        paged_attention_reference(q, k, v, table, lengths, kn, vn),
        atol=0, rtol=0)


# ---------------------------------------------------------------------------
# block-sparse attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_block_sparse_forward_matches_jax_pallas(d, dtype):
    jcfg, pcfg = pair("BigBirdSparsityConfig", num_random_blocks=2)
    arrays = qkv((2, 256, 4, d), seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_sparse(*(jnp.asarray(a, jdt) for a in arrays), jcfg,
                     backend="pallas")
    out = sparse_attention(*to_t(arrays, dtype), pcfg, backend="kernel")
    _close(out.float().numpy(), ref,
           2e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("d", WIDE)
def test_block_sparse_gradients_match_jax_pallas(d):
    jcfg, pcfg = pair("BigBirdSparsityConfig", heads=2)
    arrays = qkv((1, 128, 2, d), seed=4)
    w = qkv((1, 128, 2, d), seed=5, n=1)[0]
    q, k, v = (jnp.asarray(a) for a in arrays)
    fn = lambda q, k, v: jnp.sum(jax_sparse(q, k, v, jcfg,
                                            backend="pallas") * w)
    ref = jax.grad(fn, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = to_t(arrays, grad=True)
    (sparse_attention(tq, tk, tv, pcfg, backend="kernel")
     * torch.from_numpy(w)).sum().backward()
    for got, r in zip((tq, tk, tv), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(got.grad.numpy(), r, rtol=0,
                                   atol=2e-5 * np.abs(r).max())


# ---------------------------------------------------------------------------
# the wrappers' head dims and key tile against the CUDA sources
# ---------------------------------------------------------------------------

def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _dispatched_dims(name):
    """The head dims a .cu file's C entry points dispatch on (``d == N``)."""
    return tuple(sorted({int(n) for n in re.findall(r"\bd == (\d+)",
                                                    _source(name))}))


@pytest.mark.parametrize("module,sources", [
    ("flash_attention", ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
                         "flash_attention_fwd_bf16.cu",
                         "flash_attention_bwd_bf16.cu")),
    ("decode_attention", ("decode_attention.cu",)),
    ("paged_attention", ("paged_attention.cu",)),
    ("block_sparse_attention", ("block_sparse_attention_bwd.cu",
                                "block_sparse_attention_fwd.cu",
                                "block_sparse_attention_fwd_bf16.cu",
                                "block_sparse_attention_bwd_bf16.cu")),
])
def test_head_dims_match_the_cuda_dispatch(module, sources):
    """Each wrapper's head dims (the flash forward's and backward's apart)
    are its sources' ``d == N`` dispatch; test_torch_head_dim_256.py
    holds which of them take 256."""
    mod = importlib.import_module(f"deepspeed_tpu_torch.ops.{module}")
    for name in sources:
        dims = (mod.HEAD_DIMS if hasattr(mod, "HEAD_DIMS") else
                mod.BWD_HEAD_DIMS if "_bwd" in name else mod.FWD_HEAD_DIMS)
        assert dims[:4] == (64, 80, 96, 128), name
        assert _dispatched_dims(name) == dims, name


@pytest.mark.parametrize("name", ["flash_attention_fwd.cu",
                                  "flash_attention_fwd_bf16.cu",
                                  "flash_attention_bwd_bf16.cu"])
def test_block_k_matches_the_kernels_key_tile(name):
    """The plain forward's online-softmax step is the kernels' key tile,
    so both round p' against the same running max."""
    tiles = re.findall(r"constexpr int BK = (\d+);", _source(name))
    assert tiles and all(int(t) == BLOCK_K for t in tiles)


# ---------------------------------------------------------------------------
# cache_len as the JAX package computes it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [128, 200, 1000])
@pytest.mark.parametrize("page_len", [8, 16, 64])
def test_cache_len_and_buckets_equal_jax(max_len, page_len):
    port = ServingConfig(max_len=max_len, prefill_bucket=64,
                         paging={"page_len": page_len}).validate()
    ref = JaxServingConfig(max_len=max_len, prefill_bucket=64,
                           paging=JaxPagingConfig(page_len=page_len)
                           ).validate()
    assert port.cache_len == ref.cache_len == -(-max_len // 128) * 128
    assert port.bucket_lengths() == ref.bucket_lengths()
    assert (port.paging.pool_pages(4, port.cache_len)
            == ref.paging.pool_pages(4, ref.cache_len))


def test_max_len_200_with_page_len_64_is_accepted():
    cfg = ServingConfig(max_len=200, paging={"page_len": 64}).validate()
    assert cfg.cache_len == 256 and cfg.paged


@pytest.fixture(scope="module")
def models_256():
    jm, params = jax_gpt(seed=7, max_seq_len=256)
    return jm, params, port_gpt(jm, params)


def test_paged_engine_at_max_len_200_matches_jax(models_256):
    """num_slots 4, max_len 200, page_len 8: 32 pages a slot, a 129-page
    pool; prompts up to 160 tokens, so requests hold pages past the
    first 128 positions."""
    jm, params, model = models_256
    vocab = TINY["vocab_size"]
    r = np.random.RandomState(31)
    sys_p = r.randint(1, vocab, size=40).astype(np.int32)
    prompts = (_prompts(32, 6, 2, 30, prefix=sys_p)
               + _prompts(33, 3, 60, 120))
    outs = [int(o) for o in r.randint(2, 9, size=len(prompts))]
    knobs = dict(num_slots=4, max_len=200, prefill_bucket=16, seed=0)
    paging = dict(page_len=8, prefill_chunk=32, max_chunks_per_iter=2)
    jeng = JaxServingEngine(jm, params, JaxServingConfig(
        **knobs, paging=JaxPagingConfig(**paging)))
    peng = ServingEngine(model, ServingConfig(**knobs, paging=paging))
    assert peng._paged.num_pages == jeng._paged.num_pages == 129
    assert peng._paged.max_pages == jeng._paged.max_pages == 32
    j_toks, j_pages = _drive_lockstep(
        jeng, prompts, outs, lambda e, s: e._paged._slot_pages[s])
    p_toks, p_pages = _drive_lockstep(
        peng, prompts, outs, lambda e, s: e._paged.slot_pages(s))
    assert p_toks == j_toks
    assert p_pages == j_pages
    js, ps = jeng.metrics.snapshot(), peng.metrics.snapshot()
    for key in ("prefill_chunks", "prefill_tokens_computed",
                "prefill_tokens_reused", "prefix_lookups", "prefix_hits",
                "prefix_pages_reused", "prefix_nodes", "decode_iterations",
                "requests_finished"):
        assert ps[key] == js[key], key
    assert ps["prefix_hits"] >= 1
    peng._paged.allocator.check()


@pytest.mark.parametrize("paging", [None, {"page_len": 8,
                                           "prefill_chunk": 32}])
def test_bucket_past_the_position_table_serves_exactly(paging):
    """At max_seq_len 200 and max_len 200 the capacity is 256, so the last
    prefill bucket and the last chunk pass the model's position table;
    their pad-tail positions are clipped and the tokens equal
    generate()'s."""
    jm, params = jax_gpt(seed=9, max_seq_len=200)
    model = port_gpt(jm, params)
    eng = ServingEngine(model, ServingConfig(
        num_slots=2, max_len=200, prefill_bucket=64, paging=paging))
    assert eng.config.cache_len == 256
    prompts = _prompts(41, 3, 150, 190)
    reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
    eng.run()
    for req, p in zip(reqs, prompts):
        ref = generate(model, torch.from_numpy(p)[None],
                       max_new_tokens=4)[0, len(p):].tolist()
        assert req.output_tokens == ref
