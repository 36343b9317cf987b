"""The port's paged attention and page-pool walkers against the JAX
package's.

``paged_attention_reference`` (the plain version of the CUDA kernel) is
held to JAX ``paged_attention`` run as its Pallas kernel (interpret mode
on the CPU) and as ``impl="dense"`` after the layout transform (JAX pool
``[P, H, d, page_len]`` -> port ``[P, H, page_len, d]``; scale planes
``[P, H, 1, page_len]`` -> ``[P, H, page_len]``): fp32 atol 1e-5 (one
function, two fp32 summation orders), bf16 atol 2e-2 (one bf16 rounding
of outputs near 1). ``_quantize_kv`` is bit-equal to JAX's, and the
token / chunk scatters and the gather equal JAX's after the transform.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference import cache as jcache
from deepspeed_tpu.models.layers import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_attention as jax_paged_attention
from deepspeed_tpu_torch.inference import cache as pcache
from deepspeed_tpu_torch.models.layers import alibi_slopes
from deepspeed_tpu_torch.ops import paged_attention as port_paged_attention
from deepspeed_tpu_torch.ops.paged_attention import paged_attention_reference
from tests.test_torch_model import jax_gpt, port_gpt
from tests.torch_threads import share_cores

share_cores()

PAGE, HEADS, D, MAX_PAGES = 16, 2, 64, 8     # the tiny model's attention
LENGTHS = [0, 1, 23, 47, 16]                 # empty, one token, ragged,
                                             # an exact page boundary
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _case(seed, dtype, quant):
    """Port-layout operands: each slot owns ceil(length / PAGE) pages of
    a shuffled pool, the rest of its table row is the null page 0, which
    holds NaN (int8 pools: NaN scales)."""
    r = np.random.RandomState(seed)
    owned = [-(-n // PAGE) for n in LENGTHS]
    num_pages = sum(owned) + 1
    perm = r.permutation(np.arange(1, num_pages))
    table = np.zeros((len(LENGTHS), MAX_PAGES), np.int32)
    at = 0
    for b, own in enumerate(owned):
        table[b, :own] = perm[at:at + own]
        at += own
    shape = (num_pages, HEADS, PAGE, D)
    b = len(LENGTHS)
    q, kn, vn = (r.randn(b, HEADS, D).astype(np.float32) for _ in range(3))
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
    return q, kn, vn, k, v, ks, vs, table, np.array(LENGTHS, np.int32)


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _jax_in(x, dtype):
    """A numpy array as the JAX operand of ``dtype``, rounded as torch
    rounds it (fp32 -> bf16 round-to-nearest-even on both sides)."""
    return jnp.asarray(x, jnp.float32).astype(dtype)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("dtype,quant,alibi", [
    (torch.float32, False, False), (torch.float32, False, True),
    (torch.float32, True, False), (torch.bfloat16, False, True),
    (torch.bfloat16, True, True)])
def test_reference_matches_jax_paged_attention(impl, dtype, quant, alibi):
    q, kn, vn, k, v, ks, vs, table, lengths = _case(0, dtype, quant)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pd = jnp.int8 if quant else jd
    to_jax_pool = lambda x: jnp.asarray(x.transpose(0, 1, 3, 2)).astype(pd)
    out = jax_paged_attention(
        _jax_in(q, jd)[:, None], to_jax_pool(k), to_jax_pool(v),
        jnp.asarray(table), jnp.asarray(lengths), _jax_in(kn, jd),
        _jax_in(vn, jd),
        alibi_slopes=jax_alibi_slopes(HEADS) if alibi else None,
        k_scale=None if ks is None else jnp.asarray(ks[:, :, None, :]),
        v_scale=None if vs is None else jnp.asarray(vs[:, :, None, :]),
        impl=impl)
    ref = np.asarray(out[:, 0].astype(jnp.float32))
    got = paged_attention_reference(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), _torch(table),
        _torch(lengths), _torch(kn, dtype), _torch(vn, dtype),
        alibi_slopes=alibi_slopes(HEADS) if alibi else None,
        k_scale=None if ks is None else _torch(ks),
        v_scale=None if vs is None else _torch(vs))
    assert got.dtype == dtype and np.isfinite(got.float().numpy()).all()
    np.testing.assert_allclose(got.float().numpy(), ref, atol=ATOL[dtype],
                               rtol=0)
    # a slot of length 0 attends only itself
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  _torch(vn, dtype)[0].float().numpy())


@pytest.mark.parametrize("quant", [False, True])
def test_tail_poison_is_never_read(quant):
    """NaN past each slot's length inside its own last page (the port's
    kernel never reads there) leaves the output unchanged; the wrapper on
    CPU tensors is the plain version and launches nothing."""
    q, kn, vn, k, v, ks, vs, table, lengths = _case(3, torch.float32, quant)
    args = [_torch(x) for x in (q, k, v, table, lengths, kn, vn)]
    kw = dict(k_scale=None if ks is None else _torch(ks),
              v_scale=None if vs is None else _torch(vs))
    clean = paged_attention_reference(*args, **kw)
    poisoned = [t.clone() for t in (args[1], args[2])]
    planes = [kw["k_scale"], kw["v_scale"]] if quant else poisoned
    for b, n in enumerate(LENGTHS):
        if n % PAGE:
            page = int(table[b, n // PAGE])
            for t in planes:
                t[page, :, n % PAGE:] = np.nan
    launches = port_paged_attention.launches
    out = port_paged_attention(args[0][:, None], poisoned[0], poisoned[1],
                               *args[3:], **kw)
    assert port_paged_attention.launches == launches
    np.testing.assert_array_equal(out[:, 0].numpy(), clean.numpy())


# ---------------------------------------------------------------------------
# the pool walkers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jm, params = jax_gpt(seed=7)
    return jm, params, port_gpt(jm, params)


def _unit(tree):
    return tree["h"]["attn"]


def _port_pool(jpool, quant):
    """The port's pool holding a JAX pool tree's contents."""
    u = _unit(jpool)
    pool = pcache.PagePool(
        _torch(np.asarray(u["cached_key"]).transpose(0, 1, 2, 4, 3)),
        _torch(np.asarray(u["cached_value"]).transpose(0, 1, 2, 4, 3)))
    if quant:
        pool.k_scale = _torch(np.asarray(u["key_scale"])[..., 0, :])
        pool.v_scale = _torch(np.asarray(u["value_scale"])[..., 0, :])
    return pool


def _assert_pools_equal(pool, jpool):
    expect = _port_pool(jpool, pool.quantized)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(pool, name), getattr(expect, name)
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_quantize_kv_bit_equal_to_jax():
    r = np.random.RandomState(5)
    x = (r.randn(3, 4, 2, 64) * np.exp(r.randn(3, 4, 2, 1) * 3)
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                                 # an all-zero token
    x[1, 2, 1, :4] = [127.5, -127.5, 0.5, -0.5]      # round-half-even ties
    jq, js = jcache._quantize_kv(jnp.asarray(np.swapaxes(x, -1, -2)))
    pq, ps = pcache._quantize_kv(_torch(x))
    np.testing.assert_array_equal(pq.numpy(),
                                  np.swapaxes(np.asarray(jq), -1, -2))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js)[..., 0, :])


@pytest.mark.parametrize("quant", [False, True])
def test_scatters_and_gather_match_jax(tiny, quant):
    jm, params, model = tiny
    n_pages = 9
    jpool = jcache.init_page_pool(jm, params, n_pages, PAGE)
    if quant:
        jpool = jcache.quantize_page_pool(jpool)
    pool = pcache.init_page_pool(model, n_pages, PAGE, kv_int8=quant)
    _assert_pools_equal(pool, jpool)
    r = np.random.RandomState(11)
    L = model.config.n_layers
    # a 32-token chunk into pages 3 and 5, then one decode token for each
    # of three rows (the third masked to the null page)
    chunk = r.randn(L, HEADS, 32, D).astype(np.float32)
    jpool = jcache.scatter_chunk_pages(
        jpool, {"h": {"attn": {
            "k": jnp.asarray(chunk.transpose(0, 1, 3, 2))[:, None],
            "v": jnp.asarray(-chunk.transpose(0, 1, 3, 2))[:, None]}}},
        jnp.asarray([3, 5], jnp.int32))
    pcache.scatter_chunk_pages(pool, _torch(chunk), _torch(-chunk),
                               torch.tensor([3, 5], dtype=torch.int32))
    _assert_pools_equal(pool, jpool)
    tok = r.randn(L, 3, HEADS, D).astype(np.float32)
    pages, offs = np.array([5, 7, 0], np.int32), np.array([9, 0, 4], np.int32)
    jpool = jcache.scatter_token_pages(
        jpool, {"h": {"attn": {"k": jnp.asarray(tok)[..., None],
                               "v": jnp.asarray(2 * tok)[..., None]}}},
        jnp.asarray(pages), jnp.asarray(offs))
    pcache.scatter_token_pages(pool, _torch(tok), _torch(2 * tok),
                               _torch(pages), _torch(offs))
    _assert_pools_equal(pool, jpool)
    table = np.array([[3, 5, 0, 0, 0, 0, 0, 0], [7, 0, 0, 0, 0, 0, 0, 0]],
                     np.int32)
    jview = _unit(jcache.gather_pages(jpool, jnp.asarray(table),
                                      dequant_dtype=jnp.float32))
    view = pcache.gather_pages(pool, _torch(table))
    np.testing.assert_array_equal(
        view.k.numpy(), np.asarray(jview["cached_key"]).transpose(
            0, 1, 2, 4, 3))
    np.testing.assert_array_equal(
        view.v.numpy(), np.asarray(jview["cached_value"]).transpose(
            0, 1, 2, 4, 3))
