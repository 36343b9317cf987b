"""The accuracy argument of the fp32 block-sparse forward's 3xTF32 products.

``csrc/block_sparse_attention_fwd.cu`` runs each fp32 product of the
block-sparse forward (S = Q K^T and each listed tile's p' V) on the tensor
cores as three TF32 products, lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B),
each operand split into hi = tf32(x) and lo = tf32(x - hi) (the flash
kernels' split, emulated by ``tests/test_torch_tf32x3.py``'s int32 bit
arithmetic), and takes exp(x - m) as 2^((x - m) log2 e). Here the plain
sparse forward (``block_sparse_fwd_reference``) is rerun with its products
and exps taken that way, over the same lists in the same order, each
tile's p' V a product of its own added to acc e^(m - m'), as the kernel
adds it. Held, on BigBird-64 (every fine mask all live) and Longformer-16
(partial masks), dropout off and 0.1, at every head dim the kernels take:

- within ``FWD_CLOSE`` (2e-6) of the fp32 plain forward, for O and the
  row statistics m and l, which the card's gate compares too;
- within the card's fp32 gate (max |out - ref| / max(1, max |ref|) <=
  1e-4) of the JAX package's ``_sparse_fwd`` in Pallas interpret mode (its
  keep bits from ``PRNGKey(n)``, the port's from ``seed_words(n)``);
- and plain TF32 products (hi alone) fail that gate, so the gate tells
  the design from TF32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import sparse_attention as jax_sparse
from deepspeed_tpu_torch.ops._common import NEG_INF
from deepspeed_tpu_torch.ops.block_sparse_attention import (
    _gather, _keep, _step_lists, _tiles, _untile, block_sparse_fwd_reference)
from deepspeed_tpu_torch.ops.dropout import seed_words
from deepspeed_tpu_torch.ops.flash_attention import resolve_dropout
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import \
    device_plan
from tests.test_torch_sparse_attention import pair, qkv
from tests.test_torch_tf32x3 import (FWD_CLOSE, GATE, kernel_exp, max_rel,
                                     product_3xtf32, product_tf32)
from tests.torch_threads import share_cores

share_cores()

H, S = 2, 256

# (name, config class, kwargs): every fine mask of BigBird-64 is all live;
# Longformer-16's window tiles hold partial masks
LAYOUTS = [
    ("bigbird-64", "BigBirdSparsityConfig", dict(block=64,
                                                 num_random_blocks=1)),
    ("longformer-16", "BSLongformerSparsityConfig", dict(block=16)),
]


def sparse_forward_with(product, q, k, v, plan, scale, dropout):
    """block_sparse_fwd_reference (fp32) with its products taken by
    ``product`` and its exps by ``kernel_exp``: (o, m, l)."""
    tile = plan.plan.tile
    b, s, h, _ = q.shape
    qt, kt, vt = _tiles(q, tile), _tiles(k, tile), _tiles(v, tile)
    acc = torch.zeros_like(qt)
    m = torch.full((*qt.shape[:-1], 1), NEG_INF)
    l = torch.zeros_like(m)
    q_tile = torch.arange(plan.plan.nq).expand(h, -1)
    for j in range(plan.kv_idx.shape[-1]):
        ki, live = _step_lists(plan.kv_idx, plan.kv_pid, plan.kv_cnt,
                               plan.masks, j)
        kj, vj = _gather(kt, ki), _gather(vt, ki)
        sc = torch.where(live, product("bhnqd,bhnkd->bhnqk", qt, kj) * scale,
                         NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.where(live, kernel_exp(sc - m_new), 0.0)
        alpha = kernel_exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if dropout is not None:
            keep = _keep(dropout, b, h, q_tile, ki, tile, q.device)
            p = torch.where(keep, p * dropout.inv_keep, 0.0)
        acc = acc * alpha + product("bhnqk,bhnkd->bhnqd", p, vj)
        m = m_new
    safe = torch.where(l > 0.0, l, 1.0)
    return (_untile(acc / safe), m.reshape(b, h, s), safe.reshape(b, h, s))


def _case(layout, d, rate, seed):
    """(arrays, jax config, plan, scale, port dropout) of one case."""
    name, cls, kw = next(c for c in LAYOUTS if c[0] == layout)
    kw = dict(kw)
    jcfg, pcfg = pair(cls, heads=H, block=kw.pop("block"), **kw)
    plan = device_plan(pcfg, S, "cpu")
    assert plan is not None, name
    arrays = qkv((1, S, H, d), seed=seed)
    drop = resolve_dropout(rate, seed_words(seed), H)
    return arrays, jcfg, plan, 1.0 / math.sqrt(d), drop


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", [c[0] for c in LAYOUTS])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_3xtf32_sparse_forward_matches_fp32_and_jax(d, layout, rate):
    seed = d + len(layout) + int(rate * 10)
    arrays, jcfg, plan, scale, drop = _case(layout, d, rate, seed)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    ro, rm, rl = block_sparse_fwd_reference(q, k, v, plan, scale, drop)
    o, m, l = sparse_forward_with(product_3xtf32, q, k, v, plan, scale,
                                  drop)
    assert max_rel([o, m, l], [ro, rm, rl]) <= FWD_CLOSE
    jo = jax_sparse(*(jnp.asarray(a) for a in arrays), jcfg,
                    backend="pallas", dropout_rate=rate,
                    dropout_rng=jax.random.PRNGKey(seed) if rate else None,
                    deterministic=rate == 0.0)
    assert max_rel([o], [torch.from_numpy(np.array(jo))]) <= GATE


@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_plain_tf32_sparse_forward_fails_the_fp32_gate(d):
    arrays, _, plan, scale, drop = _case("bigbird-64", d, 0.0, seed=d)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    ro, _, _ = block_sparse_fwd_reference(q, k, v, plan, scale, drop)
    o, _, _ = sparse_forward_with(product_tf32, q, k, v, plan, scale, drop)
    assert max_rel([o], [ro]) > GATE
