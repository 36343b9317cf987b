"""The accuracy argument of the fp32 block-sparse backward's 3xTF32
products.

``csrc/block_sparse_attention_bwd.cu`` runs each fp32 product of dQ (S =
Q K^T, dP = dO V^T, dS K) and of dK/dV (S^T = K Q^T, dP^T = V dO^T,
(P o D)^T dO, dS^T Q) on the tensor cores as three TF32 products, lo(A)
hi(B) + hi(A) lo(B) + hi(A) hi(B), each operand split into hi = tf32(x)
and lo = tf32(x - hi) (``tests/test_torch_tf32x3.py``'s int32 bit
emulation of ``cvt.rna``), takes exp(fl(s * scale) - m) as 2^((fl(s *
scale) - m) log2 e) and 1 / l once a row. Here the plain versions
(``block_sparse_dq_reference``, ``block_sparse_dkv_reference``) are rerun
with their products and exps taken that way, over the same lists in the
same order, each tile's products in fresh accumulators added to the
running sums, as the kernels add them. Held, on BigBird-64 (every fine
mask all live) and Longformer-16 (partial masks), dropout off and 0.1, at
every head dim the kernels take (S 256, 2 heads):

- within ``BWD_CLOSE`` (1e-5) of the fp32 plain versions (dQ, dK, dV;
  readings 5.4e-7 to 2.1e-6 over the 16 cases);
- within the card's fp32 gate (max |out - ref| / max(1, max |ref|) <=
  1e-4) of ``jax.grad`` through the JAX package's ``_sparse_dq`` and
  ``_sparse_dkv`` in Pallas interpret mode (its keep bits from
  ``PRNGKey(n)``, the port's from ``seed_words(n)``; readings 5.4e-7 to
  2.1e-6, the fp32 plain versions themselves 2.4e-7 to 6.7e-7);
- and plain TF32 products (hi alone) fail that gate (readings 4.9e-4 to
  8.6e-4), so the gate tells the design from TF32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import sparse_attention as jax_sparse
from deepspeed_tpu_torch.ops.block_sparse_attention import (
    _gather, _keep, _row_stat, _step_lists, _tiles, _untile,
    block_sparse_dkv_reference, block_sparse_dq_reference,
    block_sparse_fwd_reference)
from tests.test_torch_sparse_tf32x3 import LAYOUTS, _case
from tests.test_torch_tf32x3 import (GATE, kernel_exp, max_rel,
                                     product_3xtf32, product_tf32)
from tests.torch_threads import share_cores

share_cores()

BWD_CLOSE = 1e-5


def _probs(product, qt, kt, live, m, l, scale):
    """P as the kernels take it: exp(fl(s * scale) - m) by ex2, times 1 / l."""
    sc = product("bhnqd,bhnkd->bhnqk", qt, kt) * scale
    return torch.where(live, kernel_exp(sc - m), 0.0) * (1.0 / l)


def dq_with(product, q, k, v, do, delta, m, l, plan, scale, dropout):
    """block_sparse_dq_reference (fp32) with its products taken by
    ``product`` and its exps by ``kernel_exp``."""
    tile = plan.plan.tile
    b, _, h, _ = q.shape
    qt, kt, vt, dot = (_tiles(x, tile) for x in (q, k, v, do))
    delta, m, l = (_row_stat(x, tile) for x in (delta, m, l))
    acc = torch.zeros_like(qt)
    q_tile = torch.arange(plan.plan.nq).expand(h, -1)
    for j in range(plan.kv_idx.shape[-1]):
        ki, live = _step_lists(plan.kv_idx, plan.kv_pid, plan.kv_cnt,
                               plan.masks, j)
        kj, vj = _gather(kt, ki), _gather(vt, ki)
        p = _probs(product, qt, kj, live, m, l, scale)
        dp = product("bhnqd,bhnkd->bhnqk", dot, vj)
        if dropout is not None:
            keep = _keep(dropout, b, h, q_tile, ki, tile, q.device)
            dp = torch.where(keep, dp * dropout.inv_keep, 0.0)
        ds = p * (dp - delta) * scale
        acc = acc + product("bhnqk,bhnkd->bhnqd", ds, kj)
    return _untile(acc)


def dkv_with(product, q, k, v, do, delta, m, l, plan, scale, dropout):
    """block_sparse_dkv_reference (fp32) likewise, over the transposed
    lists: (dk, dv)."""
    tile = plan.plan.tile
    b, _, h, _ = q.shape
    qt, kt, vt, dot = (_tiles(x, tile) for x in (q, k, v, do))
    delta, m, l = (_row_stat(x, tile) for x in (delta, m, l))
    dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
    k_tile = torch.arange(plan.plan.nq).expand(h, -1)
    for j in range(plan.qt_idx.shape[-1]):
        qi, live = _step_lists(plan.qt_idx, plan.qt_pid, plan.qt_cnt,
                               plan.masks, j)
        qj, doj = _gather(qt, qi), _gather(dot, qi)
        mj, lj, dj = _gather(m, qi), _gather(l, qi), _gather(delta, qi)
        p = _probs(product, qj, kt, live, mj, lj, scale)
        dp = product("bhnqd,bhnkd->bhnqk", doj, vt)
        pd = p
        if dropout is not None:
            keep = _keep(dropout, b, h, qi, k_tile, tile, q.device)
            dfac = torch.where(keep, dropout.inv_keep, 0.0)
            dp, pd = dp * dfac, p * dfac
        ds = p * (dp - dj) * scale
        dk = dk + product("bhnqk,bhnqd->bhnkd", ds, qj)
        dv = dv + product("bhnqk,bhnqd->bhnkd", pd, doj)
    return _untile(dk), _untile(dv)


def _inputs(layout, d, rate, seed):
    """(jax arrays and config, the backward's arguments with dO = w, the
    plain fp32 gradients)."""
    arrays, jcfg, plan, scale, drop = _case(layout, d, rate, seed)
    w = np.random.default_rng(seed + 100).standard_normal(
        arrays[0].shape).astype(np.float32)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    do = torch.from_numpy(w)
    o, m, l = block_sparse_fwd_reference(q, k, v, plan, scale, drop)
    delta = (do * o).sum(-1).transpose(1, 2)
    args = (q, k, v, do, delta, m, l, plan, scale, drop)
    refs = (block_sparse_dq_reference(*args),
            *block_sparse_dkv_reference(*args))
    return (arrays, w, jcfg), args, refs


def _grads_with(product, args):
    return (dq_with(product, *args), *dkv_with(product, *args))


def _jax_grads(arrays, w, jcfg, rate, seed):
    def loss(q, k, v):
        out = jax_sparse(q, k, v, jcfg, backend="pallas", dropout_rate=rate,
                         dropout_rng=jax.random.PRNGKey(seed) if rate
                         else None, deterministic=rate == 0.0)
        return jnp.sum(out * w)
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    return [torch.from_numpy(np.array(g)) for g in grads]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", [c[0] for c in LAYOUTS])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_3xtf32_sparse_backward_matches_fp32_and_jax(d, layout, rate):
    seed = d + len(layout) + int(rate * 10)
    (arrays, w, jcfg), args, refs = _inputs(layout, d, rate, seed)
    got = _grads_with(product_3xtf32, args)
    assert max_rel(got, refs) <= BWD_CLOSE
    assert max_rel(got, _jax_grads(arrays, w, jcfg, rate, seed)) <= GATE


@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_plain_tf32_sparse_backward_fails_the_fp32_gate(d):
    _, args, refs = _inputs("bigbird-64", d, 0.0, seed=d)
    assert max_rel(_grads_with(product_tf32, args), refs) > GATE

