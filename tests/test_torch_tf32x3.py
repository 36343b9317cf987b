"""The accuracy argument of the fp32 flash kernels' 3xTF32 products.

``csrc/flash_attention_bwd.cu`` runs each fp32 product of the backward
(S = Q K^T and dP = dO V^T in both kernels, dV, dK, dQ), and
``csrc/flash_attention_fwd.cu`` each of the forward (S = Q K^T and the
online step's p' V), on the tensor cores as three TF32 products: every
operand is split into hi = tf32(x)
and lo = tf32(x - hi), rounded to nearest with ties away from zero
(``cvt.rna.tf32.f32``), and the product is lo(A) hi(B) + hi(A) lo(B) +
hi(A) hi(B). The card cannot run here, so the split is emulated in plain
PyTorch (bit arithmetic on int32 views) and the plain fp32 backward and
forward are rerun with their products taken that way. Held to the fp32
plain versions and to the JAX package's dense reference attention
(forward) and its ``jax.vjp`` (backward) with the gate the card holds
the kernels to (max |out - ref| / max(1, max |ref|) <= 1e-4): the 3xTF32
products stay inside it, plain TF32 products (hi alone) do not, so the
gate can tell the design from TF32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.attention import (
    _reference_attention as jax_reference_attention)
from deepspeed_tpu_torch.models.layers import alibi_slopes
from deepspeed_tpu_torch.ops._common import NEG_INF
from deepspeed_tpu_torch.ops.flash_attention import (
    BLOCK_K, Dropout, flash_attention_bwd_reference,
    flash_attention_reference)
from tests.torch_threads import share_cores

share_cores()

GATE = 1e-4     # the card's fp32 gate (chip_smoke.py TOL[torch.float32])
# the forward against the fp32 plain forward. Exact products (float64,
# rounded to fp32) summed in another order already read up to 8.5e-7 on
# this grid; the 3xTF32 products, each three fp32 einsums, up to 1.1e-6
FWD_CLOSE = 2e-6


def tf32_rna(x):
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: half a unit of the 13 dropped bits added to the magnitude,
    then the bits cleared (``cvt.rna.tf32.f32`` on finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product_3xtf32(eq, a, b):
    """``einsum(eq, a, b)`` as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b),
    the small terms first."""
    (ah, al), (bh, bl) = split(a.float()), split(b.float())
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def product_tf32(eq, a, b):
    """Plain TF32: hi(a) hi(b)."""
    return torch.einsum(eq, tf32_rna(a.float()), tf32_rna(b.float()))


def backward_with(product, q, k, v, o, lse, do, bias, causal, dropout):
    """flash_attention_bwd_reference (fp32) with each product taken by
    ``product``: S, dP, dV, dK, dQ (S and dP are the same products in
    both kernels)."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    s = product("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    if causal:
        row = torch.arange(sq)[:, None] + (sk - sq)
        s = torch.where(torch.arange(sk)[None, :] <= row, s, NEG_INF)
    p = torch.where(lse[..., None] > NEG_INF / 2,
                    torch.exp(s - lse[..., None]), 0.0)
    dp = product("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    dfac = (torch.where(dropout.keep(p.shape, q.device), dropout.inv_keep,
                        0.0) if dropout is not None else 1.0)
    ds = p * (dfac * dp - delta) * scale
    pv = p * dfac
    return (product("bhqk,bkhd->bqhd", ds, k),
            product("bhqk,bqhd->bkhd", ds, q),
            product("bhqk,bqhd->bkhd", pv, do))


def max_rel(outs, refs):
    return max(float((o - r).abs().max() / r.abs().max().clamp_min(1.0))
               for o, r in zip(outs, refs))


def _case(d, s, mask, rate, seed, b=2, h=4):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d)).astype(np.float32)) for _ in range(4))
    bias = None
    if mask == "padding":
        keep = np.ones((b, s), bool)
        for i in range(b):
            keep[i, s - (i + 1) * s // 5:] = False
        bias = torch.from_numpy(np.where(keep, 0.0, NEG_INF).astype(
            np.float32))[:, None, None, :]
    drop = (Dropout(rate, 0x1234 + seed, 0x9E3779B9 ^ seed, h)
            if rate else None)
    causal = mask == "causal"
    o, lse = flash_attention_reference(q, k, v, bias, causal=causal,
                                       dropout=drop)
    refs = flash_attention_bwd_reference(q, k, v, o, lse, do, bias,
                                         causal=causal, dropout=drop)
    return (q, k, v, o, lse, do, bias, causal, drop), refs


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mask", ["causal", "padding"])
@pytest.mark.parametrize("d", [64, 80])
def test_3xtf32_products_pass_the_fp32_gate(d, mask, rate):
    args, refs = _case(d, 128, mask, rate, seed=d + int(rate * 10))
    err = max_rel(backward_with(product_3xtf32, *args), refs)
    assert err <= GATE / 10, err


@pytest.mark.parametrize("d", [64, 80])
def test_plain_tf32_products_fail_the_fp32_gate(d):
    args, refs = _case(d, 128, "causal", 0.0, seed=d)
    err = max_rel(backward_with(product_tf32, *args), refs)
    assert err > GATE, err


def test_the_split_is_exact_to_2_pow_22():
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        4096).astype(np.float32) * 10.0 ** np.random.RandomState(1).randint(
            -20, 20, 4096).astype(np.float32))
    hi, lo = split(x)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((hi - x).abs() <= x.abs() * 2.0 ** -11)
    assert torch.all((hi + lo - x).abs() <= x.abs() * 2.0 ** -22)
    # ties go away from zero: 1 + 2^-11 is halfway between two TF32 values
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert torch.equal(tf32_rna(tie), torch.tensor([1 + 2.0 ** -10,
                                                    -(1 + 2.0 ** -10)]))


def test_3xtf32_backward_matches_jax_vjp():
    """The emulated 3xTF32 backward against ``jax.vjp`` of the JAX
    package's dense reference attention (causal, fp32, no dropout)."""
    args, _ = _case(64, 128, "causal", 0.0, seed=3)
    q, k, v, o, lse, do = args[:6]
    got = backward_with(product_3xtf32, *args)

    def f(q_, k_, v_):
        return jax_reference_attention(q_, k_, v_, causal=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    refs = [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(
        do.numpy()))]
    assert max_rel(got, refs) <= GATE / 10


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def kernel_exp(x):
    """exp(x - m) as flash_attention_fwd.cu takes it (``exp_nat``):
    2^((x - m) log2 e), the argument already in natural units."""
    return torch.exp2(x * 1.4426950408889634)


def forward_with(product, q, k, v, bias, causal, dropout):
    """flash_attention_reference (fp32) with its products, S = Q K^T and
    each online step's p' V, taken by ``product`` and its exps by
    ``kernel_exp``: returns (o, lse)."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    s = product("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(d))
    if bias is not None:
        s = s + bias
    if causal:
        row = torch.arange(sq)[:, None] + (sk - sq)
        s = torch.where(torch.arange(sk)[None, :] <= row, s, NEG_INF)
    keep = dropout.keep(s.shape, q.device) if dropout is not None else None
    m = torch.full((*s.shape[:3], 1), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((*s.shape[:3], d))
    vt = v.float().transpose(1, 2)
    for k0 in range(0, sk, BLOCK_K):
        st = s[..., k0:k0 + BLOCK_K]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.where(m_new > NEG_INF / 2, kernel_exp(st - m_new), 0.0)
        alpha = kernel_exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + BLOCK_K],
                            p * dropout.inv_keep, 0.0)
        acc = acc * alpha + product("bhqk,bhkd->bhqd", p,
                                    vt[:, :, k0:k0 + BLOCK_K])
        m = m_new
    safe_l = torch.where(l > 0.0, l, 1.0)
    lse = torch.where(l > 0.0, m + torch.log(safe_l), NEG_INF)[..., 0]
    return (acc / safe_l).transpose(1, 2), lse


def _fwd_case(d, kind, rate, seed, b=2, s=128, h=4):
    """q, k, v, bias, causal and dropout of a forward case: "causal" (no
    bias), "padding" (a [b, 1, 1, s] key mask, not causal) or "alibi"
    (causal, the [1, h, 1, s] ALiBi rows of BLOOM-style models)."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)) for _ in range(3))
    bias = None
    if kind == "padding":
        keep = np.ones((b, s), bool)
        for i in range(b):
            keep[i, s - (i + 1) * s // 5:] = False
        bias = torch.from_numpy(np.where(keep, 0.0, NEG_INF).astype(
            np.float32))[:, None, None, :]
    elif kind == "alibi":
        bias = (alibi_slopes(h)[None, :, None, None]
                * torch.arange(s, dtype=torch.float32))
    drop = (Dropout(rate, 0x2468 + seed, 0x13579BDF ^ seed, h)
            if rate else None)
    return q, k, v, bias, kind != "padding", drop


def _lse_rel(lse, ref):
    return float((lse - ref).abs().max() / ref.abs().max().clamp_min(1.0))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["causal", "padding", "alibi"])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_3xtf32_forward_matches_fp32_and_jax(d, kind, rate):
    """The forward with 3xTF32 products within ``FWD_CLOSE`` of the fp32
    plain forward (o and the LSE) and within the card's gate of the JAX
    package's ``_reference_attention`` (its keep mask handed over)."""
    q, k, v, bias, causal, drop = _fwd_case(d, kind, rate,
                                            seed=d + len(kind))
    ro, rlse = flash_attention_reference(q, k, v, bias, causal=causal,
                                         dropout=drop)
    o, lse = forward_with(product_3xtf32, q, k, v, bias, causal, drop)
    assert max_rel([o], [ro]) <= FWD_CLOSE
    assert _lse_rel(lse, rlse) <= FWD_CLOSE
    keep = (None if drop is None else
            drop.keep((q.shape[0], q.shape[2], q.shape[1], k.shape[1]),
                      q.device).numpy())
    jo = jax_reference_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)),
        None if bias is None else jnp.asarray(bias.numpy()), causal=causal,
        dropout_rate=rate, dropout_mask=keep)
    assert max_rel([o], [torch.from_numpy(np.array(jo))]) <= GATE


@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_plain_tf32_forward_fails_the_fp32_gate(d):
    q, k, v, bias, causal, drop = _fwd_case(d, "causal", 0.0, seed=d)
    ro, _ = flash_attention_reference(q, k, v, bias, causal=causal)
    o, _ = forward_with(product_tf32, q, k, v, bias, causal, drop)
    assert max_rel([o], [ro]) > GATE
