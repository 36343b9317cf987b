"""The port's attention dropout, flash forward with dropout and flash
backward against the JAX package.

On the CPU the port's wrappers run the kernels' plain versions; the JAX
Pallas kernels run in interpret mode (as tests/unit/test_pallas_ops.py
runs them). The same numpy inputs and the same seed words
(``np.asarray(jax.random.PRNGKey(n))``) go into both. Tolerances: the
keep mask is bit-equal; O, LSE, dQ, dK and dV agree to atol 1e-5 in fp32
(two fp32 evaluations of one function that sum in different orders) and
2e-2 in bf16 (one bf16 rounding of outputs of magnitude ~1, on top of the
bf16 casts of P and dS that both sides make at the same points); dBias,
a sum over batch and rows of ~128 fp32 terms of magnitudes up to ~10, to
atol 2e-5 plus rtol 1e-5.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu.ops.pallas.flash_attention import (
    _flash_fwd as jax_flash_fwd, attention_dropout_keep as jax_keep,
    pack_dropout_seeds)
from deepspeed_tpu.ops.transformer.attention import (
    _reference_attention as jax_reference_attention)
from deepspeed_tpu_torch.ops._common import NEG_INF
from deepspeed_tpu_torch.ops.dropout import (attention_dropout_keep,
                                             fold_seed, seed_words)
from deepspeed_tpu_torch.ops.flash_attention import (
    Dropout, flash_attention, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd)
from deepspeed_tpu_torch.ops.transformer.attention import (
    _reference_attention, attention)
from tests.torch_threads import share_cores

share_cores()

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _words(n):
    return tuple(int(w) for w in np.asarray(jax.random.PRNGKey(n)))


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.999])
@pytest.mark.parametrize("shape,offsets", [
    ((2, 3, 17, 33), (3, 0, 0, 0, 0)),
    ((1, 2, 64, 128), (8, 3, 2, 0, 0)),
    ((2, 2, 40, 24), (5, 1, 7, 100, 64)),
])
def test_keep_mask_is_bit_equal_to_jax(rate, shape, offsets):
    th, ho, bo, qo, ko = offsets
    for n in (0, 7, 2 ** 32 - 5):
        key = jax.random.PRNGKey(n)
        ref = np.asarray(jax_keep(key, rate, shape, total_heads=th,
                                  head_offset=ho, batch_offset=bo,
                                  q_offset=qo, k_offset=ko))
        out = attention_dropout_keep(_words(n), rate, shape, th, ho, bo, qo,
                                     ko).numpy()
        assert np.array_equal(out, ref), (n, (out != ref).sum())
        assert abs(out.mean() - (1 - rate)) < 0.1


def test_seed_words_and_fold_seed():
    for n in (0, 1, 42, 2 ** 32 - 1):
        assert seed_words(n) == _words(n)
    w = seed_words(42)
    folded = {fold_seed(w, i) for i in range(64)}
    assert len(folded) == 64 and w not in folded
    assert fold_seed(w, 3) == fold_seed(w, 3)
    assert all(0 <= x < 2 ** 32 for pair in folded for x in pair)


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, g, rng


def _bias(kind, b, h, sq, sk, rng):
    if kind is None:
        return None
    if kind == "padding":                       # [b, 1, 1, sk]
        keep = np.ones((b, sk), bool)
        keep[0, sk - 40:] = False
        return np.where(keep, 0.0, NEG_INF)[:, None, None, :].astype(
            np.float32)
    if kind == "alibi":                         # [1, h, 1, sk]
        slopes = 2.0 ** -np.arange(1, h + 1)
        return (slopes[:, None] * np.arange(sk)[None, :]).astype(
            np.float32)[None, :, None, :]
    return rng.standard_normal((b, h, sq, sk)).astype(np.float32)   # full


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("sq,sk,bias_kind", [(128, 128, "padding"),
                                             (64, 128, "alibi")])
def test_forward_with_dropout_matches_jax(dtype, rate, sq, sk, bias_kind):
    b, h, d = 2, 2, 64
    q, k, v, _, rng = _inputs(b, sq, sk, h, d, 0)
    bias = _bias(bias_kind, b, h, sq, sk, rng)
    key = jax.random.PRNGKey(3)
    jq, jk, jv = (jnp.asarray(x, _JNP[dtype]) for x in (q, k, v))
    ref = jax_flash(jq, jk, jv, bias=jnp.asarray(bias), causal=True,
                    dropout_rate=rate, dropout_rng=key, block_q=64)
    # the LSE comes from the JAX forward rule itself ([b, h, s, d] layout)
    _, ref_lse = jax_flash_fwd(
        *(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)), jnp.asarray(bias),
        pack_dropout_seeds(key), d ** -0.5, True, rate, h, 64)
    tq, tk, tv = (torch.from_numpy(x).to(_TORCH[dtype]) for x in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, bias=torch.from_numpy(bias),
                               causal=True, dropout_rate=rate,
                               dropout_seed=_words(3), return_lse=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=TOL["float32"], rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("sq,sk,bias_kind", [
    (128, 128, None), (64, 128, None), (128, 128, "padding"),
    (64, 128, "alibi")])
def test_backward_matches_jax_vjp(dtype, rate, sq, sk, bias_kind):
    b, h, d = 2, 2, 64
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
    out = flash_attention(tq, tk, tv,
                          bias=None if bias is None else torch.from_numpy(
                              bias),
                          causal=True, dropout_rate=rate,
                          dropout_seed=_words(5))
    out.backward(torch.from_numpy(g).to(_TORCH[dtype]))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(o, np.float32), atol=TOL[dtype],
                               rtol=0)
    for name, r, t in zip("qkv", ref, (tq, tk, tv)):
        assert t.grad.dtype == _TORCH[dtype]
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(r, np.float32),
                                   atol=TOL[dtype], rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_dbias_matches_jax_when_the_bias_requires_grad(rate):
    b, h, sq, sk, d = 2, 2, 64, 128, 64
    q, k, v, g, rng = _inputs(b, sq, sk, h, d, 2)
    key = jax.random.PRNGKey(9)
    for kind in ("full", "alibi"):
        bias = _bias(kind, b, h, sq, sk, rng)

        def f(bias_):
            return jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             bias=bias_, causal=True, dropout_rate=rate,
                             dropout_rng=key if rate else None,
                             bias_grad=True, block_q=64)

        _, vjp = jax.vjp(f, jnp.asarray(bias))
        (ref,) = vjp(jnp.asarray(g))
        tb = torch.from_numpy(bias).requires_grad_()
        out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              bias=tb, causal=True, dropout_rate=rate,
                              dropout_seed=_words(9))
        out.backward(torch.from_numpy(g))
        assert tb.grad.shape == bias.shape
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=1e-5, err_msg=kind)


def test_no_dbias_unless_the_bias_requires_grad():
    q, k, v, g, rng = _inputs(1, 32, 32, 2, 64, 3)
    bias = torch.from_numpy(_bias("full", 1, 2, 32, 32, rng))
    tq = torch.from_numpy(q).requires_grad_()
    out = flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                          bias=bias, causal=True)
    out.backward(torch.from_numpy(g))
    assert tq.grad is not None and bias.grad is None


def test_bwd_wrapper_is_the_plain_backward_on_cpu():
    """On CPU tensors the backward wrapper runs its plain version (no
    launch counted), with the dropout offsets honoured."""
    q, k, v, g, _ = _inputs(2, 32, 48, 2, 64, 4)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    drop = Dropout(0.25, 11, 22, 6, 2, 1, 16, 3)
    o, lse = flash_attention_fwd(tq, tk, tv, causal=True, dropout=drop)
    before = (flash_attention_bwd.dkv_launches,
              flash_attention_bwd.dq_launches)
    got = flash_attention_bwd(tq, tk, tv, o, lse, tg, causal=True,
                              dropout=drop)
    ref = flash_attention_bwd_reference(tq, tk, tv, o, lse, tg, causal=True,
                                        dropout=drop)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=0, rtol=0)
    assert (flash_attention_bwd.dkv_launches,
            flash_attention_bwd.dq_launches) == before


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_reference_attention_dropout_matches_jax(rate):
    """The dense reference path draws the same keep mask as the JAX
    package's, and the flash path agrees with it on the same words."""
    q, k, v, _, _ = _inputs(2, 48, 48, 2, 64, 5)
    key = jax.random.PRNGKey(4)
    ref = jax_reference_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, dropout_rate=rate,
        dropout_rng=key, deterministic=False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = _reference_attention(tq, tk, tv, causal=True, dropout_rate=rate,
                               dropout_seed=_words(4), deterministic=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    flash = attention(tq, tk, tv, causal=True, dropout_rate=rate,
                      dropout_seed=_words(4), deterministic=False)
    torch.testing.assert_close(flash, out, atol=1e-5, rtol=0)
    quiet = attention(tq, tk, tv, causal=True, dropout_rate=rate,
                      dropout_seed=_words(4), deterministic=True)
    torch.testing.assert_close(
        quiet, _reference_attention(tq, tk, tv, causal=True), atol=1e-5,
        rtol=0)


def test_dropout_needs_seed_words_and_a_rate_below_one():
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="seed words"):
        flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="< 1"):
        flash_attention(q, q, q, dropout_rate=1.0, dropout_seed=(1, 2))
