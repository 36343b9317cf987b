"""Head dim 256 (GPT-J-6B's) in training, on the CPU.

The plain flash backward that the d-256 CUDA backward kernels are held to
on the card, against ``jax.vjp`` through the JAX package's
``flash_attention`` (its Pallas kernels in interpret mode, as
``tests/test_torch_flash_bwd.py`` runs them at d 64), from the same numpy
inputs and seed words: fp32, bf16 and fp16, dropout 0 and 0.3, a padding
bias at (sq, sk) = (128, 128) and ALiBi at (64, 128). Tolerances, as at
d 64: dQ, dK and dV within atol 1e-5 in fp32 (two fp32 evaluations of one
function summed in different orders), 2e-2 in bf16 (one bf16 rounding of
outputs ~1, on top of the bf16 casts of P and dS that both sides make at
the same points) and 2e-3 in fp16 (a few fp16 ulps at 2^-10;
``tests/test_torch_half_kernels.py``).

The d-256 fp32 kernels (``csrc/flash_tf32.cuh``, on tf32 wgmma) sum in
another order than the narrower ones: dK in 16-row and dV in 32-row q
steps, dQ in 16-key steps, each product over 8-deep steps in order.
Their arithmetic emulated in plain PyTorch (3xTF32 products of the
kernels' truncating split, hi = x toward zero at tf32 and lo = x - hi,
each 8-deep step added to the fp32 accumulator in the kernels' order)
holds to the plain fp32 backward within 1e-5 of max(1, max |ref|);
``tests/test_torch_flash_tf32_d256.py`` holds it to ``jax.vjp`` and
emulates the forward's order.

The engine on GPT-J-6B's layout at head dim 256 (2 layers, d_model 512,
2 heads of 256, rotary over 64 of each head's dims, parallel residual
with one shared LayerNorm, no attention biases, an untied head with a
bias, vocab 512, 64 tokens) against the JAX engine: fp32, FusedAdam, 2
steps from one initialization (``params_from_jax``); each step's loss
within 1e-4 and the parameters within 2 lr a step, the engine rule of
``tests/test_torch_training.py``.
"""

import functools
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt import GPT as JaxGPT
from deepspeed_tpu.models.gpt import GPTConfig as JaxGPTConfig
from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import GPT, GPTConfig
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops._common import NEG_INF
from deepspeed_tpu_torch.ops.flash_attention import (
    Dropout, flash_attention, flash_attention_bwd_reference,
    flash_attention_reference)

from tests.test_torch_flash_bwd import _bias, _inputs, _words
from tests.test_torch_tf32x3 import max_rel
from tests.test_torch_training import (_engine_config, _jax_loss,
                                       _port_loss, _tree_np)
from tests.torch_threads import share_cores

share_cores()

D = 256
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


# ---------------------------------------------------------------------------
# the plain backward at d 256 against jax.vjp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("sq,sk,bias_kind", [(128, 128, "padding"),
                                             (64, 128, "alibi")])
def test_d256_backward_matches_jax_vjp(dtype, rate, sq, sk, bias_kind):
    b, h = 1, 2
    q, k, v, g, rng = _inputs(b, sq, sk, h, D, 7)
    bias = _bias(bias_kind, b, h, sq, sk, rng)
    key = jax.random.PRNGKey(11)

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, bias=jnp.asarray(bias), causal=True,
                         dropout_rate=rate, dropout_rng=key if rate else None,
                         bias_grad=False, block_q=64)

    o, vjp = jax.vjp(f, *(jnp.asarray(x, _JNP[dtype]) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g, _JNP[dtype]))
    tq, tk, tv = (torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_()
                  for x in (q, k, v))
    out = flash_attention(tq, tk, tv, bias=torch.from_numpy(bias),
                          causal=True, dropout_rate=rate,
                          dropout_seed=_words(11))
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


# ---------------------------------------------------------------------------
# the d-256 fp32 kernels' summation order, emulated
# ---------------------------------------------------------------------------

STEP = 8        # the depth of one tf32 wgmma (m64nNk8) product


def split_trunc(x):
    """The d-256 kernels' split (``csrc/wgmma.cuh`` ``split_trunc``): hi =
    x with its 13 low mantissa bits cleared, lo = x - hi exactly, which
    the tensor cores read as tf32 toward zero."""
    hi = (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)
    return hi, lo


def _steps_3xtf32(eq, a, b, a_dim, b_dim):
    """``einsum(eq, a, b)`` contracted over 8-deep steps of the shared
    dimension (``a_dim`` of ``a``, ``b_dim`` of ``b``) in order, each step
    a 3xTF32 product (lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), halves of
    ``split_trunc``) added to the fp32 accumulator."""
    acc = None
    for i in range(0, a.shape[a_dim], STEP):
        (ah, al), (bh, bl) = (split_trunc(t.narrow(dim, i, STEP).contiguous())
                              for t, dim in ((a, a_dim), (b, b_dim)))
        part = (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
                + torch.einsum(eq, ah, bh))
        acc = part if acc is None else acc + part
    return acc


def backward_d256_kernel_order(q, k, v, o, lse, do, bias, causal, dropout):
    """(dq, dk, dv) as the d-256 fp32 kernels sum them: S and dP over the
    head dim, dV and dK over the q rows (32- and 16-row steps of 8-row
    products), dQ over the keys (16-key steps of 8-key products), all in
    order."""
    qh, kh, vh, doh = (t.transpose(1, 2).float() for t in (q, k, v, do))
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    s = _steps_3xtf32("bhqd,bhkd->bhqk", qh, kh, 3, 3) * scale
    if bias is not None:
        s = s + bias
    if causal:
        row = torch.arange(sq)[:, None] + (sk - sq)
        s = torch.where(torch.arange(sk)[None, :] <= row, s, NEG_INF)
    p = torch.where(lse[..., None] > NEG_INF / 2,
                    torch.exp(s - lse[..., None]), 0.0)
    dp = _steps_3xtf32("bhqd,bhkd->bhqk", doh, vh, 3, 3)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    dfac = (torch.where(dropout.keep(p.shape, q.device), dropout.inv_keep,
                        0.0) if dropout is not None else 1.0)
    ds_ = p * (dfac * dp - delta) * scale
    pv = p * dfac
    dq = _steps_3xtf32("bhqk,bhkd->bhqd", ds_, kh, 3, 2)
    dk = _steps_3xtf32("bhqk,bhqd->bhkd", ds_, qh, 2, 2)
    dv = _steps_3xtf32("bhqk,bhqd->bhkd", pv, doh, 2, 2)
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", [None, "padding"])
def test_d256_fp32_kernel_order_holds_the_plain_backward(bias_kind, rate):
    b, h, s = 1, 2, 128
    q, k, v, g, rng = _inputs(b, s, s, h, D, 13)
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, g))
    bias = (None if bias_kind is None
            else torch.from_numpy(_bias(bias_kind, b, h, s, s, rng)))
    drop = Dropout(rate, 0x1234, 0x9E3779B9, h) if rate else None
    o, lse = flash_attention_reference(q, k, v, bias, causal=True,
                                       dropout=drop)
    refs = flash_attention_bwd_reference(q, k, v, o, lse, do, bias,
                                         causal=True, dropout=drop)
    got = backward_d256_kernel_order(q, k, v, o, lse, do, bias, True, drop)
    assert max_rel(got, refs) <= 1e-5


# ---------------------------------------------------------------------------
# the engine on GPT-J-6B's layout at head dim 256 against the JAX engine
# ---------------------------------------------------------------------------

GPTJ_LAYOUT = dict(vocab_size=512, max_seq_len=64, d_model=512, n_layers=2,
                   n_heads=2, rotary=True, rotary_dim=64, learned_pos=False,
                   parallel_residual=True, shared_parallel_ln=True,
                   attn_use_bias=False, tie_embeddings=False,
                   lm_head_bias=True)
SEQ = 64
LR = 1e-3            # _engine_config's peak learning rate
STEPS = 2


def _batch(step):
    return {"input_ids": np.random.RandomState(100 + step).randint(
        0, GPTJ_LAYOUT["vocab_size"], size=(16, SEQ)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX engine's losses, grad norms and parameters over ``STEPS``
    train_batch steps from its initialization (the global micro batch 1 x
    the test mesh's 8 devices is the port's micro batch of 8)."""
    jm = JaxGPT(JaxGPTConfig(**GPTJ_LAYOUT, dtype=jnp.float32))
    jeng, *_ = jds.initialize(
        model=jm, config=_engine_config(1), loss_fn=_jax_loss,
        sample_batch={"input_ids": np.zeros((1, SEQ), np.int32)},
        rng=jax.random.PRNGKey(0))
    init = _tree_np(jeng.params)
    losses, norms = [], []
    for step in range(STEPS):
        losses.append(float(jeng.train_batch(_batch(step))))
        norms.append(float(jeng.get_global_grad_norm()))
    return init, losses, norms, _tree_np(jeng.params)


def test_gptj_layout_engine_matches_the_jax_engine():
    init, losses, norms, final = _jax_run()
    cfg = GPTConfig(**GPTJ_LAYOUT, dtype=torch.float32)
    assert cfg.head_dim == D
    engine, *_ = ds.initialize(
        model=GPT(cfg, seed=None), model_parameters=params_from_jax(init, cfg),
        config=_engine_config(8), loss_fn=_port_loss, device="cpu")
    for step in range(STEPS):
        loss = engine.train_batch(_batch(step))
        assert abs(float(loss) - losses[step]) <= 1e-4, step
        np.testing.assert_allclose(engine.get_global_grad_norm(),
                                   norms[step], rtol=1e-4)
    want = params_from_jax(final, cfg)
    diff = max((want[k] - v).abs().max().item()
               for k, v in engine.module.state_dict().items())
    assert diff <= 2 * LR * STEPS, diff
