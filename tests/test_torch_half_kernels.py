"""The four kernel instances of the fp16 and bf16-gradient slice, through
their plain versions on the CPU, against the JAX package; and the C entry
points the wrappers pick for them.

- fp16 flash attention: the forward (O and LSE) and ``jax.vjp`` of JAX's
  ``flash_attention`` (Pallas in interpret mode) in fp16, from the same
  numpy inputs and seed words. Tolerances: atol 2e-3 on O, dQ, dK and dV
  (values of magnitude ~1: a few fp16 ulps at 2^-10 relative, on top of
  the fp16 casts of P and dS that both sides make at the same points),
  LSE atol 1e-5 (fp32). The plain version casts p' and dS to fp16 where
  JAX does, so an fp16 dS that overflows is inf on both sides.
- fused Adam and LAMB over bf16 gradient buffers: the plain versions
  (what a CPU state runs) against JAX ``fused_adamw`` / ``fused_lamb``
  (Pallas interpret mode) given the same bf16 gradients, which JAX casts
  to fp32 first: atol 1e-6 after 3 steps, as the fp32-gradient tests.
- dispatch: fp16 takes the ``_fp16`` flash entry points with dtype code 2
  through a stand-in library; bf16 buffers take ``fused_adam_bf16`` and
  ``fused_lamb_phase1_bf16`` (and the shared apply) with the same
  arguments as the fp32 ones, counted on their own counters; every other
  kernel refuses fp16 by name.
"""

import ast
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu.ops.pallas.fused_adam import fused_adamw as jax_adamw
from deepspeed_tpu.ops.pallas.fused_lamb import fused_lamb as jax_lamb
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._common import kernel_dtype_code
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.fused_adam import FusedAdamState
from deepspeed_tpu_torch.ops.fused_lamb import FusedLambState
from deepspeed_tpu_torch.ops.op_builder import SIGNATURES
from deepspeed_tpu_torch.runtime.optimizers import Adam, Lamb

from tests.test_torch_flash_bwd import _bias, _inputs, _words

FA = sys.modules["deepspeed_tpu_torch.ops.flash_attention"]
ADAM_MOD = sys.modules["deepspeed_tpu_torch.ops.fused_adam"]
LAMB_MOD = sys.modules["deepspeed_tpu_torch.ops.fused_lamb"]
ATOL = 2e-3


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("sq,sk,bias_kind", [(128, 128, None),
                                             (64, 128, "padding")])
def test_fp16_flash_forward_and_backward_match_jax(rate, sq, sk, bias_kind):
    b, h, d = 2, 2, 64
    q, k, v, g, rng = _inputs(b, sq, sk, h, d, 4)
    bias = _bias(bias_kind, b, h, sq, sk, rng)
    key = jax.random.PRNGKey(6)

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_,
                         bias=None if bias is None else jnp.asarray(bias),
                         causal=True, dropout_rate=rate,
                         dropout_rng=key if rate else None, bias_grad=False,
                         block_q=64)

    o, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g, jnp.float16))
    tq, tk, tv = (torch.from_numpy(x).half().requires_grad_()
                  for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    out = flash_attention(tq, tk, tv, bias=tb, causal=True,
                          dropout_rate=rate, dropout_seed=_words(6))
    out.backward(torch.from_numpy(g).half())
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(o, np.float32), atol=ATOL, rtol=0)
    for name, r, t in zip("qkv", ref, (tq, tk, tv)):
        assert t.grad.dtype == torch.float16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(r, np.float32), atol=ATOL,
                                   rtol=0, err_msg=f"d{name}")
    _, lse = flash_attention(tq.detach(), tk.detach(), tv.detach(), bias=tb,
                             causal=True, dropout_rate=rate,
                             dropout_seed=_words(6), return_lse=True)
    _, ref_lse = FA.flash_attention_fwd(
        tq.detach().float(), tk.detach().float(), tv.detach().float(),
        FA._bias_operand(tb, tq.float(), tk.float()), causal=True,
        dropout=FA.resolve_dropout(rate, _words(6), h))
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5,
                               rtol=0)


SHAPES = [(3,), (17, 5), (128,), (4, 33), (300,)]


def _bf16_case(seed):
    rs = np.random.RandomState(seed)
    params = [rs.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[jnp.asarray(rs.standard_normal(s), jnp.bfloat16)
              for s in SHAPES] for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_bf16_gradient_optimizers_match_jax(name):
    params, grads = _bf16_case(11)
    if name == "adam":
        tx = jax_adamw(1e-3, 0.9, 0.95, 1e-8, 0.01)
        opt, State = Adam(1e-3, 0.9, 0.95, 1e-8, 0.01), FusedAdamState
    else:
        tx = jax_lamb(1e-3, 0.9, 0.999, 1e-6, 0.01)
        opt, State = Lamb(1e-3, 0.9, 0.999, 1e-6, 0.01), FusedLambState
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tg = [torch.zeros(s, dtype=torch.bfloat16) for s in SHAPES]
    state = State(tp, tg)
    assert state.grad_dtype == torch.bfloat16
    for step, gs in enumerate(grads, 1):
        upd, js = tx.update(gs, js, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        for buf, g in zip(tg, gs):
            buf.copy_(torch.from_numpy(np.asarray(g, np.float32)))
        opt.step(state)
        assert state.count == step
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def test_optimizer_states_take_one_gradient_dtype():
    p = [torch.zeros(3), torch.zeros(4)]
    for State in (FusedAdamState, FusedLambState):
        assert State(p, [torch.zeros(3), torch.zeros(4)]).grad_dtype \
            == torch.float32
        with pytest.raises(ValueError, match="one dtype"):
            State(p, [torch.zeros(3), torch.zeros(4, dtype=torch.bfloat16)])
        with pytest.raises(ValueError, match="fp32 or bf16"):
            State(p, [torch.zeros(3, dtype=torch.float16),
                      torch.zeros(4, dtype=torch.float16)])


@pytest.fixture
def fake_lib(monkeypatch):
    calls = []

    def entry(name):
        def fn(*args):
            assert len(args) == len(SIGNATURES[name]), name
            calls.append((name, args))
            return 0
        return fn
    lib = types.SimpleNamespace(**{n: entry(n) for n in SIGNATURES})
    monkeypatch.setattr(op_builder, "load", lambda *a, **k: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: types.SimpleNamespace(cuda_stream=0))
    return calls


def test_fp16_entry_points_take_the_bf16_ones_arguments():
    for name in SIGNATURES:
        if name.endswith("_fp16"):
            assert SIGNATURES[name] == SIGNATURES[name[:-5] + "_bf16"], name
    assert {n for n in SIGNATURES if n.endswith("_fp16")} == {
        "flash_attention_fwd_fp16", "flash_attention_bwd_dkv_fp16",
        "flash_attention_bwd_dq_fp16"}


def test_fp16_flash_launches_the_fp16_instances(fake_lib):
    q, k, v, do = (torch.zeros(1, 64, 2, 64, dtype=torch.float16)
                   for _ in range(4))
    before = (flash_attention.launches, FA.flash_attention_bwd.dkv_launches,
              FA.flash_attention_bwd.dq_launches)
    o, lse = FA._launch(q, k, v, None, True, 0.125, None)
    FA._launch_bwd(q, k, v, o, lse, do, None, True, 0.125, None)
    assert [c[0] for c in fake_lib] == [
        "flash_attention_fwd_fp16", "flash_attention_bwd_dkv_fp16",
        "flash_attention_bwd_dq_fp16"]
    assert fake_lib[0][1][6] == 2 and fake_lib[1][1][9] == 2
    assert (flash_attention.launches, FA.flash_attention_bwd.dkv_launches,
            FA.flash_attention_bwd.dq_launches) == tuple(
                n + 1 for n in before)


@pytest.mark.parametrize("gdtype,adam,lamb", [
    (torch.bfloat16, "fused_adam_bf16", "fused_lamb_phase1_bf16"),
    (torch.float32, "fused_adam", "fused_lamb_phase1")], ids=["bf16", "fp32"])
def test_gradient_dtype_picks_the_optimizer_instance(fake_lib, gdtype, adam,
                                                     lamb):
    params = [torch.zeros(5), torch.zeros(7)]
    grads = [torch.zeros(5, dtype=gdtype), torch.zeros(7, dtype=gdtype)]
    fa, fl = ADAM_MOD.fused_adam, LAMB_MOD.fused_lamb
    counts = lambda: (fa.launches, fa.bf16_launches,  # noqa: E731
                      fl.phase1_launches, fl.bf16_phase1_launches,
                      fl.apply_launches)
    before = counts()
    sa = FusedAdamState(params, grads)
    sa._build_table()
    ADAM_MOD._launch(sa, Adam().scalars(1), None, 0.0)
    sl = FusedLambState(params, grads)
    sl._build_table()
    LAMB_MOD._launch(sl, Lamb().scalars(1), None, 0.0)
    assert [c[0] for c in fake_lib] == [adam, lamb, "fused_lamb_apply"]
    bf16 = gdtype == torch.bfloat16
    assert np.subtract(counts(), before).tolist() == [
        int(not bf16), int(bf16), int(not bf16), int(bf16), 1]


def test_only_the_flash_kernels_take_fp16():
    assert kernel_dtype_code(torch.float16, fp16=True) == 2
    with pytest.raises(TypeError, match="fp16-serving slice"):
        kernel_dtype_code(torch.float16)
    ops = os.path.dirname(op_builder.__file__)
    takers = set()
    for name in os.listdir(ops):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ops, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", "") == "kernel_dtype_code"
                    and any(kw.arg == "fp16" for kw in node.keywords)):
                takers.add(name)
    assert takers == {"flash_attention.py"}
