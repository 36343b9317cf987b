"""The model side of the one-card training modes against the JAX package:
activation checkpointing (remat policies), the chunked loss and
progressive layer drop, on the CPU at 2 layers and d_model 128.

- Remat: for each policy the port's gradients are bit-equal to its own
  ``none`` (the same operations recomputed in the same order; dropout's
  keep mask is a counter hash), and within atol 1e-5 of the model's
  largest gradient of ``jax.grad`` through the JAX model under the same
  policy (two fp32 evaluations, as ``test_torch_bert.py``). ``full``
  recomputes the flash forward (two forward runs a layer), the others
  never do (one).
- ``gpt_chunked_loss_fn``: value within 1e-6 and the gradients of hidden
  and wte within 1e-6 of the largest (fp32; the chunks' sums in JAX's
  order), at s % chunk == 0 and != 0 (one chunk), with and without
  z_loss; the port's chunked loss also equals its ``gpt_loss_fn`` over
  full logits within the same bounds.
- PLD: theta(t) equal to JAX's schedule (the same float64 formula);
  GPT pre-LN, the parallel layout and BERT post-LN with
  ``layer_keep_prob`` within 1e-5 of JAX in fp32; in bf16 the output
  dtype follows JAX's promotion (an fp32 array p makes the residual
  stream fp32, a Python float keeps it bf16) and the logits agree within
  bf16's 2e-2 of the largest. JAX's scanned stack cannot carry that fp32
  stream (its scan refuses the dtype change), so the bf16 cases hold the
  port against JAX's unrolled layers.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.bert import BertEncoder as JaxBertEncoder
from deepspeed_tpu.models.gpt import gpt_chunked_loss_fn as jax_chunked
from deepspeed_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss
from deepspeed_tpu.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as JaxPLD
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import (GPT, BertEncoder, GPTConfig,
                                        gpt_chunked_loss_fn, gpt_loss_fn)
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.layers import REMAT_POLICIES
from deepspeed_tpu_torch.ops.dropout import seed_words
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop

from tests.test_torch_bert import configs as bert_configs
from tests.test_torch_bert import tree_np
from tests.test_torch_model import TINY, jax_gpt, port_gpt, tokens
from tests.torch_threads import share_cores

share_cores()

FA = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
ATOL = 1e-5
POLICIES = ("full", "dots", "dots_no_batch", "attn_out")


def _port_grads(model, ids, rate=0.0):
    model.train().requires_grad_(True)
    model.zero_grad()
    t = torch.from_numpy(ids).long()
    loss = gpt_loss_fn(model(t[:, :-1], dropout_seed=seed_words(7)),
                       t[:, 1:])
    loss.backward()
    return loss.item(), {k: p.grad.clone()
                         for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def remat_runs():
    """The port's loss and gradients under each policy, attention dropout
    0.1, and the flash forward launches each one counted."""
    jm, params = jax_gpt()
    base = port_gpt(jm, params)
    ids = tokens((2, 33))
    runs = {}
    for name in ("none", *POLICIES):
        cfg = dataclasses.replace(base.config, remat=name,
                                  attn_dropout_rate=0.1)
        model = GPT(cfg)
        model.load_state_dict(base.state_dict())
        calls = []
        real = FA.flash_attention_fwd

        def counting(*a, **k):
            calls.append(1)
            return real(*a, **k)
        FA.flash_attention_fwd = counting
        try:
            runs[name] = (*_port_grads(model, ids), len(calls))
        finally:
            FA.flash_attention_fwd = real
    return runs


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_are_bit_equal_to_none(remat_runs, policy):
    loss, grads, fwd = remat_runs[policy]
    ref_loss, ref, ref_fwd = remat_runs["none"]
    assert loss == ref_loss
    for k, g in ref.items():
        assert torch.equal(grads[k], g), k
    # the flash forward runs once a layer, twice under "full"
    assert ref_fwd == TINY["n_layers"]
    assert fwd == TINY["n_layers"] * (2 if policy == "full" else 1)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_shared_parallel_ln_is_bit_equal_to_none(policy):
    """GPT-J's layout (one LN for both branches): the LN runs once a layer
    without remat, and each policy's gradients equal none's bit for bit
    (the regions hand the shared LN's output across, as the layer without
    remat shares it)."""
    ids = torch.from_numpy(tokens((2, 33))).long()
    cfg = GPTConfig(**TINY, dtype=torch.float32, parallel_residual=True,
                    shared_parallel_ln=True)
    runs = {}
    for name in ("none", policy):
        model = GPT(dataclasses.replace(cfg, remat=name))
        ln_calls = []
        for blk in model.h:
            blk.ln_1.register_forward_hook(
                lambda *_: ln_calls.append(1))
        loss = gpt_loss_fn(model(ids[:, :-1]), ids[:, 1:])
        loss.backward()
        runs[name] = (loss.item(), [p.grad for p in model.parameters()],
                      len(ln_calls))
    assert runs["none"][2] == TINY["n_layers"]
    assert runs[policy][0] == runs["none"][0]
    assert all(torch.equal(a, b)
               for a, b in zip(runs[policy][1], runs["none"][1]))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_match_jax_under_the_same_policy(policy):
    jm, params = jax_gpt(remat=policy)
    model = port_gpt(jm, params)
    model.config = dataclasses.replace(model.config, remat=policy)
    ids = tokens((2, 33))

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids[:, :-1]))
        return jax_gpt_loss(logits, jnp.asarray(ids[:, 1:]))
    ref_loss, jgrads = jax.value_and_grad(jloss)(params)
    loss, grads = _port_grads(model, ids)
    assert abs(loss - float(ref_loss)) <= ATOL
    ref = params_from_jax(tree_np(jgrads), model.config)
    scale = max(g.abs().max().item() for g in ref.values())
    for k, g in ref.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=0,
                                   atol=ATOL * scale, err_msg=k)


def test_remat_policies_are_jaxs_but_offload():
    from deepspeed_tpu.models.gpt import REMAT_POLICIES as JAX_POLICIES
    assert set(REMAT_POLICIES) == set(JAX_POLICIES) - {"offload"}
    with pytest.raises(NotImplementedError, match="offload"):
        GPT(GPTConfig(**TINY, remat="offload"))
    with pytest.raises(ValueError, match="unknown remat"):
        GPT(GPTConfig(**TINY, remat="everything"))


def _loss(m, batch, rng, train):
    ids = batch["input_ids"].long()
    return gpt_loss_fn(m(ids[:, :-1], dropout_seed=rng), ids[:, 1:])


@pytest.mark.parametrize("block,model_remat,want", [
    ({}, "none", "full"),                       # JAX: none -> full
    ({}, "dots", "dots"),                       # the model's own policy
    ({"remat_policy": "attn_out"}, "none", "attn_out"),
    ({"remat_policy": "none", "number_checkpoints": 4,
      "contiguous_memory_optimization": True}, "full", "none"),
])
def test_activation_checkpointing_block_maps_as_jax(block, model_remat,
                                                    want, caplog):
    model = GPT(GPTConfig(**TINY, dtype=torch.float32, remat=model_remat))
    with caplog.at_level("WARNING", logger="deepspeed_tpu_torch"):
        eng, *_ = ds.initialize(
            model=model, loss_fn=_loss, device="cpu",
            config={"train_batch_size": 2,
                    "activation_checkpointing": block})
    assert eng.module.config.remat == want
    if "number_checkpoints" in block:
        assert "number_checkpoints is ignored" in caplog.text
        assert "contiguous_memory_optimization" in caplog.text


def test_activation_checkpointing_api_configures_and_refuses():
    ac.reset()
    assert not ac.is_configured()
    ac.configure(deepspeed_config={"activation_checkpointing": {
        "remat_policy": "dots", "profile": True, "number_checkpoints": 3}})
    assert ac.is_configured() and ac.checkpointing.REMAT_POLICY == "dots"
    assert ac.checkpointing._NUM_LAYERS == 3
    w = torch.randn(8, 16, requires_grad=True)
    x = torch.randn(4, 8)
    f = lambda x: torch.tanh(x @ w).square().sum()        # noqa: E731
    want, = torch.autograd.grad(f(x), w)
    for name in ("none", "full", "dots", "dots_no_batch", "attn_out"):
        ac.set_remat_policy(name)
        got, = torch.autograd.grad(ac.checkpoint(f, x), w)
        assert torch.equal(got, want), name
    assert torch.equal(torch.autograd.grad(
        ac.checkpoint_wrapper(f)(x), w)[0], want)
    with pytest.raises(NotImplementedError, match="offload"):
        ac.configure(checkpoint_in_cpu=True)
    with pytest.raises(NotImplementedError, match="offload"):
        ac.set_remat_policy("offload")

    class MPU:
        def get_model_parallel_world_size(self):
            return 2
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ac.configure(mpu_=MPU())
    ac.reset()
    assert not ac.is_configured() and ac.checkpointing.REMAT_POLICY is None
    tracker = ac.model_parallel_seed(5)
    a, b = tracker.fork(), tracker.fork()
    assert not torch.equal(torch.rand(3, generator=a),
                           torch.rand(3, generator=b))
    again = ac.model_parallel_seed(5).fork()
    assert torch.equal(torch.rand(3, generator=again),
                       torch.rand(3, generator=ac.model_parallel_seed(
                           5).fork()))


# --------------------------------------------------------------------------
# the chunked loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk,z_loss", [(32, 8, 0.0), (32, 8, 1e-3),
                                            (30, 8, 0.0), (30, 8, 1e-3)])
def test_chunked_loss_matches_jax(s, chunk, z_loss):
    rs = np.random.RandomState(s)
    h = rs.randn(2, s, 64).astype(np.float32)
    w = (rs.randn(97, 64) * 0.1).astype(np.float32)
    y = rs.randint(0, 97, size=(2, s)).astype(np.int32)
    ref, (rdh, rdw) = jax.value_and_grad(
        lambda a, b: jax_chunked(a, b, jnp.asarray(y), chunk, z_loss),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = gpt_chunked_loss_fn(th, tw, torch.from_numpy(y), chunk, z_loss)
    loss.backward()
    assert abs(loss.item() - float(ref)) <= 1e-6
    for got, want in ((th.grad, rdh), (tw.grad, rdw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    # and the same function as the loss over full logits
    th2 = torch.from_numpy(h).requires_grad_()
    tw2 = torch.from_numpy(w).requires_grad_()
    full = gpt_loss_fn(th2 @ tw2.t(), torch.from_numpy(y), z_loss=z_loss)
    full.backward()
    assert abs(full.item() - loss.item()) <= 1e-6
    np.testing.assert_allclose(th.grad.numpy(), th2.grad.numpy(), rtol=0,
                               atol=1e-6 * th2.grad.abs().max().item())


def test_return_hidden_feeds_the_chunked_loss_and_refuses_an_untied_head():
    jm, params = jax_gpt()
    model = port_gpt(jm, params)
    ids = torch.from_numpy(tokens((2, 17))).long()
    h, w = model(ids[:, :-1], return_hidden=True)
    assert w is model.wte and h.shape == (2, 16, TINY["d_model"])
    jh, jw = jm.apply({"params": params}, jnp.asarray(ids[:, :-1].numpy()),
                      return_hidden=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        gpt_chunked_loss_fn(h, w, ids[:, 1:], 8).item(),
        float(jax_chunked(jh, jw, jnp.asarray(ids[:, 1:].numpy()), 8)),
        atol=ATOL, rtol=0)
    untied = GPT(GPTConfig(**TINY, tie_embeddings=False))
    with pytest.raises(ValueError, match="tie_embeddings"):
        untied(ids, return_hidden=True)


# --------------------------------------------------------------------------
# progressive layer drop
# --------------------------------------------------------------------------

def test_pld_theta_schedule_is_jaxs():
    ours, ref = ProgressiveLayerDrop(0.5, 0.001), JaxPLD(0.5, 0.001)
    for step in (0, 1, 10, 500, 5000):
        assert ours.update_state(step) == ref.update_state(step)
    assert ours.get_state() == ref.get_state()


def _keep_prob(kind):
    return {"array": (jnp.float32(0.7), torch.tensor(0.7)),
            "float": (0.7, 0.7)}[kind]


PARALLEL = {"parallel_residual": True, "use_bias": False}


@pytest.mark.parametrize("variant,dtype,kind", [
    ({}, "float32", "array"), (PARALLEL, "float32", "array"),
    ({}, "bfloat16", "array"), ({}, "bfloat16", "float")],
    ids=["preln-fp32", "parallel-fp32", "preln-bf16-array",
         "preln-bf16-float"])
def test_gpt_layer_keep_prob_matches_jax(variant, dtype, kind):
    # unrolled: JAX's scanned stack cannot carry the fp32 stream that an
    # fp32 keep probability makes of a bf16 one (scan carry dtypes)
    jm, params = jax_gpt(scan_layers=False, **variant)
    model = port_gpt(jm, params)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = type(jm)(dataclasses.replace(jm.config, dtype=jdt))
    model.config = dataclasses.replace(model.config, dtype=tdt)
    for m in model.modules():
        if hasattr(m, "dtype") and isinstance(m.dtype, torch.dtype):
            m.dtype = tdt
    ids = tokens((2, 16))
    jp, tp = _keep_prob(kind)
    ref = jm.apply({"params": params}, jnp.asarray(ids), layer_keep_prob=jp)
    got = model(torch.from_numpy(ids).long(), layer_keep_prob=tp)
    assert str(got.dtype)[6:] == str(ref.dtype)
    want = np.asarray(ref.astype(jnp.float32))
    tol = ATOL if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0,
                               atol=tol)


def test_bert_post_ln_layer_keep_prob_matches_jax():
    jcfg, pcfg = bert_configs(False, max_seq_len=64)
    enc = JaxBertEncoder(jcfg)
    ids = np.random.RandomState(3).randint(1, 96, size=(2, 64)).astype(
        np.int32)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    (seq, pooled) = enc.apply({"params": params}, jnp.asarray(ids),
                              layer_keep_prob=jnp.float32(0.6))
    model = BertEncoder(pcfg)
    sd = params_from_jax({"bert": tree_np(params)}, pcfg)
    model.load_state_dict({k[len("bert."):]: v for k, v in sd.items()
                           if k.startswith("bert.")})
    got_seq, got_pooled = model(torch.from_numpy(ids).long(),
                                layer_keep_prob=torch.tensor(0.6))
    np.testing.assert_allclose(got_seq.detach().numpy(), np.asarray(seq),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_pooled.detach().numpy(),
                               np.asarray(pooled), atol=ATOL, rtol=0)
    # keep probability 1 is the ungated layer, up to x + (y - x) rounding
    plain, _ = model(torch.from_numpy(ids).long())
    one, _ = model(torch.from_numpy(ids).long(),
                   layer_keep_prob=torch.tensor(1.0))
    torch.testing.assert_close(plain, one, atol=ATOL, rtol=0)
