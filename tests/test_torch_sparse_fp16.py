"""The fp16 block-sparse forward, dQ and dK/dV, held against the JAX
package, and a tiny sparse BERT trained in fp16 with every dropout on by
both engines.

The port's fp16 kernels (the ``_fp16`` instances of
``csrc/block_sparse_attention_fwd_bf16.cu`` and ``..._bwd_bf16.cu``) round
where the bf16 ones and their plain versions round: P' to the value dtype
before P V, P∘D before dV, dS before dK and dQ, fp32 sums, the stores
(JAX ``block_sparse_kernel.py`` :239, :278, :318-321). On the CPU the
kernel route runs those plain versions in fp16; here they are held
against the JAX package's Pallas block-sparse kernels in fp16 (interpret
mode) on the same numpy inputs, with dropout off and at 0.2 (seed words
``seed_words(n)`` against ``PRNGKey(n)``: the same keep bits), on the
cases of ``test_torch_sparse_bf16.py``. Bounds, fixed before the first
run:

- forward: atol 2e-3 on outputs of size ~1 (the fp16 row of ``PERF.md``;
  one fp16 ulp at 1 is 9.8e-4, and the two sides round P against running
  maxima of different tiles);
- gradients, per tensor: atol 5e-3 × max|ref|, rms(err) / rms(ref) <=
  1.25e-4 for dV and 6e-4 for dQ and dK: a quarter of the bf16 test's
  bounds (fp16's ulp is an eighth of bf16's, the other eighth left for
  the tile orders, which are the same as in bf16).

The engine test: BERT (2 layers, d 128, 2 heads of 64, BigBird-16 at 128
tokens) in fp16 on fp32 masters with attention dropout 0, MLP and
embedding dropout 0.1, FusedLamb, dynamic loss scaling, micro 8 x gas 2,
4 steps (two poisoned through a loss keyword so their fp16 gradients
overflow, as ``test_torch_precision_engine.py`` does). The JAX fp16
engine's ``nn.Dropout`` calls are fed the port's masks through
``flax.linen.intercept_methods``, from site words the batch carries (the
words the port's engine derives for that step and microbatch), hashed in
jnp by the JAX package's own ``_keep_from_coords``. Gates, as the fp16
engine row's: each step's loss within 1e-3, the loss scale, the skip
count and the optimizer's step count exact.
"""

import dataclasses

import flax.linen as nn
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as ds
from deepspeed_tpu.models.bert import BertForPreTraining as JaxBert
from deepspeed_tpu.models.bert import bert_pretrain_loss as jax_bert_loss
from deepspeed_tpu.ops.pallas.flash_attention import _keep_from_coords
from deepspeed_tpu.ops.sparse_attention import sparse_attention as jax_sparse
from deepspeed_tpu_torch.models import BertForPreTraining, bert_pretrain_loss
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.dropout import (EMBED_SITE, MLP_SITE,
                                             fold_seed, seed_words,
                                             site_words)
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import \
    device_plan
from tests.test_torch_bert import batch as bert_batch
from tests.test_torch_bert import configs, tree_np
from tests.test_torch_sparse_attention import pair, qkv, to_t
from tests.test_torch_sparse_bf16 import CASES
from tests.torch_threads import share_cores

share_cores()

FWD_ATOL = 2e-3
ATOL = 5e-3          # of max|ref|, per tensor
RMS = {"dq": 6e-4, "dk": 6e-4, "dv": 1.25e-4}   # rms(err) / rms(ref)
H, D = 2, 64


def _run(jcfg, pcfg, s, rate, seed):
    """(port out, JAX out, port grads, JAX grads) in fp16."""
    arrays = qkv((1, s, H, D), seed=seed)
    w = qkv((1, s, H, D), seed=seed + 1, n=1)[0]
    drop = dict(dropout_rate=rate, deterministic=rate == 0.0)
    jfn = lambda q, k, v: jax_sparse(  # noqa: E731
        q, k, v, jcfg, backend="pallas",
        dropout_rng=jax.random.PRNGKey(seed) if rate else None, **drop)
    # one forward for the output and the gradients of sum(out * w), whose
    # cotangent is w in the output's dtype
    ref_out, vjp = jax.vjp(jfn, *(jnp.asarray(a, jnp.float16)
                                  for a in arrays))
    ref = vjp(jnp.asarray(w, jnp.float16))
    q, k, v = to_t(arrays, torch.float16, grad=True)
    out = sparse_attention(q, k, v, pcfg, backend="kernel",
                           dropout_seed=seed_words(seed) if rate else None,
                           **drop)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert ref_out.dtype == jnp.float16 and out.dtype == torch.float16
    return (out, np.asarray(ref_out, np.float32), [t.grad for t in (q, k, v)],
            [np.asarray(r, np.float32) for r in ref])


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["rate0", "rate0.2"])
@pytest.mark.parametrize("name,cls,kw,s", CASES, ids=[c[0] for c in CASES])
def test_fp16_forward_and_gradients_match_jax_pallas(name, cls, kw, s, rate):
    kw = dict(kw)
    jcfg, pcfg = pair(cls, heads=H, block=kw.pop("block"), **kw)
    assert device_plan(pcfg, s, "cpu") is not None
    out, ref_out, got, ref = _run(jcfg, pcfg, s, rate, seed=11)
    np.testing.assert_allclose(out.float().detach().numpy(), ref_out,
                               atol=FWD_ATOL, rtol=0,
                               err_msg=f"{name} rate={rate} forward")
    for g, r, what in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == torch.float16, what
        g = g.float().numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL * np.abs(r).max(),
                                   err_msg=f"{name} rate={rate} {what}")
        rms = np.sqrt(np.mean((g - r) ** 2) / np.mean(r ** 2))
        assert rms <= RMS[what], (name, rate, what, rms)


# --------------------------------------------------------------------------
# a tiny sparse BERT in fp16 with every dropout on, both engines
# --------------------------------------------------------------------------

RATE = 0.1
LR = 1e-3
POISON = 1e6
FP16 = {"enabled": True, "loss_scale": 0, "initial_scale_power": 16,
        "loss_scale_window": 2, "hysteresis": 2, "min_loss_scale": 1.0}
STEPS = [(0, False), (1, True), (2, False), (3, True)]   # (seed, poisoned)
N_LAYERS = 2
SEQ = 128


def _engine_config(micro):
    return {"train_batch_size": 16, "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "FusedLamb",
                          "params": {"lr": LR, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "fp16": FP16,
            "steps_per_print": 10_000}


def _site_words(words):
    """[1 + layers, 2] int32 bit patterns: the embedding site's words,
    then each layer's MLP site's, of one microbatch's forward words."""
    rows = [site_words(words, EMBED_SITE)] + [
        site_words(fold_seed(words, i), MLP_SITE) for i in range(N_LAYERS)]
    return np.array(rows, np.uint32).view(np.int32)


def _batch(seed, step_words):
    """16 rows of the tiny BERT batch and, per row, its microbatch's site
    words (micro i: rows 8i..8i+7, words fold_seed(step_words, i))."""
    bt = bert_batch(b=16, s=SEQ, seed=seed)
    bt["words"] = np.stack([_site_words(fold_seed(step_words, r // 8))
                            for r in range(16)])
    return bt


def _jax_masks(words):
    """Each nn.Dropout call of the JAX BERT replaced by flax's formula
    over the port's keep bits, hashed in jnp from ``words`` [1 + L, 2]."""
    def interceptor(next_fun, args, kwargs, ctx):
        if not (isinstance(ctx.module, nn.Dropout)
                and ctx.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        path = ctx.module.path[1:]          # under "bert"
        site = 0 if path == ("Dropout_0",) else 1 + int(
            path[0].rsplit("_", 1)[1])
        s0, s1 = words[site, 0], words[site, 1]
        b, s, d = x.shape
        keep = _keep_from_coords(
            s0, s1, jnp.arange(b, dtype=jnp.uint32)[:, None, None],
            jnp.arange(s, dtype=jnp.uint32)[None, :, None],
            jnp.arange(d, dtype=jnp.uint32)[None, None, :], RATE)
        return jnp.where(keep, x / (1.0 - RATE), 0.0)
    return interceptor


def _jax_loss(model, params, batch, rng, train, boost=1.0):
    words = jax.lax.bitcast_convert_type(batch["words"][0], jnp.uint32)
    with nn.intercept_methods(_jax_masks(words)):
        mlm, nsp = model.apply(params, batch["input_ids"],
                               token_type_ids=batch["token_type_ids"],
                               deterministic=not train)
    return boost * jax_bert_loss(mlm, nsp, batch["mlm_labels"],
                                 batch["nsp_labels"])


def _port_loss(model, batch, rng, train, boost=1.0):
    mlm, nsp = model(batch["input_ids"].long(),
                     token_type_ids=batch["token_type_ids"].long(),
                     dropout_seed=rng)
    return boost * bert_pretrain_loss(mlm, nsp, batch["mlm_labels"],
                                      batch["nsp_labels"])


def _count(state):
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        if "count" in jax.tree_util.keystr(path):
            return int(np.asarray(leaf))
    raise AssertionError("no count in the optimizer state")


def test_fp16_sparse_bert_with_dropout_matches_the_jax_fp16_engine():
    jcfg, pcfg = configs(True, max_seq_len=SEQ, n_layers=N_LAYERS,
                         dropout_rate=RATE)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float16, scan_layers=False)
    pcfg = dataclasses.replace(pcfg, dtype=torch.float16)
    jeng, *_ = jds.initialize(
        model=JaxBert(jcfg), config=_engine_config(1), loss_fn=_jax_loss,
        sample_batch={"input_ids": np.zeros((1, SEQ), np.int32)},
        rng=jax.random.PRNGKey(0))
    # the step leaves the loss-scale state replicated over the engine's
    # mesh; placed so before the first step, the step compiles once
    mesh = jax.tree.leaves(jeng.params)[0].sharding.mesh
    jeng.loss_scale_state = jax.device_put(
        jeng.loss_scale_state, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec()))
    tree = tree_np(jeng.params["params"])
    eng, *_ = ds.initialize(model=BertForPreTraining(pcfg, seed=None),
                            model_parameters=params_from_jax(tree, pcfg),
                            config=_engine_config(8), loss_fn=_port_loss,
                            seed=42, device="cpu")
    rows = []
    for seed, poisoned in STEPS:
        bt = _batch(seed, fold_seed(eng._seed, eng.global_steps + 1))
        boost = POISON if poisoned else 1.0
        # an array operand: the JAX engine compiles its step once
        want = float(jeng.train_batch(
            bt, boost=np.float32(boost))) / boost
        got = float(eng.train_batch(bt, boost=boost)) / boost
        rows.append((got, want))
        print(f"step {len(rows)}: loss port {got!r} JAX {want!r}")
        assert abs(got - want) <= 1e-3, rows
        assert (eng.get_loss_scale(), eng.skipped_steps,
                eng.optimizer_state.count) == (
            jeng.get_loss_scale(), jeng.skipped_steps,
            _count(jeng.optimizer_state)), rows
    assert eng.skipped_steps == 2 and eng.global_steps == len(STEPS)
