"""The port's BERT (dense and block-sparse) against the JAX package's.

A JAX ``BertForPreTraining`` is initialised from a seed, its params go
through ``params_from_jax`` (scanned or unrolled trees) into the port's
model, and the same numpy ids go through both; fp32 on the CPU, d_model
128, 2 heads of 64, 2 layers, vocab 96, S 256. On the CPU the JAX
package's sparse layers take their dense-mask route and the port's its
kernel route (the plain versions of the block-sparse kernels), so the
comparison holds the port's sparse path against the reference semantics.
Tolerances: logits and loss atol 1e-5 (values of size ~1 through two
fp32 evaluations); gradients atol 1e-5 of the model's largest gradient
(a small gradient, such as a bias's mean of p - y, carries the absolute
error of the sums behind it, not one relative to its own size).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.core import meta, unfreeze

from deepspeed_tpu.models.bert import BertConfig as JaxBertConfig
from deepspeed_tpu.models.bert import BertForPreTraining as JaxBert
from deepspeed_tpu.models.bert import bert_pretrain_loss as jax_bert_loss
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu.ops.sparse_attention import \
    SparseAttentionUtils as JaxUtils
from deepspeed_tpu_torch.models import (BertConfig, BertForPreTraining,
                                        bert_pretrain_loss)
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as psc

ATOL = 1e-5
TINY = dict(vocab_size=96, max_seq_len=256, d_model=128, n_layers=2,
            n_heads=2)
S = 256


def configs(sparse, max_seq_len=S, **kw):
    """(JAX config, port config) of the tiny BERT; ``sparse``: BigBird-16
    or None."""
    shared = {**TINY, "max_seq_len": max_seq_len, **kw}
    jcfg = JaxBertConfig(**shared, dtype=jnp.float32, sparsity_config=(
        jsc.BigBirdSparsityConfig(2, block=16) if sparse else None))
    pcfg = BertConfig(**shared, dtype=torch.float32, sparsity_config=(
        psc.BigBirdSparsityConfig(2, block=16) if sparse else None))
    return jcfg, pcfg


def jax_bert(jcfg, scan_layers=True, seed=0):
    jcfg = dataclasses.replace(jcfg, scan_layers=scan_layers)
    m = JaxBert(jcfg)
    params = m.init(jax.random.PRNGKey(seed),
                    jnp.ones((1, jcfg.max_seq_len), jnp.int32))["params"]
    return m, params


def tree_np(params):
    return jax.tree.map(np.asarray, unfreeze(meta.unbox(params)))


def port_bert(pcfg, params):
    model = BertForPreTraining(pcfg)
    model.load_state_dict(params_from_jax(tree_np(params), pcfg))
    return model


def batch(b=2, s=S, seed=0, vocab=TINY["vocab_size"]):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, vocab, size=(b, s)).astype(np.int32)
    types = (np.arange(s) >= s // 2).astype(np.int32)[None].repeat(b, 0)
    labels = np.where(rs.rand(b, s) < 0.15, ids, -1).astype(np.int32)
    return {"input_ids": ids, "token_type_ids": types, "mlm_labels": labels,
            "nsp_labels": rs.randint(0, 2, size=b).astype(np.int32)}


def jax_loss(m, params, bt, attention_mask=None):
    mlm, nsp = m.apply({"params": params}, jnp.asarray(bt["input_ids"]),
                       token_type_ids=jnp.asarray(bt["token_type_ids"]),
                       attention_mask=attention_mask)
    return jax_bert_loss(mlm, nsp, jnp.asarray(bt["mlm_labels"]),
                         jnp.asarray(bt["nsp_labels"])), (mlm, nsp)


def port_forward(model, bt, attention_mask=None):
    t = {k: torch.from_numpy(v).long() for k, v in bt.items()}
    mlm, nsp = model(t["input_ids"], token_type_ids=t["token_type_ids"],
                     attention_mask=attention_mask)
    return bert_pretrain_loss(mlm, nsp, t["mlm_labels"],
                              t["nsp_labels"]), (mlm, nsp)


CASES = [  # (id, scan_layers, pre_ln, sparse, padded)
    ("scanned-postln-dense", True, False, False, False),
    ("unrolled-postln-sparse", False, False, True, False),
    ("scanned-preln-sparse", True, True, True, False),
    ("unrolled-preln-dense", False, True, False, False),
    ("scanned-postln-sparse-padded", True, False, True, True),
]


@pytest.mark.parametrize("name,scan,pre_ln,sparse,padded", CASES,
                         ids=[c[0] for c in CASES])
def test_logits_loss_and_grads_match_jax(name, scan, pre_ln, sparse,
                                         padded):
    jcfg, pcfg = configs(sparse, pre_ln=pre_ln)
    jm, params = jax_bert(jcfg, scan_layers=scan)
    model = port_bert(pcfg, params)
    bt = batch()
    mask = None
    if padded:   # a padded row: the sparse layers take the dense route
        mask = np.ones((2, S), np.int32)
        mask[1, 200:] = 0
    (ref_loss, (rmlm, rnsp)), jgrads = jax.value_and_grad(
        lambda p: jax_loss(jm, p, bt, None if mask is None
                           else jnp.asarray(mask)), has_aux=True)(params)
    loss, (mlm, nsp) = port_forward(
        model, bt, None if mask is None else torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(mlm.detach().numpy(), np.asarray(rmlm),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(nsp.detach().numpy(), np.asarray(rnsp),
                               atol=ATOL, rtol=0)
    assert abs(loss.item() - float(ref_loss)) <= ATOL
    ref_grads = params_from_jax(tree_np(jgrads), pcfg)
    named = dict(model.named_parameters())
    assert set(ref_grads) == set(named)
    scale = max(g.abs().max().item() for g in ref_grads.values())
    for k, g in ref_grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=ATOL * scale, err_msg=k)


def test_bigbird_at_another_length_takes_the_trained_pattern():
    """Trained (max_seq_len) 512, run at 256: both packages attend with
    the 512-token pattern's slice (the pinned dense route)."""
    jcfg, pcfg = configs(True, max_seq_len=512)
    jm, params = jax_bert(jcfg)
    model = port_bert(pcfg, params)
    bt = batch(seed=1)
    _, (rmlm, rnsp) = jax_loss(jm, params, bt)
    _, (mlm, nsp) = port_forward(model, bt)
    np.testing.assert_allclose(mlm.detach().numpy(), np.asarray(rmlm),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(nsp.detach().numpy(), np.asarray(rnsp),
                               atol=ATOL, rtol=0)


def test_replace_self_attention_with_sparse_matches_jax():
    """A dense BERT of 128 positions made sparse at 256: the same config,
    the same extended position table, the same logits at 256."""
    jcfg, pcfg = configs(False, max_seq_len=128)
    jm, params = jax_bert(jcfg)
    state = params_from_jax(tree_np(params), pcfg)
    jcfg2, jparams2 = JaxUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            jcfg, params, S, jsc.BigBirdSparsityConfig(2, block=16))
    pcfg2, state2 = SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            pcfg, state, S, psc.BigBirdSparsityConfig(2, block=16))
    assert pcfg2.max_seq_len == jcfg2.max_seq_len == S
    assert pcfg2.sparsity_config.cache_key() == \
        jcfg2.sparsity_config.cache_key()
    assert state["bert.position_embeddings"].shape[0] == 128   # untouched
    ref_state = params_from_jax(tree_np(jparams2), pcfg2)
    assert set(ref_state) == set(state2)
    for k, v in ref_state.items():
        assert torch.equal(state2[k], v), k
    model = BertForPreTraining(pcfg2)
    model.load_state_dict(state2)
    bt = batch(seed=2)
    _, (rmlm, _) = jax_loss(JaxBert(jcfg2), jparams2, bt)
    _, (mlm, _) = port_forward(model, bt)
    np.testing.assert_allclose(mlm.detach().numpy(), np.asarray(rmlm),
                               atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="exceed"):
        SparseAttentionUtils.extend_position_embedding(state2, 100)


def test_pad_and_unpad_match_jax():
    ids = np.arange(2 * 37, dtype=np.int32).reshape(2, 37)
    ones = np.ones_like(ids)
    ref = JaxUtils.pad_to_block_size(16, jnp.asarray(ids), jnp.asarray(ones),
                                     jnp.asarray(ones), None, None, 0)
    got = SparseAttentionUtils.pad_to_block_size(
        16, torch.from_numpy(ids), torch.from_numpy(ones),
        torch.from_numpy(ones), None, None, 0)
    assert got[0] == ref[0] == 11
    for a, b in zip(got[1:4], ref[1:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[4] is None and got[5] is None
    out = torch.zeros(2, 48, 8)
    assert SparseAttentionUtils.unpad_sequence_output(11, out).shape == (
        2, 37, 8)


def test_pretrain_loss_matches_jax():
    rs = np.random.RandomState(3)
    mlm = rs.standard_normal((2, 16, 96)).astype(np.float32)
    nsp = rs.standard_normal((2, 2)).astype(np.float32)
    labels = np.where(rs.rand(2, 16) < 0.3, rs.randint(0, 96, (2, 16)), -1)
    nsp_labels = np.array([0, 1])
    ref = jax_bert_loss(jnp.asarray(mlm), jnp.asarray(nsp),
                        jnp.asarray(labels), jnp.asarray(nsp_labels))
    got = bert_pretrain_loss(torch.from_numpy(mlm), torch.from_numpy(nsp),
                             torch.from_numpy(labels),
                             torch.from_numpy(nsp_labels))
    assert abs(float(got) - float(ref)) <= 1e-6
    none = np.full((2, 16), -1)
    assert np.isfinite(float(bert_pretrain_loss(
        torch.from_numpy(mlm), torch.from_numpy(nsp),
        torch.from_numpy(none), torch.from_numpy(nsp_labels))))


def test_later_slice_options_raise():
    _, pcfg = configs(False)
    with pytest.raises(NotImplementedError, match="residual-dropout"):
        BertForPreTraining(dataclasses.replace(pcfg, dropout_rate=0.1))
    with pytest.raises(NotImplementedError, match="remat"):
        BertForPreTraining(dataclasses.replace(pcfg, remat="offload"))
    with pytest.raises(ValueError, match="activation"):
        BertForPreTraining(dataclasses.replace(pcfg, activation="tanh"))
