"""The port's LAMB (``FusedLamb`` and ``Lamb``) against the JAX package's.

The plain version of the fused LAMB kernels (what a CPU state runs) is
held against JAX ``fused_lamb`` (Pallas in interpret mode) and
``optax.lamb``, both behind optax's ``clip_by_global_norm`` as the JAX
engine chains it, on the same numpy parameters and gradients; then the
port's engine on a tiny block-sparse BERT against the JAX engine.
Tolerances:

- optimizer steps: atol 1e-6 on parameters of magnitude ~1 after 3 steps
  (the same fp32 formula; the norms of the trust ratio are summed in other
  orders, and optax divides by 1 - b^t where the kernels multiply by its
  fp32 reciprocal);
- engine: every step's loss within 1e-4 and the global grad norm within
  1e-4 relative (two fp32 evaluations of a 2-layer model); each final
  parameter tensor within 0.04 of the sum of its largest step per step
  (``PARAM_TOL``): the sound port reads at most 0.0226 of it, a trust
  ratio 2% too large 0.0492 and 10% too large 0.2069.
"""

import dataclasses

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.core import meta, unfreeze

import deepspeed_tpu as jds
import deepspeed_tpu_torch as ds
from deepspeed_tpu.models.bert import BertConfig as JaxBertConfig
from deepspeed_tpu.models.bert import BertForPreTraining as JaxBert
from deepspeed_tpu.models.bert import bert_pretrain_loss as jax_bert_loss
from deepspeed_tpu.ops.pallas.fused_lamb import fused_lamb as jax_fused_lamb
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.models import (BertConfig, BertForPreTraining,
                                        bert_pretrain_loss)
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops import fused_lamb
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as psc
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.optimizers import (Adam, Lamb,
                                                    build_optimizer)
from tests.torch_threads import share_cores

share_cores()

SHAPES = [(3,), (17, 5), (128,), (4, 33), (7,), (300,)]
ZERO = 4            # the tensor that starts at 0 (trust ratio 1)
WARMUP = {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2,
          "warmup_num_steps": 3}
STEPS = 3


def _tree(seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _params():
    p = _tree(0)
    p[ZERO][:] = 0.0
    return p


def _grads(step, scale):
    return [g * scale for g in _tree(100 + step)]


def _run_jax(tx, scale):
    params = [jnp.asarray(p) for p in _params()]
    state = tx.init(params)
    for t in range(STEPS):
        updates, state = tx.update([jnp.asarray(g) for g in
                                    _grads(t, scale)], state, params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


def _run_port(opt, scale, max_norm=1.0):
    params = [torch.from_numpy(p) for p in _params()]
    grads = [torch.zeros_like(p) for p in params]
    state = opt.init(params, grads)
    for t in range(STEPS):
        for g, new in zip(grads, _grads(t, scale)):
            g.copy_(torch.from_numpy(new))
        norm = torch.linalg.vector_norm(torch.stack([g.norm()
                                                     for g in grads]))
        opt.step(state, norm, max_norm)
    assert state.count == STEPS
    return [p.numpy() for p in params]


def _close(port, ref, atol=1e-6):
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _clipped(tx):
    return optax.chain(optax.clip_by_global_norm(1.0), tx)


@pytest.mark.parametrize("scale", [0.01, 100.0], ids=["noclip", "clip"])
def test_fused_lamb_matches_jax_fused_lamb_and_optax(scale):
    """FusedLamb against the JAX Pallas ``fused_lamb`` (interpret) and
    Lamb against ``optax.lamb``, WarmupLR, weight decay on every tensor,
    a zero tensor; grads scaled far below and far above the clip."""
    jsched = jax_sched.warmup_lr(**WARMUP)
    sched = lr_schedules.warmup_lr(**WARMUP)
    params = {"betas": [0.9, 0.99], "weight_decay": 0.01}
    ref = _run_jax(_clipped(jax_fused_lamb(jsched, b1=0.9, b2=0.99,
                                           eps=1e-6, weight_decay=0.01)),
                   scale)
    _close(_run_port(build_optimizer("FusedLamb", params, sched), scale),
           ref)
    ref = _run_jax(_clipped(optax.lamb(jsched, b1=0.9, b2=0.99, eps=1e-8,
                                       weight_decay=0.01)), scale)
    _close(_run_port(build_optimizer("Lamb", params, sched), scale), ref)


def test_lamb_flavours_index_the_schedule_and_default_eps_apart():
    """FusedLamb takes schedule(t) at step t and eps 1e-6 (the JAX
    registry's fused_lamb); Lamb takes schedule(t - 1) and eps 1e-8
    (optax.lamb through _adam_args). Swapping the index fails the parity
    above by far more than its tolerance."""
    sched = lr_schedules.warmup_lr(**WARMUP)
    fused, plain = (build_optimizer(k, {}, sched) for k in ("FusedLamb",
                                                             "Lamb"))
    assert (fused.eps, fused.one_based) == (1e-6, True)
    assert (plain.eps, plain.one_based) == (1e-8, False)
    assert fused.lr_at(1) == sched(1) and plain.lr_at(1) == sched(0)
    assert build_optimizer("Fused_Lamb", {"eps": 1e-7}).eps == 1e-7
    swapped = build_optimizer("Lamb", {"eps": 1e-6}, sched)
    ref = _run_jax(_clipped(jax_fused_lamb(jax_sched.warmup_lr(**WARMUP))),
                   100.0)
    assert max(np.abs(a - b).max() for a, b in zip(
        _run_port(swapped, 100.0), ref)) > 1e-3


def test_plain_step_keeps_state_on_the_tensors_device():
    """The plain version reads nothing back to the host: the trust ratio
    and the clip stay tensors."""
    opt = Lamb(1e-3, weight_decay=0.01)
    p = [torch.ones(5), torch.zeros(3)]
    g = [torch.full((5,), 2.0), torch.ones(3)]
    st = opt.init(p, g)
    before = (fused_lamb.phase1_launches, fused_lamb.apply_launches)
    opt.step(st, torch.tensor(10.0), 1.0)
    assert (fused_lamb.phase1_launches, fused_lamb.apply_launches) == before
    # p = 1: u = 1 + wd, trust = |p| / |u| -> p moves by lr exactly
    np.testing.assert_allclose(p[0].numpy(), 1.0 - 1e-3, rtol=1e-6)
    # p = 0: trust 1, and the clipped g = 0.1 gives u = 0.1 / (0.1 + eps),
    # up to the fp32 bias correction c2 = 1 / (1 - 0.999) (5e-5 off)
    np.testing.assert_allclose(p[1].numpy(), -1e-3 * 0.1 / (0.1 + 1e-6),
                               rtol=1e-4)


def test_config_and_registry_paths():
    d = {"train_batch_size": 8,
         "optimizer": {"type": "FusedLamb", "params": {"lr": 2e-3}},
         "sparse_attention": {"mode": "bigbird", "block": 64}}
    cfg = DeepSpeedConfig.from_dict(d)
    assert cfg.sparse_attention == JaxConfig.from_dict(d).sparse_attention
    model = BertForPreTraining(BertConfig(**TINY, dtype=torch.float32))
    eng, opt, _, _ = ds.initialize(model=model, config=d,
                                   loss_fn=_port_loss, device="cpu")
    assert isinstance(opt, Lamb) and opt.one_based
    client = Lamb(1e-3, one_based=False)
    eng, opt, _, _ = ds.initialize(model=model, config=d, optimizer=client,
                                   loss_fn=_port_loss, device="cpu")
    assert opt is client
    with pytest.raises(TypeError, match="Lamb"):
        ds.initialize(model=model, config=d, optimizer=object(),
                      loss_fn=_port_loss, device="cpu")
    assert isinstance(build_optimizer("FusedAdam", {}), Adam)


# --------------------------------------------------------------------------
# the engine on a tiny block-sparse BERT
# --------------------------------------------------------------------------

TINY = dict(vocab_size=96, max_seq_len=128, d_model=128, n_layers=2,
            n_heads=2)
SEQ = 128


def _engine_config(micro):
    return {"train_batch_size": 16, "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "FusedLamb",
                          "params": {"lr": 2e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 3,
                                     "warmup_max_lr": 2e-3}},
            "gradient_clipping": 1.0, "steps_per_print": 10_000}


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, TINY["vocab_size"], size=(16, SEQ)).astype(np.int32)
    types = (np.arange(SEQ) >= SEQ // 2).astype(np.int32)[None].repeat(16, 0)
    labels = np.where(rs.rand(16, SEQ) < 0.15, ids, -1).astype(np.int32)
    return {"input_ids": ids, "token_type_ids": types, "mlm_labels": labels,
            "nsp_labels": rs.randint(0, 2, size=16).astype(np.int32)}


def _jax_loss(model, params, batch, rng, train):
    mlm, nsp = model.apply(params, batch["input_ids"],
                           token_type_ids=batch["token_type_ids"],
                           deterministic=not train)
    return jax_bert_loss(mlm, nsp, batch["mlm_labels"], batch["nsp_labels"])


def _port_loss(model, batch, rng, train):
    mlm, nsp = model(batch["input_ids"].long(),
                     token_type_ids=batch["token_type_ids"].long(),
                     dropout_seed=rng)
    return bert_pretrain_loss(mlm, nsp, batch["mlm_labels"],
                              batch["nsp_labels"])


def _tree_np(params):
    return jax.tree.map(np.asarray, unfreeze(meta.unbox(params)))["params"]


PARAM_TOL = 0.04   # of a tensor's summed largest step per step


def test_engine_matches_the_jax_engine_for_5_steps():
    """FusedLamb, WarmupLR, clip 1.0, gas 2, fp32, BigBird-16 sparse
    attention, dropout off. The JAX engine shards each microbatch over the
    8-device test mesh: its global micro batch (1 x 8) is the port's
    train_micro_batch_size_per_gpu."""
    jcfg = JaxBertConfig(**TINY, dtype=jnp.float32,
                         sparsity_config=jsc.BigBirdSparsityConfig(
                             2, block=16))
    jeng, *_ = jds.initialize(
        model=JaxBert(jcfg), config=_engine_config(1), loss_fn=_jax_loss,
        sample_batch={"input_ids": np.zeros((1, SEQ), np.int32)},
        rng=jax.random.PRNGKey(0))
    pcfg = BertConfig(**TINY, dtype=torch.float32,
                      sparsity_config=psc.BigBirdSparsityConfig(2, block=16))
    eng, opt, _, _ = ds.initialize(
        model=BertForPreTraining(pcfg),
        model_parameters=params_from_jax(_tree_np(jeng.params), pcfg),
        config=_engine_config(8), loss_fn=_port_loss, device="cpu")
    assert isinstance(opt, Lamb)
    batch = _batch()
    prev = {k: v.clone() for k, v in eng.module.state_dict().items()}
    moves = {k: 0.0 for k in prev}
    for step in range(5):
        ref = float(jeng.train_batch(batch))
        loss = eng.train_batch(batch)
        assert abs(float(loss) - ref) <= 1e-4, step
        np.testing.assert_allclose(eng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4)
        now = eng.module.state_dict()
        for k in moves:
            moves[k] += (now[k] - prev[k]).abs().max().item()
            prev[k] = now[k].clone()
    assert eng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    final = params_from_jax(_tree_np(jeng.params), pcfg)
    for k, v in eng.module.state_dict().items():
        assert (final[k] - v).abs().max().item() <= PARAM_TOL * moves[k], k
