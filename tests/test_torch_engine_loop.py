"""The engine's own training loop (``loss = engine(batch);
engine.backward(loss); engine.step()``), ``train_batch``/``eval_batch``
with keyword operands, and the Adagrad and SGD optimizers, against the
JAX package.

One JAX engine (module fixture) runs 3 steps of forward/backward/step at
gas 2, then 2 ``train_batch`` steps and an ``eval_batch`` with a keyword
operand; the port replays them from the same weights (``params_from_jax``).
Tolerances, as ``tests/test_torch_training.py``'s engine test: every
microbatch loss within 1e-4 and the grad norm within 1e-4 relative (two
fp32 evaluations of a 2-layer model); parameters within 2 lr a step
(Adam moves a parameter by about lr a step whatever its gradient's size,
so a gradient near 0 whose sign differs between two fp32 summation
orders moves it by up to 2 lr); the eval loss after 5 steps within 1e-3
(those parameter gaps, through the model). Against the port's own
``train_batch`` the split convention is bit-equal with dropout off at gas
2 (the same operations in the same order: ``grad(loss / 2)`` summed into
the same buffers). Adagrad and SGD against optax: atol 1e-6 (the same
fp32 formula; the schedule on the host in float64 against JAX's fp32).
"""

import numpy as np
import optax
import pytest
import jax
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.runtime import lr_schedules as jax_sched
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import GPT, GPTConfig
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.dropout import fold_seed, seed_words
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.optimizers import (SGD, Adagrad,
                                                    build_optimizer)

from tests.test_torch_model import TINY, jax_gpt
from tests.test_torch_training import (SEQ, WARMUP, _batch, _close,
                                       _engine_config, _jax_loss, _port_loss,
                                       _run_jax, _run_port, _tree_np)

LR = 1e-3            # _engine_config's peak learning rate
WEIGHT = 0.5         # the keyword operand of train_batch and eval_batch


def _jax_weighted(model, params, batch, rng, train, weight=1.0):
    return weight * _jax_loss(model, params, batch, rng, train)


def _port_weighted(model, batch, rng, train, weight=1.0):
    return weight * _port_loss(model, batch, rng, train)


def _micro(batch, g, rows=8):
    return {k: v[g * rows:(g + 1) * rows] for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's trajectory: 3 forward/backward/step steps, then 2
    train_batch steps and one eval_batch with weight=0.5."""
    jm, _ = jax_gpt()
    jeng, *_ = jds.initialize(
        model=jm, config=_engine_config(1), loss_fn=_jax_weighted,
        sample_batch={"input_ids": np.zeros((1, SEQ), np.int32)},
        rng=jax.random.PRNGKey(0))
    rec = {"init": _tree_np(jeng.params), "split": [], "norms": []}
    for s in range(3):
        batch = _batch(s)
        for g in range(2):
            loss = jeng.forward(_micro(batch, g))
            jeng.backward(loss)
            rec["split"].append(float(loss))
        jeng.step()
        rec["norms"].append(jeng.get_global_grad_norm())
    rec["counts"] = (jeng.global_steps, jeng.micro_steps,
                     jeng.global_samples)
    rec["after_split"] = _tree_np(jeng.params)
    rec["train"] = [float(jeng.train_batch(_batch(s), weight=WEIGHT))
                    for s in (3, 4)]
    rec["final"] = _tree_np(jeng.params)
    rec["eval"] = float(jeng.eval_batch(_batch(5), weight=WEIGHT))
    return rec


def _port_engine(state_dict, opt="FusedAdam", rate=0.0, seed=42):
    cfg = GPTConfig(**TINY, dtype=torch.float32, attn_dropout_rate=rate)
    config = _engine_config(8)
    config["optimizer"] = {"type": opt, "params": {
        **config["optimizer"]["params"], "momentum": 0.9}}
    if opt != "FusedAdam":
        config["optimizer"]["params"].pop("betas")
    engine, *_ = ds.initialize(model=GPT(cfg, seed=3),
                               model_parameters=state_dict, config=config,
                               loss_fn=_port_weighted, seed=seed,
                               device="cpu")
    return engine


def _split_steps(engine, steps=range(3)):
    losses, norms = [], []
    for s in steps:
        batch = _batch(s)
        for g in range(2):
            loss = engine(_micro(batch, g))
            engine.backward(loss)
            losses.append(loss.detach())
        engine.step()
        norms.append(engine.get_global_grad_norm())
    return losses, norms


def _param_gap(engine, tree):
    want = params_from_jax(tree, engine.module.config)
    return max((want[k] - v).abs().max().item()
               for k, v in engine.module.state_dict().items())


def test_split_convention_matches_the_jax_engine(jax_run):
    cfg = GPTConfig(**TINY, dtype=torch.float32)
    eng = _port_engine(params_from_jax(jax_run["init"], cfg))
    losses, norms = _split_steps(eng)
    for i, (a, b) in enumerate(zip(losses, jax_run["split"])):
        assert a.shape == () and abs(float(a) - b) <= 1e-4, i
    np.testing.assert_allclose(norms, jax_run["norms"], rtol=1e-4)
    assert (eng.global_steps, eng.micro_steps, eng.global_samples) == \
        jax_run["counts"] == (3, 6, 48)
    assert _param_gap(eng, jax_run["after_split"]) <= 2 * LR * 3


def test_train_batch_and_eval_batch_take_loss_kwargs_as_jax(jax_run):
    cfg = GPTConfig(**TINY, dtype=torch.float32)
    eng = _port_engine(params_from_jax(jax_run["init"], cfg))
    _split_steps(eng)
    for s, ref in zip((3, 4), jax_run["train"]):
        assert abs(float(eng.train_batch(_batch(s), weight=WEIGHT)) - ref) \
            <= 1e-4, s
    assert _param_gap(eng, jax_run["final"]) <= 2 * LR * 5
    assert eng.global_steps == 5 and eng.micro_steps == 10
    out = eng.eval_batch(_batch(5), weight=WEIGHT)
    assert abs(float(out) - jax_run["eval"]) <= 1e-3
    plain = eng.eval_batch(_batch(5))
    assert float(out) == pytest.approx(WEIGHT * float(plain), rel=1e-6)


@pytest.mark.parametrize("opt", ["FusedAdam", "FusedLamb", "Adagrad",
                                 "SGD"])
def test_split_convention_is_bit_equal_to_train_batch(opt):
    base = GPT(GPTConfig(**TINY, dtype=torch.float32)).state_dict()
    fused, split = _port_engine(base, opt), _port_engine(base, opt)
    means = []
    for s in range(3):
        batch = _batch(s)
        ref = fused.train_batch(batch)
        total = torch.zeros(())
        for g in range(2):
            loss = split(_micro(batch, g))
            split.backward(loss)
            split.step()
            total += loss.detach()
        means.append((ref, total / 2))
        assert split.get_global_grad_norm() == fused.get_global_grad_norm()
    assert all(torch.equal(a, b) for a, b in means)
    for (name, a), b in zip(fused.module.named_parameters(),
                            split.module.parameters()):
        assert torch.equal(a, b), name
    opt_a, opt_b = fused.optimizer_state, split.optimizer_state
    assert opt_a.count == opt_b.count == 3
    for slot in opt_a.SLOTS:
        assert all(torch.equal(a, b) for a, b in zip(
            getattr(opt_a, slot), getattr(opt_b, slot))), slot
    assert (fused.global_steps, fused.micro_steps, fused.global_samples) \
        == (split.global_steps, split.micro_steps, split.global_samples)


def test_call_is_forward_and_seeds_follow_micro_steps():
    """engine(batch) is engine.forward(batch); with dropout on, forward's
    seed words are fold_seed(seed, micro_steps + 1) (JAX :1337), so
    calling it twice without a backward draws the same bits, and the
    convention's losses differ from train_batch's by design."""
    base = GPT(GPTConfig(**TINY, dtype=torch.float32)).state_dict()
    eng = _port_engine(base, rate=0.2, seed=7)
    mb = _micro(_batch(0), 0)
    a, b = eng(mb), eng.forward(mb)
    assert torch.equal(a, b)
    want = _port_weighted(eng.module,
                          {"input_ids": torch.from_numpy(mb["input_ids"])},
                          fold_seed(seed_words(7), 1), True)
    assert torch.equal(a, want)
    eng.backward(a)
    assert eng.micro_steps == 1
    c = eng(_micro(_batch(0), 0))
    assert not torch.equal(a, c)          # micro step 2's words
    other = _port_engine(base, rate=0.2, seed=7)
    assert float(other.train_batch(_batch(0))) != float((a + c).detach() / 2)


def test_backward_needs_a_forward_and_step_waits_for_the_boundary():
    base = GPT(GPTConfig(**TINY, dtype=torch.float32)).state_dict()
    eng = _port_engine(base)
    with pytest.raises(RuntimeError, match="without a preceding forward"):
        eng.backward()
    before = [p.detach().clone() for p in eng.module.parameters()]
    eng.backward(eng(_micro(_batch(0), 0)))
    with pytest.raises(RuntimeError, match="without a preceding forward"):
        eng.backward()                    # the loss was consumed
    assert not eng.is_gradient_accumulation_boundary()
    eng.step()                            # before the boundary: nothing
    assert all(torch.equal(a, b) for a, b in
               zip(before, eng.module.parameters()))
    assert (eng.global_steps, eng.global_samples,
            eng.optimizer_state.count) == (0, 0, 0)
    with pytest.raises(RuntimeError, match="open forward"):
        eng.train_batch(_batch(0))
    eng.backward(eng(_micro(_batch(0), 1)))
    assert eng.is_gradient_accumulation_boundary()
    eng.step()
    assert (eng.global_steps, eng.global_samples,
            eng.optimizer_state.count) == (1, 16, 1)
    assert not eng.is_gradient_accumulation_boundary()
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, eng.module.parameters()))


def test_the_first_backward_after_a_step_zeroes_the_buffers():
    """After a step the next backward starts a new window: the buffers
    then hold that microbatch's gradient / gas alone, in the buffers the
    optimizer's table was built over."""
    base = GPT(GPTConfig(**TINY, dtype=torch.float32)).state_dict()
    eng = _port_engine(base)
    ptrs = [g.data_ptr() for g in eng._grads]
    _split_steps(eng, steps=[0])
    mb = _micro(_batch(1), 0)
    eng.backward(eng(mb))
    got = [g.clone() for g in eng._grads]
    loss = _port_weighted(eng.module,
                          {"input_ids": torch.from_numpy(mb["input_ids"])},
                          None, True)
    want = torch.autograd.grad(loss / 2, eng._params)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    assert [g.data_ptr() for g in eng._grads] == ptrs
    assert all(p.grad is g for p, g in zip(eng._params, eng._grads))


# --------------------------------------------------------------------------
# Adagrad and SGD
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,params,ref", [
    ("Adagrad", {}, lambda lr: optax.adagrad(lr, eps=1e-10)),
    ("Adagrad", {"eps": 1e-6}, lambda lr: optax.adagrad(lr, eps=1e-6)),
    ("SGD", {}, lambda lr: optax.sgd(lr, momentum=0.0)),
    ("SGD", {"momentum": 0.9}, lambda lr: optax.sgd(lr, momentum=0.9)),
    ("SGD", {"momentum": 0.9, "nesterov": True},
     lambda lr: optax.sgd(lr, momentum=0.9, nesterov=True)),
])
@pytest.mark.parametrize("clip", [None, 0.01, 100.0])
def test_adagrad_and_sgd_match_optax(name, params, ref, clip):
    """With a warmup schedule (optax's index: the learning rate of step t
    is schedule(t - 1)) and, when ``clip`` is set, the gradients scaled so
    their global norm lies far below (100) or far above (0.01) the
    threshold 1 of ``clip_by_global_norm`` chained before the update, as
    the JAX engine chains it (engine.py:603-607)."""
    tx = ref(jax_sched.warmup_lr(**WARMUP))
    opt = build_optimizer(name, params, lr_schedules.warmup_lr(**WARMUP))
    assert isinstance(opt, Adagrad if name == "Adagrad" else SGD)
    assert not opt.one_based
    if clip is None:
        _close(_run_port(opt), _run_jax(tx))
        return
    scaled = optax.chain(optax.scale(clip), optax.chain(
        optax.clip_by_global_norm(1.0), tx))
    _close(_run_port(opt, grad_norm=clip, max_norm=1.0), _run_jax(scaled))


def test_adagrad_accumulator_starts_at_0_1_and_sgd_keeps_a_trace():
    p = [torch.ones(3)]
    g = [torch.full((3,), 2.0)]
    ada = Adagrad(0.5)
    state = ada.init(p, g)
    assert state.SLOTS == ("sum_of_squares",)
    assert torch.equal(state.sum_of_squares[0], torch.full((3,), 0.1))
    ada.step(state)
    np.testing.assert_allclose(state.sum_of_squares[0].numpy(), 4.1,
                               rtol=1e-6)
    np.testing.assert_allclose(p[0].numpy(), 1 - 0.5 * 2 / np.sqrt(4.1),
                               rtol=1e-6)
    sgd = SGD(0.5)                      # momentum 0 still keeps a trace
    p = [torch.ones(3)]
    state = sgd.init(p, g)
    assert state.SLOTS == ("trace",)
    sgd.step(state)
    assert torch.equal(state.trace[0], g[0])
    assert torch.equal(p[0], torch.zeros(3))


def test_engine_trains_with_adagrad_and_sgd_from_the_config():
    base = GPT(GPTConfig(**TINY, dtype=torch.float32)).state_dict()
    for opt, slot in (("Adagrad", "sum_of_squares"), ("SGD", "trace")):
        eng = _port_engine(base, opt)
        assert type(eng.optimizer).__name__ == opt
        losses = [float(eng.train_batch(_batch(0))) for _ in range(3)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], opt
        assert eng.optimizer_state.count == 3
        assert len(getattr(eng.optimizer_state, slot)) == len(eng._params)
