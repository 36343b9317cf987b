"""The engine's precision modes against the JAX engine on the CPU: fp16
with dynamic loss scaling, and bf16 gradient accumulation with Adam and
LAMB, in both calling conventions (``train_batch``; ``forward`` /
``backward`` / ``step``), on a 2-layer d_model 128 GPT from the same
weights (``params_from_jax``) and the same numpy batches.

fp16: the model computes in fp16 (fp32 masters), FusedAdam, dynamic
scale from 2**16 with hysteresis 2 and a window of 2 steps, so a run
grows the scale, spends hysteresis and shrinks it, and gradient clipping
at 0.5, below every step's norm (0.74-0.92), so the unscaled norm decides
each step's clip. Two steps of each convention are poisoned (the loss
times 1e6 through a keyword operand of both engines), so their fp16
gradients overflow: the scale, the skip count and the optimizer's step
count must equal JAX's exactly after every step (the finite flags are
the same decisions). Each taken step's global grad norm (of the unscaled
gradients) within 1e-3 relative of JAX's (readings <= 1.6e-4: two fp16
evaluations); losses within 1e-3 (readings <= 4e-5). Parameters: the
mean absolute gap to JAX's within 0.02 of the mean absolute move of
JAX's run (readings 0.0039); the largest gap is no measure, as Adam
moves an element whose fp16 gradient is near 0 by a full lr of either
sign (readings 1.5 x the largest move), so it is held only to 2 lr a
taken step. Planted faults fail: without the unscale the norms read
~6e4, with the unscale after the norm the clip shrinks every step (mean
gap 0.76 of the move). A skipped step leaves the optimizer's moments
and count untouched (checked against a copy). An fp16 checkpoint saved
mid-run and resumed through ``latest`` repeats the uninterrupted run's
losses and scale bit for bit.

bf16 accumulation: an fp32 model, gradients cast to bf16 and summed in
bf16 buffers (``.grad`` stays None; the buffers keep their storage);
losses within 1e-4, the grad norm within 1e-2 relative (a bf16 buffer
rounds at ~4e-3, and a gradient the two frameworks compute 1e-7 apart may
round to neighbouring bf16 values), parameters within 2 lr a step. No
clipping: optax clips bf16 gradients in bf16 arithmetic, the fused
kernels clip the widened fp32 values (``ROADMAP.md`` Queue 3). At gas 2
and dropout off the two conventions are bit-equal in the port (dividing
by 2 before or after the gradient is exact).
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import GPT, GPTConfig, gpt_loss_fn
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import update_scale

from tests.test_torch_model import TINY, jax_gpt
from tests.test_torch_training import SEQ, _batch, _jax_loss, _tree_np

LR = 1e-3
POISON = 1e6
CLIP = 0.5          # below every fp16 step's grad norm
FP16 = {"enabled": True, "loss_scale": 0, "initial_scale_power": 16,
        "loss_scale_window": 2, "hysteresis": 2, "min_loss_scale": 1.0}
# (batch seed, poisoned?) of each step
TRAIN_STEPS = [(0, False), (1, True), (2, False), (3, False), (4, True),
               (5, True)]
SPLIT_STEPS = [(6, False), (7, True), (8, True), (9, False)]


def _config(micro, opt="FusedAdam", fp16=None, accum=None, clip=0.0):
    params = {"lr": LR, "weight_decay": 0.01}
    if opt == "FusedAdam":
        params["betas"] = [0.9, 0.95]
    cfg = {"train_batch_size": 16, "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": opt, "params": params},
           "gradient_clipping": clip, "steps_per_print": 10_000}
    if fp16:
        cfg["fp16"] = fp16
    if accum:
        cfg["data_types"] = {"grad_accum_dtype": accum}
    return cfg


def _jax_poisoned(model, params, batch, rng, train, boost=1.0):
    return boost * _jax_loss(model, params, batch, rng, train)


def _port_poisoned(model, batch, rng, train, boost=1.0):
    ids = batch["input_ids"].long()
    return boost * gpt_loss_fn(model(ids, dropout_seed=rng)[:, :-1],
                               ids[:, 1:])


def _micro(batch, g, rows=8):
    return {k: v[g * rows:(g + 1) * rows] for k, v in batch.items()}


def _drive(engine, steps, split, read):
    """Run ``steps`` in one convention; ``read(engine)`` after each."""
    out = []
    for seed, poisoned in steps:
        batch, kw = _batch(seed), {"boost": POISON if poisoned else 1.0}
        if split:
            losses = []
            for g in range(2):
                loss = engine.forward(_micro(batch, g), **kw)
                engine.backward(loss)
                losses.append(float(getattr(loss, "detach", lambda: loss)()))
            engine.step()
            loss = sum(losses) / 2
        else:
            loss = float(engine.train_batch(batch, **kw))
        out.append((loss / kw["boost"], *read(engine)))
    return out


def _jax_engine(model, config, loss_fn=_jax_poisoned):
    jeng, *_ = jds.initialize(
        model=model, config=config, loss_fn=loss_fn,
        sample_batch={"input_ids": np.zeros((1, SEQ), np.int32)},
        rng=jax.random.PRNGKey(0))
    return jeng


def _port_engine(tree, dtype, config, seed=42):
    cfg = GPTConfig(**TINY, dtype=dtype)
    engine, *_ = ds.initialize(
        model=GPT(cfg), model_parameters=params_from_jax(tree, cfg),
        config=config, loss_fn=_port_poisoned, seed=seed, device="cpu")
    return engine


def _param_gap(engine, tree):
    want = params_from_jax(tree, engine.module.config)
    return max((want[k] - v).abs().max().item()
               for k, v in engine.module.state_dict().items())


def _mean_gap_of_move(engine, tree, init):
    """The mean absolute gap of the engine's parameters to ``tree``, over
    the mean absolute move of ``tree`` from ``init``."""
    want = params_from_jax(tree, engine.module.config)
    start = params_from_jax(init, engine.module.config)
    got = engine.module.state_dict()
    gap = torch.cat([(want[k] - got[k]).abs().flatten() for k in want])
    move = torch.cat([(want[k] - start[k]).abs().flatten() for k in want])
    return (gap.mean() / move.mean()).item()


@pytest.fixture(scope="module")
def fp16_jax():
    """The JAX fp16 engine: 6 train_batch steps, then 4 split steps."""
    import jax.numpy as jnp
    jm, _ = jax_gpt()
    jm = type(jm)(jm.config.__class__(**{**jm.config.__dict__,
                                         "dtype": jnp.float16}))
    jeng = _jax_engine(jm, _config(1, fp16=FP16, clip=CLIP))
    init = _tree_np(jeng.params)
    read = lambda e: (*_jax_read(e), e.get_global_grad_norm())  # noqa: E731
    train = _drive(jeng, TRAIN_STEPS, False, read)
    after_train = _tree_np(jeng.params)
    split = _drive(jeng, SPLIT_STEPS, True, read)
    return {"init": init, "train": train, "split": split,
            "after_train": after_train, "final": _tree_np(jeng.params)}


def _jax_read(jeng):
    count = int(np.asarray(_count(jeng.optimizer_state)))
    return jeng.get_loss_scale(), jeng.skipped_steps, count


def _count(state):
    """The fused Adam state's step count inside optax's chain."""
    for leaf in jax.tree_util.tree_leaves_with_path(state):
        if "count" in jax.tree_util.keystr(leaf[0]):
            return leaf[1]
    raise AssertionError("no count in the optimizer state")


def _port_read(engine):
    return (engine.get_loss_scale(), engine.skipped_steps,
            engine.optimizer_state.count)


def test_fp16_engine_matches_the_jax_engine_in_both_conventions(fp16_jax):
    eng = _port_engine(fp16_jax["init"], torch.float16,
                       _config(8, fp16=FP16, clip=CLIP))
    read = lambda e: (*_port_read(e), e.get_global_grad_norm())  # noqa: E731
    train = _drive(eng, TRAIN_STEPS, False, read)
    gap_train = _param_gap(eng, fp16_jax["after_train"])
    mean_train = _mean_gap_of_move(eng, fp16_jax["after_train"],
                                   fp16_jax["init"])
    split = _drive(eng, SPLIT_STEPS, True, read)
    taken_norms = []
    for got, want in zip(train + split, fp16_jax["train"] + fp16_jax["split"]):
        assert got[1:4] == want[1:4], (got, want)   # scale, skips, count
        assert abs(got[0] - want[0]) <= 1e-3, (got, want)
        if np.isfinite(want[4]):                      # a step taken
            assert abs(got[4] - want[4]) <= 1e-3 * want[4], (got, want)
            taken_norms.append(want[4])
    skipped = train[-1][2] + (split[-1][2] - train[-1][2])
    assert skipped == 5 and eng.global_steps == 10
    scales = {r[1] for r in train + split}
    assert len(scales) >= 3               # it grew and shrank
    taken = len(TRAIN_STEPS + SPLIT_STEPS) - skipped
    assert len(taken_norms) == taken and min(taken_norms) > CLIP
    assert gap_train <= 2 * LR * taken
    assert _param_gap(eng, fp16_jax["final"]) <= 2 * LR * taken
    assert mean_train <= 0.02, mean_train
    mean_final = _mean_gap_of_move(eng, fp16_jax["final"], fp16_jax["init"])
    assert mean_final <= 0.02, mean_final


def test_fp16_skipped_step_keeps_the_optimizer_state():
    jm, params = jax_gpt()
    eng = _port_engine(_tree_np({"params": params}), torch.float16,
                       _config(8, fp16=dict(FP16, hysteresis=1)))
    eng.train_batch(_batch(0))
    before = copy.deepcopy((eng.optimizer_state.count,
                            [m.clone() for m in eng.optimizer_state.exp_avg],
                            [p.detach().clone() for p in eng._params]))
    scale = eng.get_loss_scale()
    eng.train_batch(_batch(1), boost=POISON)
    assert eng.skipped_steps == 1 and eng.global_steps == 2
    assert eng.optimizer_state.count == before[0] == 1
    assert all(torch.equal(a, b) for a, b in zip(
        eng.optimizer_state.exp_avg, before[1]))
    assert all(torch.equal(a, b) for a, b in zip(eng._params, before[2]))
    assert eng.get_loss_scale() == scale / 2          # hysteresis 1
    # a finite gradient whose square overflows fp32 is no overflow
    assert update_scale(eng.loss_scale_state, torch.tensor(True)).scale \
        == eng.loss_scale_state.scale


def test_fp16_checkpoint_resumes_bit_for_bit(tmp_path):
    jm, params = jax_gpt()
    tree = _tree_np({"params": params})
    cfg = _config(8, fp16=FP16)
    steps = [(0, False), (1, True), (2, False), (3, False), (4, False)]
    a = _port_engine(tree, torch.float16, cfg)
    want = _drive(a, steps, False, _port_read)
    b = _port_engine(tree, torch.float16, cfg)
    _drive(b, steps[:3], False, _port_read)
    b.save_checkpoint(str(tmp_path))
    c = _port_engine(tree, torch.float16, cfg)
    path, _ = c.load_checkpoint(str(tmp_path))
    assert path is not None and c.skipped_steps == 1
    assert c.get_loss_scale() == want[2][1]
    got = _drive(c, steps[3:], False, _port_read)
    assert got == want[3:]
    assert all(torch.equal(x, y) for x, y in zip(a._params, c._params))
    saved = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert set(saved["loss_scale"]) == {"scale", "growth_tracker",
                                        "overflows", "hysteresis_left"}


@pytest.fixture(scope="module", params=["FusedAdam", "FusedLamb"])
def bf16_jax(request):
    """The JAX engine with bf16 accumulation: 2 train_batch steps, then 2
    split steps."""
    jm, _ = jax_gpt()
    jeng = _jax_engine(jm, _config(1, request.param, accum="bf16"))
    init = _tree_np(jeng.params)
    read = lambda e: (e.get_global_grad_norm(),)     # noqa: E731
    train = _drive(jeng, [(0, False), (1, False)], False, read)
    after_train = _tree_np(jeng.params)
    split = _drive(jeng, [(2, False), (3, False)], True, read)
    return {"opt": request.param, "init": init, "train": train,
            "split": split, "after_train": after_train,
            "final": _tree_np(jeng.params)}


def test_bf16_accumulation_matches_the_jax_engine(bf16_jax):
    eng = _port_engine(bf16_jax["init"], torch.float32,
                       _config(8, bf16_jax["opt"], accum="bf16"))
    assert all(g.dtype == torch.bfloat16 for g in eng._grads)
    assert all(p.grad is None for p in eng._params)
    ptrs = [g.data_ptr() for g in eng._grads]
    read = lambda e: (e.get_global_grad_norm(),)     # noqa: E731
    train = _drive(eng, [(0, False), (1, False)], False, read)
    assert _param_gap(eng, bf16_jax["after_train"]) <= 2 * LR * 2
    split = _drive(eng, [(2, False), (3, False)], True, read)
    for got, want in zip(train + split, bf16_jax["train"] + bf16_jax["split"]):
        assert abs(got[0] - want[0]) <= 1e-4, (got, want)
        assert abs(got[1] - want[1]) <= 1e-2 * want[1], (got, want)
    assert _param_gap(eng, bf16_jax["final"]) <= 2 * LR * 4
    assert [g.data_ptr() for g in eng._grads] == ptrs
    assert all(p.grad is None for p in eng._params)


@pytest.mark.parametrize("opt", ["FusedAdam", "FusedLamb"])
def test_bf16_accumulation_conventions_are_bit_equal_at_gas_2(opt):
    jm, params = jax_gpt()
    tree = _tree_np({"params": params})
    runs = []
    for split in (False, True):
        eng = _port_engine(tree, torch.float32,
                           _config(8, opt, accum="bf16"))
        _drive(eng, [(0, False), (1, False)], split, lambda e: ())
        runs.append([p.detach().clone() for p in eng._params])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
