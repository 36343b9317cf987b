"""The port's training slice against the JAX package's.

Fused Adam, the optax Adam/AdamW flavours, clipping, the LR schedules,
the config and the engine run on the CPU (the kernels' plain versions) and
are held against the JAX package on the same numpy inputs (Pallas in
interpret mode). Tolerances:

- optimizer updates: atol 1e-6 on parameters of magnitude ~1 after 5 steps
  (the same fp32 formula; division by 1 - b^t on one side, product with
  its fp32 reciprocal on the other, a few ulps apart);
- LR schedules: rtol 1e-5 (host float64 against a few JAX fp32 roundings);
- engine: every step's loss within 1e-4 and the global grad norm within
  1e-4 relative of the JAX engine's (two fp32 evaluations of a 2-layer
  model); the final parameters within 2 lr per step: Adam moves a
  parameter by about lr a step whatever its gradient's size, so a
  gradient near 0 whose sign differs between two fp32 summation orders
  moves it by up to 2 lr.
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
from deepspeed_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from deepspeed_tpu.ops.pallas.fused_adam import fused_adamw
from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config_utils import DeepSpeedConfigError
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import GPT, GPTConfig, gpt_loss_fn
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops import flash_attention, flash_attention_bwd
from deepspeed_tpu_torch.ops import fused_adam
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.config_utils import (
    DeepSpeedConfigError as PortConfigError)
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.serving.engine import ServingEngine

from tests.test_torch_model import TINY, jax_gpt
from tests.torch_threads import share_cores

share_cores()

SHAPES = [(3,), (17, 5), (128,), (4, 33)]
WARMUP = {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2,
          "warmup_num_steps": 3}


def _tree(seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _grads(step):
    return _tree(100 + step)


def _run_jax(tx, steps=5):
    params = [jnp.asarray(p) for p in _tree(0)]
    state = tx.init(params)
    for t in range(steps):
        updates, state = tx.update([jnp.asarray(g) for g in _grads(t)],
                                   state, params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


def _run_port(opt, steps=5, grad_norm=None, max_norm=0.0):
    params = [torch.from_numpy(p) for p in _tree(0)]
    grads = [torch.zeros_like(p) for p in params]
    state = opt.init(params, grads)
    for t in range(steps):
        for g, new in zip(grads, _grads(t)):
            g.copy_(torch.from_numpy(new))
        norm = None
        if grad_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                [g.norm() for g in grads])) * grad_norm
            for g in grads:
                g.mul_(grad_norm)
        opt.step(state, norm, max_norm)
    assert state.count == steps
    return [p.numpy() for p in params]


def _close(port, ref, atol=1e-6):
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _max_diff(a, b):
    return max(np.abs(x - y).max() for x, y in zip(a, b))


def test_fused_adam_matches_jax_fused_adamw_with_warmup():
    jsched = jax_sched.warmup_lr(**WARMUP)
    ref = _run_jax(fused_adamw(jsched, b1=0.9, b2=0.95, eps=1e-8,
                               weight_decay=0.1))
    opt = build_optimizer("FusedAdam", {"betas": [0.9, 0.95],
                                        "weight_decay": 0.1},
                          lr_schedules.warmup_lr(**WARMUP))
    _close(_run_port(opt), ref)


def test_adamw_matches_optax_and_the_schedule_indices_differ():
    """FusedAdam takes schedule(t) at step t, optax schedule(t - 1): with
    a warmup the two trajectories differ by far more than the tolerance,
    so swapping the indices fails the parity below."""
    jsched = jax_sched.warmup_lr(**WARMUP)
    sched = lr_schedules.warmup_lr(**WARMUP)
    ref = _run_jax(optax.adamw(jsched, b1=0.9, b2=0.95, eps=1e-8,
                               weight_decay=0.1))
    params = {"betas": [0.9, 0.95], "weight_decay": 0.1}
    for kind in ("AdamW", "Adam"):
        _close(_run_port(build_optimizer(kind, params, sched)), ref)
    fused = _run_port(build_optimizer("FusedAdam", params, sched))
    assert _max_diff(fused, ref) > 1e-3


def test_adam_l2_mode_matches_optax_chain():
    """adam_w_mode false: L2 wd * p added to the grad before the step."""
    ref = _run_jax(optax.chain(optax.add_decayed_weights(0.05),
                               optax.adam(1e-2, b1=0.9, b2=0.999)))
    opt = build_optimizer("Adam", {"lr": 1e-2, "weight_decay": 0.05,
                                   "adam_w_mode": False})
    assert not opt.decoupled and not opt.one_based
    _close(_run_port(opt), ref)


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_clipping_is_optax_clip_by_global_norm(scale):
    """Both sides of the threshold: grads scaled so the norm is far below
    and far above max_norm = 1."""
    jsched = jax_sched.warmup_lr(**WARMUP)

    def scaled(tx):
        return optax.chain(optax.scale(scale), tx)

    ref = _run_jax(scaled(optax.chain(optax.clip_by_global_norm(1.0),
                                      fused_adamw(jsched, weight_decay=0.1))))
    opt = build_optimizer("FusedAdam", {"weight_decay": 0.1},
                          lr_schedules.warmup_lr(**WARMUP))
    _close(_run_port(opt, grad_norm=scale, max_norm=1.0), ref)


def test_later_optimizers_raise():
    for name in ("OneBitLamb", "OneBitAdam"):
        with pytest.raises(NotImplementedError, match="slice"):
            build_optimizer(name, {})
    # Adagrad and SGD build since the engine-loop slice
    for name in ("SGD", "Adagrad"):
        assert type(build_optimizer(name, {})).__name__ == name
    with pytest.raises(ValueError, match="Unknown"):
        build_optimizer("Nope", {})


@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3,
                     "lr_range_test_step_size": 4,
                     "lr_range_test_step_rate": 2.0,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 5, "cycle_second_step_size": 7,
                  "decay_step_size": 2, "decay_lr_rate": 0.5}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 8, "warmup_type": "log"}),
    ("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 8,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 18, "warmup_max_lr": 1e-3,
                       "warmup_num_steps": 6}),
])
def test_lr_schedules_match_jax(name, params):
    ref = jax_sched.get_lr_schedule(name, params)
    port = lr_schedules.get_lr_schedule(name, params)
    for step in range(21):
        assert isinstance(port(step), float)
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-5,
                                   atol=0, err_msg=f"step {step}")


@pytest.mark.parametrize("d", [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "gradient_accumulation_steps": 2},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 3},
    {"train_batch_size": 12},
    {"train_micro_batch_size_per_gpu": 5},
    {"gradient_accumulation_steps": 7},
    {},
])
def test_config_resolves_batch_sizes_as_jax(d):
    ref = JaxConfig.from_dict(d)
    ref.resolve_batch_sizes(1)
    cfg = DeepSpeedConfig.from_dict(d)
    assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
            cfg.gradient_accumulation_steps) == (
        ref.train_batch_size, ref.train_micro_batch_size_per_gpu,
        ref.gradient_accumulation_steps)


def test_config_reads_the_slice_blocks_and_rejects_bad_batches():
    d = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
         "optimizer": {"type": "FusedAdam", "params": {"lr": 6e-4}},
         "scheduler": {"type": "WarmupLR", "params": {}},
         "bf16": {"enabled": True}, "gradient_clipping": 1.0,
         "zero_optimization": {"stage": 1}, "fp16": {"enabled": False},
         "data_types": {"grad_accum_dtype": "fp32"}}
    cfg = DeepSpeedConfig.from_dict(d)
    assert cfg.optimizer.type == "FusedAdam" and cfg.bf16.enabled
    assert cfg.train_micro_batch_size_per_gpu == 8
    bad = {"train_batch_size": 10, "train_micro_batch_size_per_gpu": 3,
           "gradient_accumulation_steps": 2}
    with pytest.raises(DeepSpeedConfigError):
        JaxConfig.from_dict(bad).resolve_batch_sizes(1)
    with pytest.raises(PortConfigError, match="Batch arithmetic"):
        DeepSpeedConfig.from_dict(bad)


@pytest.mark.parametrize("block,match", [
    ({"activation_checkpointing": {"cpu_checkpointing": True}}, "offload"),
    ({"zero_optimization": {"stage": 2}}, "ZeRO"),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
     "offload"),
    ({"tiering": {"enabled": True}}, "tiering"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
    ({"mesh": {"expert": 2}}, "multi-GPU"),
    ({"resilience": {"enabled": True}}, "resilience"),
    ({"observability": {"enabled": True}}, "observability"),
    ({"compression_training": {"activation_quantization": {
        "shared_parameters": {"enabled": True}}}}, "compression"),
    ({"curriculum_learning": {"enabled": True}}, "data-efficiency"),
    ({"eigenvalue": {"enabled": True}}, "eigenvalue"),
    ({"activation_checkpointing": {"remat_policy": "offload"}}, "remat"),
    ({"flops_profiler": {"enabled": True}}, "observability"),
    ({"wall_clock_breakdown": True}, "timers"),
    ({"memory_breakdown": True}, "memory report"),
    ({"dump_state": True}, "observability"),
])
def test_config_later_slice_blocks_raise(block, match):
    with pytest.raises(NotImplementedError, match=match):
        DeepSpeedConfig.from_dict({"train_batch_size": 8, **block})


@pytest.mark.parametrize("block,match", [
    ({"steps_per_print": 5}, "no step log"),
    ({"prescale_gradients": True}, "reduces no gradients"),
    ({"zero_optimization": {"stage": 1, "overlap_comm": True}},
     "zero_optimization.overlap_comm"),
    ({"fp16": {"enabled": False, "loss_scale": 128.0}}, "fp16.loss_scale"),
    ({"checkpoint": {"tag_validation": "Warn"}}, "nothing reads it"),
])
def test_config_keys_without_effect_warn(block, match, caplog):
    with caplog.at_level("WARNING", logger="deepspeed_tpu_torch"):
        DeepSpeedConfig.from_dict({"train_batch_size": 8, **block})
    assert match in caplog.text


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

SEQ = 32


def _engine_config(micro):
    return {"train_batch_size": 16, "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "FusedAdam",
                          "params": {"lr": 1e-3, "betas": [0.9, 0.95],
                                     "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 3,
                                     "warmup_max_lr": 1e-3}},
            "gradient_clipping": 1.0, "steps_per_print": 10_000}


def _jax_loss(model, params, batch, rng, train):
    ids = batch["input_ids"]
    logits = model.apply(params, ids, deterministic=not train)
    return jax_gpt_loss_fn(logits[:, :-1], ids[:, 1:])


def _port_loss(model, batch, rng, train):
    ids = batch["input_ids"].long()
    logits = model(ids, dropout_seed=rng)
    return gpt_loss_fn(logits[:, :-1], ids[:, 1:])


def _batch(seed=0):
    return {"input_ids": np.random.RandomState(seed).randint(
        0, TINY["vocab_size"], size=(16, SEQ)).astype(np.int32)}


def _tree_np(params):
    return jax.tree.map(np.asarray, unfreeze(meta.unbox(params)))["params"]


def _port_engine(state_dict, attn_dropout=0.0, seed=42):
    cfg = GPTConfig(**TINY, dtype=torch.float32,
                    attn_dropout_rate=attn_dropout)
    engine, opt, loader, sched = ds.initialize(
        model=GPT(cfg), model_parameters=state_dict,
        config=_engine_config(8), loss_fn=_port_loss, seed=seed,
        device="cpu")
    assert opt is engine.optimizer and loader is None
    assert sched is engine.lr_schedule
    return engine


def test_engine_matches_the_jax_engine_for_5_steps():
    """FusedAdam, WarmupLR, clip 1.0, gas 2, fp32, dropout off. The JAX
    engine shards each microbatch over the 8-device test mesh: its global
    micro batch (1 x 8) is the port's train_micro_batch_size_per_gpu."""
    jm, _ = jax_gpt()
    jeng, *_ = jds.initialize(
        model=jm, config=_engine_config(1), loss_fn=_jax_loss,
        sample_batch={"input_ids": np.zeros((1, SEQ), np.int32)},
        rng=jax.random.PRNGKey(0))
    cfg = GPTConfig(**TINY, dtype=torch.float32)
    eng = _port_engine(params_from_jax(_tree_np(jeng.params), cfg))
    batch = _batch()
    for step in range(5):
        ref = float(jeng.train_batch(batch))
        loss = eng.train_batch(batch)
        assert loss.shape == () and loss.dtype == torch.float32
        assert abs(float(loss) - ref) <= 1e-4, step
        np.testing.assert_allclose(eng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4)
    assert eng.global_steps == 5 and eng.global_samples == 80
    assert eng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    final = params_from_jax(_tree_np(jeng.params), cfg)
    diff = max((final[k] - v).abs().max().item()
               for k, v in eng.module.state_dict().items())
    assert diff <= 2 * 1e-3 * 5, diff
    np.testing.assert_allclose(float(eng.eval_batch(batch)),
                               float(jeng.eval_batch(batch)), atol=1e-3)


def test_attention_dropout_runs_are_reproducible_and_change_the_loss():
    base = GPT(GPTConfig(**TINY, dtype=torch.float32)).state_dict()
    batch = _batch(1)
    runs = []
    for rate in (0.2, 0.2, 0.0):
        eng = _port_engine(base, attn_dropout=rate)
        runs.append([eng.train_batch(batch).item() for _ in range(2)])
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[2][0]
    other_seed = _port_engine(base, attn_dropout=0.2, seed=7)
    assert other_seed.train_batch(batch).item() != runs[0][0]


def test_engine_keeps_its_gradient_buffers_and_launches_no_kernel():
    """The fused Adam table is built over the gradient buffers once: they
    keep their storage across steps. CPU tensors count no launch."""
    flash_attention.launches = fused_adam.launches = 0
    flash_attention_bwd.dkv_launches = flash_attention_bwd.dq_launches = 0
    eng = _port_engine(GPT(GPTConfig(**TINY, dtype=torch.float32))
                       .state_dict(), attn_dropout=0.1)
    ptrs = [g.data_ptr() for g in eng._grads]
    for _ in range(2):
        eng.train_batch(_batch(2))
    assert [p.grad.data_ptr() for p in eng._params] == ptrs
    assert all(p.grad is g for p, g in zip(eng._params, eng._grads))
    assert (flash_attention.launches, fused_adam.launches,
            flash_attention_bwd.dkv_launches,
            flash_attention_bwd.dq_launches) == (0, 0, 0, 0)


def test_initialize_runs_on_cuda_unless_asked():
    model = GPT(GPTConfig(**TINY, dtype=torch.float32))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.initialize(model=model, config=_engine_config(8),
                      loss_fn=_port_loss)
    # training_data gives the dataloader since the engine-loop slice
    _, _, loader, _ = ds.initialize(
        model=model, config=_engine_config(8), loss_fn=_port_loss,
        training_data=[np.zeros(SEQ, np.int32)] * 16, device="cpu")
    assert len(loader) == 1 and next(iter(loader)).shape == (16, SEQ)
    with pytest.raises(ValueError, match="train_batch_size"):
        _port_engine(model.state_dict()).train_batch(
            {"input_ids": np.zeros((4, SEQ), np.int32)})


def test_residual_dropout_raises_naming_the_later_slice():
    """The former refusal is gone: a GPT with dropout_rate 0.1 builds,
    trains a step on the CPU through the engine, and in training mode
    refuses a forward without its seed words (the name is the test's
    old one)."""
    cfg = GPTConfig(**TINY, dtype=torch.float32, dropout_rate=0.1)
    model = GPT(cfg, seed=1)
    ids = torch.from_numpy(_batch(0)["input_ids"][:2]).long()
    with pytest.raises(ValueError, match="seed words"):
        model(ids)
    engine, *_ = ds.initialize(model=model, config=_engine_config(8),
                               loss_fn=_port_loss, seed=5, device="cpu")
    loss = float(engine.train_batch(_batch(0)))
    assert np.isfinite(loss)
    plain = GPT(dataclasses.replace(cfg, dropout_rate=0.0), seed=None)
    plain.load_state_dict(model.state_dict())
    assert torch.equal(model.eval()(ids), plain.eval()(ids))


def test_serving_runs_the_model_in_eval_mode():
    """A model built with attention dropout serves token-exact against the
    same weights without it: init_inference puts it in eval mode, so no
    keep bit is ever drawn while serving."""
    cfg = GPTConfig(**TINY, dtype=torch.float32)
    plain = GPT(cfg, seed=3)
    dropped = GPT(dataclasses.replace(cfg, attn_dropout_rate=0.5), seed=3)
    assert dropped.training
    prompts = [np.array([5, 6, 7, 8]), np.array([9, 10])]
    outs = []
    for model in (plain, dropped):
        eng = init_inference(model, device="cpu")
        assert not eng.module.training
        gen = eng.generate(prompts[0][None], max_new_tokens=6)
        srv = eng.serve({"num_slots": 2, "max_len": 32,
                         "prefill_bucket": 8})
        assert isinstance(srv, ServingEngine)
        reqs = [srv.submit(p, max_new_tokens=5) for p in prompts]
        srv.run()
        outs.append((gen.tolist(), [r.output_tokens for r in reqs]))
    assert outs[0] == outs[1]
    # a model left in training mode refuses the cache path rather than
    # dropping attention probabilities while decoding
    srv = ServingEngine(dropped.train(), {"num_slots": 1, "max_len": 32,
                                          "prefill_bucket": 8})
    srv.submit(prompts[0], max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="eval"):
        srv.run()
