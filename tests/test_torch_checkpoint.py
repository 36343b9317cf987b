"""The port's checkpoints: save, resume, async save, integrity manifests
shared with the JAX package, and the 16-bit export in flax's layout.

- A run saved at step 2 of 4 and resumed in a fresh engine continues the
  uninterrupted run bit for bit (losses, parameters, optimizer slots and
  counters), attention dropout on, in both calling conventions and for
  every optimizer: the meta file keeps ``micro_steps``, so ``forward``
  folds the same seed words after the resume.
- ``load_module_only`` and ``load_optimizer_states=False`` restore what
  the JAX engine restores (``tests/unit/test_engine.py:167-190``); an
  async save publishes ``latest`` only once durable (:244-273).
- Manifests: the JAX package's ``verify_manifest`` passes a port tag and
  the port's passes a tag from JAX's ``write_manifest``; both flag one
  flipped byte; a torn newest tag makes a load fall back to the previous
  verified tag and rewrite ``latest``.
- ``save_16bit_model`` writes the bytes ``flax.serialization.to_bytes``
  writes for the same tree; ``msgpack_restore`` reads the keys and shapes
  of the JAX GPT's unrolled params, with the port's parameters rounded
  to bf16.
"""

import json
import os

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from flax.core import meta, unfreeze
import jax

from deepspeed_tpu.runtime.resilience import manifest as jax_manifest
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import GPT, GPTConfig, gpt_loss_fn
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime import checkpointing
from deepspeed_tpu_torch.runtime import serialization as port_ser
from deepspeed_tpu_torch.runtime.resilience import manifest as port_manifest
from deepspeed_tpu_torch.runtime.resilience.manifest import (
    CheckpointCorruptionError)

from tests.test_torch_model import TINY, jax_gpt

SEQ, MICRO, GAS = 32, 4, 2
JAX_META_KEYS = {"global_steps", "global_samples", "skipped_steps",
                 "zero_stage", "dp_world_size", "client_state"}


def _loss(model, batch, rng, train):
    ids = batch["input_ids"].long()
    return gpt_loss_fn(model(ids, dropout_seed=rng)[:, :-1], ids[:, 1:])


def _data(n=32):
    return {"input_ids": np.random.RandomState(1).randint(
        0, TINY["vocab_size"], size=(n, SEQ)).astype(np.int32)}


def _engine(opt="FusedAdam", rate=0.1):
    params = {"lr": 2e-3, "weight_decay": 0.01}
    if opt == "SGD":
        params["momentum"] = 0.9
    config = {"train_batch_size": MICRO * GAS,
              "train_micro_batch_size_per_gpu": MICRO,
              "gradient_accumulation_steps": GAS, "gradient_clipping": 1.0,
              "optimizer": {"type": opt, "params": params},
              "scheduler": {"type": "WarmupLR", "params": {
                  "warmup_num_steps": 3, "warmup_max_lr": 2e-3}}}
    cfg = GPTConfig(**TINY, dtype=torch.float32, attn_dropout_rate=rate)
    engine, _, loader, _ = ds.initialize(
        model=GPT(cfg, seed=5), config=config, loss_fn=_loss, seed=11,
        training_data=_data(), device="cpu")
    return engine, loader


def _steps(engine, loader, first, last, split=True):
    """Optimizer steps first..last-1 of the loader's epoch 0; returns the
    microbatch losses (split) or the step losses (train_batch)."""
    out = []
    for k, batch in enumerate(loader):
        if k >= last:
            break
        if k < first:
            continue
        if not split:
            out.append(engine.train_batch(batch))
            continue
        for g in range(GAS):
            mb = {n: v[g * MICRO:(g + 1) * MICRO] for n, v in batch.items()}
            loss = engine(mb)
            engine.backward(loss)
            engine.step()
            out.append(loss.detach())
    return out


def _state(engine):
    opt = engine.optimizer_state
    return ([p.detach().clone() for p in engine.module.parameters()],
            {s: [t.clone() for t in getattr(opt, s)] for s in opt.SLOTS},
            (opt.count, engine.global_steps, engine.global_samples,
             engine.micro_steps))


def _equal_states(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert a[1].keys() == b[1].keys()
    for s in a[1]:
        assert all(torch.equal(x, y) for x, y in zip(a[1][s], b[1][s])), s
    assert a[2] == b[2]


@pytest.mark.parametrize("split", [True, False],
                         ids=["forward_backward_step", "train_batch"])
@pytest.mark.parametrize("opt", ["FusedAdam", "FusedLamb", "Adagrad", "SGD"])
def test_resume_continues_the_uninterrupted_run_bit_for_bit(tmp_path, opt,
                                                            split):
    ref, loader = _engine(opt)
    full = _steps(ref, loader, 0, 4, split)
    eng, loader = _engine(opt)
    _steps(eng, loader, 0, 2, split)
    eng.save_checkpoint(str(tmp_path), client_state={"batches": 2})
    assert (tmp_path / "latest").read_text() == "global_step2"
    fresh, loader = _engine(opt)
    path, client = fresh.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step2")
    assert client == {"batches": 2}
    rest = _steps(fresh, loader, client["batches"], 4, split)
    n = len(full) // 2
    assert all(torch.equal(a, b) for a, b in zip(full[n:], rest))
    _equal_states(_state(ref), _state(fresh))


def test_meta_has_the_jax_keys_and_micro_steps_falls_back(tmp_path):
    eng, loader = _engine()
    _steps(eng, loader, 0, 1)
    eng.save_checkpoint(str(tmp_path), tag="t")
    with open(tmp_path / "t" / "engine_meta.json") as f:
        meta_d = json.load(f)
    assert set(meta_d) == JAX_META_KEYS | {"micro_steps"}
    assert (meta_d["global_steps"], meta_d["micro_steps"],
            meta_d["dp_world_size"], meta_d["skipped_steps"]) == (1, 2, 1, 0)
    assert sorted(os.listdir(tmp_path / "t")) == [
        "engine_meta.json", "manifest.json", "state.pt"]
    # a meta file without micro_steps: global_steps x gas
    del meta_d["micro_steps"]
    meta_d["global_steps"] = 5
    with open(tmp_path / "t" / "engine_meta.json", "w") as f:
        json.dump(meta_d, f)
    port_manifest.write_manifest(str(tmp_path / "t"), step=5, tag="t")
    fresh, _ = _engine()
    fresh.load_checkpoint(str(tmp_path), tag="t")
    assert (fresh.global_steps, fresh.micro_steps) == (5, 5 * GAS)


def test_state_file_is_keyed_by_keystr_paths(tmp_path):
    eng, _ = _engine()
    eng.save_checkpoint(str(tmp_path))
    state = torch.load(tmp_path / "global_step0" / "state.pt",
                       weights_only=True)
    assert "['params']['h_0']['attn']['qkv']['kernel']" in state["params"]
    assert set(state["optimizer_state"]) == {"count", "exp_avg",
                                             "exp_avg_sq"}
    assert set(state["optimizer_state"]["exp_avg"]) == set(state["params"])
    assert {checkpointing.port_name(p) for p in state["params"]} == set(
        eng.module.state_dict())


def test_load_keeps_storage_and_the_optimizer_table(tmp_path):
    """A load copies into the parameters, gradient buffers and moments in
    place: the fused kernels' device tables stay valid."""
    eng, loader = _engine()
    _steps(eng, loader, 0, 1)
    eng.save_checkpoint(str(tmp_path))
    fresh, _ = _engine()
    opt = fresh.optimizer_state
    ptrs = opt._pointers()
    params = list(fresh.module.parameters())
    fresh.load_checkpoint(str(tmp_path))
    assert opt._pointers() == ptrs
    assert all(a is b for a, b in zip(params, fresh.module.parameters()))
    assert all(p.grad is g for p, g in zip(fresh._params, fresh._grads))


def test_load_module_only_and_without_optimizer_states(tmp_path):
    eng, loader = _engine()
    _steps(eng, loader, 0, 2)
    eng.save_checkpoint(str(tmp_path), tag="t")
    e2, loader2 = _engine()
    opt0 = {s: [t.clone() for t in getattr(e2.optimizer_state, s)]
            for s in e2.optimizer_state.SLOTS}
    e2.load_checkpoint(str(tmp_path), tag="t", load_module_only=True)
    assert all(torch.equal(a, b) for a, b in zip(
        eng.module.parameters(), e2.module.parameters()))
    for s, ts in opt0.items():     # optimizer state untouched
        assert all(torch.equal(a, b) for a, b in
                   zip(ts, getattr(e2.optimizer_state, s)))
    assert e2.optimizer_state.count == 0 and e2.global_steps == 2
    e3, loader3 = _engine()
    e3.load_checkpoint(str(tmp_path), tag="t", load_optimizer_states=False)
    assert e3.optimizer_state.count == 0
    assert all(torch.equal(a, b) for a, b in zip(
        eng.module.parameters(), e3.module.parameters()))
    losses = _steps(e3, loader3, 2, 3)
    assert all(np.isfinite(float(x)) for x in losses)


def test_async_save_publishes_latest_once_durable(tmp_path):
    eng, loader = _engine()
    it = iter(loader)
    eng.train_batch(next(it))
    snap = [p.detach().clone() for p in eng.module.parameters()]
    eng.save_checkpoint(str(tmp_path), tag="a1", async_save=True)
    # keep training while the write is in flight: the save snapshotted
    eng.train_batch(next(it))
    eng.train_batch(next(it))
    assert not (tmp_path / "latest").exists()
    assert not (tmp_path / "a1" / "manifest.json").exists()
    assert eng.wait_checkpoint() == str(tmp_path / "a1")
    assert (tmp_path / "latest").read_text() == "a1"
    assert eng.wait_checkpoint() is None
    fresh, _ = _engine()
    fresh.load_checkpoint(str(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(
        snap, fresh.module.parameters()))
    assert fresh.global_steps == 1
    eng.save_checkpoint(str(tmp_path), tag="a2", async_save=True)
    eng.destroy()
    assert (tmp_path / "latest").read_text() == "a2"
    assert eng._async_writer is None
    eng.destroy()                                   # idempotent


def test_a_second_async_save_publishes_the_first(tmp_path):
    eng, _ = _engine()
    eng.save_checkpoint(str(tmp_path), tag="b1", async_save=True)
    eng.save_checkpoint(str(tmp_path), tag="b2", async_save=True)
    assert (tmp_path / "latest").read_text() == "b1"
    assert port_manifest.verify_manifest(str(tmp_path / "b1")) == []
    eng.destroy()
    assert (tmp_path / "latest").read_text() == "b2"


def _flip_a_byte(path, offset=100):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def test_manifests_verify_across_packages(tmp_path):
    eng, _ = _engine()
    eng.save_checkpoint(str(tmp_path / "port"), tag="p")
    port_tag = str(tmp_path / "port" / "p")
    # a JAX-style tag: files of any content, manifested by the JAX package
    jax_tag = tmp_path / "jax" / "j"
    (jax_tag / "state").mkdir(parents=True)
    (jax_tag / "state" / "shard").write_bytes(os.urandom(4096))
    (jax_tag / "engine_meta.json").write_text(json.dumps({"global_steps": 3}))
    for algorithm in ("crc32", "sha256"):
        jax_manifest.write_manifest(str(jax_tag), step=3, tag="j",
                                    algorithm=algorithm)
        assert port_manifest.verify_manifest(str(jax_tag)) == []
        port_manifest.write_manifest(port_tag, step=0, tag="p",
                                     algorithm=algorithm)
        assert jax_manifest.verify_manifest(port_tag) == []
        ours = port_manifest.read_manifest(port_tag)
        jax_manifest.write_manifest(port_tag, step=0, tag="p",
                                    algorithm=algorithm)
        theirs = port_manifest.read_manifest(port_tag)
        ours.pop("framework_version"), theirs.pop("framework_version")
        assert ours == theirs
    _flip_a_byte(os.path.join(port_tag, "state.pt"))
    _flip_a_byte(jax_tag / "state" / "shard")
    for tag in (port_tag, str(jax_tag)):
        for mod in (jax_manifest, port_manifest):
            errors = mod.verify_manifest(tag)
            assert len(errors) == 1 and "sha256" in errors[0], (tag, mod)


def test_a_torn_newest_tag_falls_back_and_repairs_latest(tmp_path, caplog):
    eng, loader = _engine()
    it = iter(loader)
    eng.train_batch(next(it))
    eng.save_checkpoint(str(tmp_path))              # global_step1
    good = [p.detach().clone() for p in eng.module.parameters()]
    eng.train_batch(next(it))
    eng.save_checkpoint(str(tmp_path))              # global_step2
    assert (tmp_path / "latest").read_text() == "global_step2"
    state = tmp_path / "global_step2" / "state.pt"
    with open(state, "r+b") as f:                   # a torn write
        f.truncate(os.path.getsize(state) // 2)
    fresh, _ = _engine()
    with caplog.at_level("WARNING", logger="deepspeed_tpu_torch"):
        path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step1")
    assert "falling back" in caplog.text
    assert (tmp_path / "latest").read_text() == "global_step1"
    assert fresh.global_steps == 1
    assert all(torch.equal(a, b) for a, b in zip(
        good, fresh.module.parameters()))
    # an explicitly named torn tag raises rather than load another step
    with pytest.raises(CheckpointCorruptionError, match="global_step2"):
        fresh.load_checkpoint(str(tmp_path), tag="global_step2")
    with pytest.raises(CheckpointCorruptionError):
        checkpointing.load_module_params(str(tmp_path), tag="global_step2")
    assert set(checkpointing.load_module_params(str(tmp_path))) == set(
        fresh.module.state_dict())


def test_nothing_to_load_returns_none(tmp_path, caplog):
    eng, _ = _engine()
    with caplog.at_level("WARNING", logger="deepspeed_tpu_torch"):
        assert eng.load_checkpoint(str(tmp_path)) == (None, {})
        assert eng.load_checkpoint(str(tmp_path), tag="nope") == (None, {})
    assert "no 'latest' file" in caplog.text
    with pytest.raises(FileNotFoundError):
        checkpointing.load_module_params(str(tmp_path), tag="nope")


def test_load_module_params_returns_the_port_state_dict(tmp_path):
    eng, loader = _engine()
    _steps(eng, loader, 0, 1)
    eng.save_checkpoint(str(tmp_path))
    sd = checkpointing.load_module_params(str(tmp_path))
    want = eng.module.state_dict()
    assert sd.keys() == want.keys()
    assert all(torch.equal(sd[k], want[k]) for k in sd)
    model = GPT(eng.module.config, seed=99)
    model.load_state_dict(sd)


def test_save_16bit_model_is_flax_msgpack(tmp_path):
    """The export holds the JAX GPT's unrolled tree (keys and shapes of
    ``jax_gpt(scan_layers=False)``), each leaf the port's parameter
    rounded to bf16, in exactly the bytes flax writes for that tree."""
    _, jparams = jax_gpt(scan_layers=False)
    want_tree = jax.tree.map(np.asarray, unfreeze(meta.unbox(jparams)))
    eng, loader = _engine()
    _steps(eng, loader, 0, 1)
    path = eng.save_16bit_model(str(tmp_path))
    assert path == str(tmp_path / "model_states.msgpack")
    data = open(path, "rb").read()
    got = serialization.msgpack_restore(data)
    assert list(got) == ["params"]
    got_leaves = jax.tree_util.tree_leaves_with_path(got["params"])
    want_leaves = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [jax.tree_util.keystr(p) for p, _ in got_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (p, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.shape == b.shape and a.dtype.name == "bfloat16", p
    sd = eng.module.state_dict()
    back = params_from_jax(got["params"], eng.module.config)
    for name, t in back.items():
        rounded = sd[name].to(torch.bfloat16).float()
        assert torch.equal(t, rounded), name
    ref = serialization.to_bytes({"params": jax.tree.map(
        lambda t: t.float().numpy().astype(jax.numpy.bfloat16),
        eng._zero3_consolidated_16bit_state_dict())["params"]})
    assert data == ref
    fp32 = eng.save_16bit_model(str(tmp_path), "fp32.msgpack",
                                dtype=torch.float32)
    tree = serialization.msgpack_restore(open(fp32, "rb").read())
    assert tree["params"]["wte"].dtype == np.float32
    np.testing.assert_array_equal(tree["params"]["wte"],
                                  sd["wte"].numpy())


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, "", "k" * 31, "k" * 32, "k" * 255, "k" * 256, "k" * 70000,
    b"x" * 255, b"x" * 256, b"x" * 70000, [1] * 15, [1] * 16, [1] * 70000,
    ["a", b"b", [2, -3]]])
def test_encoder_picks_msgpacks_encoding(value):
    assert port_ser.to_bytes(value) == msgpack.packb(value)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 15, 16, 17, 255, 256, 70000])
def test_encoder_maps_and_ext_lengths(n):
    d = {f"k{i:05d}": i for i in range(n)}
    assert port_ser.to_bytes(d) == msgpack.packb(d)
    t = torch.arange(n, dtype=torch.int8)
    assert port_ser.to_bytes({"t": t}) == serialization.to_bytes(
        {"t": t.numpy()})
