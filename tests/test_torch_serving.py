"""The port's continuous-batching ``ServingEngine``: 33 mixed requests
through 4 slots, token-exact against the port's ``generate()`` per
request and, for 4 of them, against the JAX package's ``generate()``;
cancel, eos early finish and the metrics snapshot."""

import numpy as np
import pytest
import jax.numpy as jnp

from deepspeed_tpu.inference.generation import generate as jax_generate
from deepspeed_tpu_torch.inference.generation import generate
from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine
from tests.test_torch_model import TINY, jax_gpt, port_gpt
from tests.torch_threads import share_cores

share_cores()

VOCAB = TINY["vocab_size"]


@pytest.fixture(scope="module")
def models():
    jm, params = jax_gpt(seed=7)
    return jm, params, port_gpt(jm, params)


def _workload(n, seed=0, prompt_range=(3, 24), out_range=(1, 8)):
    r = np.random.RandomState(seed)
    prompts = [r.randint(1, VOCAB, size=r.randint(*prompt_range)
                         ).astype(np.int32) for _ in range(n)]
    outs = [int(r.randint(*out_range)) for _ in range(n)]
    return prompts, outs


def _reference(model, prompt, max_new, **kw):
    return generate(model, prompt[None], max_new_tokens=max_new,
                    **kw)[0, len(prompt):].tolist()


@pytest.mark.parametrize("pipeline_depth", [1, 0])
def test_33_requests_through_4_slots_match_generate(models, pipeline_depth):
    jm, params, model = models
    prompts, outs = _workload(33)
    streamed = {}

    def on_token(req, tok):
        streamed.setdefault(req.request_id, []).append(tok)

    eng = ServingEngine(model, ServingConfig(
        num_slots=4, max_len=128, prefill_bucket=16,
        pipeline_depth=pipeline_depth))
    reqs = [eng.submit(p, max_new_tokens=o, on_token=on_token)
            for p, o in zip(prompts, outs)]
    eng.run()
    for req, p, o in zip(reqs, prompts, outs):
        assert req.done and req.status == "finished"
        assert req.output_tokens == _reference(model, p, o), req.request_id
        assert streamed[req.request_id] == req.output_tokens

    snap = eng.metrics.snapshot()
    assert snap["requests_admitted"] == 33 > eng.config.num_slots
    assert snap["requests_finished"] == 33
    assert snap["queue_depth_max"] > 0
    assert snap["tokens_generated"] == sum(outs)
    assert snap["ttft_steps_p95"] >= snap["ttft_steps_p50"] >= 0
    assert not eng.busy and eng.num_free_slots == 4

    if pipeline_depth == 1:
        # 4 of them against the JAX package: one ragged JAX generate over
        # their prompts (each row decodes from its own length)
        pick = range(4)
        width = max(len(prompts[i]) for i in pick)
        ids = np.zeros((4, width), np.int32)
        for row, i in enumerate(pick):
            ids[row, :len(prompts[i])] = prompts[i]
        lens = [len(prompts[i]) for i in pick]
        ref = np.asarray(jax_generate(
            jm, params, jnp.asarray(ids), max_new_tokens=max(outs[i]
                                                            for i in pick),
            prompt_lengths=lens))
        for row, i in enumerate(pick):
            np.testing.assert_array_equal(
                reqs[i].output_tokens, ref[row, lens[row]:lens[row] + outs[i]])


def test_eos_completes_slot_early(models):
    _, _, model = models
    prompts, _ = _workload(6, seed=2)
    # an eos that occurs: request 0's first greedy token
    eos = _reference(model, prompts[0], 1)[0]
    eng = ServingEngine(model, ServingConfig(num_slots=2, max_len=128,
                                             prefill_bucket=16,
                                             eos_token_id=eos))
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.run()
    assert reqs[0].output_tokens == [eos]
    for req, p in zip(reqs, prompts):
        ref = _reference(model, p, 8, eos_token_id=eos)
        got = req.output_tokens
        assert got == ref[:len(got)]
        assert len(got) == 8 or got[-1] == eos


def test_cancel_queued_and_active(models):
    _, _, model = models
    prompts, _ = _workload(4, seed=3)
    eng = ServingEngine(model, ServingConfig(num_slots=2, max_len=128,
                                             prefill_bucket=16))
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.advance()                      # admits 0 and 1, 2 and 3 queued
    assert eng.cancel(reqs[3].request_id)          # queued
    assert eng.cancel(reqs[0].request_id)          # active
    assert not eng.cancel("no-such-request")
    eng.run()
    assert reqs[0].status == reqs[3].status == "cancelled"
    assert len(reqs[0].output_tokens) < 10 and not reqs[3].output_tokens
    for i in (1, 2):
        assert reqs[i].output_tokens == _reference(model, prompts[i], 10)
    snap = eng.metrics.snapshot()
    assert snap["requests_cancelled"] == 2
    assert snap["requests_finished"] == 2


def test_queue_deadline_and_cap(models):
    _, _, model = models
    prompts, _ = _workload(3, seed=4)
    eng = ServingEngine(model, ServingConfig(num_slots=1, max_len=128,
                                             prefill_bucket=16, max_queue=2))
    first = eng.submit(prompts[0], max_new_tokens=6)
    late = eng.submit(prompts[1], max_new_tokens=2, deadline_steps=2)
    with pytest.raises(RuntimeError, match="queue full"):
        eng.submit(prompts[2], max_new_tokens=2)
    eng.run()
    assert first.status == "finished" and len(first.output_tokens) == 6
    assert late.status == "timeout" and not late.output_tokens
    snap = eng.metrics.snapshot()
    assert snap["requests_timed_out"] == 1
    assert snap["requests_rejected"] == 1


def test_sampled_serving_finishes_in_vocab(models):
    _, _, model = models
    prompts, outs = _workload(5, seed=5)
    eng = ServingEngine(model, ServingConfig(
        num_slots=2, max_len=128, prefill_bucket=16, temperature=0.8,
        top_k=20, seed=3))
    reqs = [eng.submit(p, max_new_tokens=o) for p, o in zip(prompts, outs)]
    eng.run()
    for req, o in zip(reqs, outs):
        assert len(req.output_tokens) == o
        assert all(0 <= t < VOCAB for t in req.output_tokens)


def test_submit_validation_and_config_refusals(models):
    _, _, model = models
    eng = ServingEngine(model, ServingConfig(num_slots=1, max_len=64))
    with pytest.raises(ValueError, match="per-slot budget"):
        eng.submit(np.ones(60, np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="token ids"):
        eng.submit(np.array([1, VOCAB]), max_new_tokens=2)
    assert eng.metrics.snapshot()["requests_rejected"] == 2
    with pytest.raises(ValueError, match="max_seq_len"):
        ServingEngine(model, ServingConfig(num_slots=1, max_len=256))
    with pytest.raises(NotImplementedError, match="QoS"):
        ServingEngine(model, {"qos": {"enabled": True}})
    cfg = ServingConfig(max_len=100, prefill_bucket=16)
    # the capacity rounds up to 128, as the JAX package's does
    assert cfg.cache_len == 128
    assert cfg.bucket_lengths()[-2:] == (112, 128)
    assert cfg.bucket_for(17) == 32
