"""The port's serving QoS against the JAX package's, on the CPU in fp32.

The ``qos`` config's validation and ``class_for`` are JAX's; the
degradation ladder (levels, admit and shed decisions, the chunk and
speculation budgets) replays JAX's ``QosController`` on the same signals;
a ~3x overload trace (bursts of 8 against 4 slots) through both engines
ends with the same status, shed reason and tokens for every request.
Priority preemption resumes token-exactly against ``generate()`` on the
contiguous and the paged engine; nothing is preempted without the block
or before a head is at risk, and the queue TTL still times out without
it.
"""

import dataclasses
from collections import deque

import numpy as np
import pytest

from benchmarks.serving.load_harness import make_qos_trace
from deepspeed_tpu.serving import QosConfig as JaxQosConfig
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.engine import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.qos import QosController as JaxController
from deepspeed_tpu.serving.qos import \
    standard_qos_config as jax_standard_qos_config
from deepspeed_tpu_torch.inference.generation import generate
from deepspeed_tpu_torch.serving import (PagingConfig, QosConfig,
                                         QosController, ServingConfig,
                                         ServingEngine)
from deepspeed_tpu_torch.serving.qos import (LEVEL_REFUSE,
                                             standard_qos_config)
from deepspeed_tpu_torch.serving.request import Request
from tests.test_torch_model import TINY, jax_gpt, port_gpt
from tests.torch_threads import share_cores

share_cores()

VOCAB = TINY["vocab_size"]
CLASSES = [
    {"name": "interactive", "priority": 2, "ttft_slo_steps": 32,
     "preempt_after_steps": 1, "sheddable": False},
    {"name": "standard", "priority": 1, "ttft_slo_steps": 128},
    {"name": "batch", "priority": 0},
]


@pytest.fixture(scope="module")
def models():
    jm, params = jax_gpt(seed=5)
    return jm, params, port_gpt(jm, params)


def _ref(model, req):
    return generate(model, np.asarray(req.prompt)[None],
                    max_new_tokens=req.max_new_tokens)[
                        0, len(req.prompt):].tolist()


# ---------------------------------------------------------------------------
# the config and the controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(classes=[]),
    dict(classes=[{"name": "a", "priority": 1}, {"name": "b", "priority": 1}]),
    dict(classes=[{"name": "a", "priority": 1}, {"name": "a", "priority": 2}]),
    dict(classes=[{"name": "a", "priority": 1, "ttft_slo_steps": -1}]),
    dict(max_preemptions_per_iter=-1), dict(ladder_patience_steps=0),
    dict(recover_patience_steps=0), dict(min_free_page_frac=1.5),
    dict(degraded_max_chunks_per_iter=0), dict(watchdog_timeout_s=0.0)])
def test_config_refusals_match_jax(bad):
    for cls in (QosConfig, JaxQosConfig):
        with pytest.raises(ValueError):
            cls(**bad).validate()


def test_class_for_and_the_standard_config_match_jax():
    ours, theirs = QosConfig(classes=CLASSES), JaxQosConfig(classes=CLASSES)
    for prio in range(-3, 6):
        assert (dataclasses.asdict(ours.class_for(prio))
                == dataclasses.asdict(theirs.class_for(prio)))
    assert (dataclasses.asdict(QosConfig())
            == dataclasses.asdict(JaxQosConfig()))
    for kw in ({}, dict(ttft_slo_steps=8, shed_queue_depth=3,
                        watchdog_timeout_s=2.0)):
        assert (dataclasses.asdict(standard_qos_config(4, **kw))
                == dataclasses.asdict(jax_standard_qos_config(4, **kw)))


def test_the_ladder_replays_jax_on_the_same_signals():
    """Random overload signals through both controllers: every level,
    admit decision, queued-shed decision and budget equal, step by step."""
    kw = dict(classes=CLASSES, shed_queue_depth=6, shed_ttft_p95_steps=20,
              min_free_page_frac=0.2, ladder_patience_steps=3,
              recover_patience_steps=5)
    ours = QosController(QosConfig(**kw))
    theirs = JaxController(JaxQosConfig(**kw))
    r = np.random.RandomState(0)
    reqs = []
    for prio in (0, 1, 2):
        for tokens in ([], [3]):
            req = Request(np.ones(4, np.int32), 8, len(reqs), priority=prio)
            req.tokens = tokens
            req.submitted_iteration = 0
            reqs.append(req)
    levels = set()
    for it in range(400):
        burst = (it // 40) % 2 == 0
        sig = dict(iteration=it,
                   queue_depth=int(r.randint(0, 12 if burst else 4)),
                   ttft_p95_steps=(None if r.rand() < 0.2
                                   else float(r.randint(0, 40))),
                   free_frac=(None if r.rand() < 0.3 else float(r.rand())))
        assert ours.observe(**sig) == theirs.observe(**sig)
        levels.add(ours.level)
        for cls in QosConfig(**kw).classes:
            for p95 in (None, 10.0, 200.0):
                for under in (False, True):
                    assert (ours.admit(cls, class_ttft_p95=p95,
                                       under_load=under)
                            == theirs.admit(cls, class_ttft_p95=p95,
                                            under_load=under))
        po, pt = ours.queued_shed_predicate(), theirs.queued_shed_predicate()
        assert (po is None) == (pt is None)
        if po is not None:
            assert [po(q) for q in reqs] == [pt(q) for q in reqs]
        for q in reqs:
            cls = ours.config.class_for(q.priority)
            assert (ours.head_at_risk(q, cls, it)
                    == theirs.head_at_risk(q, cls, it))
        assert ours.max_chunks(4) == theirs.max_chunks(4)
        assert ours.max_spec_tokens(4) == theirs.max_spec_tokens(4)
        assert ours.snapshot() == theirs.snapshot()
    assert LEVEL_REFUSE in levels and 0 in levels


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _replay(engine, trace):
    """``benchmarks/serving/load_harness.py`` ``replay``: submit each
    request at its arrival step on the engine clock (idle gaps jump to
    the next arrival), advance until idle; the handles in trace order."""
    pending = deque(sorted(trace, key=lambda t: t["arrival_step"]))
    handles, clock = {}, 0
    while pending or engine.busy:
        clock = max(clock, engine.iteration)
        if not engine.busy and pending and pending[0]["arrival_step"] > clock:
            clock = pending[0]["arrival_step"]
        while pending and pending[0]["arrival_step"] <= clock:
            t = pending.popleft()
            handles[t["id"]] = engine.submit(
                t["prompt"], t["max_new_tokens"], request_id=t["id"],
                priority=t["priority"])
        engine.advance()
    return [handles[t["id"]] for t in trace]


def test_3x_overload_trace_matches_the_jax_engine(models):
    jm, params, model = models
    classes = [dict(c, preempt_after_steps=4) if c["priority"] == 2 else c
               for c in CLASSES]
    knobs = dict(num_slots=4, max_len=128, prefill_bucket=128)
    trace = make_qos_trace("burst", seed=0, num_requests=40,
                           vocab_size=VOCAB, prompt_len_range=(4, 32),
                           output_len_range=(4, 16), mean_interarrival=1.0)
    ours = ServingEngine(model, ServingConfig(**knobs, qos=QosConfig(
        classes=classes, shed_queue_depth=8, ladder_patience_steps=4)))
    got = _replay(ours, trace)
    theirs = JaxServingEngine(jm, params, JaxServingConfig(
        **knobs, qos=JaxQosConfig(classes=classes, shed_queue_depth=8,
                                  ladder_patience_steps=4)))
    want = _replay(theirs, trace)
    assert ([(h.status, h.shed_reason, h.output_tokens,
              h.first_token_iteration) for h in got]
            == [(h.status, h.shed_reason, h.output_tokens,
                 h.first_token_iteration) for h in want])
    snap = ours.metrics.snapshot()
    assert snap["requests_shed"] > 0 and snap["class/batch/shed"] > 0
    assert snap.get("class/interactive/shed", 0) == 0
    assert snap["class/interactive/ttft_steps_p95"] <= 32
    jsnap = theirs.metrics.snapshot()
    for key, val in snap.items():
        if key.startswith(("shed/", "class/", "requests_")):
            assert jsnap[key] == val, key
    theirs.close()


@pytest.mark.parametrize("paged", [False, True])
def test_preemption_resumes_token_exact(models, paged):
    """Low-priority requests fill the slots (or the pool); a late
    interactive one preempts one of them back to the queue; every request
    ends with generate()'s tokens, and the interactive one starts well
    before a slot would have come free."""
    _, _, model = models
    r = np.random.RandomState(3 if paged else 0)
    paging = (PagingConfig(page_len=16, num_pages=2 * (128 // 16) + 1)
              if paged else None)
    eng = ServingEngine(model, ServingConfig(
        num_slots=3 if paged else 2, max_len=128, prefill_bucket=16,
        paging=paging, qos=QosConfig(classes=CLASSES)))
    n, out, warm = (40, 80, 8) if paged else (6, 20, 3)
    lows = [eng.submit(r.randint(1, VOCAB, size=n), out, priority=0)
            for _ in range(2)]
    for _ in range(warm):
        eng.advance()
    hi = eng.submit(r.randint(1, VOCAB, size=5), 4, priority=2)
    while eng.busy:
        eng.advance()
        if paged:
            eng._paged.allocator.check()
    assert sum(q.preemptions for q in lows) == 1
    assert hi.first_token_iteration - hi.submitted_iteration <= 4
    for q in [hi] + lows:
        assert q.status == "finished" and q.output_tokens == _ref(model, q)
    snap = eng.metrics.snapshot()
    assert snap["requests_preempted"] == snap["requests_resumed"] == 1
    assert snap["class/batch/preempted"] == snap["class/batch/resumed"] == 1
    if paged:
        stats = eng._paged.stats()
        assert snap["prefix_hits"] >= 1
        assert stats["pages_in_use"] == stats["prefix_nodes"]


@pytest.mark.parametrize("qos", [False, True])
def test_no_preemption_without_qos_or_an_at_risk_head(models, qos):
    _, _, model = models
    r = np.random.RandomState(1)
    classes = [dict(c, preempt_after_steps=None) for c in CLASSES]
    eng = ServingEngine(model, ServingConfig(
        num_slots=1, max_len=128, prefill_bucket=16,
        qos=QosConfig(classes=classes) if qos else None))
    a = eng.submit(r.randint(1, VOCAB, size=4), 10, priority=0)
    b = eng.submit(r.randint(1, VOCAB, size=4), 3, priority=2)
    eng.run()
    assert a.preemptions == 0 and a.output_tokens == _ref(model, a)
    assert b.status == "finished"
    assert eng.metrics.requests_preempted == 0
    assert eng.qos_level == (0 if qos else None)


def test_queue_ttl_without_qos(models):
    _, _, model = models
    r = np.random.RandomState(5)
    eng = ServingEngine(model, ServingConfig(num_slots=1, max_len=128,
                                             prefill_bucket=16))
    head = eng.submit(r.randint(1, VOCAB, size=4), 12)
    late = eng.submit(r.randint(1, VOCAB, size=4), 4, deadline_steps=3)
    eng.run()
    assert head.status == "finished" and late.status == "timeout"
    assert eng.metrics.snapshot()["requests_timed_out"] == 1
