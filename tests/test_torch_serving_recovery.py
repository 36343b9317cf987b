"""The port's serving fault containment and elastic capacity, on the CPU.

An allocation failure while admitting or prefilling (a raised
``torch.cuda.OutOfMemoryError``, or a kernel launch failing with
``cudaErrorMemoryAllocation``) sheds exactly that request with reason
``oom``, keeps its forensics and rebuilds the device state; everyone else
finishes with ``generate()``'s tokens, and any other error propagates.
``recover()`` requeues every live request over a rebuilt state and the
rerun is token-exact; the watchdog's timer thread only flags a stalled
iteration, the next ``advance()`` recovers, a healthy run never fires it,
a flag nobody takes while the iteration still runs escalates, and a fire
in the last iteration of a run never does. ``set_slot_cap`` drains slots above the
cap by preemption, ``close()`` is idempotent, ``from_config`` takes a
config carrying a ``serving`` block (a ``fleet`` block still raises), and
``is_oom_error``, ``oom_forensics`` and ``format_memory_report`` read as
the JAX package's.
"""

import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.generation import generate
from deepspeed_tpu_torch.models import GPT, GPTConfig
from deepspeed_tpu_torch.observability.memory import (
    MemoryAccountant, device_memory_stats, format_memory_report,
    is_oom_error, oom_forensics, tree_bytes)
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError)
from deepspeed_tpu_torch.serving import (PagingConfig, QosConfig,
                                         ServingConfig, ServingEngine)
import deepspeed_tpu_torch.serving.engine as engine_mod
from tests.torch_threads import share_cores

share_cores()

VOCAB = 61
OOM = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                  "9.00 MiB")


@pytest.fixture(scope="module")
def model():
    return GPT(GPTConfig(vocab_size=VOCAB, max_seq_len=128, d_model=64,
                         n_layers=2, n_heads=2, dtype=torch.float32),
               seed=3).eval()


def _qos(**kw):
    return QosConfig(classes=[
        {"name": "interactive", "priority": 2, "preempt_after_steps": 1,
         "sheddable": False},
        {"name": "standard", "priority": 1},
        {"name": "batch", "priority": 0}], **kw)


def _ref(model, req):
    return generate(model, np.asarray(req.prompt)[None],
                    max_new_tokens=req.max_new_tokens)[
                        0, len(req.prompt):].tolist()


def _engine(model, paged=False, **kw):
    return ServingEngine(model, ServingConfig(
        num_slots=2, max_len=128, prefill_bucket=16,
        paging=PagingConfig(page_len=16) if paged else None, **kw))


def _flaky(monkeypatch, name, err, at=2):
    """Make the ``at``-th call of the engine module's ``name`` raise."""
    orig, calls = getattr(engine_mod, name), []

    def fn(*a, **kw):
        calls.append(1)
        if len(calls) == at:
            raise err
        return orig(*a, **kw)
    monkeypatch.setattr(engine_mod, name, fn)


# ---------------------------------------------------------------------------
# OOM containment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["admit", "chunk_prefill", "launch"])
def test_an_oom_sheds_the_request_and_the_engine_keeps_serving(
        model, monkeypatch, where):
    paged = where == "chunk_prefill"
    eng = _engine(model, paged=paged, qos=_qos())
    r = np.random.RandomState(1)
    reqs = [eng.submit(r.randint(1, VOCAB, size=5), 4, priority=1)
            for _ in range(3)]
    err = (RuntimeError("flash_attention_fwd: CUDA kernel launch failed "
                        "with cudaError 2") if where == "launch" else OOM)
    _flaky(monkeypatch, "_chunk_prefill_impl" if paged else "_admit_impl",
           err)
    eng.run()
    assert [q.status for q in reqs].count("shed") == 1
    shed = next(q for q in reqs if q.status == "shed")
    assert shed.shed_reason == "oom"
    assert "out of memory" in eng.last_oom_forensics["reason"]
    assert eng.last_oom_forensics["memory"]["top_buffers"]
    for q in reqs:
        if q is not shed:
            assert q.status == "finished" and q.output_tokens == _ref(model,
                                                                      q)
    snap = eng.metrics.snapshot()
    assert snap["shed/oom"] == 1 and snap["recoveries"] == 1
    assert [f["kind"] for f in snap["faults"]] == ["oom", "recovery"]
    if paged:
        eng._paged.allocator.check()
        stats = eng._paged.stats()
        assert stats["pages_in_use"] == stats["prefix_nodes"]


def test_an_error_that_is_not_an_oom_propagates(model, monkeypatch):
    eng = _engine(model)
    eng.submit([1, 2, 3], 2)
    _flaky(monkeypatch, "_admit_impl", RuntimeError("boom"), at=1)
    with pytest.raises(RuntimeError, match="boom"):
        eng.run()


def test_is_oom_error_and_the_forensics():
    assert is_oom_error(OOM)
    assert is_oom_error(RuntimeError("paged_attention: CUDA kernel launch "
                                     "failed with cudaError 2"))
    assert is_oom_error(RuntimeError("CUDA error: out of memory"))
    for other in (RuntimeError("boom"), ValueError("out of memory"),
                  RuntimeError("flash_attention_fwd: CUDA kernel launch "
                               "failed with cudaError 20"),
                  RuntimeError("... failed with cudaError 700")):
        assert not is_oom_error(other)
    acct = MemoryAccountant()
    kv = torch.zeros(4, 8)
    assert acct.account("serving/kv_pool", [kv, kv], name="pool") == 256
    acct.account("serving/params", num_bytes=1000)
    report = oom_forensics("test", acct)
    assert report["reason"] == "test"
    assert report["live_at_failure"] == device_memory_stats()  # None here
    assert [b["bytes"] for b in report["memory"]["top_buffers"]] == \
        [1000, 256]
    text = format_memory_report(report["memory"])
    assert "serving/kv_pool" in text and "TOTAL" in text
    acct.discard("serving/params")
    assert acct.static_total() == 256
    assert format_memory_report(MemoryAccountant().report()) == \
        "(no memory attribution recorded)"
    assert tree_bytes({"a": (kv, [kv]), "b": None}) == 256


# ---------------------------------------------------------------------------
# recover() and the watchdog
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_recover_requeues_queued_and_active_requests(model, paged):
    eng = _engine(model, paged=paged, qos=_qos())
    r = np.random.RandomState(6)
    reqs = [eng.submit(r.randint(1, VOCAB, size=5), 8, priority=i % 2)
            for i in range(4)]
    for _ in range(3):
        eng.advance()
    active = [q for q in reqs if q.status == "running"]
    assert active and any(q.status == "queued" for q in reqs)
    eng.recover("restart")
    assert all(q.status == "preempted" for q in active)
    assert eng.num_free_slots == 2 and not eng._pending
    eng.run()
    for q in reqs:
        assert q.status == "finished" and q.output_tokens == _ref(model, q)
    snap = eng.metrics.snapshot()
    assert snap["recoveries"] == 1
    assert snap["requests_resumed"] == len(active)
    if paged:
        eng._paged.allocator.check()
        stats = eng._paged.stats()
        assert stats["pages_in_use"] == stats["prefix_nodes"]


def test_the_watchdog_fires_recovers_and_stays_exact(model, monkeypatch):
    eng = _engine(model, qos=_qos(watchdog_timeout_s=0.15))
    escalations = []
    eng.on_watchdog_fatal = escalations.append
    r = np.random.RandomState(2)
    reqs = [eng.submit(r.randint(1, VOCAB, size=5), 6, priority=1)
            for _ in range(3)]
    orig, calls = engine_mod._decode_iter_impl, []

    def stalled(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            time.sleep(0.5)          # past the 0.15 s budget
        return orig(*a, **kw)
    monkeypatch.setattr(engine_mod, "_decode_iter_impl", stalled)
    try:
        eng.run()
    finally:
        eng.close()
    snap = eng.metrics.snapshot()
    kinds = [f["kind"] for f in snap["faults"]]
    assert "watchdog" in kinds and "recovery" in kinds
    assert snap["recoveries"] >= 1
    for q in reqs:
        assert q.status == "finished" and q.output_tokens == _ref(model, q)


def test_the_watchdog_escalates_only_when_its_flag_is_never_taken(model):
    eng = _engine(model, qos=_qos(watchdog_timeout_s=0.1))
    fatals = []
    eng.on_watchdog_fatal = fatals.append
    eng._watchdog.step_started()             # an iteration that never ends:
    time.sleep(0.6)                          # the thread fires, nobody takes
    assert len(fatals) == 1                  # the flag, it escalates
    assert fatals[0].startswith("serving iteration stuck")
    eng._on_watchdog_fire("slow")
    eng._watchdog_report = None              # advance() took it
    time.sleep(0.3)
    assert len(fatals) == 1
    eng._watchdog.step_finished()
    eng.close()


@pytest.mark.parametrize("then_close", [True, False])
def test_a_fire_in_the_last_iteration_never_escalates(model, then_close):
    """The watchdog fires inside the last ``advance()`` of a run, which
    returns: closing the engine cancels the escalation and drops the flag;
    an idle server keeps the flag for its next ``advance()``."""
    eng = _engine(model, qos=_qos(watchdog_timeout_s=0.05))
    fatals = []
    eng.on_watchdog_fatal = fatals.append
    req = eng.submit([1, 2, 3, 4], 3, priority=1)
    eng.run()
    admit = eng._admit_ready

    def stalled_admit():
        eng._on_watchdog_fire("stalled")     # as the timer thread would
        admit()
    eng._admit_ready = stalled_admit
    eng.advance()                            # the last iteration
    eng._admit_ready = admit
    if then_close:
        eng.close()
        assert eng._watchdog_report is None and eng._escalation is None
    time.sleep(0.25)                         # five windows
    assert fatals == []
    if not then_close:
        assert eng._watchdog_report == "stalled"
        eng.advance()                        # the next one recovers
        assert eng._watchdog_report is None
        assert eng.metrics.snapshot()["recoveries"] == 1
        eng.close()
    assert req.status == "finished" and req.output_tokens == _ref(model, req)


def test_the_watchdog_never_fires_on_a_healthy_run(model):
    eng = _engine(model, qos=_qos(watchdog_timeout_s=30.0))
    reqs = [eng.submit([1, 2, 3, i + 4], 3, priority=1) for i in range(3)]
    eng.run()
    assert eng._watchdog is not None and not eng._watchdog.fired
    assert all(q.status == "finished" for q in reqs)
    assert eng.metrics.faults == []
    assert eng.metrics_snapshot()["qos"] == eng._qos.snapshot()
    eng.close()
    assert eng._watchdog is None
    eng.close()                               # idempotent
    assert eng.accountant.static_total() == 0


# ---------------------------------------------------------------------------
# elastic capacity and construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_set_slot_cap_drains_by_preemption(model, paged):
    eng = ServingEngine(model, ServingConfig(
        num_slots=3, max_len=128, prefill_bucket=16, qos=_qos(),
        paging=PagingConfig(page_len=16) if paged else None))
    r = np.random.RandomState(3)
    reqs = [eng.submit(r.randint(1, VOCAB, size=6), 12, priority=0)
            for _ in range(4)]
    for _ in range(4):
        eng.advance()
    assert eng.set_slot_cap(1) == 1
    assert all(q is None for q in eng._slot_req[1:])
    assert sum(q.preemptions for q in reqs) == 2
    peak = 0
    while eng.busy:
        eng.advance()
        peak = max(peak, sum(q is not None for q in eng._slot_req))
    assert peak == 1 and eng.num_free_slots == 1
    for q in reqs:
        assert q.status == "finished" and q.output_tokens == _ref(model, q)
    assert eng.set_slot_cap(10) == 3 and eng.num_free_slots == 3
    assert eng.metrics.snapshot()["slot_cap"] == 1


def test_from_config_takes_a_serving_block(model):
    cfg = {"train_batch_size": 1,
           "serving": {"num_slots": 2, "max_len": 64, "prefill_bucket": 16,
                       "paging": {"page_len": 16},
                       "qos": {"classes": [{"name": "a", "priority": 0}]},
                       "speculation": {"max_spec_tokens": 2}}}
    eng = ServingEngine.from_config(model, cfg)
    assert eng.config.paged and eng.config.qos_enabled
    assert eng.config.spec_enabled and eng.config.cache_len == 128
    req = eng.submit([1, 2, 3, 1, 2, 3], 5)
    eng.run()
    assert req.output_tokens == _ref(model, req)
    parsed = DeepSpeedConfig.from_dict(cfg)
    assert parsed.serving.qos.classes[0].name == "a"
    assert DeepSpeedConfig.from_dict({}).serving is None
    with pytest.raises(DeepSpeedConfigError, match="serving"):
        DeepSpeedConfig.from_dict({"serving": {"num_slots": 0}})
    with pytest.raises(NotImplementedError, match="fleet"):
        DeepSpeedConfig.from_dict({"serving": {"fleet": {}}})
