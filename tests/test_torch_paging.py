"""The port's paged serving: the copied allocator and prefix cache against
the JAX package's on the same operation sequences, the paged engine
against the JAX paged engine on one seeded trace (tokens, per-slot page
lists, prefill-chunk counts, prefix stats), and against the port's own
``generate()`` and contiguous engine, token for token.

The tiny config of ``test_torch_model.py`` (2 layers, d_model 128,
head_dim 64), page_len 16, max_len 128 — a 128 multiple, so the page
tables are as wide as the JAX engine's. Engine runs on the CPU take the
paged-attention plain version (the port's "auto") against the JAX gather
path (its "auto" on the CPU); both are exact in fp32 up to summation
order, and token equality is required.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.engine import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.paging import NULL_PAGE as JAX_NULL_PAGE
from deepspeed_tpu.serving.paging import PageAllocator as JaxPageAllocator
from deepspeed_tpu.serving.paging import PagingConfig as JaxPagingConfig
from deepspeed_tpu.serving.paging import PrefixCache as JaxPrefixCache
from deepspeed_tpu_torch.inference.generation import generate
from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine
from deepspeed_tpu_torch.serving.paging import (NULL_PAGE, PageAllocator,
                                                PagingConfig, PrefixCache)
from tests.test_torch_model import TINY, jax_gpt, port_gpt
from tests.torch_threads import share_cores

share_cores()

VOCAB = TINY["vocab_size"]
PAGE = 16


@pytest.fixture(scope="module")
def models():
    jm, params = jax_gpt(seed=7)
    return jm, params, port_gpt(jm, params)


def _ref(model, prompt, n):
    return generate(model, prompt[None], max_new_tokens=n)[0, len(prompt):
                                                           ].tolist()


def _prompts(seed, n, lo, hi, prefix=None):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tail = r.randint(1, VOCAB, size=int(r.randint(lo, hi))).astype(
            np.int32)
        out.append(tail if prefix is None else np.concatenate([prefix, tail]))
    return out


def _paging(**kw):
    return {"page_len": PAGE, "prefill_chunk": 16, **kw}


# ---------------------------------------------------------------------------
# the copied allocator and prefix cache, driven like the JAX package's
# (tests/unit/test_serving_paging.py:112-236), results compared
# ---------------------------------------------------------------------------

def _attempt(log, fn, *args):
    try:
        log.append(fn(*args))
    except ValueError as e:
        log.append(f"ValueError: {e}")


def _sc_alloc_roundtrip(A, C, null, log):
    a = A(9)
    pages = a.alloc(3)
    log += [pages, null in pages, a.pages_in_use,
            [a.refcount(p) for p in pages], sorted(a.release(pages)),
            a.free_pages]
    a.check()


def _sc_all_or_nothing(A, C, null, log):
    a = A(5)
    log += [a.alloc(5), a.free_pages, a.alloc(4), a.alloc(1)]
    a.check()


def _sc_shared_lifecycle(A, C, null, log):
    a = A(4)
    (page,) = a.alloc(1)
    a.retain([page])
    log += [a.refcount(page), a.release([page]), a.free_pages,
            a.release([page]), a.free_pages]
    a.check()


def _sc_misuse(A, C, null, log):
    a = A(4)
    (page,) = a.alloc(1)
    a.release([page])
    _attempt(log, a.release, [page])
    _attempt(log, a.retain, [page])
    _attempt(log, a.alloc, -1)
    a.check()


def _sc_random_exercise(A, C, null, log):
    r = np.random.RandomState(0)
    a = A(17)
    live = []
    for _ in range(300):
        op = r.randint(3)
        if op == 0:
            got = a.alloc(int(r.randint(1, 4)))
            log.append(got)
            if got is not None:
                live.append(got)
        elif op == 1 and live:
            run = live[r.randint(len(live))]
            a.retain(run)
            live.append(list(run))
        elif op == 2 and live:
            log.append(a.release(live.pop(r.randint(len(live)))))
        a.check()
    for run in live:
        log.append(a.release(run))
    log.append(a.free_pages)


def _sc_miss_insert_hit(A, C, null, log):
    a = A(17)
    c = C(4, a)
    toks = list(range(100, 112))
    log.append(c.match(toks))
    pages = a.alloc(3)
    log += [c.insert(toks, pages), [a.refcount(p) for p in pages],
            c.match(toks), c.match(toks + [1, 2, 3, 4, 5]),
            c.match(toks[:4] + [9] * 8)]
    c.note_admitted(2)
    c.note_admitted(0)
    log.append(c.stats())


def _sc_insert_dedup(A, C, null, log):
    a = A(17)
    c = C(4, a)
    toks = list(range(8))
    first = a.alloc(2)
    log.append(c.insert(toks, first))
    dup = a.alloc(2)
    log += [c.insert(toks, dup), c.match(toks + [1] * 4), a.refcount(dup[0])]
    a.check()


def _sc_evict_leaf_lru(A, C, null, log):
    a = A(5)
    c = C(4, a)
    old = a.alloc(2)
    c.insert(list(range(8)), old)
    a.release(old)
    new = a.alloc(2)
    c.insert(list(range(50, 58)), new)
    a.release(new)
    log += [a.free_pages, c.evict(1), a.refcount(old[1]), a.refcount(old[0]),
            c.match(list(range(8)) + [1] * 4), c.stats()]
    a.check()


def _sc_evict_live_reader(A, C, null, log):
    a = A(3)
    c = C(4, a)
    run = a.alloc(2)
    c.insert(list(range(8)), run)
    a.retain(run)
    a.release(run)
    log += [c.evict(2), c.stats()["prefix_nodes"], a.free_pages,
            c.match(list(range(8)) + [0] * 4)]
    a.release(run)
    log += [c.evict(2), c.stats(), a.free_pages]
    a.check()


@pytest.mark.parametrize("scenario", [
    _sc_alloc_roundtrip, _sc_all_or_nothing, _sc_shared_lifecycle,
    _sc_misuse, _sc_random_exercise, _sc_miss_insert_hit, _sc_insert_dedup,
    _sc_evict_leaf_lru, _sc_evict_live_reader], ids=lambda f: f.__name__[4:])
def test_allocator_and_prefix_cache_match_jax(scenario):
    jax_log, port_log = [], []
    scenario(JaxPageAllocator, JaxPrefixCache, JAX_NULL_PAGE, jax_log)
    scenario(PageAllocator, PrefixCache, NULL_PAGE, port_log)
    assert port_log == jax_log


def test_paging_config_validation():
    p = PagingConfig()
    assert p.enabled and p.page_len == 128 and p.chunk_tokens == 128
    assert p.pool_pages(num_slots=4, cache_len=1024) == 4 * 8 + 1
    for bad, match in ((dict(page_len=0), "page_len"),
                       (dict(page_len=96), "must divide"),
                       (dict(page_len=16, prefill_chunk=24), "prefill_chunk"),
                       (dict(page_len=16, max_chunks_per_iter=0),
                        "max_chunks_per_iter"),
                       (dict(page_len=16, num_pages=8), "num_pages"),
                       (dict(kernel="sometimes"), "kernel")):
        with pytest.raises(ValueError, match=match):
            PagingConfig(**bad).validate(128)
    cfg = ServingConfig(num_slots=2, max_len=128, paging={"page_len": 16})
    assert isinstance(cfg.paging, PagingConfig) and cfg.validate().paged
    assert not ServingConfig(num_slots=2, paging={"enabled": False}).paged
    # the port takes any page_len dividing max_len (the JAX package needs
    # a 128 multiple for its TPU kernel)
    ServingConfig(num_slots=2, max_len=96, paging={"page_len": 32}).validate()


# ---------------------------------------------------------------------------
# the paged engine against the JAX paged engine
# ---------------------------------------------------------------------------

def _drive_lockstep(eng, prompts, outs, paged_of):
    """Submit everything, then advance to the end recording, each
    iteration, which physical pages each live request holds."""
    reqs = [eng.submit(p, max_new_tokens=o) for p, o in zip(prompts, outs)]
    pages = []
    while eng.busy:
        eng.advance()
        pages.append(sorted(
            (req.request_id, tuple(paged_of(eng, slot)))
            for slot, req in enumerate(eng._slot_req) if req is not None))
    return [list(r.output_tokens) for r in reqs], pages


def test_paged_engine_matches_jax_paged_engine(models):
    jm, params, model = models
    r = np.random.RandomState(21)
    sys_p = r.randint(1, VOCAB, size=40).astype(np.int32)
    prompts = (_prompts(22, 4, 2, 30, prefix=sys_p)
               + _prompts(23, 3, 20, 70))
    outs = [int(o) for o in r.randint(2, 9, size=len(prompts))]
    knobs = dict(num_slots=3, max_len=128, prefill_bucket=16, seed=0)
    paging = dict(page_len=PAGE, prefill_chunk=32, num_pages=17,
                  max_chunks_per_iter=2)
    jeng = JaxServingEngine(jm, params, JaxServingConfig(
        **knobs, paging=JaxPagingConfig(**paging)))
    peng = ServingEngine(model, ServingConfig(**knobs, paging=paging))
    j_toks, j_pages = _drive_lockstep(
        jeng, prompts, outs, lambda e, s: e._paged._slot_pages[s])
    p_toks, p_pages = _drive_lockstep(
        peng, prompts, outs, lambda e, s: e._paged.slot_pages(s))
    assert p_toks == j_toks
    assert p_pages == j_pages
    js, ps = jeng.metrics.snapshot(), peng.metrics.snapshot()
    for key in ("prefill_chunks", "prefill_tokens_computed",
                "prefill_tokens_reused", "prefix_lookups", "prefix_hits",
                "prefix_pages_reused", "prefix_pages_evicted",
                "prefix_nodes", "decode_iterations", "requests_finished"):
        assert ps[key] == js[key], key
    assert ps["prefix_hits"] >= 1
    peng._paged.allocator.check()


# ---------------------------------------------------------------------------
# the paged engine against the port's generate() and contiguous engine
# ---------------------------------------------------------------------------

def test_paged_matches_generate_and_contiguous_engine(models):
    _, _, model = models
    prompts = _prompts(31, 9, 3, 60)
    outs = [int(o) for o in np.random.RandomState(32).randint(1, 9, size=9)]
    engines = {
        "contiguous": ServingEngine(model, ServingConfig(
            num_slots=3, max_len=128, prefill_bucket=16)),
        "paged": ServingEngine(model, ServingConfig(
            num_slots=3, max_len=128, prefill_bucket=16,
            paging=_paging(prefill_chunk=32))),
        "paged gather": ServingEngine(model, ServingConfig(
            num_slots=3, max_len=128, prefill_bucket=16,
            paging=_paging(kernel="off"))),
    }
    toks = {}
    for name, eng in engines.items():
        reqs = [eng.submit(p, max_new_tokens=o)
                for p, o in zip(prompts, outs)]
        eng.run()
        toks[name] = [list(r.output_tokens) for r in reqs]
    assert toks["paged"] == toks["contiguous"] == toks["paged gather"]
    assert toks["paged"] == [_ref(model, p, o) for p, o in zip(prompts, outs)]
    mgr = engines["paged"]._paged
    mgr.allocator.check()
    assert engines["paged gather"]._paged.decode_gather_transient_bytes() > 0
    assert mgr.decode_gather_transient_bytes() == 0


def test_long_prompt_interleaves_with_decode(models):
    """A 100-token prompt prefills in 7 page chunks while the running
    decode batch advances one step per chunk."""
    _, _, model = models
    r = np.random.RandomState(3)
    eng = ServingEngine(model, ServingConfig(
        num_slots=3, max_len=128, prefill_bucket=16, paging=_paging()))
    short = [r.randint(1, VOCAB, size=5).astype(np.int32) for _ in range(2)]
    sreqs = [eng.submit(p, max_new_tokens=20) for p in short]
    for _ in range(3):
        eng.advance()
    long_p = r.randint(1, VOCAB, size=100).astype(np.int32)
    lreq = eng.submit(long_p, max_new_tokens=4)
    eng.advance()                      # admits the long prompt + chunk 1
    decodes = []
    while eng._prefill_tasks:
        eng.advance()
        decodes.append(eng.metrics.decode_iterations)
    eng.run()
    assert len(decodes) == 6
    assert decodes == list(range(decodes[0], decodes[0] + 6))
    assert eng.metrics.prefill_chunks == 2 + 7
    assert lreq.output_tokens == _ref(model, long_p, 4)
    for req, p in zip(sreqs, short):
        assert req.output_tokens == _ref(model, p, 20)


def test_chunk_budget_per_iteration(models):
    _, _, model = models
    long_p = np.random.RandomState(5).randint(1, VOCAB, size=90).astype(
        np.int32)
    eng = ServingEngine(model, ServingConfig(
        num_slots=2, max_len=128, prefill_bucket=16,
        paging=_paging(max_chunks_per_iter=4)))
    req = eng.submit(long_p, max_new_tokens=3)
    eng.advance()
    assert eng.metrics.prefill_chunks == 4
    eng.advance()
    assert eng.metrics.prefill_chunks == 6
    eng.run()
    assert req.output_tokens == _ref(model, long_p, 3)


def test_shared_system_prompt_reuses_pages(models):
    _, _, model = models
    sys_p = np.random.RandomState(11).randint(1, VOCAB, size=48).astype(
        np.int32)
    prompts = _prompts(12, 6, 2, 10, prefix=sys_p)
    eng = ServingEngine(model, ServingConfig(
        num_slots=2, max_len=128, prefill_bucket=16, paging=_paging()))
    reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
    eng.run()
    for req, p in zip(reqs, prompts):
        assert req.output_tokens == _ref(model, p, 4)
    snap = eng.metrics.snapshot()
    # the first two admit together; the four later ones hit 3 shared pages
    assert snap["prefix_hits"] >= 4
    assert snap["prefix_tokens_reused"] >= 4 * 48
    assert (snap["prefill_tokens_reused"] + snap["prefill_tokens_computed"]
            == sum(len(p) for p in prompts))
    assert snap["page_utilization"] > 0 and "prefix_hit_rate" in snap


def test_starvation_evicts_prefix_then_admits(models):
    _, _, model = models
    r = np.random.RandomState(13)
    eng = ServingEngine(model, ServingConfig(
        num_slots=2, max_len=128, prefill_bucket=16,
        paging=_paging(num_pages=9)))            # one full-length row
    first_p = r.randint(1, VOCAB, size=40).astype(np.int32)
    first = eng.submit(first_p, max_new_tokens=4)
    eng.run()
    assert first.output_tokens == _ref(model, first_p, 4)
    assert eng._paged.stats()["prefix_nodes"] == 2
    big_p = r.randint(1, VOCAB, size=100).astype(np.int32)
    big = eng.submit(big_p, max_new_tokens=8)    # needs 7 of 8 pages
    eng.run()
    assert big.output_tokens == _ref(model, big_p, 8)
    assert eng._paged.stats()["prefix_pages_evicted"] >= 1
    eng._paged.allocator.check()


def test_cancel_releases_pages(models):
    _, _, model = models
    prompts = _prompts(41, 4, 20, 50)
    eng = ServingEngine(model, ServingConfig(
        num_slots=2, max_len=128, prefill_bucket=16,
        paging=_paging(enable_prefix_cache=False)))
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.advance()                      # admits 0 and 1 (pages held)
    held = eng._paged.allocator.pages_in_use
    assert held == sum(eng._paged.pages_for(len(p), 10) for p in prompts[:2])
    assert eng.cancel(reqs[0].request_id)          # mid-prefill
    assert eng._paged.allocator.pages_in_use == held - eng._paged.pages_for(
        len(prompts[0]), 10)
    assert eng.cancel(reqs[3].request_id)          # queued
    eng.run()
    assert reqs[0].status == reqs[3].status == "cancelled"
    for i in (1, 2):
        assert reqs[i].output_tokens == _ref(model, prompts[i], 10)
    assert eng._paged.allocator.pages_in_use == 0
    eng._paged.allocator.check()
