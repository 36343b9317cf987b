"""The port's self-speculative decoding against the JAX package's, on the
CPU in fp32.

``NgramProposer`` proposes JAX's tokens on random and tiled sequences. The
per-row multi-token decode step (speculative verification: each row writes
its K + 1 tokens at its own frontier and attends over the whole cache
capacity under the mask ``col <= idx + i``) gives JAX's logits and cache
within 1e-5, for a GPT-2 layout and a rotary one with ``[b, s]``
positions. The speculative engine, contiguous and paged, emits JAX's
speculative engine's tokens on the same iterations (so the same tokens
were accepted a step) with the same proposed and accepted totals, and the
port's non-speculative engine's tokens; rollbacks across page edges, chunked
prefill and preemption with resumption keep ``generate()``'s tokens and a
clean page allocator. ``cache_len``'s speculation headroom gives JAX's
capacities, buckets and page tables.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.cache import set_cache_index as jax_set_index
from deepspeed_tpu.inference.generation import _prefill_impl as jax_prefill
from deepspeed_tpu.inference.generation import init_cache as jax_init_cache
from deepspeed_tpu.serving import PagingConfig as JaxPagingConfig
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import SpeculationConfig as JaxSpecConfig
from deepspeed_tpu.serving.engine import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.speculation import NgramProposer as JaxProposer
from deepspeed_tpu_torch.inference.cache import set_cache_index
from deepspeed_tpu_torch.inference.generation import generate, init_cache
from deepspeed_tpu_torch.serving import (PagingConfig, QosConfig,
                                         ServingConfig, ServingEngine,
                                         SpeculationConfig)
from deepspeed_tpu_torch.serving.speculation import NgramProposer
from tests.test_torch_model import TINY, jax_gpt, port_gpt
from tests.test_torch_rotary import jax_rotary_gpt, port_of
from tests.torch_threads import share_cores

share_cores()

VOCAB = TINY["vocab_size"]
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jm, params = jax_gpt(seed=11)
    return jm, params, port_gpt(jm, params)


def _motif(r, n, motif_len=3):
    motif = r.randint(1, VOCAB, size=motif_len).astype(np.int32)
    return np.tile(motif, -(-n // motif_len))[:n]


def _workload(seed, n=7):
    """Half self-similar (a short motif tiled), half uniform prompts."""
    r = np.random.RandomState(seed)
    prompts, outs = [], []
    for i in range(n):
        k = int(r.randint(6, 30))
        prompts.append(_motif(r, k) if i % 2 == 0
                       else r.randint(1, VOCAB, size=k).astype(np.int32))
        outs.append(int(r.randint(4, 16)))
    return prompts, outs


def _ref(model, prompt, max_new):
    return generate(model, np.asarray(prompt)[None],
                    max_new_tokens=max_new)[0, len(prompt):].tolist()


def _run_checked(eng):
    """Advance to the end, holding the page allocator after every
    iteration (a leaked or double-freed page fails where it happens)."""
    while eng.busy:
        eng.advance()
        if eng._paged is not None:
            eng._paged.allocator.check()


# ---------------------------------------------------------------------------
# the proposer and the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "tiled"])
def test_ngram_proposer_matches_jax(kind):
    r = np.random.RandomState(0 if kind == "random" else 1)
    cfg = SpeculationConfig(ngram_max=3, ngram_min=1)
    ours, theirs = NgramProposer(cfg), JaxProposer(JaxSpecConfig(
        ngram_max=3, ngram_min=1))
    proposed = 0
    for _ in range(60):
        n = int(r.randint(1, 40))
        seq = (_motif(r, n, int(r.randint(1, 6))) if kind == "tiled"
               else r.randint(1, 8, size=n).astype(np.int32))
        for k in (0, 1, 4, 7):
            got, want = ours.propose(seq, k), theirs.propose(seq, k)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.int32
            proposed += got.size
    assert proposed > 0


@pytest.mark.parametrize("bad", [
    dict(max_spec_tokens=0), dict(ngram_min=0),
    dict(ngram_min=3, ngram_max=2)])
def test_speculation_config_refusals_match_jax(bad):
    for cls in (SpeculationConfig, JaxSpecConfig):
        with pytest.raises(ValueError):
            cls(**bad).validate(0.0)
    # greedy only: a sampling engine refuses the block
    for cfg, spec in ((ServingConfig, SpeculationConfig),
                      (JaxServingConfig, JaxSpecConfig)):
        with pytest.raises(ValueError, match="greedy"):
            cfg(temperature=0.7, speculation=spec()).validate()


@pytest.mark.parametrize("max_len,page_len", [(100, 16), (124, 16),
                                              (128, 32), (1020, 128)])
def test_cache_len_headroom_and_page_tables_match_jax(models, max_len,
                                                      page_len):
    for k in (1, 4, 8):
        ours = ServingConfig(max_len=max_len, prefill_bucket=16,
                             paging={"page_len": page_len},
                             speculation={"max_spec_tokens": k}).validate()
        theirs = JaxServingConfig(
            max_len=max_len, prefill_bucket=16,
            paging=JaxPagingConfig(page_len=page_len),
            speculation=JaxSpecConfig(max_spec_tokens=k)).validate()
        assert ours.cache_len == theirs.cache_len >= max_len + k
        assert ours.bucket_lengths() == theirs.bucket_lengths()
        assert (ours.paging.pool_pages(8, ours.cache_len)
                == theirs.paging.pool_pages(8, theirs.cache_len))
    # the engine's page tables are that wide
    _, _, model = models
    eng = ServingEngine(model, ServingConfig(
        num_slots=3, max_len=125, prefill_bucket=16,
        paging={"page_len": 16}, speculation={"max_spec_tokens": 4}))
    assert eng.config.cache_len == 256
    assert tuple(eng._paged.page_table.shape) == (3, 256 // 16)
    assert ServingConfig(max_len=125).cache_len == 128   # no headroom


# ---------------------------------------------------------------------------
# the per-row multi-token step
# ---------------------------------------------------------------------------

def _per_row_step(jm, params, model):
    """Prefill 3 rows of 24 tokens in both packages, move each row's
    frontier to its own index, run one 5-token step per row; returns the
    logits and caches of both (the port's as numpy [L, b, h, S, d])."""
    b, p_len, s, cap = 3, 24, 5, 64
    r = np.random.RandomState(2)
    ids = r.randint(1, VOCAB, size=(b, p_len)).astype(np.int32)
    step = r.randint(1, VOCAB, size=(b, s)).astype(np.int32)
    idx = np.array([3, 24, 13], np.int32)
    pos = (idx[:, None] + np.arange(s)[None]).astype(np.int32)   # [b, s]

    jcache = jax_init_cache(jm, params, b, cap)
    _, jcache = jax_prefill(jm, params, jcache, jnp.asarray(ids),
                            jnp.arange(p_len))
    jcache = jax_set_index(jcache, jnp.asarray(idx))
    jlogits, var = jax.jit(lambda c, t, q: jm.apply(
        {"params": params, "cache": c}, t, decode=True, positions=q,
        mutable=["cache"]))(jcache, jnp.asarray(step), jnp.asarray(pos))
    jk = np.asarray(var["cache"]["h"]["attn"]["cached_key"])
    jv = np.asarray(var["cache"]["h"]["attn"]["cached_value"])

    cache = init_cache(model, b, cap)
    with torch.no_grad():
        model(torch.from_numpy(ids).long(), positions=torch.arange(p_len),
              cache=cache)
        set_cache_index(cache, idx)
        logits = model(torch.from_numpy(step).long(),
                       positions=torch.from_numpy(pos).long(), cache=cache)
    assert torch.equal(cache.index, torch.from_numpy(idx + s))
    return (logits.numpy(), np.asarray(jlogits),
            (cache.k.numpy(), cache.v.numpy()),
            (jk.transpose(0, 1, 2, 4, 3), jv.transpose(0, 1, 2, 4, 3)))


@pytest.mark.parametrize("layout", ["gpt2", "rotary"])
def test_per_row_multi_token_step_matches_jax(models, layout):
    if layout == "gpt2":
        jm, params, model = models
    else:
        jm, params = jax_rotary_gpt()
        model = port_of(jm, params)
    logits, jlogits, kv, jkv = _per_row_step(jm, params, model)
    np.testing.assert_allclose(logits, jlogits, atol=ATOL, rtol=0)
    for ours, theirs in zip(kv, jkv):
        np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the speculative engine
# ---------------------------------------------------------------------------

def _serve(eng, prompts, outs):
    """Submit and run; per request, its tokens and the engine iteration
    each token was streamed at (equal schedules mean equal acceptance)."""
    marks = {}

    def on_token(req, tok):
        marks.setdefault(req.request_id, []).append(eng.iteration)

    reqs = [eng.submit(p, o, request_id=i, on_token=on_token)
            for i, (p, o) in enumerate(zip(prompts, outs))]
    _run_checked(eng)
    return [(q.output_tokens, marks[q.request_id]) for q in reqs]


@pytest.mark.parametrize("paged", [False, True])
def test_spec_engine_matches_jax_and_the_plain_engine(models, paged):
    jm, params, model = models
    prompts, outs = _workload(seed=3 + paged)
    knobs = dict(num_slots=3, max_len=128, prefill_bucket=16)
    ours = ServingEngine(model, ServingConfig(
        **knobs, paging=PagingConfig(page_len=16) if paged else None,
        speculation=SpeculationConfig()))
    got = _serve(ours, prompts, outs)
    theirs = JaxServingEngine(jm, params, JaxServingConfig(
        **knobs, paging=JaxPagingConfig(page_len=16) if paged else None,
        speculation=JaxSpecConfig()))
    want = _serve(theirs, prompts, outs)
    assert got == want
    snap, jsnap = ours.metrics.snapshot(), theirs.metrics.snapshot()
    for key in ("spec_proposed_tokens", "spec_accepted_tokens",
                "decode_iterations", "tokens_generated"):
        assert snap[key] == jsnap[key], key
    assert snap["spec_proposed_tokens"] > 0 < snap["spec_accepted_tokens"]
    assert snap["decode_iterations"] < sum(outs)
    plain = ServingEngine(model, ServingConfig(
        **knobs, paging=PagingConfig(page_len=16) if paged else None))
    assert [t for t, _ in _serve(plain, prompts, outs)] == \
        [t for t, _ in got]
    for (tokens, _), p, o in zip(got, prompts, outs):
        assert tokens == _ref(model, p, o)
    if paged:
        stats = ours._paged.stats()
        assert stats["pages_in_use"] == stats["prefix_nodes"]
    theirs.close()


class _Oracle:
    """Proposes each request's true greedy continuation (full
    acceptance)."""

    def __init__(self, fulls):
        self.fulls = [np.asarray(f, np.int32) for f in fulls]

    def propose(self, seq, k):
        n = len(seq)
        for full in self.fulls:
            if n <= len(full) and (full[:n] == seq).all():
                return full[n:n + k].astype(np.int32)
        return np.zeros((0,), np.int32)


class _Adversary(_Oracle):
    """Proposes the true continuation + 1: every proposal is rejected at
    its first token."""

    def propose(self, seq, k):
        return ((super().propose(seq, k) + 1) % VOCAB).astype(np.int32)


@pytest.mark.parametrize("proposer", ["oracle", "adversary"])
def test_rollback_across_page_boundaries(models, proposer):
    """Frontiers that cross a page edge inside the verification window,
    under full acceptance and full rejection: tokens exact, the allocator
    clean after every iteration."""
    _, _, model = models
    r = np.random.RandomState(4)
    cases = [(14, 12), (15, 12), (16, 12), (30, 12)]
    prompts = [r.randint(1, VOCAB, size=n).astype(np.int32)
               for n, _ in cases]
    refs = [_ref(model, p, o) for p, (_, o) in zip(prompts, cases)]
    fulls = [np.concatenate([p, f]) for p, f in zip(prompts, refs)]
    eng = ServingEngine(model, ServingConfig(
        num_slots=2, max_len=128, prefill_bucket=16,
        paging=PagingConfig(page_len=16), speculation=SpeculationConfig()))
    eng._spec = (_Oracle if proposer == "oracle" else _Adversary)(fulls)
    reqs = [eng.submit(p, o) for p, (_, o) in zip(prompts, cases)]
    _run_checked(eng)
    assert [q.output_tokens for q in reqs] == refs
    snap = eng.metrics.snapshot()
    assert snap["spec_proposed_tokens"] > 0
    if proposer == "oracle":
        assert snap["spec_acceptance_rate"] == 1.0
    else:
        assert snap["spec_accepted_tokens"] == 0
        assert snap["decode_iterations"] >= max(o for _, o in cases) - 1


def test_speculation_with_chunked_prefill(models):
    _, _, model = models
    r = np.random.RandomState(5)
    prompts = [_motif(r, 40, 4), r.randint(1, VOCAB, size=37).astype(
        np.int32)]
    eng = ServingEngine(model, ServingConfig(
        num_slots=2, max_len=128, prefill_bucket=16,
        paging=PagingConfig(page_len=16, prefill_chunk=16),
        speculation=SpeculationConfig()))
    reqs = [eng.submit(p, 12) for p in prompts]
    _run_checked(eng)
    for q, p in zip(reqs, prompts):
        assert q.output_tokens == _ref(model, p, 12)
    snap = eng.metrics.snapshot()
    assert snap["prefill_chunks"] > 2 and snap["spec_proposed_tokens"] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_speculation_with_preemption_and_resume(models, paged):
    """Two low-priority self-similar requests fill the slots and
    speculate; a late high-priority one preempts one back to the queue;
    everyone ends with generate()'s tokens."""
    _, _, model = models
    r = np.random.RandomState(6)
    qos = QosConfig(classes=[
        {"name": "interactive", "priority": 2, "preempt_after_steps": 1,
         "sheddable": False},
        {"name": "batch", "priority": 0}])
    eng = ServingEngine(model, ServingConfig(
        num_slots=2, max_len=128, prefill_bucket=16, qos=qos,
        paging=PagingConfig(page_len=16) if paged else None,
        speculation=SpeculationConfig()))
    lows = [eng.submit(_motif(r, 12), 40, priority=0) for _ in range(2)]
    for _ in range(4):
        eng.advance()
    hi = eng.submit(r.randint(1, VOCAB, size=5), 6, priority=2)
    _run_checked(eng)
    assert sum(q.preemptions for q in lows) == 1
    snap = eng.metrics.snapshot()
    assert snap["requests_resumed"] == 1 and snap["spec_proposed_tokens"]
    for q in [hi] + lows:
        assert q.status == "finished"
        assert q.output_tokens == _ref(model, q.prompt, q.max_new_tokens)
