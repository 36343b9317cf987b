"""Continuous-batching serving engine (counterpart of
``deepspeed_tpu/serving/engine.py``) over contiguous slots or a paged KV
pool, FIFO admission, optional int8 weights and int8 KV pages.

Contiguous (no ``paging`` block): the engine owns ``num_slots``
preallocated cache rows and runs two device programs:

- ``_admit_impl``: prefill one request (right-padded to its length
  bucket) through a single-row scratch cache, copy the row into its slot,
  sample its first token and activate the slot's state row;
- ``_decode_iter_impl``: one single-token decode step over every slot —
  per-slot lengths (per-row cache index, so the decode kernel masks each
  slot to its own valid prefix), per-slot positions, per-slot eos/budget
  completion. Free slots ride along masked.

Paged (``paging`` block, ``paging/manager.py``): admission gates on free
pages (prefix-cache hits are referenced, not recomputed), prompts prefill
in page-aligned chunks (at most ``max_chunks_per_iter`` per iteration,
interleaved with decode), and decode attends straight over the pool
through the paged-attention kernel (``paging.kernel`` "off": the gather
path). ``quantize.weights: int8`` serves an int8 copy of the model
through the ``wo_int8_matmul`` kernels; ``quantize.kv: int8`` stores the
pool int8. QoS, speculation and the fleet come with later slices.

Requests queue on the host (``scheduler.py``) and are admitted into free
slots between decode steps. Token readback is pipelined: each dispatch
copies its tokens into pinned host memory behind a CUDA event, and the
host waits on that event only ``pipeline_depth`` dispatches later, so the
device runs step k+1 while the host streams step k. Nothing else in the
loop synchronises with the device.
"""

from collections import deque
from typing import Optional

import numpy as np
import torch

from ..inference.cache import (cache_max_len, make_row_cache,
                               set_cache_index, write_cache_row)
from ..inference.generation import (_prefill_impl, _sample_impl,
                                    _sampling_mode, init_cache)
from ..module_inject.module_quantize import (quantize_for_serving,
                                             quantized_nbytes)
from .config import ServingConfig
from .metrics import ServingMetrics
from .request import Request
from .paging.manager import (PagedKVManager, _chunk_prefill_impl,
                             _paged_decode_iter_impl)
from .scheduler import FifoScheduler


def _admit_impl(model, cache, state, prompt, prompt_len: int, slot: int,
                max_new: int, generator, eos_id: int, mode):
    """Prefill ``prompt`` ([1, bucket], right-padded) through a fresh
    single-row cache, copy the row into ``slot``, sample the first token
    from position ``prompt_len - 1`` and activate the slot's state row (in
    place). The pad tail's K/V sits at positions >= prompt_len, which the
    slot's length mask never reads and later decode tokens overwrite in
    order (a bucket may pass ``max_seq_len`` when ``cache_len`` does:
    ``GPT.forward`` clamps its learned-position gather, and rotary takes
    the raw positions, as JAX's). Returns (token, done) as device
    tensors."""
    row = make_row_cache(cache)
    positions = torch.arange(prompt.shape[1], device=prompt.device)
    logits = _prefill_impl(model, row, prompt, positions)
    tok = _sample_impl(logits[:, prompt_len - 1], generator, mode)[0]
    write_cache_row(cache, row, slot)
    remaining = max_new - 1
    # eos_id is -1 when eos is disabled: sampled tokens are always >= 0
    done = (tok == eos_id) | (remaining <= 0)
    state["lengths"][slot] = prompt_len
    state["last_token"][slot] = tok
    state["active"][slot] = ~done
    state["remaining"][slot] = remaining
    return tok, done


def _decode_iter_impl(model, cache, state, generator, eos_id: int, mode):
    """One masked decode step over the full slot batch.

    Every slot runs; inactive slots write their token at a clamped
    position inside their own row (re-prefilled at the next admission)
    and their output is masked to -1. Positions are the write positions,
    as JAX's (only inactive slots can pass the model's position table,
    whose gather ``GPT.forward`` clamps). Returns (new state, tokens,
    done)."""
    lengths, active = state["lengths"], state["active"]
    idx_w = lengths.clamp(max=cache_max_len(cache) - 1)
    set_cache_index(cache, idx_w)
    positions = idx_w[:, None]
    logits = model(state["last_token"][:, None], positions=positions,
                   cache=cache)
    nxt = _sample_impl(logits[:, -1, :], generator, mode)

    remaining = torch.where(active, state["remaining"] - 1,
                            state["remaining"])
    done = active & ((nxt == eos_id) | (remaining <= 0))
    new_state = {
        "lengths": torch.where(active, lengths + 1, lengths),
        "last_token": torch.where(active, nxt, state["last_token"]),
        "active": active & ~done,
        "remaining": remaining,
    }
    return new_state, torch.where(active, nxt, -1), done


class _Readback:
    """A dispatch's outputs on their way to the host. On a CUDA device
    they are copied into pinned host buffers behind an event, and only
    ``numpy()`` waits on that event."""

    def __init__(self, *tensors):
        self._event = None
        if tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in tensors]
            for host, t in zip(self._host, tensors):
                host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(tensors)

    def numpy(self):
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class ServingEngine:
    """Continuous-batching serving over a fixed slot pool.

    Usage::

        eng = ServingEngine(model, ServingConfig(num_slots=8, max_len=1024))
        reqs = [eng.submit(prompt, max_new_tokens=64) for prompt in work]
        eng.run()                      # or: interleave submit()/advance()
        reqs[0].output_tokens          # streamed per token via on_token=

    The model's device is the engine's. ``generator`` drives sampling when
    ``temperature > 0`` (default: seeded from ``config.seed``).
    """

    def __init__(self, model, config: Optional[ServingConfig] = None, *,
                 generator: Optional[torch.Generator] = None, **overrides):
        if config is None:
            config = ServingConfig(**overrides)
        elif isinstance(config, dict):
            config = ServingConfig(**{**config, **overrides})
        elif overrides:
            raise ValueError("pass knobs either via config= or as keyword "
                             "overrides, not both")
        self.config = config.validate()
        if self.config.weights_int8:
            # an int8 copy (the caller's model is untouched); a model that
            # is already int8 passes through
            model = quantize_for_serving(
                model, min_size=self.config.quantize.min_size)
        self.module = model
        model_max = model.config.max_seq_len
        if self.config.max_len > model_max:
            raise ValueError(
                f"serving.max_len={self.config.max_len} exceeds the "
                f"model's max_seq_len {model_max}")
        self.device = model.wte.device
        self._mode = _sampling_mode(self.config.temperature,
                                    self.config.top_k, self.config.top_p)
        self._gen = generator or torch.Generator(
            device=self.device).manual_seed(self.config.seed)
        # -1 when eos is disabled: the device comparison never fires
        self._eos = (self.config.eos_token_id
                     if self.config.eos_token_id is not None else -1)
        n = self.config.num_slots
        self._paged = None
        if self.config.paged:
            # the manager owns the pool, allocator, prefix cache and page
            # tables; no contiguous slot rows exist
            self._paged = PagedKVManager(model, self.config)
            self._cache = None
            self._prefill_tasks = deque()   # (slot, req, prompt, max_new,
                                            #  [chunk plans])
        else:
            self._cache = set_cache_index(
                init_cache(model, n, self.config.cache_len),
                torch.zeros(n, dtype=torch.int32))
        self._state = {
            "lengths": torch.zeros(n, dtype=torch.int32, device=self.device),
            "last_token": torch.zeros(n, dtype=torch.int64,
                                      device=self.device),
            "active": torch.zeros(n, dtype=torch.bool, device=self.device),
            "remaining": torch.zeros(n, dtype=torch.int32,
                                     device=self.device),
        }
        self.scheduler = FifoScheduler(self.config)
        self.metrics = ServingMetrics()
        self._slot_req = [None] * n       # host view of slot -> Request
        self._free = deque(range(n))
        self._pending = deque()           # in-flight readbacks, FIFO
        self._iteration = 0
        self._seq = 0

    # -- client API --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               request_id=None, on_token=None,
               deadline_steps: Optional[int] = None) -> Request:
        """Queue one request; returns its live ``Request`` handle.
        ``deadline_steps`` is a queue TTL on the engine-iteration clock
        (default ``config.default_deadline_steps``; None waits forever)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens is None:
            max_new_tokens = self.config.default_max_new_tokens
        if deadline_steps is None:
            deadline_steps = self.config.default_deadline_steps
        vocab = self.module.config.vocab_size
        try:
            self.scheduler.validate_request(prompt.shape[0], max_new_tokens)
            if prompt.min() < 0 or prompt.max() >= vocab:
                raise ValueError(f"token ids must lie in [0, {vocab})")
        except ValueError:
            self.metrics.on_reject()
            raise
        if request_id is None:
            request_id = self._seq
        req = Request(prompt, max_new_tokens, request_id, on_token=on_token,
                      deadline_steps=deadline_steps)
        req.submitted_iteration = self._iteration
        req._seq = self._seq
        self._seq += 1
        try:
            self.scheduler.add(req)
        except RuntimeError:
            self.metrics.on_reject()
            raise
        self.metrics.on_submit()
        return req

    def cancel(self, request_id) -> bool:
        """Cancel one request by id: a queued request leaves the queue, an
        active one releases its slot immediately (its device row is
        deactivated; already-dispatched decode steps for it are dropped at
        harvest). Returns False when no live request carries the id."""
        req = self.scheduler.remove(request_id)
        if req is not None:
            req._cancelled(self._iteration)
            self.metrics.on_cancel()
            return True
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.request_id == request_id:
                self._state["active"][slot] = False
                self._state["remaining"][slot] = 0
                if self._paged is not None:
                    # drop its unfinished prefill chunks and return its
                    # page references (prefix-published pages live on
                    # through the tree's own reference)
                    self._prefill_tasks = deque(
                        t for t in self._prefill_tasks if t[0] != slot)
                    self._paged.release_slot(slot)
                self._slot_req[slot] = None
                self._free.append(slot)
                req._cancelled(self._iteration)
                self.metrics.on_cancel()
                return True
        return False

    def run(self, max_iterations: Optional[int] = None):
        """Drive admissions/decode/harvest until every submitted request
        has finished (or ``max_iterations`` engine iterations elapse)."""
        it = 0
        while self.busy:
            self.advance()
            it += 1
            if max_iterations is not None and it >= max_iterations:
                break

    @property
    def busy(self) -> bool:
        return bool(self.scheduler.depth or self._pending
                    or any(r is not None for r in self._slot_req))

    @property
    def num_free_slots(self) -> int:
        return len(self._free)

    # -- engine loop -------------------------------------------------------
    @torch.no_grad()
    def advance(self):
        """One engine iteration: expire overdue queued requests, admit into
        free slots, dispatch one decode over the slot batch, harvest
        readbacks beyond the pipeline depth. Safe to call when idle."""
        for req in self.scheduler.expire(self._iteration):
            req._timed_out(self._iteration)
            self.metrics.on_timeout()
        if self._paged is not None:
            self._admit_ready_paged()
            self._run_prefill_chunks()
        else:
            self._admit_ready()
        dispatched = self._dispatch_decode()
        # keep at most pipeline_depth dispatches in flight; drain fully
        # when nothing new was dispatched (tail of the workload)
        target = self.config.pipeline_depth if dispatched else 0
        while len(self._pending) > target:
            self._harvest_one()
        busy = sum(r is not None for r in self._slot_req)
        self.metrics.sample(self.scheduler.depth, busy,
                            self.config.num_slots,
                            paged=(self._paged.stats()
                                   if self._paged is not None else None))

    def memory_report(self) -> dict:
        """Resident bytes of the KV pool and of the weights (int8 against
        their dense equivalent); paged engines add the gather-path
        transient (0 on the kernel path), the page dtype and whether the
        paged-attention kernel runs."""
        if self._paged is not None:
            kv = self._paged.pool_bytes()
        else:
            kv = sum(t.numel() * t.element_size()
                     for t in (self._cache.k, self._cache.v))
        out = {"kv_pool_resident_bytes": kv,
               "params_bytes": quantized_nbytes(self.module)}
        if self._paged is not None:
            out["decode_gather_transient_bytes"] = \
                self._paged.decode_gather_transient_bytes()
            out["kv_page_dtype"] = (
                "int8" if self._paged.kv_quant
                else str(self._paged.dequant_dtype).replace("torch.", ""))
            out["paged_kernel"] = self._paged.use_kernel
        return out

    def _admit_ready(self):
        while self._free and self.scheduler.depth:
            req = self.scheduler.next_request()
            slot = self._free.popleft()
            prompt = req.effective_prompt()
            n = prompt.shape[0]
            padded = np.zeros((1, self.config.bucket_for(n)), np.int64)
            padded[0, :n] = prompt
            # pinned + non_blocking: the upload does not wait for the
            # decode steps still queued on the device
            prompt_t = torch.from_numpy(padded)
            if self.device.type == "cuda":
                prompt_t = prompt_t.pin_memory().to(self.device,
                                                    non_blocking=True)
            tok, done = _admit_impl(
                self.module, self._cache, self._state, prompt_t, n, slot,
                req.remaining_budget(), self._gen, self._eos, self._mode)
            self._slot_req[slot] = req
            req._admitted(slot, self._iteration)
            self.metrics.on_admit()
            self._pending.append(("admit", slot, req, _Readback(tok, done)))

    # -- paged admission + chunked prefill ---------------------------------
    def _peek_free_slot(self) -> Optional[int]:
        """The slot the next admission takes (None when all are taken)."""
        return self._free[0] if self._free else None

    def _take_slot(self, slot: int):
        self._free.remove(slot)

    def _admit_ready_paged(self):
        """Admit queued requests while pages cover them. Admission gates
        on free PAGES, not free slots: a page-starved queue head stays
        queued (order preserved) until running requests release pages or
        the prefix cache evicts."""
        while True:
            req = self.scheduler.peek()
            if req is None:
                return
            slot = self._peek_free_slot()
            if slot is None:
                return
            prompt = req.effective_prompt()
            max_new = req.remaining_budget()
            shared = self._paged.try_admit(slot, prompt, max_new)
            if shared is None:              # page-starved head
                return
            self.scheduler.next_request()   # actually pop it
            self._take_slot(slot)
            self._slot_req[slot] = req
            req._admitted(slot, self._iteration)
            self.metrics.on_admit(shared_tokens=shared)
            self._prefill_tasks.append(
                (slot, req, prompt, max_new,
                 self._plan_chunks(prompt, shared)))

    def _plan_chunks(self, prompt, shared_tokens: int):
        """Split the non-shared prefill tail into page-aligned chunks:
        full ``chunk_tokens`` chunks, then one tail chunk padded to the
        smallest page multiple covering the remainder. Always at least
        one chunk: the prefix match stops short of the last prompt token,
        whose logits seed sampling."""
        p_len = int(prompt.shape[0])
        page = self._paged.page_len
        cap = self._paged.chunk_tokens
        chunks, start = [], shared_tokens
        while start < p_len:
            remaining = p_len - start
            width = cap if remaining >= cap else -(-remaining // page) * page
            chunks.append((start, width))
            start += width
        return chunks

    def _run_prefill_chunks(self):
        """Run at most ``max_chunks_per_iter`` prefill chunks this
        iteration, FIFO across admitted-but-unprefilled requests: a long
        prompt never stalls the decode batch by more than this many
        chunks per decode dispatch."""
        budget = self.config.paging.max_chunks_per_iter
        while budget > 0 and self._prefill_tasks:
            slot, req, prompt, max_new, chunks = self._prefill_tasks[0]
            start, width = chunks.pop(0)
            self._dispatch_chunk(slot, req, prompt, max_new, start, width,
                                 is_last=not chunks)
            if not chunks:
                self._prefill_tasks.popleft()
            budget -= 1

    def _dispatch_chunk(self, slot: int, req, prompt, max_new: int,
                        start: int, width: int, is_last: bool):
        """Prefill one page-aligned chunk of one request. Mid-chunks only
        fill pages; the last chunk also samples the first token
        (pipelined like a contiguous admit) and publishes the prompt's
        full pages to the prefix cache."""
        p_len = int(prompt.shape[0])
        real = min(start + width, p_len) - start
        padded = np.zeros((1, width), np.int64)
        padded[0, :real] = prompt[start:start + real]
        ids = torch.from_numpy(padded)
        if self.device.type == "cuda":
            ids = ids.pin_memory().to(self.device, non_blocking=True)
        mgr = self._paged
        out = _chunk_prefill_impl(
            self.module, mgr.pool, self._state, mgr.page_table[slot], ids,
            start, p_len, slot, max_new, is_last, self._gen, self._eos,
            self._mode)
        self.metrics.on_prefill_chunk(real)
        if is_last:
            # pages below the prompt's full-page boundary are immutable
            # from here (decode appends strictly past them): publish them
            # for copy-free reuse by later identical prefixes
            mgr.publish(slot, prompt)
            self._pending.append(("admit", slot, req, _Readback(*out)))

    def _dispatch_decode(self) -> bool:
        if all(r is None for r in self._slot_req):
            return False
        snapshot = list(self._slot_req)
        busy = sum(r is not None for r in snapshot)
        if self._paged is not None:
            mgr = self._paged
            self._state, toks, done = _paged_decode_iter_impl(
                self.module, mgr.pool, mgr.page_table, self._state,
                self._gen, self._eos, self._mode, mgr.use_kernel)
        else:
            self._state, toks, done = _decode_iter_impl(
                self.module, self._cache, self._state, self._gen, self._eos,
                self._mode)
        self.metrics.on_decode_dispatch(busy, self.config.num_slots)
        self._pending.append(("decode", snapshot, _Readback(toks, done)))
        self._iteration += 1
        return True

    def _harvest_one(self):
        """Read back the oldest in-flight dispatch and stream its tokens
        and completions to their requests."""
        entry = self._pending.popleft()
        if entry[0] == "admit":
            _, slot, req, readback = entry
            tok, done = readback.numpy()
            if req.done:         # cancelled between dispatch and readback
                return
            req._emit(int(tok), self._iteration)
            self.metrics.on_token()
            if bool(done):
                self._finish(slot, req)
            return
        _, snapshot, readback = entry
        toks, done = readback.numpy()
        for slot, req in enumerate(snapshot):
            if req is None or req.done:  # empty, or cancelled in flight
                continue
            if toks[slot] >= 0:
                req._emit(int(toks[slot]), self._iteration)
                self.metrics.on_token()
            if done[slot]:
                self._finish(slot, req)

    def _finish(self, slot: int, req: Request):
        req._finished(self._iteration)
        self.metrics.on_finish(req)
        if self._paged is not None:
            # return the slot's page references; prefix-published pages
            # survive through the radix tree's own refcount
            self._paged.release_slot(slot)
        self._slot_req[slot] = None
        self._free.append(slot)
