"""Continuous-batching serving engine (counterpart of
``deepspeed_tpu/serving/engine.py``) over contiguous slots or a paged KV
pool, with optional int8 weights and int8 KV pages, QoS and
self-speculative decoding.

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
pool int8.

QoS (``qos`` block, ``qos.py``): requests carry a ``priority``; a
high-priority queue head past its class's ``preempt_after_steps``
preempts the lowest-priority active request back to the queue (its
generated tokens kept: resumption re-prefills prompt + partial output,
which the paged prefix cache serves page by page). Admission sheds early
with an explicit ``shed`` status against per-class SLO targets, and the
degradation ladder (shed the lowest class, shrink the chunk budget,
refuse admits) runs on the decode-step clock, so decisions replay
exactly. Fault containment: a hung-dispatch watchdog (its timer thread
only sets a flag; ``advance()`` recovers on the engine thread), an OOM
guard on admission and chunk prefill that sheds the offender with an
``oom_forensics`` report, and ``recover()``, which requeues every live
request over a rebuilt device state. ``set_slot_cap`` drains slots above
a cap by preemption.

Speculation (``speculation`` block, ``speculation.py``): a host n-gram
proposer and one batched verification step (K + 1 query rows a slot
through the flash forward under a per-row cache mask) replace the decode
step on iterations where some slot proposes; the output stays the
non-speculative engine's token for token. The fleet comes with a later
slice.

Requests queue on the host (``scheduler.py``) and are admitted into free
slots between decode steps. Token readback is pipelined: each dispatch
copies its tokens into pinned host memory behind a CUDA event, and the
host waits on that event only ``pipeline_depth`` dispatches later, so the
device runs step k+1 while the host streams step k. Nothing else in the
loop synchronises with the device.
"""

import os
import threading
import time
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
from ..observability.memory import (MemoryAccountant, is_oom_error,
                                    oom_forensics)
from . import qos as qos_mod
from .config import ServingConfig
from .metrics import ServingMetrics
from .qos import QosController
from .request import PREEMPTED, Request
from .paging.manager import (PagedKVManager, _chunk_prefill_impl,
                             _paged_decode_iter_impl)
from .scheduler import FifoScheduler
from .speculation import NgramProposer, _spec_verify_impl


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


class _Watchdog:
    """A daemon thread that reports one engine iteration stuck past
    ``timeout_s`` (JAX ``runtime/resilience/preemption.py`` ``Watchdog``
    with a recovery callback in place of a process abort). Armed between
    ``step_started()`` and ``step_finished()`` only; fires once. It calls
    ``on_fire(report)`` from its own thread, which must not touch the
    device."""

    def __init__(self, timeout_s: float, on_fire):
        self.timeout_s = float(timeout_s)
        self.poll_s = max(0.01, self.timeout_s / 4)
        self._on_fire = on_fire
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._stop = threading.Event()
        self.fired = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-watchdog")

    def start(self) -> "_Watchdog":
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def step_started(self):
        with self._lock:
            self._armed_at = time.monotonic()

    def step_finished(self):
        with self._lock:
            self._armed_at = None

    def in_step(self) -> bool:
        """True between ``step_started()`` and ``step_finished()``."""
        with self._lock:
            return self._armed_at is not None

    def _run(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                armed_at = self._armed_at
            if armed_at is None:
                continue
            stuck_s = time.monotonic() - armed_at
            if stuck_s >= self.timeout_s:
                self.fired = True
                self._on_fire(f"serving iteration stuck for {stuck_s:.2f} s "
                              f"(watchdog_timeout_s={self.timeout_s})")
                return


class ServingEngine:
    """Continuous-batching serving over a fixed slot pool.

    Usage::

        eng = ServingEngine(model, ServingConfig(num_slots=8, max_len=1024))
        reqs = [eng.submit(prompt, max_new_tokens=64) for prompt in work]
        eng.run()                      # or: interleave submit()/advance()
        reqs[0].output_tokens          # streamed per token via on_token=

    The model's device is the engine's. ``generator`` drives sampling when
    ``temperature > 0`` (default: seeded from ``config.seed``). Construct
    directly, from ``InferenceEngine.serve()``, or from a config dict's
    ``serving`` block via ``from_config``.
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
        self._init_device_state()
        self.scheduler = FifoScheduler(self.config)
        self.metrics = ServingMetrics()
        self._slot_req = [None] * n       # host view of slot -> Request
        self._free = deque(range(n))
        self._pending = deque()           # in-flight readbacks, FIFO
        self._iteration = 0
        self._seq = 0
        # QoS plane (qos.py): None without the block — the FIFO engine
        self._qos = (QosController(self.config.qos)
                     if self.config.qos_enabled else None)
        # speculation plane (speculation.py): the host proposer; None
        # keeps one token a step
        self._spec = (NgramProposer(self.config.speculation)
                      if self.config.spec_enabled else None)
        self._slot_cap = n                # admissible slots (set_slot_cap
                                          # drains above it by preemption;
                                          # the decode batch stays n)
        self._preempts_this_iter = 0
        self._watchdog = None
        self._watchdog_report = None      # set by the watchdog thread;
                                          # advance() recovers on it
        self._escalation = None           # the fire's escalation timer
        self._closed = False
        self.on_watchdog_fatal = None     # escalation hook when the flag
                                          # is never taken; None exits
                                          # the process with code 70
        self.last_oom_forensics = None    # latest allocation-failure report
        self.accountant = MemoryAccountant()
        self._restart_watchdog()
        self._account_memory()

    def _init_device_state(self):
        """(Re)build the device-side KV cache or page pool and the slot
        state rows: at construction and from ``recover()``."""
        n = self.config.num_slots
        if self.config.paged:
            if self._paged is None:
                # the manager owns the pool, allocator, prefix cache and
                # page tables; no contiguous slot rows exist
                self._paged = PagedKVManager(self.module, self.config)
            else:
                self._paged.reset()
            self._cache = None
            self._prefill_tasks = deque()   # (slot, req, prompt, max_new,
                                            #  [chunk plans])
        else:
            self._cache = None              # the old rows go first
            self._cache = set_cache_index(
                init_cache(self.module, n, self.config.cache_len),
                torch.zeros(n, dtype=torch.int32))
        self._state = {
            "lengths": torch.zeros(n, dtype=torch.int32, device=self.device),
            "last_token": torch.zeros(n, dtype=torch.int64,
                                      device=self.device),
            "active": torch.zeros(n, dtype=torch.bool, device=self.device),
            "remaining": torch.zeros(n, dtype=torch.int32,
                                     device=self.device),
        }

    # -- the watchdog ------------------------------------------------------
    def _restart_watchdog(self):
        """Arm (or re-arm after a fire) the hung-dispatch watchdog when the
        QoS block sets ``watchdog_timeout_s``."""
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if (not self._closed and self._qos is not None
                and self.config.qos.watchdog_timeout_s is not None):
            self._watchdog = _Watchdog(self.config.qos.watchdog_timeout_s,
                                       self._on_watchdog_fire).start()

    def _on_watchdog_fire(self, report: str):
        """Watchdog-thread callback: record only (no device call from a
        foreign thread); the next ``advance()`` recovers on the engine
        thread. A dispatch that never returns never reaches that
        ``advance()``: if the flag is still untaken one window later,
        ``on_watchdog_fatal(report)`` runs, or the process exits with
        code 70 so a supervisor restarts it."""
        if self._closed:
            return
        self._watchdog_report = report
        self.metrics.on_fault(
            "watchdog", f"dispatch stalled past "
            f"{self.config.qos.watchdog_timeout_s}s", self._iteration)
        timer = threading.Timer(self.config.qos.watchdog_timeout_s,
                                self._watchdog_escalate, args=(report,))
        timer.daemon = True
        self._escalation = timer
        timer.start()

    def _watchdog_escalate(self, report: str):
        """Escalate only while the stalled iteration is still running: a
        flag left untaken because the iteration returned and no later
        ``advance()`` came (the last one of a run, an idle server) waits
        for the next ``advance()``."""
        watchdog = self._watchdog
        if (self._closed or self._watchdog_report is None
                or watchdog is None or not watchdog.in_step()):
            return
        if self.on_watchdog_fatal is not None:
            self.on_watchdog_fatal(report)
        else:
            os._exit(70)

    # -- memory ------------------------------------------------------------
    def _account_memory(self):
        """Attribute the engine's resident device buffers (shapes only,
        no device reads)."""
        acct = self.accountant
        acct.account("serving/params", self.module)
        if self._paged is not None:
            acct.account("serving/kv_pool", num_bytes=self._paged.pool_bytes(),
                         name="page_pool")
            acct.account("serving/kv_pool", self._paged.page_table,
                         name="page_table")
        else:
            acct.account("serving/kv_pool", self._cache, name="slot_cache")
        acct.account("serving/state", self._state)

    def memory_report(self) -> dict:
        """Resident bytes of the KV pool and of the weights (int8 against
        their dense equivalent) and the attribution by subsystem; paged
        engines add the gather-path transient (0 on the kernel path), the
        page dtype and whether the paged-attention kernel runs."""
        report = self.accountant.report()
        out = {"by_subsystem": {tag: info["bytes"] for tag, info
                                in report["by_subsystem"].items()},
               "kv_pool_resident_bytes":
                   self.accountant.subsystem_bytes("serving/kv_pool"),
               "params_bytes": quantized_nbytes(self.module)}
        if self._paged is not None:
            out["decode_gather_transient_bytes"] = \
                self._paged.decode_gather_transient_bytes()
            out["kv_page_dtype"] = (
                "int8" if self._paged.kv_quant
                else str(self._paged.dequant_dtype).replace("torch.", ""))
            out["paged_kernel"] = self._paged.use_kernel
        return out

    def close(self):
        """Stop the watchdog, cancel a pending escalation, drop an untaken
        fire and this engine's memory attribution. Idempotent."""
        self._closed = True
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self._escalation is not None:
            self._escalation.cancel()
            self._escalation = None
        self._watchdog_report = None
        for tag in ("serving/params", "serving/kv_pool", "serving/state"):
            self.accountant.discard(tag)

    def metrics_snapshot(self) -> dict:
        """The serving metrics, the memory attribution and, with QoS on,
        the ladder's state (``qos``)."""
        out = {"serving": self.metrics.snapshot(),
               "memory": self.accountant.report()}
        if self._qos is not None:
            out["qos"] = self._qos.snapshot()
        return out

    # -- client API --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               request_id=None, on_token=None,
               deadline_steps: Optional[int] = None,
               priority: int = 0) -> Request:
        """Queue one request; returns its live ``Request`` handle.

        ``deadline_steps`` is a queue TTL on the engine-iteration clock
        (this argument, then the QoS class default, then
        ``config.default_deadline_steps``; None waits forever).
        ``priority`` (higher = more important) orders admission with the
        ``qos`` block on; SLO-aware admission may return the handle
        already in ``shed`` status."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens is None:
            max_new_tokens = self.config.default_max_new_tokens
        qos_cls = (self._qos.config.class_for(priority)
                   if self._qos is not None else None)
        if deadline_steps is None and qos_cls is not None:
            deadline_steps = qos_cls.deadline_steps
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
                      deadline_steps=deadline_steps, priority=priority)
        if qos_cls is not None:
            req.qos_class = qos_cls.name
        req.submitted_iteration = self._iteration
        # the p95-TTFT-under-load population: arrivals while others wait
        # or every admissible slot is taken
        req.submitted_under_load = bool(
            self.scheduler.depth or self._peek_free_slot() is None)
        req._seq = self._seq
        self._seq += 1
        if self._qos is not None:
            ok, reason = self._qos.admit(
                qos_cls,
                class_ttft_p95=self.metrics.class_ttft_p95(qos_cls.name),
                under_load=req.submitted_under_load)
            if not ok:
                self.metrics.on_submit(req)
                req._shed(self._iteration, reason)
                self.metrics.on_shed(req, reason)
                return req
        try:
            self.scheduler.add(req)
        except RuntimeError:
            self.metrics.on_reject()
            raise
        self.metrics.on_submit(req)
        return req

    def _deactivate(self, slot: int):
        """Mask a slot's device row (in-flight and later steps drop it),
        drop its unfinished prefill chunks and pages, and free the slot."""
        self._state["active"][slot] = False
        self._state["remaining"][slot] = 0
        if self._paged is not None:
            # prefix-published pages live on through the tree's reference
            self._prefill_tasks = deque(
                t for t in self._prefill_tasks if t[0] != slot)
            self._paged.release_slot(slot)
        self._slot_req[slot] = None
        self._free.append(slot)

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
                self._deactivate(slot)
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
        """Free admissible slots (below the slot cap)."""
        return sum(1 for s in self._free if s < self._slot_cap)

    @property
    def iteration(self) -> int:
        """The engine's decode-iteration clock."""
        return self._iteration

    @property
    def qos_level(self) -> Optional[int]:
        """The degradation ladder's level (None without QoS)."""
        return self._qos.level if self._qos is not None else None

    @property
    def slot_cap(self) -> int:
        return self._slot_cap

    # -- engine loop -------------------------------------------------------
    @torch.no_grad()
    def advance(self):
        """One engine iteration: recover after a watchdog fire, evaluate
        the QoS ladder, expire overdue queued requests, admit into free
        slots (preempting a lower class for an at-risk high-priority head;
        paged: reserve pages and run at most ``max_chunks_per_iter``
        prefill chunks), dispatch one decode or verification step over
        the slot batch, harvest readbacks beyond the pipeline depth. Safe
        to call when idle."""
        if self._watchdog_report is not None:
            report, self._watchdog_report = self._watchdog_report, None
            self.recover("hung dispatch", kind="watchdog", detail=report)
        self._preempts_this_iter = 0
        if self._qos is not None:
            self._qos_tick()
        for req in self.scheduler.expire(self._iteration):
            req._timed_out(self._iteration)
            self.metrics.on_timeout(req)
        if self._watchdog is not None:
            self._watchdog.step_started()
        try:
            if self._paged is not None:
                self._admit_ready_paged()
                self._run_prefill_chunks()
            else:
                self._admit_ready()
            dispatched = self._dispatch_decode()
            # keep at most pipeline_depth dispatches in flight; drain
            # fully when nothing new was dispatched (tail of the workload)
            target = self.config.pipeline_depth if dispatched else 0
            while len(self._pending) > target:
                self._harvest_one()
        finally:
            if self._watchdog is not None:
                self._watchdog.step_finished()
        busy = sum(r is not None for r in self._slot_req)
        self.metrics.sample(self.scheduler.depth, busy,
                            self.config.num_slots,
                            paged=(self._paged.stats()
                                   if self._paged is not None else None),
                            qos_level=self.qos_level,
                            slot_cap=self._slot_cap)

    def _qos_tick(self):
        """One ladder evaluation on the decode-step clock, and the queued
        shed sweep its level implies (host state only: replays exactly)."""
        free_frac = None
        if self._paged is not None:
            free_frac = 1.0 - self._paged.stats()["page_utilization"]
        self._qos.observe(iteration=self._iteration,
                          queue_depth=self.scheduler.depth,
                          ttft_p95_steps=self.metrics.ttft_under_load_p95(),
                          free_frac=free_frac)
        pred = self._qos.queued_shed_predicate()
        if pred is not None:
            for req in self.scheduler.shed_queued(pred):
                req._shed(self._iteration, qos_mod.SHED_LADDER)
                self.metrics.on_shed(req, qos_mod.SHED_LADDER)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on CUDA from pinned memory
        without blocking, so it does not wait for queued device work."""
        t = torch.from_numpy(array)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- free slots (slot-cap aware) ---------------------------------------
    def _peek_free_slot(self) -> Optional[int]:
        """The slot the next admission takes: the first free one below the
        cap (None when all are taken or drained)."""
        for s in self._free:
            if s < self._slot_cap:
                return s
        return None

    def _take_slot(self, slot: int):
        self._free.remove(slot)

    # -- priority preemption -----------------------------------------------
    def _try_preempt_for(self, head: Request, need: str = "slot") -> bool:
        """Free capacity for an at-risk high-priority queue head by
        preempting the lowest-priority active request back to the queue
        (JAX engine.py:782-830). ``need``: ``"slot"`` or ``"pages"``, the
        resource admission found short. Returns True when admission should
        be retried. Deterministic, and at most
        ``max_preemptions_per_iter`` an iteration."""
        if self._qos is None or not self._qos.config.preemption:
            return False
        if (self._preempts_this_iter
                >= self._qos.config.max_preemptions_per_iter):
            return False
        head_cls = self._qos.config.class_for(head.priority)
        if not self._qos.head_at_risk(head, head_cls, self._iteration):
            return False
        # drain in-flight work first: the victim keeps every token it was
        # dispatched, and a completion may free a slot or pages outright
        drained = bool(self._pending)
        while self._pending:
            self._harvest_one()
        if need == "slot" and self._peek_free_slot() is not None:
            return True
        if need == "pages" and drained:
            return True
        victim_slot = None
        for slot, r in enumerate(self._slot_req):
            if r is None or r.done or r.priority >= head.priority:
                continue
            if victim_slot is None:
                victim_slot = slot
                continue
            v = self._slot_req[victim_slot]
            # lowest priority first; among ties the most recently admitted
            # (least work lost), then the highest slot: a total order
            if ((r.priority, -(r.admitted_iteration or 0), -slot)
                    < (v.priority, -(v.admitted_iteration or 0),
                       -victim_slot)):
                victim_slot = slot
        if victim_slot is None:
            return False
        self._preempt_slot(victim_slot)
        self._preempts_this_iter += 1
        return True

    def _preempt_slot(self, slot: int):
        """Preempt one active request back to the front of its class's
        queue with its generated tokens kept. Call with ``_pending``
        drained: undelivered tokens would be missing from the resume
        prompt."""
        req = self._slot_req[slot]
        self._deactivate(slot)
        req._preempted(self._iteration)
        self.scheduler.requeue(req)
        self.metrics.on_preempt(req)

    # -- admission ---------------------------------------------------------
    def _admit_ready(self):
        while True:
            req = self.scheduler.peek()
            if req is None:
                return
            slot = self._peek_free_slot()
            if slot is None:
                if self._try_preempt_for(req):
                    continue        # a slot (or a completion) freed up
                return
            self.scheduler.next_request()   # pop the head
            self._take_slot(slot)
            # a resumption re-prefills prompt + the tokens it kept
            prompt = req.effective_prompt()
            resumed = req.status == PREEMPTED
            n = prompt.shape[0]
            padded = np.zeros((1, self.config.bucket_for(n)), np.int64)
            padded[0, :n] = prompt
            oom = None
            try:
                tok, done = _admit_impl(
                    self.module, self._cache, self._state,
                    self._upload(padded), n, slot, req.remaining_budget(),
                    self._gen, self._eos, self._mode)
            except RuntimeError as e:
                if not is_oom_error(e):
                    raise
                oom = str(e)
            if oom is not None:
                # out of the except block: its traceback, and the cache and
                # scratch rows its frames hold, are gone before the rebuild
                self._shed_on_oom(req, "admit", oom)
                return
            self._slot_req[slot] = req
            req._admitted(slot, self._iteration)
            self.metrics.on_admit(req)
            if resumed:
                self.metrics.on_resume(req)
            self._pending.append(("admit", slot, req, _Readback(tok, done)))

    def _admit_ready_paged(self):
        """Admit queued requests while pages cover them. Admission gates
        on free PAGES, not free slots: a page-starved queue head stays
        queued (class order kept) until running requests release pages,
        the prefix cache evicts, or, with QoS on, an at-risk high-priority
        head preempts a lower class's pages free."""
        while True:
            req = self.scheduler.peek()
            if req is None:
                return
            slot = self._peek_free_slot()
            if slot is None:
                if self._try_preempt_for(req):
                    continue
                return
            prompt = req.effective_prompt()
            max_new = req.remaining_budget()
            shared = self._paged.try_admit(slot, prompt, max_new)
            if shared is None:              # page-starved head
                if self._try_preempt_for(req, need="pages"):
                    continue
                return
            self.scheduler.next_request()   # pop it
            self._take_slot(slot)
            resumed = req.status == PREEMPTED
            self._slot_req[slot] = req
            req._admitted(slot, self._iteration)
            self.metrics.on_admit(req, shared_tokens=shared)
            if resumed:
                self.metrics.on_resume(req)
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
        iteration (the ladder shrinks the budget at level >= 2), FIFO
        across admitted-but-unprefilled requests."""
        budget = self.config.paging.max_chunks_per_iter
        if self._qos is not None:
            budget = self._qos.max_chunks(budget)
        while budget > 0 and self._prefill_tasks:
            slot, req, prompt, max_new, chunks = self._prefill_tasks[0]
            start, width = chunks.pop(0)
            if not self._dispatch_chunk(slot, req, prompt, max_new, start,
                                        width, is_last=not chunks):
                return          # OOM containment rebuilt the queue state
            if not chunks:
                self._prefill_tasks.popleft()
            budget -= 1

    def _dispatch_chunk(self, slot: int, req, prompt, max_new: int,
                        start: int, width: int, is_last: bool) -> bool:
        """Prefill one page-aligned chunk of one request. Mid-chunks only
        fill pages; the last chunk also samples the first token
        (pipelined like a contiguous admit) and publishes the prompt's
        full pages to the prefix cache. Returns False when an allocation
        failure was contained."""
        p_len = int(prompt.shape[0])
        real = min(start + width, p_len) - start
        padded = np.zeros((1, width), np.int64)
        padded[0, :real] = prompt[start:start + real]
        mgr = self._paged
        oom = None
        try:
            out = _chunk_prefill_impl(
                self.module, mgr.pool, self._state, mgr.page_table[slot],
                self._upload(padded), start, p_len, slot, max_new, is_last,
                self._gen, self._eos, self._mode)
        except RuntimeError as e:
            if not is_oom_error(e):
                raise
            oom = str(e)
        if oom is not None:
            self._shed_on_oom(req, "chunk_prefill", oom)
            return False
        self.metrics.on_prefill_chunk(real)
        if is_last:
            # pages below the prompt's full-page boundary are immutable
            # from here (decode appends strictly past them): publish them
            # for copy-free reuse by later identical prefixes
            mgr.publish(slot, prompt)
            self._pending.append(("admit", slot, req, _Readback(*out)))
        return True

    # -- decode and speculative verification -------------------------------
    def _dispatch_decode(self) -> bool:
        if all(r is None for r in self._slot_req):
            return False
        if self._spec is not None:
            proposals = self._collect_proposals()
            if proposals is not None:
                return self._dispatch_spec_verify(*proposals)
            if all(r is None for r in self._slot_req):
                return False    # the proposal drain finished every slot
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

    def _collect_proposals(self):
        """This iteration's proposals ``(props [slots, K], counts
        [slots])`` (numpy), or None when no slot proposes (the iteration
        then takes the plain decode step). Drains the in-flight readbacks
        first: the proposer matches each slot's current frontier, which
        pipelining lags by ``pipeline_depth`` tokens."""
        kmax = self.config.speculation.max_spec_tokens
        if self._qos is not None:
            # the ladder's first rung: speculation sheds from the first
            # overloaded iteration, before any request does
            kmax = self._qos.max_spec_tokens(kmax)
        if kmax <= 0 or not self._mode[0]:
            return None
        if not any(r is not None and not r.done and r.tokens
                   for r in self._slot_req):
            return None
        while self._pending:
            self._harvest_one()
        n = self.config.num_slots
        props = np.zeros((n, self.config.speculation.max_spec_tokens),
                         np.int64)
        counts = np.zeros((n,), np.int32)
        for slot, req in enumerate(self._slot_req):
            # proposable: running with its first token harvested and at
            # least 2 tokens of budget left (with 1 a plain step finishes)
            if req is None or req.done or not req.tokens:
                continue
            budget = min(kmax, req.remaining_budget() - 1)
            if budget <= 0:
                continue
            got = self._spec.propose(req.effective_prompt(), budget)
            props[slot, :got.shape[0]] = got
            counts[slot] = got.shape[0]
        if not counts.any():
            return None
        return props, counts

    def _dispatch_spec_verify(self, props, counts) -> bool:
        """Dispatch the one batched verification step over the slot batch
        (non-proposing slots ride along and emit the one token a plain
        step would). Counts as one decode iteration on the step clock."""
        snapshot = list(self._slot_req)
        busy = sum(r is not None for r in snapshot)
        if self._paged is not None:
            mgr = self._paged
            kv, table, dequant = mgr.pool, mgr.page_table, mgr.dequant_dtype
        else:
            kv, table, dequant = self._cache, None, None
        self._state, toks, done = _spec_verify_impl(
            self.module, kv, table, self._state, self._upload(props),
            self._upload(counts), self._gen, self._eos, self._mode, dequant)
        self.metrics.on_decode_dispatch(busy, self.config.num_slots,
                                        verify=True)
        self._pending.append(("spec", snapshot, _Readback(toks, done),
                              counts))
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
        snapshot, readback = entry[1], entry[2]
        toks, done = readback.numpy()
        for slot, req in enumerate(snapshot):
            if req is None or req.done:  # empty, or cancelled in flight
                continue
            if entry[0] == "spec":
                # [slots, K + 1], position i >= 0 iff emitted: the
                # accepted proposals and the bonus token, in order
                emitted = 0
                for tok in toks[slot]:
                    if tok < 0:
                        break
                    req._emit(int(tok), self._iteration)
                    emitted += 1
                if emitted:
                    self.metrics.on_token(emitted)
                    if entry[3][slot]:
                        self.metrics.on_spec(int(entry[3][slot]),
                                             emitted - 1)
            elif toks[slot] >= 0:
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

    # -- fault containment and recovery ------------------------------------
    def _shed_on_oom(self, req: Request, where: str, err: str):
        """Allocation-failure containment: keep the ``oom_forensics``
        report, shed the offending request with reason ``oom``, and
        rebuild the device state through ``recover()`` so the engine
        serves everyone else (a failed step may have written part of the
        cache or state). ``err``: the error's message."""
        self.last_oom_forensics = oom_forensics(
            f"serving {where} out of memory (request {req.request_id!r}): "
            f"{err[:200]}", self.accountant)
        req._shed(self._iteration, qos_mod.SHED_OOM)
        self.metrics.on_shed(req, qos_mod.SHED_OOM)
        self.metrics.on_fault("oom", f"{where}: request {req.request_id!r} "
                              "shed after an allocation failure",
                              self._iteration)
        self.recover(f"oom during {where}", kind="oom")

    def recover(self, reason: str, kind: str = "restart",
                detail: Optional[str] = None):
        """Requeue-and-re-prefill recovery (JAX engine.py:1259-1294).

        Drops the in-flight readbacks (their tokens were never streamed,
        so the re-prefill regenerates them), rebuilds the KV cache or
        pool and the slot state from scratch, and pushes every live
        admitted request back to the queue in arrival order with its
        generated tokens kept. Queued requests stay. The next
        ``advance()`` re-admits and re-prefills prompt + partial output
        (page-granular prefix hits make that cheap on the paged engine).
        ``detail`` (a watchdog report) goes into the fault log."""
        self._pending.clear()
        victims = [r for r in self._slot_req if r is not None and not r.done]
        n = self.config.num_slots
        self._slot_req = [None] * n
        self._free = deque(range(n))
        self._init_device_state()
        self._account_memory()
        # requeue in reverse arrival order: each goes to its class's head,
        # so the earliest ends up first
        for r in sorted(victims, key=lambda r: r._seq or 0, reverse=True):
            r._preempted(self._iteration)
            self.scheduler.requeue(r)
            self.metrics.on_preempt(r)
        self.metrics.on_recover(kind, reason if detail is None
                                else f"{reason}: {detail.splitlines()[0]}",
                                len(victims), self._iteration)
        self._restart_watchdog()   # a fired watchdog is one-shot

    # -- elastic capacity ----------------------------------------------------
    def set_slot_cap(self, n: int) -> int:
        """Set the admissible-slot cap. A lower cap drains: active
        requests in slots at or above it are preempted back to the queue
        (tokens kept) and resume in an admissible slot. The decode batch
        stays ``num_slots`` wide; capped slots ride along masked. Returns
        the applied cap."""
        n = max(1, min(int(n), self.config.num_slots))
        old, self._slot_cap = self._slot_cap, n
        if n < old:
            drained = [s for s in range(n, self.config.num_slots)
                       if self._slot_req[s] is not None]
            if drained:
                while self._pending:    # keep the in-flight tokens first
                    self._harvest_one()
                for slot in drained:
                    r = self._slot_req[slot]
                    if r is not None and not r.done:
                        self._preempt_slot(slot)
        return n

    # -- construction helpers ---------------------------------------------
    @classmethod
    def from_config(cls, model, ds_config, **kwargs):
        """Build from a ``runtime.config.DeepSpeedConfig`` (or its dict)
        carrying a ``serving`` block (absent: the defaults)."""
        from ..runtime.config import DeepSpeedConfig
        if isinstance(ds_config, dict):
            ds_config = DeepSpeedConfig.from_dict(ds_config)
        return cls(model, ds_config.serving or ServingConfig(), **kwargs)
