"""Request queue + admission policy (a copy of
``deepspeed_tpu/serving/scheduler.py``, kept in this package so the port
imports nothing of the JAX package).

Reference frame: DeepSpeed-Inference/MII serve requests by re-forming
whole batches; the continuous-batching scheduler here instead admits
individual requests into free KV-cache slots BETWEEN decode steps, so
one straggler never holds the batch (the Orca/vLLM scheduling insight,
applied with TPU-static shapes: admission changes slot METADATA, never
the compiled decode shape).

Ordering: strict priority across classes (higher ``request.priority``
admits first), FIFO within a class — which degenerates to plain FIFO
when every request carries the default priority, so the pre-QoS
behaviour is unchanged for priority-free traffic. Head-of-line blocking
exists on slot/page availability only — every queued request already
fits a slot (submit() validates the token budget), so the head never
blocks the tail for shape reasons.

Robustness contract: queued requests can carry a ``deadline_steps``
queue TTL (``expire`` sweeps them out on the engine-iteration clock so a
saturated server sheds load deterministically instead of growing an
unbounded backlog), ``remove`` supports client-side ``cancel()``,
``requeue`` re-inserts preempted requests at the FRONT of their class
(they were already admitted once — resumption must not wait behind new
arrivals of the same class), and ``shed_queued`` backs the degradation
ladder's queued-request sweep.
"""

from collections import deque
from typing import Callable, Dict, List, Optional

from .request import Request


class FifoScheduler:
    """Priority admission queue over the slot pool (FIFO within class)."""

    def __init__(self, config):
        self.config = config
        self._queues: Dict[int, deque] = {}   # priority -> FIFO deque

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def depth(self) -> int:
        return len(self)

    def _priorities(self) -> List[int]:
        """Admission order: highest priority first."""
        return sorted(self._queues, reverse=True)

    def add(self, request: Request):
        cap = self.config.max_queue
        if cap is not None and len(self) >= cap:
            raise RuntimeError(
                f"serving queue full ({cap} requests); raise max_queue or "
                "apply client-side backpressure")
        self._queues.setdefault(request.priority, deque()).append(request)

    def requeue(self, request: Request):
        """Front-of-class re-insert for preempted/recovered requests. No
        queue-cap check: the request was already admitted once, and
        bouncing it here would turn a preemption into a drop."""
        self._queues.setdefault(request.priority,
                                deque()).appendleft(request)

    def next_request(self) -> Optional[Request]:
        """Pop the next admissible request (None when the queue is empty):
        the FIFO head of the highest non-empty priority class."""
        for p in self._priorities():
            q = self._queues[p]
            if q:
                return q.popleft()
        return None

    def peek(self) -> Optional[Request]:
        """The queue head WITHOUT popping it. The engine admits in two
        phases — reserve resources (pages / a slot, possibly via
        preemption) for the head, then pop — so a resource-starved head
        stays queued and class order is preserved while it waits."""
        for p in self._priorities():
            q = self._queues[p]
            if q:
                return q[0]
        return None

    def queued(self) -> List[Request]:
        """Every queued request in admission order."""
        return [r for p in self._priorities() for r in self._queues[p]]

    def _discard(self, requests: List[Request]):
        gone = set(map(id, requests))
        for p, q in self._queues.items():
            if any(id(r) in gone for r in q):
                self._queues[p] = deque(r for r in q if id(r) not in gone)

    def expire(self, iteration: int) -> List[Request]:
        """Remove queued requests whose deadline passed the engine clock
        (deterministic: the iteration count, not wall time). Callers
        complete them with ``timeout`` status. Preempted requests that
        already generated tokens are exempt — their progress is
        resumable, and discarding it would waste paid-for compute."""
        expired = [r for r in self.queued()
                   if not r.tokens
                   and r.deadline_iteration() is not None
                   and iteration >= r.deadline_iteration()]
        if expired:
            self._discard(expired)
        return expired

    def shed_queued(self, predicate: Callable[[Request], bool]
                    ) -> List[Request]:
        """Remove and return queued requests matching ``predicate`` (the
        degradation ladder's sweep). Callers complete them with ``shed``
        status."""
        matched = [r for r in self.queued() if predicate(r)]
        if matched:
            self._discard(matched)
        return matched

    def remove(self, request_id) -> Optional[Request]:
        """Remove one queued request by id (for ``cancel``); None when no
        queued request carries that id."""
        for r in self.queued():
            if r.request_id == request_id:
                self._discard([r])
                return r
        return None

    def validate_request(self, prompt_len: int, max_new_tokens: int):
        """Refuse requests that can never fit a slot — the serving analog
        of the engine.generate max_seq_len check (clear error at submit
        time, not a truncated response later)."""
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        budget = self.config.max_len
        if prompt_len + max_new_tokens > budget:
            raise ValueError(
                f"prompt_len ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) = {prompt_len + max_new_tokens} "
                f"exceeds the per-slot budget max_len={budget}; shorten "
                "the prompt, reduce max_new_tokens, or raise "
                "serving.max_len")
