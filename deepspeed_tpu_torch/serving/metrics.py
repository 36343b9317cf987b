"""Serving metrics (counterpart of ``deepspeed_tpu/serving/metrics.py``
``ServingMetrics``): counters and step-clock percentiles only, with no
monitor, registry or flight recorder. Every value is host scheduler state
or derived from tokens the engine already read back — recording a metric
never adds a device synchronisation.

- ttft: submit -> first streamed token (wall seconds; ``*_steps`` is the
  engine-iteration count, deterministic run-to-run; ``*_under_load`` only
  requests that arrived while others waited or every slot was taken)
- queue_depth: requests waiting for a slot, sampled per iteration
- slot_occupancy: fraction of slots holding a live request
- throughput: generated tokens / wall seconds since the first submit
- paged engines: prefill chunks, the prefill ledger (prompt tokens
  computed vs reused from the prefix cache) and the page manager's
  latest ``stats()`` (page utilisation, prefix lookups / hits / pages
  reused / evicted)
- QoS: sheds by reason and by class, preemptions, resumptions, the fault
  log (watchdog fires, OOM sheds, recoveries), the per-class breakdown
  (JAX :136-166) and its ``class/<name>/*`` snapshot keys
- speculation: proposed, accepted and rejected tokens, the acceptance
  rate and the emitted tokens per decode iteration
"""

import time
from collections import deque
from typing import Optional

# sliding window for the percentile histories of a long-lived server
HISTORY_WINDOW = 4096

# retained fault-log entries (watchdog fires, OOM sheds, recoveries)
FAULT_LOG_LIMIT = 32


def _percentile(values, q):
    """Nearest-rank percentile (rounded index over the sorted values, as
    ``deepspeed_tpu/observability/metrics.py`` ``percentile``)."""
    s = sorted(values)
    return s[min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))]


class ServingMetrics:
    def __init__(self):
        self.requests_submitted = 0
        self.requests_admitted = 0
        self.requests_finished = 0
        self.requests_timed_out = 0    # queued past deadline_steps
        self.requests_cancelled = 0    # client cancel() (queued or active)
        self.requests_rejected = 0     # refused at submit (budget/queue cap)
        self.requests_shed = 0         # QoS shed (SLO admission, the
                                       # ladder, OOM containment)
        self.requests_preempted = 0    # preempted back to the queue
                                       # (priority, scale-down, recovery)
        self.requests_resumed = 0      # re-admissions after preemption
        self.recoveries = 0            # requeue-and-re-prefill recoveries
        self.shed_by_reason = {}       # reason -> count (qos.SHED_*)
        self.faults = []               # [{kind, detail, iteration}], the
                                       # last FAULT_LOG_LIMIT
        self.per_class = {}            # qos class name -> counters + ttft
        self.qos_level = None          # latest ladder level
        self.slot_cap = None           # latest admissible-slot cap
        self.tokens_generated = 0
        self.prefills = 0
        self.decode_iterations = 0
        self.wasted_slot_steps = 0     # inactive slots carried through decode
        # speculation: proposed = entered verification, accepted = emitted
        # to the request, rejected = rolled back
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0
        self.spec_verify_iterations = 0   # decode iterations that verified
        # paged mode: the prefill ledger — computed counts prompt tokens
        # run through chunk prefill (pad excluded), reused those served
        # from shared prefix pages
        self.prefill_chunks = 0
        self.prefill_tokens_computed = 0
        self.prefill_tokens_reused = 0
        self.paged_stats: Optional[dict] = None   # latest manager.stats()
        self.ttft_s = deque(maxlen=HISTORY_WINDOW)
        self.ttft_steps = deque(maxlen=HISTORY_WINDOW)
        self.ttft_steps_under_load = deque(maxlen=HISTORY_WINDOW)
        self.latency_s = deque(maxlen=HISTORY_WINDOW)
        self.queue_depth_sum = 0
        self.queue_depth_max = 0
        self.occupancy_sum = 0.0
        self.busy_slots_max = 0
        self.samples = 0
        self.started_at: Optional[float] = None

    # -- per-class accounting ----------------------------------------------
    def _cls(self, request) -> Optional[dict]:
        """The per-class bucket of a request (None when it carries no QoS
        class: priority-free traffic stays out of the breakdown)."""
        name = getattr(request, "qos_class", None)
        if name is None:
            return None
        c = self.per_class.get(name)
        if c is None:
            c = {"submitted": 0, "admitted": 0, "finished": 0,
                 "timed_out": 0, "shed": 0, "preempted": 0, "resumed": 0,
                 "ttft_steps": deque(maxlen=HISTORY_WINDOW)}
            self.per_class[name] = c
        return c

    def _count(self, request, key: str):
        c = self._cls(request)
        if c is not None:
            c[key] += 1

    def class_ttft_p95(self, class_name: str):
        """p95 TTFT (steps) of one class's recent completions — the
        SLO-admission signal (None = no data yet)."""
        c = self.per_class.get(class_name)
        if not c or not c["ttft_steps"]:
            return None
        return _percentile(c["ttft_steps"], 95)

    def ttft_under_load_p95(self):
        """p95 of the under-load TTFT population in steps (the ladder's
        latency signal; None until under-load completions exist)."""
        if not self.ttft_steps_under_load:
            return None
        return _percentile(self.ttft_steps_under_load, 95)

    # -- engine hooks ------------------------------------------------------
    def on_submit(self, request=None):
        if self.started_at is None:
            self.started_at = time.perf_counter()
        self.requests_submitted += 1
        self._count(request, "submitted")

    def on_admit(self, request=None, shared_tokens: int = 0):
        self.requests_admitted += 1
        self.prefills += 1
        self.prefill_tokens_reused += shared_tokens
        self._count(request, "admitted")

    def on_prefill_chunk(self, tokens_computed: int):
        self.prefill_chunks += 1
        self.prefill_tokens_computed += tokens_computed

    def on_decode_dispatch(self, busy_slots: int, num_slots: int,
                           verify: bool = False):
        """One decode iteration; ``verify``: a speculative verification
        step rather than a one-token step."""
        self.decode_iterations += 1
        self.spec_verify_iterations += verify
        self.wasted_slot_steps += num_slots - busy_slots

    def on_token(self, n: int = 1):
        """``n`` emitted tokens. An accepted verification step emits
        several in one decode iteration, so token counters take the
        emitted count while ``decode_iterations`` stays one a dispatch."""
        self.tokens_generated += n

    def on_spec(self, proposed: int, accepted: int):
        """One slot's speculation outcome at harvest (the bonus token is
        not counted: the rate measures the proposer)."""
        self.spec_proposed_tokens += proposed
        self.spec_accepted_tokens += accepted
        self.spec_rejected_tokens += proposed - accepted

    def on_timeout(self, request=None):
        self.requests_timed_out += 1
        self._count(request, "timed_out")

    def on_cancel(self):
        self.requests_cancelled += 1

    def on_reject(self):
        self.requests_rejected += 1

    def on_shed(self, request, reason=None):
        """An explicit QoS shed (admission refusal, ladder sweep or OOM
        containment), counted overall, by reason and by class."""
        self.requests_shed += 1
        key = reason or "unspecified"
        self.shed_by_reason[key] = self.shed_by_reason.get(key, 0) + 1
        self._count(request, "shed")

    def on_preempt(self, request):
        self.requests_preempted += 1
        self._count(request, "preempted")

    def on_resume(self, request):
        self.requests_resumed += 1
        self._count(request, "resumed")

    def on_fault(self, kind: str, detail: str, iteration: int):
        """One containment event (watchdog fire, OOM shed, recovery) in
        the capped fault log."""
        self.faults.append({"kind": kind, "detail": detail,
                            "iteration": iteration})
        del self.faults[:-FAULT_LOG_LIMIT]

    def on_recover(self, kind: str, reason: str, requeued: int,
                   iteration: int):
        self.recoveries += 1
        self.on_fault("recovery",
                      f"{kind}: {reason} ({requeued} requests requeued)",
                      iteration)

    def on_finish(self, request):
        self.requests_finished += 1
        if request.ttft_s is not None:
            self.ttft_s.append(request.ttft_s)
        if request.latency_s is not None:
            self.latency_s.append(request.latency_s)
        c = self._cls(request)
        if (request.first_token_iteration is not None
                and request.submitted_iteration is not None):
            steps = (request.first_token_iteration
                     - request.submitted_iteration)
            self.ttft_steps.append(steps)
            if request.submitted_under_load:
                self.ttft_steps_under_load.append(steps)
            if c is not None:
                c["ttft_steps"].append(steps)
        if c is not None:
            c["finished"] += 1

    def sample(self, queue_depth: int, busy_slots: int, num_slots: int,
               paged: Optional[dict] = None,
               qos_level: Optional[int] = None,
               slot_cap: Optional[int] = None):
        if paged is not None:
            self.paged_stats = paged    # host allocator arithmetic only
        if qos_level is not None:
            self.qos_level = qos_level
        if slot_cap is not None:
            self.slot_cap = slot_cap
        self.queue_depth_sum += queue_depth
        self.queue_depth_max = max(self.queue_depth_max, queue_depth)
        self.occupancy_sum += busy_slots / max(1, num_slots)
        self.busy_slots_max = max(self.busy_slots_max, busy_slots)
        self.samples += 1

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Counters are all-time; ttft/latency percentiles cover the most
        recent ``HISTORY_WINDOW`` completions. Keys are the JAX package's
        (its monitor, registry and flight-recorder entries aside)."""
        elapsed = (time.perf_counter() - self.started_at
                   if self.started_at is not None else 0.0)
        out = {
            "requests_submitted": self.requests_submitted,
            "requests_admitted": self.requests_admitted,
            "requests_finished": self.requests_finished,
            "requests_timed_out": self.requests_timed_out,
            "requests_cancelled": self.requests_cancelled,
            "requests_rejected": self.requests_rejected,
            "requests_shed": self.requests_shed,
            "requests_preempted": self.requests_preempted,
            "requests_resumed": self.requests_resumed,
            "recoveries": self.recoveries,
            "tokens_generated": self.tokens_generated,
            "prefills": self.prefills,
            "decode_iterations": self.decode_iterations,
            "wasted_slot_steps": self.wasted_slot_steps,
            "elapsed_s": elapsed,
            "throughput_tokens_per_s": (self.tokens_generated / elapsed
                                        if elapsed > 0 else 0.0),
            "queue_depth_mean": (self.queue_depth_sum / self.samples
                                 if self.samples else 0.0),
            "queue_depth_max": self.queue_depth_max,
            "slot_occupancy_mean": (self.occupancy_sum / self.samples
                                    if self.samples else 0.0),
            "concurrent_requests_peak": self.busy_slots_max,
        }
        if self.spec_proposed_tokens:
            out["spec_proposed_tokens"] = self.spec_proposed_tokens
            out["spec_accepted_tokens"] = self.spec_accepted_tokens
            out["spec_rejected_tokens"] = self.spec_rejected_tokens
            out["spec_acceptance_rate"] = (self.spec_accepted_tokens
                                           / self.spec_proposed_tokens)
            out["spec_verify_iterations"] = self.spec_verify_iterations
            # emitted tokens per decode dispatch (1.0 without speculation)
            out["tokens_per_decode_iteration"] = (
                self.tokens_generated / max(1, self.decode_iterations))
        if self.prefill_chunks or self.prefill_tokens_reused:
            total = self.prefill_tokens_computed + self.prefill_tokens_reused
            out["prefill_chunks"] = self.prefill_chunks
            out["prefill_tokens_computed"] = self.prefill_tokens_computed
            out["prefill_tokens_reused"] = self.prefill_tokens_reused
            out["prefill_recompute_skipped_frac"] = (
                self.prefill_tokens_reused / total if total else 0.0)
        if self.paged_stats is not None:
            out.update(self.paged_stats)
        for name, vals in (("ttft_s", self.ttft_s),
                           ("ttft_steps", self.ttft_steps),
                           ("ttft_steps_under_load",
                            self.ttft_steps_under_load),
                           ("latency_s", self.latency_s)):
            if vals:
                out[f"{name}_p50"] = _percentile(vals, 50)
                out[f"{name}_p95"] = _percentile(vals, 95)
                out[f"{name}_mean"] = sum(vals) / len(vals)
        if self.qos_level is not None:
            out["qos_level"] = self.qos_level
        if self.slot_cap is not None:
            out["slot_cap"] = self.slot_cap
        for reason, n in sorted(self.shed_by_reason.items()):
            out[f"shed/{reason}"] = n
        if self.faults:
            out["faults"] = list(self.faults)
        for name, c in sorted(self.per_class.items()):
            for key in ("submitted", "admitted", "finished", "timed_out",
                        "shed", "preempted", "resumed"):
                out[f"class/{name}/{key}"] = c[key]
            if c["submitted"]:
                out[f"class/{name}/shed_rate"] = c["shed"] / c["submitted"]
            if c["ttft_steps"]:
                out[f"class/{name}/ttft_steps_p50"] = _percentile(
                    c["ttft_steps"], 50)
                out[f"class/{name}/ttft_steps_p95"] = _percentile(
                    c["ttft_steps"], 95)
        return out
