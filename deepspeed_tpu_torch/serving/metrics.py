"""Serving metrics (counterpart of ``deepspeed_tpu/serving/metrics.py``
``ServingMetrics``): counters and step-clock percentiles only, with no
monitor, registry or flight recorder. Every value is host scheduler state
or derived from tokens the engine already read back — recording a metric
never adds a device synchronisation.

- ttft: submit -> first streamed token (wall seconds; ``*_steps`` is the
  engine-iteration count, deterministic run-to-run)
- queue_depth: requests waiting for a slot, sampled per iteration
- slot_occupancy: fraction of slots holding a live request
- throughput: generated tokens / wall seconds since the first submit
"""

import time
from collections import deque
from typing import Optional

# sliding window for the percentile histories of a long-lived server
HISTORY_WINDOW = 4096


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
        self.tokens_generated = 0
        self.prefills = 0
        self.decode_iterations = 0
        self.wasted_slot_steps = 0     # inactive slots carried through decode
        self.ttft_s = deque(maxlen=HISTORY_WINDOW)
        self.ttft_steps = deque(maxlen=HISTORY_WINDOW)
        self.latency_s = deque(maxlen=HISTORY_WINDOW)
        self.queue_depth_sum = 0
        self.queue_depth_max = 0
        self.occupancy_sum = 0.0
        self.busy_slots_max = 0
        self.samples = 0
        self.started_at: Optional[float] = None

    # -- engine hooks ------------------------------------------------------
    def on_submit(self):
        if self.started_at is None:
            self.started_at = time.perf_counter()
        self.requests_submitted += 1

    def on_admit(self):
        self.requests_admitted += 1
        self.prefills += 1

    def on_decode_dispatch(self, busy_slots: int, num_slots: int):
        self.decode_iterations += 1
        self.wasted_slot_steps += num_slots - busy_slots

    def on_token(self, n: int = 1):
        self.tokens_generated += n

    def on_timeout(self):
        self.requests_timed_out += 1

    def on_cancel(self):
        self.requests_cancelled += 1

    def on_reject(self):
        self.requests_rejected += 1

    def on_finish(self, request):
        self.requests_finished += 1
        if request.ttft_s is not None:
            self.ttft_s.append(request.ttft_s)
        if (request.first_token_iteration is not None
                and request.submitted_iteration is not None):
            self.ttft_steps.append(request.first_token_iteration
                                   - request.submitted_iteration)
        if request.latency_s is not None:
            self.latency_s.append(request.latency_s)

    def sample(self, queue_depth: int, busy_slots: int, num_slots: int):
        self.queue_depth_sum += queue_depth
        self.queue_depth_max = max(self.queue_depth_max, queue_depth)
        self.occupancy_sum += busy_slots / max(1, num_slots)
        self.busy_slots_max = max(self.busy_slots_max, busy_slots)
        self.samples += 1

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Counters are all-time; ttft/latency percentiles cover the most
        recent ``HISTORY_WINDOW`` completions."""
        elapsed = (time.perf_counter() - self.started_at
                   if self.started_at is not None else 0.0)
        out = {
            "requests_submitted": self.requests_submitted,
            "requests_admitted": self.requests_admitted,
            "requests_finished": self.requests_finished,
            "requests_timed_out": self.requests_timed_out,
            "requests_cancelled": self.requests_cancelled,
            "requests_rejected": self.requests_rejected,
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
        for name, vals in (("ttft_s", self.ttft_s),
                           ("ttft_steps", self.ttft_steps),
                           ("latency_s", self.latency_s)):
            if vals:
                out[f"{name}_p50"] = _percentile(vals, 50)
                out[f"{name}_p95"] = _percentile(vals, 95)
                out[f"{name}_mean"] = sum(vals) / len(vals)
        return out
