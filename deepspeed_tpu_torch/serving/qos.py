"""Serving QoS: priority classes, SLO-aware shedding, the degradation
ladder (a copy of ``deepspeed_tpu/serving/qos.py``, kept in this package
so the port imports nothing of the JAX package).

The host-side policy plane the engine consults between decode dispatches:

- ``QosClass`` / ``QosConfig`` — the ``serving.qos`` config block: named
  priority classes (higher ``priority`` wins), per-class SLO targets on
  the decode-step clock, and the overload thresholds the degradation
  ladder trips on.
- ``QosController`` — a deterministic state machine evaluated once per
  engine iteration. Every input is host scheduler state or a
  step-denominated percentile, so the same request trace produces the
  same shed set bit for bit, run to run.

The degradation ladder (one level per sustained-overload window,
hysteresis on recovery):

  0 healthy  — admit everything; per-class SLO shedding only
  1 shed     — shed the lowest sheddable class (queued + new submits)
  2 degrade  — additionally shrink paged ``max_chunks_per_iter`` so
               prefill stops competing with decode
  3 refuse   — shed every sheddable class at submit; only protected
               classes still enter the queue

Standard library only: ``serving/config.py`` embeds ``QosConfig``.
"""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# shed reasons (Request.shed_reason / the per-reason metrics breakdown)
SHED_LADDER = "ladder"     # degradation ladder level >= 1
SHED_SLO = "slo"           # class p95 TTFT already past its SLO target
SHED_REFUSE = "refuse"     # ladder level 3: refusing sheddable admits
SHED_OOM = "oom"           # RESOURCE_EXHAUSTED while admitting/prefilling

LEVEL_HEALTHY = 0
LEVEL_SHED = 1
LEVEL_DEGRADE = 2
LEVEL_REFUSE = 3
LEVEL_NAMES = ("healthy", "shed", "degrade", "refuse")


@dataclass
class QosClass:
    """One priority class. ``priority`` is the scheduler key (higher =
    more important); the SLO fields are targets on the deterministic
    engine-iteration clock, not wall time."""
    name: str
    priority: int
    ttft_slo_steps: Optional[int] = None    # p95 TTFT target (steps);
                                            # admission sheds a sheddable
                                            # class already past it
    deadline_steps: Optional[int] = None    # default queue TTL for the
                                            # class (overrides the engine
                                            # default; per-request wins)
    preempt_after_steps: Optional[int] = None
                                            # queued this many steps with
                                            # no slot -> may preempt a
                                            # lower class (None = never)
    sheddable: bool = True                  # False = protected: the
                                            # ladder/SLO never sheds it


def default_classes() -> List[QosClass]:
    """The three-band default: protected interactive traffic that may
    preempt, best-effort standard, and sheddable batch."""
    return [
        QosClass(name="interactive", priority=2, ttft_slo_steps=32,
                 preempt_after_steps=4, sheddable=False),
        QosClass(name="standard", priority=1, ttft_slo_steps=128),
        QosClass(name="batch", priority=0),
    ]


@dataclass
class QosConfig:
    """The ``serving.qos`` config block (docs/config.md)."""
    enabled: bool = True
    classes: List[QosClass] = field(default_factory=default_classes)
    preemption: bool = True          # priority preemption-to-queue
    max_preemptions_per_iter: int = 1
    # ladder overload thresholds (None/0.0 = that signal never trips)
    shed_queue_depth: Optional[int] = None
    shed_ttft_p95_steps: Optional[int] = None    # under-load p95 TTFT
    min_free_page_frac: float = 0.0              # paged pool headroom
    ladder_patience_steps: int = 4   # consecutive overloaded iterations
                                     # before escalating one level
    recover_patience_steps: int = 16  # consecutive healthy iterations
                                      # before de-escalating one level
    degraded_max_chunks_per_iter: int = 1   # chunk budget at level >= 2
    watchdog_timeout_s: Optional[float] = None
                                     # hung-decode watchdog (wall
                                     # seconds; None = disabled)

    def __post_init__(self):
        # nested-block plumbing: dict_to_dataclass is shallow, so a JSON
        # config's class list arrives as dicts
        self.classes = [QosClass(**c) if isinstance(c, dict) else c
                        for c in self.classes]

    def validate(self) -> "QosConfig":
        if not self.classes:
            raise ValueError("serving.qos.classes must name at least one "
                             "priority class")
        prios = [c.priority for c in self.classes]
        if len(set(prios)) != len(prios):
            raise ValueError(
                f"serving.qos.classes priorities must be distinct, got "
                f"{sorted(prios)}")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(
                f"serving.qos.classes names must be distinct, got {names}")
        for c in self.classes:
            for fld in ("ttft_slo_steps", "deadline_steps",
                        "preempt_after_steps"):
                v = getattr(c, fld)
                if v is not None and v < 0:
                    raise ValueError(
                        f"serving.qos class {c.name!r}: {fld} must be >= 0 "
                        f"(or null), got {v}")
        if self.max_preemptions_per_iter < 0:
            raise ValueError("serving.qos.max_preemptions_per_iter must be "
                             f">= 0, got {self.max_preemptions_per_iter}")
        if self.ladder_patience_steps < 1:
            raise ValueError("serving.qos.ladder_patience_steps must be "
                             f">= 1, got {self.ladder_patience_steps}")
        if self.recover_patience_steps < 1:
            raise ValueError("serving.qos.recover_patience_steps must be "
                             f">= 1, got {self.recover_patience_steps}")
        if not 0.0 <= self.min_free_page_frac <= 1.0:
            raise ValueError("serving.qos.min_free_page_frac must be in "
                             f"[0, 1], got {self.min_free_page_frac}")
        if self.degraded_max_chunks_per_iter < 1:
            raise ValueError("serving.qos.degraded_max_chunks_per_iter must "
                             f"be >= 1, got "
                             f"{self.degraded_max_chunks_per_iter}")
        if (self.watchdog_timeout_s is not None
                and self.watchdog_timeout_s <= 0):
            raise ValueError("serving.qos.watchdog_timeout_s must be > 0 "
                             f"(or null), got {self.watchdog_timeout_s}")
        return self

    def class_for(self, priority: int) -> QosClass:
        """The class a request priority maps to: exact match, else the
        highest class at or below it, else the lowest class (so any int
        priority is admissible without configuring every value)."""
        best = None
        for c in self.classes:
            if c.priority == priority:
                return c
            if c.priority < priority and (best is None
                                          or c.priority > best.priority):
                best = c
        if best is not None:
            return best
        return min(self.classes, key=lambda c: c.priority)

    def lowest_sheddable(self) -> Optional[QosClass]:
        shed = [c for c in self.classes if c.sheddable]
        return min(shed, key=lambda c: c.priority) if shed else None


def standard_qos_config(num_slots: int, *, ttft_slo_steps: int = 32,
                        preempt_after_steps: int = 4,
                        shed_queue_depth: Optional[int] = None,
                        ladder_patience_steps: int = 4,
                        watchdog_timeout_s: Optional[float] = None
                        ) -> QosConfig:
    """The knob-driven three-band config: protected interactive with the
    given SLO + preemption trigger, standard at 4x the interactive SLO,
    sheddable batch, ladder overload at ``4 * num_slots`` queued unless
    overridden."""
    return QosConfig(
        classes=[
            QosClass(name="interactive", priority=2,
                     ttft_slo_steps=ttft_slo_steps,
                     preempt_after_steps=preempt_after_steps,
                     sheddable=False),
            QosClass(name="standard", priority=1,
                     ttft_slo_steps=4 * ttft_slo_steps),
            QosClass(name="batch", priority=0),
        ],
        shed_queue_depth=(shed_queue_depth if shed_queue_depth is not None
                          else 4 * num_slots),
        ladder_patience_steps=ladder_patience_steps,
        watchdog_timeout_s=watchdog_timeout_s)


class QosController:
    """Deterministic degradation-ladder state machine.

    ``observe`` runs once per engine iteration with step-clock inputs
    only (queue depth, under-load p95 TTFT in steps, free-page
    fraction); ``admit`` decides accept-vs-shed for one submission.
    No wall-clock reads anywhere, so decisions replay bit-exactly.
    """

    HISTORY = 64   # retained level transitions (the /statusz breadcrumb)

    def __init__(self, config: QosConfig):
        self.config = config.validate()
        self.level = LEVEL_HEALTHY
        self._overload_streak = 0
        self._healthy_streak = 0
        self.level_changes: List[dict] = []

    @property
    def level_name(self) -> str:
        return LEVEL_NAMES[self.level]

    def _set_level(self, iteration: int, level: int, reason: str):
        self.level_changes.append({"iteration": iteration,
                                   "from": LEVEL_NAMES[self.level],
                                   "to": LEVEL_NAMES[level],
                                   "reason": reason})
        del self.level_changes[:-self.HISTORY]
        self.level = level

    def observe(self, *, iteration: int, queue_depth: int,
                ttft_p95_steps: Optional[float],
                free_frac: Optional[float]) -> int:
        """One ladder evaluation on the decode-step clock. Escalates one
        level after ``ladder_patience_steps`` consecutive overloaded
        iterations, de-escalates one level after
        ``recover_patience_steps`` consecutive healthy ones (hysteresis:
        a boundary-riding load cannot flap the ladder per step)."""
        cfg = self.config
        reasons = []
        if (cfg.shed_queue_depth is not None
                and queue_depth >= cfg.shed_queue_depth):
            reasons.append("queue_depth")
        if (cfg.shed_ttft_p95_steps is not None and ttft_p95_steps is not None
                and ttft_p95_steps > cfg.shed_ttft_p95_steps):
            reasons.append("ttft_p95")
        if (free_frac is not None and cfg.min_free_page_frac > 0.0
                and free_frac < cfg.min_free_page_frac):
            reasons.append("page_pressure")
        if reasons:
            self._overload_streak += 1
            self._healthy_streak = 0
            if (self._overload_streak >= cfg.ladder_patience_steps
                    and self.level < LEVEL_REFUSE):
                self._set_level(iteration, self.level + 1, "+".join(reasons))
                self._overload_streak = 0
        else:
            self._healthy_streak += 1
            self._overload_streak = 0
            if (self._healthy_streak >= cfg.recover_patience_steps
                    and self.level > LEVEL_HEALTHY):
                self._set_level(iteration, self.level - 1, "recovered")
                self._healthy_streak = 0
        return self.level

    def admit(self, qos_class: QosClass, *,
              class_ttft_p95: Optional[float],
              under_load: bool = True) -> Tuple[bool, Optional[str]]:
        """Accept-or-shed for one submission of ``qos_class``. Protected
        classes always enter; sheddable ones shed when the ladder says
        so or when the class's own p95 TTFT already misses its SLO (an
        explicit early ``shed`` beats a silent queue-TTL expiry).

        ``under_load`` gates the SLO check: the p95 window only refills
        from the class's OWN completions, so after an overload burst it
        would stay frozen above the SLO forever once the class stops
        admitting. A request arriving while capacity is free cannot miss
        its TTFT target, so an idle engine always admits — the window
        then refreshes from the new completions and the signal recovers."""
        if not qos_class.sheddable:
            return True, None
        if self.level >= LEVEL_REFUSE:
            return False, SHED_REFUSE
        low = self.config.lowest_sheddable()
        if (self.level >= LEVEL_SHED and low is not None
                and qos_class.priority <= low.priority):
            return False, SHED_LADDER
        if (under_load and qos_class.ttft_slo_steps is not None
                and class_ttft_p95 is not None
                and class_ttft_p95 > qos_class.ttft_slo_steps):
            return False, SHED_SLO
        return True, None

    def queued_shed_predicate(self):
        """Predicate for the queued-request shed sweep at the current
        level (None = no sweep). Requests that already generated tokens
        are never swept — an admitted request's progress is resumable,
        so shedding it would discard paid-for work."""
        if self.level < LEVEL_SHED:
            return None
        cfg = self.config
        if self.level >= LEVEL_REFUSE:
            def pred(req):
                return (cfg.class_for(req.priority).sheddable
                        and not req.tokens)
            return pred
        low = cfg.lowest_sheddable()
        if low is None:
            return None

        def pred(req):
            c = cfg.class_for(req.priority)
            return (c.sheddable and c.priority <= low.priority
                    and not req.tokens)
        return pred

    def head_at_risk(self, request, qos_class: QosClass,
                     iteration: int) -> bool:
        """Should the queue head trigger preemption? True when its class
        opted in (``preempt_after_steps``) and it has waited at least
        that many engine iterations without a slot."""
        if not self.config.preemption:
            return False
        after = qos_class.preempt_after_steps
        if after is None or request.submitted_iteration is None:
            return False
        return iteration - request.submitted_iteration >= after

    def max_chunks(self, configured: int) -> int:
        """The effective paged ``max_chunks_per_iter`` at the current
        ladder level (level >= 2 shrinks prefill's decode interference)."""
        if self.level >= LEVEL_DEGRADE:
            return min(configured, self.config.degraded_max_chunks_per_iter)
        return configured

    def max_spec_tokens(self, configured: int) -> int:
        """The effective speculation budget at the current pressure: 0 —
        speculation fully shed — from the FIRST overloaded iteration
        (``observe`` saw an overload signal this step) or while the
        ladder sits at any shedding level. Escalation to request
        shedding needs ``ladder_patience_steps`` CONSECUTIVE overloaded
        iterations, so speculation is always the first thing to go and
        the last to come back — strictly before any request sheds.
        Pure streak/level arithmetic on the step clock: the shed
        sequence replays bit-exactly."""
        if self._overload_streak >= 1 or self.level >= LEVEL_SHED:
            return 0
        return configured

    def snapshot(self) -> dict:
        """JSON-able controller state (the /statusz qos section)."""
        return {
            "level": self.level,
            "level_name": self.level_name,
            "overload_streak": self._overload_streak,
            "healthy_streak": self._healthy_streak,
            "speculation_shed": bool(self._overload_streak >= 1
                                     or self.level >= LEVEL_SHED),
            "level_changes": list(self.level_changes),
        }
