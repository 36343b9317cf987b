"""Device-memory accounting and OOM forensics (counterpart of
``deepspeed_tpu/observability/memory.py``, as far as the serving engine
reads it).

- ``MemoryAccountant``: static attribution of the long-lived buffers an
  engine owns (weights, the KV cache or page pool, slot state) to
  subsystem tags, from tensor shapes and dtypes only, plus
  ``sample_live()``, one read of the CUDA caching allocator's
  ``torch.cuda.memory_stats`` (a host-side query; it forces no device
  work). The JAX package publishes both as registry gauges; those come
  with the port's metrics registry.
- ``is_oom_error``: a device allocation failure — torch's
  ``OutOfMemoryError``, or a kernel launch of this package that failed
  with ``cudaErrorMemoryAllocation`` (``ops._common.check_launch``).
- ``oom_forensics``: the post-mortem the serving engine keeps when it
  sheds a request after an allocation failure: the allocator's stats at
  the failure and before it, and the attributed buffers, largest first.
"""

import re
import time
from typing import Dict, Optional

import torch

# the CUDA runtime's cudaErrorMemoryAllocation, as check_launch reports it
_LAUNCH_OOM = re.compile(r"cudaError 2\b")
_OOM_MARKERS = ("out of memory", "Out of memory", "OUT_OF_MEMORY")


def tree_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a tensor, a module's parameters
    and buffers, or dicts, lists, tuples and dataclasses of them), from
    shapes and dtypes only."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, torch.nn.Module):
        return sum(tree_bytes(t) for t in
                   (*tree.parameters(), *tree.buffers()))
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    fields = getattr(tree, "__dataclass_fields__", None)
    if fields is not None:
        return sum(tree_bytes(getattr(tree, f)) for f in fields)
    return 0


def device_memory_stats(index: int = 0) -> Optional[dict]:
    """The CUDA caching allocator's view of device ``index`` under the
    JAX package's key names (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit``), plus ``bytes_reserved``, ``num_ooms`` and
    ``num_alloc_retries``; None without a card."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(index)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
        "bytes_limit": torch.cuda.get_device_properties(index).total_memory,
        "num_ooms": stats.get("num_ooms", 0),
        "num_alloc_retries": stats.get("num_alloc_retries", 0),
    }


class MemoryAccountant:
    """Static attribution by (subsystem, buffer name) plus live samples.
    ``account()`` replaces by (subsystem, name), so re-accounting an
    engine re-states its footprint instead of double-counting."""

    def __init__(self):
        # subsystem tag -> {buffer name -> bytes}
        self._static: Dict[str, Dict[str, int]] = {}
        self.last_live: Optional[dict] = None
        self.live_samples = 0

    def account(self, subsystem: str, tree=None, *,
                num_bytes: Optional[int] = None,
                name: Optional[str] = None) -> int:
        """Attribute a resident buffer (``tree``, or ``num_bytes``) to
        ``subsystem``; returns its bytes."""
        if num_bytes is None:
            num_bytes = tree_bytes(tree)
        self._static.setdefault(subsystem, {})[name or subsystem] = \
            int(num_bytes)
        return int(num_bytes)

    def discard(self, subsystem: str) -> None:
        """Drop a subsystem's attribution (a torn-down engine)."""
        self._static.pop(subsystem, None)

    def subsystem_bytes(self, subsystem: str) -> int:
        return sum(self._static.get(subsystem, {}).values())

    def static_total(self) -> int:
        return sum(sum(b.values()) for b in self._static.values())

    def top_buffers(self, n: int = 8):
        """The ``n`` largest attributed buffers as ``[{"subsystem",
        "name", "bytes"}, ...]``."""
        rows = [{"subsystem": tag, "name": name, "bytes": b}
                for tag, buffers in self._static.items()
                for name, b in buffers.items()]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:max(1, int(n))]

    def sample_live(self) -> Optional[dict]:
        """One ``device_memory_stats()`` read; None without a card."""
        stats = device_memory_stats()
        if stats is None:
            return None
        self.live_samples += 1
        self.last_live = {"sampled_at_unix": time.time(), **stats}
        return self.last_live

    def report(self, top: int = 8) -> dict:
        """Per-subsystem attribution (with per-buffer detail), the static
        total, the last live sample and the top attributed buffers."""
        return {
            "by_subsystem": {tag: {"bytes": sum(buffers.values()),
                                   "buffers": dict(buffers)}
                             for tag, buffers in sorted(self._static.items())},
            "static_total_bytes": self.static_total(),
            "live": self.last_live,
            "live_samples": self.live_samples,
            "top_buffers": self.top_buffers(top),
        }


def is_oom_error(err: BaseException) -> bool:
    """Is ``err`` a device allocation failure? torch's
    ``OutOfMemoryError``, a kernel launch that failed with
    ``cudaErrorMemoryAllocation`` (``check_launch``'s "cudaError 2"), or
    a CUDA runtime error that reports running out of memory."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    if not isinstance(err, RuntimeError):
        return False
    msg = str(err)
    return (_LAUNCH_OOM.search(msg) is not None
            or any(marker in msg for marker in _OOM_MARKERS))


def oom_forensics(reason: str, accountant: MemoryAccountant,
                  top: int = 8) -> dict:
    """The allocation-failure post-mortem: a fresh allocator sample (the
    failed allocation leaves the stats readable), the last one before it,
    and the accountant's report."""
    last = accountant.last_live
    fresh = accountant.sample_live()
    return {
        "reason": reason,
        "captured_at_unix": time.time(),
        "live_at_failure": fresh,
        "last_live_snapshot": last,
        "memory": accountant.report(top),
    }


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for scale, suffix in ((1e12, "TB"), (1e9, "GB"), (1e6, "MB"),
                          (1e3, "KB")):
        if abs(n) >= scale:
            return f"{n / scale:.2f}{suffix}"
    return f"{n:.0f}B"


def format_memory_report(report: dict) -> str:
    """An accountant ``report()`` as text: one line a subsystem, the
    static total, and the live sample."""
    by_sub = report.get("by_subsystem") or {}
    if not by_sub and report.get("live") is None:
        return "(no memory attribution recorded)"
    width = max([len("subsystem")] + [len(t) for t in by_sub])
    lines = [f"{'subsystem':<{width}}  {'resident':>10}  buffers"]
    for tag, info in by_sub.items():
        names = ", ".join(sorted(info.get("buffers", {})))
        lines.append(f"{tag:<{width}}  {_fmt_bytes(info['bytes']):>10}  "
                     f"{names}")
    lines.append(f"{'TOTAL (static)':<{width}}  "
                 f"{_fmt_bytes(report.get('static_total_bytes')):>10}")
    live = report.get("live")
    if live:
        lines.append(f"live: used={_fmt_bytes(live.get('bytes_in_use'))} "
                     f"limit={_fmt_bytes(live.get('bytes_limit'))} "
                     f"peak={_fmt_bytes(live.get('peak_bytes_in_use'))}")
    else:
        lines.append("live: unavailable (no CUDA device)")
    return "\n".join(lines)
