"""Host side of the block-sparse attention kernels: the layout plan.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py``
``LayoutPlan`` and ``compile_layout`` (:55-191). The [H, S/B, S/B] block
layout of a ``SparsityConfig`` is compiled into per-(head, q-tile) lists
of the active k-tiles (``kv_*``), the transposed per-(head, k-tile) lists
of the q-tiles that see each k-tile (``qt_*``, for dK/dV), and the
deduplicated fine masks [U, tile, tile] (a block smaller than the tile,
and the triangular diagonal tile of unidirectional configs). The refusals
are the JAX package's: ``seq_len % tile``, a block that neither divides
nor is a multiple of the tile, and a fine row with no active block each
give None (the caller takes the dense-mask route).

The tile is the port's choice. The JAX package picks 128 or 256 for the
TPU's matrix unit; the CUDA kernels (``ops/csrc/block_sparse_attention_*.cu``)
work on ``KERNEL_TILE`` = 64 tiles, which hold BigBird's 64-token blocks
exactly: at S = 4096 the BigBird-64 layout covers 14.6% of the score
matrix, a 128-tile plan 34.9% of it. ``compile_layout(config, s,
tile=128 or 256)`` builds the JAX package's plan for that tile, array for
array. ``device_plan`` keeps the plan's int32 tables and masks on a
device, cached by (``cache_key()``, seq, device), so a call copies
nothing from the host; with each list family goes its count table, which
also gives the kernels the rows' launch order (the longest lists first)
and which fine masks are all live.
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

KERNEL_TILE = 64


@dataclass
class LayoutPlan:
    """Compiled work lists for one (layout, seq, tile). All numpy."""
    kv_idx: np.ndarray         # [H, NQ, MAXK] int32, padded with 0
    kv_pid: np.ndarray         # [H, NQ, MAXK] int32 mask pattern ids
    kv_cnt: np.ndarray         # [H, NQ] int32
    qt_idx: np.ndarray         # [H, NQ, MAXQ] int32 (k-major lists)
    qt_pid: np.ndarray         # [H, NQ, MAXQ] int32
    qt_cnt: np.ndarray         # [H, NQ] int32
    masks: np.ndarray          # [U, tile, tile] int8
    tile: int
    n_heads: int
    nq: int
    active_tiles: int
    total_tiles: int
    live_pairs: int = 0        # (q, k) pairs the layout attends, all heads

    @property
    def density(self):
        return self.active_tiles / max(self.total_tiles, 1)


_PLAN_CACHE = {}


def _tileable(block: int, seq_len: int, tile: int) -> bool:
    return seq_len % tile == 0 and (tile % block == 0 or block % tile == 0)


def compile_layout(config, seq_len: int,
                   tile: int = KERNEL_TILE) -> Optional[LayoutPlan]:
    """Build the tile work lists of ``config`` at ``seq_len``; None when
    the layout cannot be tiled at ``tile`` (JAX :79-191 at a given tile)."""
    try:
        key = (config.cache_key(), seq_len, tile)
    except TypeError:
        key = None
    if key is not None and key in _PLAN_CACHE:
        return _PLAN_CACHE[key]

    block = config.block
    if not _tileable(block, seq_len, tile):
        return None
    layout = np.asarray(config.make_layout(seq_len))  # [H, nb, nb] 0/1
    nheads, nb, _ = layout.shape
    if block >= tile:
        r = block // tile
        fine = np.repeat(np.repeat(layout, r, axis=1), r, axis=2)
        nq = nb * r
        rq = 1
    else:
        rq = tile // block
        nq = seq_len // tile
        fine = layout

    # every fine q row needs >= 1 active block, else the two paths diverge
    # on the empty row (dense gives a uniform softmax)
    if not fine.any(axis=-1).all():
        return None

    causal = getattr(config, "attention", None) == "unidirectional"
    masks: list = []
    mask_ids: dict = {}

    def pattern_id(sub, rel):
        """rel: "past" = tile fully before the diagonal, "diag" = the
        triangular tile (unidirectional semantics are causal at the
        ELEMENT level)."""
        key_ = (sub.tobytes(), rel)
        if key_ not in mask_ids:
            expanded = np.kron(sub, np.ones((tile // sub.shape[0],
                                             tile // sub.shape[1]), np.int8))
            if rel == "diag":
                expanded = expanded * np.tril(
                    np.ones((tile, tile), np.int8))
            mask_ids[key_] = len(masks)
            masks.append(expanded.astype(np.int8))
        return mask_ids[key_]

    rows = [[[] for _ in range(nq)] for _ in range(nheads)]
    cols = [[[] for _ in range(nq)] for _ in range(nheads)]
    total = 0
    pids = []
    for h in range(nheads):
        for qi in range(nq):
            subrows = fine[h, qi * rq:(qi + 1) * rq]
            for ki in range(qi + 1 if causal else nq):
                sub = subrows[:, ki * rq:(ki + 1) * rq]
                if sub.any():
                    rel = "diag" if (causal and ki == qi) else "past"
                    pid = pattern_id(np.ascontiguousarray(sub), rel)
                    rows[h][qi].append((ki, pid))
                    cols[h][ki].append((qi, pid))
                    pids.append(pid)
                    total += 1

    def pad(lists):
        mx = max(1, max(len(l) for hl in lists for l in hl))
        idx = np.zeros((nheads, nq, mx), np.int32)
        pid = np.zeros((nheads, nq, mx), np.int32)
        cnt = np.zeros((nheads, nq), np.int32)
        for h in range(nheads):
            for i, l in enumerate(lists[h]):
                cnt[h, i] = len(l)
                for j, (x, p) in enumerate(l):
                    idx[h, i, j] = x
                    pid[h, i, j] = p
        return idx, pid, cnt

    kv_idx, kv_pid, kv_cnt = pad(rows)
    qt_idx, qt_pid, qt_cnt = pad(cols)
    masks_np = np.stack(masks)
    live = masks_np.reshape(len(masks), -1).sum(axis=1, dtype=np.int64)
    plan = LayoutPlan(kv_idx=kv_idx, kv_pid=kv_pid, kv_cnt=kv_cnt,
                      qt_idx=qt_idx, qt_pid=qt_pid, qt_cnt=qt_cnt,
                      masks=masks_np, tile=tile, n_heads=nheads, nq=nq,
                      active_tiles=total, total_tiles=nheads * nq * nq,
                      live_pairs=int(live[pids].sum()))
    if key is not None:
        if len(_PLAN_CACHE) >= 16:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[key] = plan
    return plan


class DevicePlan(NamedTuple):
    """A plan's tables and masks on one device (int32 lists, int8 masks)
    and the host plan they came from. ``kv_table`` / ``qt_table`` are the
    count tables the kernels take (``count_table``); ``kv_cnt`` /
    ``qt_cnt`` are views of their heads."""
    plan: LayoutPlan
    seq_len: int
    kv_idx: torch.Tensor
    kv_pid: torch.Tensor
    kv_cnt: torch.Tensor
    qt_idx: torch.Tensor
    qt_pid: torch.Tensor
    qt_cnt: torch.Tensor
    masks: torch.Tensor
    kv_table: torch.Tensor
    qt_table: torch.Tensor

    @property
    def device(self):
        return self.masks.device


def count_table(cnt: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """The kernels' int32 count table of one list family: the counts
    [H * nt], then the rows in launch order (count descending, ties by
    row: the same plan always gives the same order), then one flag per
    fine mask, 1 when every entry of the mask is live."""
    flat = cnt.reshape(-1).astype(np.int64)
    order = np.argsort(-flat, kind="stable")
    full = masks.reshape(len(masks), -1).all(axis=1)
    return np.concatenate([flat, order, full]).astype(np.int32)


_DEVICE_PLANS = {}


def device_plan(config, seq_len: int, device) -> Optional[DevicePlan]:
    """The kernels' plan (``KERNEL_TILE``) of ``config`` at ``seq_len``
    with its tables on ``device``; None when the layout does not tile or
    the config has no hashable ``cache_key()`` (the dense-mask route
    takes both)."""
    device = torch.device(device)
    try:
        key = (config.cache_key(), seq_len, str(device))
    except TypeError:
        return None
    if key in _DEVICE_PLANS:
        return _DEVICE_PLANS[key]
    plan = compile_layout(config, seq_len)
    if plan is None:
        return None
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    kv_table = to(count_table(plan.kv_cnt, plan.masks))
    qt_table = to(count_table(plan.qt_cnt, plan.masks))
    rows = plan.kv_cnt.shape
    dp = DevicePlan(plan, seq_len, to(plan.kv_idx), to(plan.kv_pid),
                    kv_table[:rows[0] * rows[1]].view(rows), to(plan.qt_idx),
                    to(plan.qt_pid), qt_table[:rows[0] * rows[1]].view(rows),
                    to(plan.masks), kv_table, qt_table)
    if len(_DEVICE_PLANS) >= 16:
        _DEVICE_PLANS.pop(next(iter(_DEVICE_PLANS)))
    _DEVICE_PLANS[key] = dp
    return dp
