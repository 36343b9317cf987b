"""The split-KV grid and workspace of the decode and paged attention
kernels (``csrc/decode_split.cuh``).

Both kernels split a row's keys into chunks of ``CHUNK`` keys at key
indices that are multiples of ``CHUNK`` and run one CTA a chunk; the grid's
chunk count comes from the capacity (never from the lengths, which live on
the device). A row of more than one chunk writes each chunk's fp32 partial
state (m, l, acc[d]) to a workspace and counts it on the row's counter;
the last chunk to arrive merges the partials in chunk order and resets the
counter to 0.

The workspace is one per device, shared by both kernels, allocated at
first use and grown when a call needs more (its counters zeroed only
then). Calls on one stream are ordered, so one workspace serves them all;
two launches in flight at once on different streams of one device would
share the counters and must not be made.
"""

import torch

CHUNK = 128   # keys of a chunk; the kernels' split::CHUNK

# device -> (partials fp32, counters int32, their launch arguments: the
# two pointers and sizes)
_WORKSPACES = {}


def decode_chunks(capacity: int) -> int:
    """Chunks of a decode row: a cache of ``capacity`` (S) keys."""
    return -(-capacity // CHUNK)


def paged_chunks(max_pages: int, page_len: int) -> int:
    """Chunks of a paged row: the table's pool keys plus the current
    token, which is key ``length`` (at most ``max_pages * page_len``)."""
    return -(-(max_pages * page_len + 1) // CHUNK)


def workspace_size(rows: int, chunks: int, d: int):
    """(partial floats, counters) a launch over ``rows`` (batch x heads)
    of ``chunks`` chunks at head dim ``d`` needs."""
    return rows * chunks * (d + 2), rows


def workspace(device: torch.device, rows: int, chunks: int, d: int):
    """The launch arguments of the device's workspace, grown to hold a
    launch of ``rows`` x ``chunks`` at head dim ``d``: (partials pointer,
    counters pointer, partial floats, counters)."""
    floats, counters = workspace_size(rows, chunks, d)
    ws = _WORKSPACES.get(device)
    if ws is None or ws[2][2] < floats or ws[2][3] < counters:
        if ws is not None:
            floats, counters = (max(floats, ws[2][2]),
                                max(counters, ws[2][3]))
        parts = torch.empty(floats, dtype=torch.float32, device=device)
        count = torch.zeros(counters, dtype=torch.int32, device=device)
        ws = (parts, count, (parts.data_ptr(), count.data_ptr(), floats,
                             counters))
        _WORKSPACES[device] = ws
    return ws[2]
