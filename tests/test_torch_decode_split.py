"""The split-KV design of the decode and paged attention kernels
(``ops/csrc/decode_split.cuh``), emulated in plain PyTorch, against the
JAX package's decode and paged attention; and the wrappers' grid and
workspace sizing (``ops/decode_split.py``).

The emulation is the kernels' arithmetic in fp32 for these tests only (no
wrapper calls it): a row's keys split into chunks of ``CHUNK`` keys at key
indices that are multiples of ``CHUNK``; each chunk gives its partial
state (m, l, acc); the chunks merge in ascending order, a one-chunk row
writing acc / l. Against JAX ``decode_attention`` (its Pallas kernel in
interpret mode, as the JAX package's tests run it on the CPU) and
``paged_attention`` (``_paged_dense``, and the Pallas kernel at page_len
128): fp32, within 2e-6 of max(1, max |ref|), one function in two fp32
summation orders (int8 pages hold values up to 127 x their scale, and
their rounding grows with them). The paged
emulation over a slot's pages plus its current token is bit-equal to the
decode emulation over a cache holding the same tokens: the chunk
boundaries depend on the key index alone.
"""

import os
import re
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.layers import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas.decode_attention import \
    decode_attention as jax_decode_attention
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_attention as jax_paged_attention
from deepspeed_tpu_torch.models.layers import alibi_slopes
from deepspeed_tpu_torch.ops import decode_split, op_builder
from deepspeed_tpu_torch.ops.decode_split import CHUNK
from deepspeed_tpu_torch.ops.op_builder import SIGNATURES
from tests.torch_threads import share_cores

share_cores()

HEADS, CAPACITY = 2, 1024
LENGTHS = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 300, CAPACITY]
ATOL = 2e-6   # of max(1, max |ref|)


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=ATOL * max(1.0, np.abs(ref).max()))


# --------------------------------------------------------------------------
# the emulation
# --------------------------------------------------------------------------

def merge_chunks(qf, keys, values, bias):
    """One row: qf [d] (scaled q), keys / values [n, d], bias [n] (ALiBi,
    0 without), all fp32. Chunks of CHUNK keys give (m, l, acc); a row of
    one chunk returns acc / l, else the max of the m, then l and acc
    summed in ascending chunk order, each scaled by exp(m_i - max)."""
    parts = []
    for c0 in range(0, keys.shape[0], CHUNK):
        s = keys[c0:c0 + CHUNK] @ qf + bias[c0:c0 + CHUNK]
        m = s.max()
        p = torch.exp(s - m)
        parts.append((m, p.sum(), p @ values[c0:c0 + CHUNK]))
    if len(parts) == 1:
        _, l, acc = parts[0]
        return acc / l
    mm = torch.stack([m for m, _, _ in parts]).max()
    lsum = torch.zeros((), dtype=torch.float32)
    asum = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp(m - mm)
        lsum = lsum + l * f
        asum = asum + acc * f
    return asum / lsum


def emulate_decode(q, k, v, lengths, slopes=None):
    """q [B, H, d]; k/v [B, H, S, d]; fp32. Row (b, h) reads min(length,
    S) keys with ALiBi column j - (length - 1); rows of length <= 0 give
    zeros."""
    B, H, d = q.shape
    scale = 1.0 / np.sqrt(d)
    out = torch.zeros(B, H, d)
    for b in range(B):
        length = int(lengths[b])
        n = max(0, min(length, k.shape[2]))
        if n == 0:
            continue
        col = torch.arange(n, dtype=torch.float32)
        for h in range(H):
            slope = 0.0 if slopes is None else float(slopes[h])
            out[b, h] = merge_chunks(q[b, h] * scale, k[b, h, :n],
                                     v[b, h, :n],
                                     slope * (col - float(length - 1)))
    return out


def emulate_paged(q, k_pages, v_pages, table, lengths, k_new, v_new,
                  slopes=None, k_scale=None, v_scale=None):
    """q, k_new, v_new [B, H, d]; pools [pages, H, page_len, d] (int8 with
    fp32 scales [pages, H, page_len]). Slot b reads its n = min(length,
    capacity) pool keys through the table (logical page clamped to
    max_pages - 1) and the current token as key n: ALiBi column j -
    length for pool keys, 0 for the current token."""
    B, H, d = q.shape
    page_len, max_pages = k_pages.shape[2], table.shape[1]
    scale = 1.0 / np.sqrt(d)
    out = torch.zeros(B, H, d)
    for b in range(B):
        length = int(lengths[b])
        n = min(length, max_pages * page_len)
        j = torch.arange(n)
        pages = table[b, torch.clamp(j // page_len, max=max_pages - 1)].long()
        off = j % page_len
        col = torch.cat([j.float() - float(length), torch.zeros(1)])
        for h in range(H):
            kk = k_pages[pages, h, off].float()
            vv = v_pages[pages, h, off].float()
            if k_scale is not None:
                kk = kk * k_scale[pages, h, off][:, None]
                vv = vv * v_scale[pages, h, off][:, None]
            slope = 0.0 if slopes is None else float(slopes[h])
            out[b, h] = merge_chunks(
                q[b, h] * scale, torch.cat([kk, k_new[b, h][None]]),
                torch.cat([vv, v_new[b, h][None]]), slope * col)
    return out


# --------------------------------------------------------------------------
# cases
# --------------------------------------------------------------------------

def _decode_case(seed, d):
    r = np.random.RandomState(seed)
    B = len(LENGTHS)
    q = r.randn(B, HEADS, d).astype(np.float32)
    k, v = (r.randn(B, HEADS, CAPACITY, d).astype(np.float32)
            for _ in range(2))
    return q, k, v, np.array(LENGTHS, np.int32)


def _paged_case(seed, d, page_len, quant):
    """Each slot owns ceil(length / page_len) pages of a shuffled pool; the
    rest of its table row is the null page 0, which holds NaN (int8
    pools: NaN scales), as do the unowned tails of last pages."""
    r = np.random.RandomState(seed)
    B, max_pages = len(LENGTHS), CAPACITY // page_len
    owned = [-(-n // page_len) for n in LENGTHS]
    num_pages = sum(owned) + 1
    perm = r.permutation(np.arange(1, num_pages))
    table = np.zeros((B, max_pages), np.int32)
    at = 0
    for b, own in enumerate(owned):
        table[b, :own] = perm[at:at + own]
        at += own
    shape = (num_pages, HEADS, page_len, d)
    q, kn, vn = (r.randn(B, HEADS, d).astype(np.float32) for _ in range(3))
    if quant:
        k, v = (r.randint(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (r.rand(*shape[:3]).astype(np.float32) * 0.05
                  for _ in range(2))
        poison = (ks, vs)
    else:
        k, v = (r.randn(*shape).astype(np.float32) for _ in range(2))
        ks = vs = None
        poison = (k, v)
    for x in poison:
        x[0] = np.nan
        for b, n in enumerate(LENGTHS):
            if n % page_len:
                x[table[b, n // page_len], :, n % page_len:] = np.nan
    return q, kn, vn, k, v, ks, vs, table, np.array(LENGTHS, np.int32)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# the emulation against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_decode_emulation_matches_jax_decode_attention(d, alibi):
    q, k, v, lengths = _decode_case(d, d)
    ref = jax_decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k.swapaxes(2, 3)),
        jnp.asarray(v.swapaxes(2, 3)), jnp.asarray(lengths),
        alibi_slopes=jax_alibi_slopes(HEADS) if alibi else None,
        block_k=128)
    got = emulate_decode(_t(q), _t(k), _t(v), lengths,
                         alibi_slopes(HEADS) if alibi else None)
    _close(got.numpy(), ref[:, 0])
    assert not got[0].any()            # length 0: zeros


PAGED_CASES = [  # (page_len, d, alibi, int8 pages)
    (16, 64, False, False), (16, 80, True, False), (16, 96, False, True),
    (16, 128, True, True), (128, 64, True, False), (128, 80, False, False),
    (128, 96, True, True), (128, 128, False, True)]


@pytest.mark.parametrize("page_len,d,alibi,quant", PAGED_CASES)
def test_paged_emulation_matches_jax_paged_dense(page_len, d, alibi, quant):
    _check_paged_against_jax(page_len, d, alibi, quant, "dense")


@pytest.mark.parametrize("alibi,quant", [(True, False), (False, True)])
def test_paged_emulation_matches_jax_paged_kernel(alibi, quant):
    _check_paged_against_jax(128, 64, alibi, quant, "kernel")


def _check_paged_against_jax(page_len, d, alibi, quant, impl):
    q, kn, vn, k, v, ks, vs, table, lengths = _paged_case(
        page_len + d, d, page_len, quant)
    pool = lambda x: jnp.asarray(x.transpose(0, 1, 3, 2))
    ref = jax_paged_attention(
        jnp.asarray(q)[:, None], pool(k), pool(v), jnp.asarray(table),
        jnp.asarray(lengths), jnp.asarray(kn), jnp.asarray(vn),
        alibi_slopes=jax_alibi_slopes(HEADS) if alibi else None,
        k_scale=None if ks is None else jnp.asarray(ks[:, :, None, :]),
        v_scale=None if vs is None else jnp.asarray(vs[:, :, None, :]),
        impl=impl)
    got = emulate_paged(_t(q), _t(k), _t(v), _t(table), lengths, _t(kn),
                        _t(vn), alibi_slopes(HEADS) if alibi else None,
                        _t(ks), _t(vs))
    assert np.isfinite(got.numpy()).all()
    _close(got.numpy(), ref[:, 0])
    # a slot of length 0 attends only itself
    np.testing.assert_array_equal(got[0].numpy(), vn[0])


@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
@pytest.mark.parametrize("page_len", [16, 128])
def test_paged_emulation_is_the_decode_emulation(page_len, alibi):
    """Over a slot's pages plus its current token the paged emulation
    gives the decode emulation's bits over a cache of the same n + 1
    tokens: the same chunks at the same key indices."""
    q, kn, vn, k, v, _, _, table, lengths = _paged_case(7, 64, page_len,
                                                        False)
    B, d = len(LENGTHS), 64
    kc = np.zeros((B, HEADS, CAPACITY + 1, d), np.float32)
    vc = np.zeros_like(kc)
    for b, n in enumerate(LENGTHS):
        pages = table[b, :-(-n // page_len)]
        kc[b, :, :n] = k[pages].transpose(1, 0, 2, 3).reshape(
            HEADS, -1, d)[:, :n]
        vc[b, :, :n] = v[pages].transpose(1, 0, 2, 3).reshape(
            HEADS, -1, d)[:, :n]
        kc[b, :, n], vc[b, :, n] = kn[b], vn[b]
    slopes = alibi_slopes(HEADS) if alibi else None
    paged = emulate_paged(_t(q), _t(k), _t(v), _t(table), lengths, _t(kn),
                          _t(vn), slopes)
    decode = emulate_decode(_t(q), _t(kc), _t(vc), lengths + 1, slopes)
    assert torch.equal(paged, decode)


def test_one_chunk_is_its_merge():
    """A row of one chunk writes acc / l: the bits its merge gives, whose
    factor is exp(m - m) = 1."""
    r = np.random.RandomState(3)
    qf, keys, values = (torch.from_numpy(r.randn(*s).astype(np.float32))
                        for s in ((64,), (CHUNK, 64), (CHUNK, 64)))
    bias = torch.zeros(CHUNK)
    direct = merge_chunks(qf, keys, values, bias)
    s = keys @ qf
    m = s.max()
    p = torch.exp(s - m)
    f = torch.exp(m - m)
    merged = (torch.zeros(64) + (p @ values) * f) / (
        torch.zeros(()) + p.sum() * f)
    assert float(f) == 1.0 and torch.equal(direct, merged)


# --------------------------------------------------------------------------
# grid and workspace
# --------------------------------------------------------------------------

def test_chunk_is_the_kernels():
    path = os.path.join(os.path.dirname(op_builder.__file__), "csrc",
                        "decode_split.cuh")
    with open(path) as f:
        m = re.search(r"#define DS_SPLIT_CHUNK (\d+)", f.read())
    assert m and int(m.group(1)) == CHUNK == 128


@pytest.mark.parametrize("capacity,chunks", [
    (1, 1), (CHUNK - 1, 1), (CHUNK, 1), (CHUNK + 1, 2), (1024, 8),
    (1025, 9), (8192, 64)])
def test_decode_chunks_come_from_the_capacity(capacity, chunks):
    assert decode_split.decode_chunks(capacity) == chunks


@pytest.mark.parametrize("max_pages,page_len,chunks", [
    (1, 1, 1), (1, CHUNK - 1, 1), (1, CHUNK, 2), (8, 128, 9), (64, 16, 9),
    (13, 16, 2), (64, 128, 65)])
def test_paged_chunks_count_the_current_token(max_pages, page_len, chunks):
    """The current token is key n <= max_pages * page_len."""
    assert decode_split.paged_chunks(max_pages, page_len) == chunks


def test_workspace_is_allocated_once_and_grown(monkeypatch):
    monkeypatch.setattr(decode_split, "_WORKSPACES", {})
    dev = torch.device("cpu")
    held = lambda: decode_split._WORKSPACES[dev]
    args = decode_split.workspace(dev, 24, 8, 64)
    parts, counters = held()[:2]
    assert args == (parts.data_ptr(), counters.data_ptr(), 24 * 8 * 66, 24)
    assert parts.numel() == 24 * 8 * 66 and counters.numel() == 24
    assert parts.dtype == torch.float32 and counters.dtype == torch.int32
    assert not counters.any()
    counters[3] = 7                   # a launch in flight leaves no mark
    assert decode_split.workspace(dev, 12, 4, 128) == args   # fits: same
    assert held()[0] is parts and held()[1] is counters
    decode_split.workspace(dev, 48, 2, 64)    # more rows: grows
    assert held()[0].numel() == 24 * 8 * 66 and held()[1].numel() == 48
    assert not held()[1].any()
    grown = decode_split.workspace(dev, 24, 65, 64)  # more partials
    assert grown[2:] == (24 * 65 * 66, 48)
    assert grown[:2] == (held()[0].data_ptr(), held()[1].data_ptr())


@pytest.fixture
def fake_lib(monkeypatch):
    """op_builder.load() returns a library whose entry points record
    their arguments; the wrappers' launches run on CPU tensors."""
    calls = []

    def entry(name):
        def fn(*args):
            assert len(args) == len(SIGNATURES[name]), name
            calls.append((name, args))
            return 0
        return fn
    lib = types.SimpleNamespace(**{n: entry(n) for n in SIGNATURES})
    monkeypatch.setattr(op_builder, "load", lambda *a, **k: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(decode_split, "_WORKSPACES", {})
    return calls


def test_decode_launch_takes_the_workspace(fake_lib):
    from deepspeed_tpu_torch.ops.decode_attention import _launch
    B, H, S, d = 3, 2, 300, 64
    q = torch.zeros(B, H, d, dtype=torch.bfloat16)
    k = torch.zeros(B, H, S, d, dtype=torch.bfloat16)
    lengths = torch.tensor([0, 5, 300], dtype=torch.int32)
    for _ in range(2):
        _launch(q, k, k, lengths, None, 0.125)
    (_, a), (_, b) = fake_lib
    parts, counters, _ = decode_split._WORKSPACES[q.device]
    # partials, counters and their sizes; the same buffers every call
    assert a[6:10] == b[6:10] == (parts.data_ptr(), counters.data_ptr(),
                                  B * H * 3 * (d + 2), B * H)


def test_paged_launch_takes_the_workspace(fake_lib):
    from deepspeed_tpu_torch.ops.paged_attention import _launch
    B, H, d, page_len, max_pages = 2, 2, 80, 16, 16
    q = torch.zeros(B, H, d)
    pool = torch.zeros(5, H, page_len, d)
    table = torch.zeros(B, max_pages, dtype=torch.int32)
    lengths = torch.tensor([3, 40], dtype=torch.int32)
    _launch(q, pool, pool, table, lengths, q, q, None, None, None, 0.1)
    _launch(q, pool, pool, table, lengths, q, q, None, None, None, 0.1)
    (_, a), (_, b) = fake_lib
    parts, counters, _ = decode_split._WORKSPACES[q.device]
    chunks = decode_split.paged_chunks(max_pages, page_len)    # 257 keys
    assert chunks == 3
    assert a[11:15] == b[11:15] == (parts.data_ptr(), counters.data_ptr(),
                                    B * H * chunks * (d + 2), B * H)
