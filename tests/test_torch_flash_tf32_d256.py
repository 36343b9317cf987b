"""The fp32 flash kernels at head dim 256 on tf32 wgmma, from the CPU.

``csrc/flash_tf32.cuh`` runs the fp32 (3xTF32) forward, dQ, dK and dV at
d 256 on tf32 wgmma warpgroups, behind the fp32 entry points that the
other head dims use. They run only on the card (``chip_smoke.py`` phases
2, 3, 12 and 13); held here:

- the forward's summation order, emulated: online-softmax steps of
  ``R_FWD`` = 32 keys (the narrower dims take 64), S over the head dim in
  3xTF32 steps of 8 in order, each step's p' V over its keys in 3xTF32
  steps of 8. It holds the plain forward within 1e-5 of max(1, max |ref|)
  (O and the LSE), and JAX's forward (its Pallas kernel in interpret
  mode, the keep bits of the same seed) within the card's fp32 gate, at
  dropout 0 and 0.1, with and without a padding bias; plain TF32 in the
  same order misses the gate;
- the backward in the kernels' order (``tests/test_torch_head_dim_256_
  train.py``'s emulation: every product in ordered 3xTF32 steps of 8)
  against ``jax.vjp`` through JAX's Pallas kernels within the gate;
- the kernels' split (``split_trunc``): hi the truncation of x to tf32,
  lo = x - hi exactly, hi + tf32(lo) within 2^-20 |x| of x;
- the 128-byte swizzle of the fp32 tiles, the stagers' addresses and the
  wgmma descriptors' reads against the hardware's address function, in a
  model of shared memory that computes both products of a step from
  what the stagers write and what the descriptors read; the resident
  fragment slots against the tf32 A fragment;
- the shared-memory budgets the header states, and that the fp32 entry
  points send d 256 to the tf32 kernels (sources; the wrappers through a
  stand-in library); that the spill gate names every instance, and that
  ``tools/d256_ablation.py --fp32`` and ``tools/d256_phase_profile.py``
  find the text they edit.
"""

import ast
import importlib
import math
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu.ops.pallas.flash_attention import (
    _flash_fwd as jax_flash_fwd, pack_dropout_seeds)
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._common import NEG_INF
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention_reference, resolve_dropout)
from deepspeed_tpu_torch.ops.op_builder import SIGNATURES

from tests.test_torch_abi import fake_lib  # noqa: F401  (a fixture)
from tests.test_torch_flash_bwd import _bias, _inputs, _words
from tests.test_torch_head_dim_256_train import (_steps_3xtf32,
                                                 backward_d256_kernel_order,
                                                 split_trunc)
from tests.test_torch_tf32x3 import GATE, kernel_exp, max_rel
from tests.torch_threads import share_cores

share_cores()

fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
CSRC = os.path.join(os.path.dirname(op_builder.__file__), "csrc")
D = 256
R_FWD = 32          # flash_tf32.cuh Cfg<FWD>::R: the forward's key step
CLOSE = 1e-5        # the kernels' order against the plain versions


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated, against the plain versions and JAX
# ---------------------------------------------------------------------------

def forward_d256_kernel_order(q, k, v, bias, causal, dropout,
                              steps=_steps_3xtf32):
    """(o, lse) as the d-256 fp32 forward sums them: S = Q K^T over the
    head dim and each step's p' V over its R_FWD keys, both in ordered
    8-deep steps of ``steps``; the online softmax of flash_attention_fwd.cu
    (max in natural units, then ex2) over R_FWD-key steps."""
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    s = steps("bhqd,bhkd->bhqk", qh, kh, 3, 3) * (1.0 / math.sqrt(D))
    if bias is not None:
        s = s + bias
    if causal:
        row = torch.arange(sq)[:, None] + (sk - sq)
        s = torch.where(torch.arange(sk)[None, :] <= row, s, NEG_INF)
    keep = dropout.keep(s.shape, q.device) if dropout is not None else None
    m = torch.full((*s.shape[:3], 1), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((*s.shape[:3], D))
    for k0 in range(0, sk, R_FWD):
        st = s[..., k0:k0 + R_FWD]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.where(m_new > NEG_INF / 2, kernel_exp(st - m_new), 0.0)
        alpha = kernel_exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + R_FWD], p * dropout.inv_keep,
                            0.0)
        acc = acc * alpha + steps("bhqk,bhkd->bhqd", p,
                                  vh[:, :, k0:k0 + R_FWD], 3, 2)
        m = m_new
    safe_l = torch.where(l > 0.0, l, 1.0)
    lse = torch.where(l > 0.0, m + torch.log(safe_l), NEG_INF)[..., 0]
    return (acc / safe_l).transpose(1, 2), lse


def _steps_tf32(eq, a, b, a_dim, b_dim):
    """Plain TF32 (hi(a) hi(b)) in the same ordered 8-deep steps."""
    acc = None
    for i in range(0, a.shape[a_dim], 8):
        part = torch.einsum(
            eq, split_trunc(a.narrow(a_dim, i, 8).contiguous())[0],
            split_trunc(b.narrow(b_dim, i, 8).contiguous())[0])
        acc = part if acc is None else acc + part
    return acc


def _case(rate, bias_kind, seed, b=1, h=2, s=128):
    q, k, v, g, rng = _inputs(b, s, s, h, D, seed)
    bias = _bias(bias_kind, b, h, s, s, rng)
    drop = resolve_dropout(rate, _words(seed), h)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tb = None if bias is None else torch.from_numpy(bias)
    return (q, k, v, g, bias), (tq, tk, tv, tg, tb), drop


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", [None, "padding"])
def test_d256_fp32_forward_order_holds_the_plain_forward_and_jax(
        bias_kind, rate):
    (q, k, v, _, bias), (tq, tk, tv, _, tb), drop = _case(rate, bias_kind,
                                                          21)
    ro, rlse = flash_attention_reference(tq, tk, tv, tb, causal=True,
                                         dropout=drop)
    o, lse = forward_d256_kernel_order(tq, tk, tv, tb, True, drop)
    assert max_rel([o], [ro]) <= CLOSE
    assert max_rel([lse], [rlse]) <= CLOSE
    ref, ref_lse = jax_flash_fwd(
        *(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)),
        None if bias is None else jnp.asarray(bias),
        pack_dropout_seeds(jax.random.PRNGKey(21)) if rate else None,
        D ** -0.5, True, rate, q.shape[2], 64)
    jo = torch.from_numpy(np.array(jnp.swapaxes(ref, 1, 2)))
    assert max_rel([o], [jo]) <= GATE
    assert max_rel([lse], [torch.from_numpy(np.array(ref_lse)[..., 0])]) \
        <= GATE


def test_plain_tf32_in_the_forward_order_fails_the_fp32_gate():
    _, (tq, tk, tv, _, _), _ = _case(0.0, None, 22)
    ro, _ = flash_attention_reference(tq, tk, tv, None, causal=True)
    o, _ = forward_d256_kernel_order(tq, tk, tv, None, True, None,
                                     steps=_steps_tf32)
    assert max_rel([o], [ro]) > GATE


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", [None, "padding"])
def test_d256_fp32_backward_order_holds_jax_vjp(bias_kind, rate):
    (q, k, v, g, bias), (tq, tk, tv, tg, tb), drop = _case(rate, bias_kind,
                                                           23)
    key = jax.random.PRNGKey(23)

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_,
                         bias=None if bias is None else jnp.asarray(bias),
                         causal=True, dropout_rate=rate,
                         dropout_rng=key if rate else None, bias_grad=False,
                         block_q=64)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    refs = [torch.from_numpy(np.array(r)) for r in vjp(jnp.asarray(g))]
    o, lse = flash_attention_reference(tq, tk, tv, tb, causal=True,
                                       dropout=drop)
    got = backward_d256_kernel_order(tq, tk, tv, o, lse, tg, tb, True, drop)
    assert max_rel(got, refs) <= GATE


def test_the_split_is_a_truncation_and_its_exact_remainder():
    """``split_trunc`` (the kernels' split, ``split_trunc`` here): hi is x
    toward zero at 10 mantissa bits (reckoned in float64 from frexp), lo
    = x - hi exactly, and hi + tf32(lo) within 2^-20 |x| of x (and a
    subnormal tf32 unit), over magnitudes from subnormal to 3e38."""
    src = _source("wgmma.cuh")
    assert "hi = __float_as_uint(x) & 0xFFFFE000u;" in src
    assert "lo = __float_as_uint(x - __uint_as_float(hi));" in src
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.standard_normal(1 << 14) * 10.0 ** rng.integers(-30, 30, 1 << 14),
        np.array([0.0, -0.0, 1e-40, -3e-42, 65504.0, 3e38])]).astype(
            np.float32)
    t = torch.from_numpy(x)
    hi = (t.view(torch.int32) & ~0x1FFF).view(torch.float32).numpy()
    _, lo = split_trunc(t)
    mant, exp = np.frexp(x.astype(np.float64))
    step = np.maximum(np.ldexp(1.0, exp - 11), 2.0 ** -136)  # a tf32 unit
    assert np.array_equal(hi.astype(np.float64),
                          np.trunc(x.astype(np.float64) / step) * step)
    rem = x.astype(np.float64) - hi.astype(np.float64)
    assert np.array_equal((x - hi).astype(np.float64), rem)   # exact
    got = hi.astype(np.float64) + lo.numpy().astype(np.float64)
    # below 2^-126 a tf32 unit is 2^-136, so a subnormal x loses up to one
    assert (np.abs(got - x) <= 2.0 ** -20 * np.abs(x) + 2.0 ** -136).all()


# ---------------------------------------------------------------------------
# the tiles in shared memory, modelled
# ---------------------------------------------------------------------------

NT = 128                        # threads of a warpgroup


def sw128(off):
    """The SW128 address function: bits 4-6 XOR bits 7-9."""
    return off ^ (((off >> 7) & 7) << 4)


def sw128_f32(r, k):            # wgmma.cuh
    return r * 32 + ((k ^ (r & 7)) << 2)


def trans_col_bytes(v):         # wgmma.cuh
    return (v // 32) * D * 128 + (v % 32) * 4


def stage_split(rows):
    """The floats ``store_split`` writes for a [R][D] operand: the hi
    plane, then the lo plane (the model keeps values, hi = lo = x)."""
    R = rows.shape[0]
    mem = np.full(2 * R * D, np.nan)
    CH, STEP = D // 4, NT // (D // 4)
    for tid in range(NT):
        c = tid % CH
        base = (c >> 3) * R * 32
        for i in range(R // STEP):
            r = tid // CH + i * STEP
            for e in range(4):
                mem[base + sw128_f32(r, c & 7) + e] = rows[r, 4 * c + e]
                mem[base + R * D + sw128_f32(r, c & 7) + e] = rows[r,
                                                                  4 * c + e]
    return mem


def stage_split_t(rows):
    """The floats ``store_split_t`` writes for a [R][D] operand staged
    transposed: [D][32]-float tiles, hi at columns 0..R-1, lo at R..2R-1."""
    R = rows.shape[0]
    mem = np.full(max(2 * R, 32) * D, np.nan)
    KQ, STEP = R // 4, NT // (R // 4)
    for tid in range(NT):
        c = tid % KQ
        row = (c >> 1) * 8 + (c & 1)
        vh, vl = 4 * c, R + 4 * c
        for pss in range(D // 4 // STEP):
            for e in range(4):
                d = (tid // KQ + pss * STEP) * 4 + e
                for i in range(4):
                    x = rows[row + 2 * i, d]
                    mem[(vh // 32) * D * 32 + sw128_f32(d, (vh % 32) >> 2)
                        + i] = x
                    mem[(vl // 32) * D * 32 + sw128_f32(d, (vl % 32) >> 2)
                        + i] = x
    return mem


def descriptor_read(mem, start_bytes, n, kp):
    """What a K-major SW128 descriptor starting ``start_bytes`` into a
    1024-byte aligned tile (SBO 1024) reads for row n, k position kp of an
    8-deep tf32 step."""
    off = start_bytes + (n // 8) * 1024 + (n % 8) * 128 + kp * 4
    return mem[sw128(off) // 4]


@pytest.mark.parametrize("R", [16, 32])
def test_the_plain_stager_and_the_s_descriptors_read_the_operand(R):
    """S = A B^T read back through the S products' descriptors (step kk
    of the hi plane at (kk / 4) R 128 + (kk % 4) 32 bytes; the lo plane R
    D 4 bytes on) from what stage_split wrote: B[n][8kk + kp] for every
    row, step and position; and every float of both planes written."""
    rng = np.random.default_rng(R)
    rows = rng.standard_normal((R, D))
    mem = stage_split(rows)
    assert not np.isnan(mem).any()
    for plane in (0, R * D * 4):
        for kk in range(D // 8):
            start = plane + (kk >> 2) * R * 128 + (kk & 3) * 32
            for n in range(R):
                for kp in range(8):
                    assert descriptor_read(mem, start, n, kp) == \
                        rows[n, 8 * kk + kp]
    src = _source("flash_tf32.cuh")
    assert ("const uint32_t off = (kk >> 2) * N * 128 + (kk & 3) * 32;"
            in src)
    assert "constexpr uint32_t LO = N * D * 4;" in src


@pytest.mark.parametrize("R", [16, 32])
def test_the_transposed_stager_feeds_the_accumulating_product(R):
    """acc += X T modelled end to end: X's accumulator fragment turned
    into A fragments in c_to_a_tf32's order (position t <- column 2t,
    t + 4 <- 2t + 1), T read through the descriptors (hi plane's step j at
    virtual column 8j, lo's at R + 8j) from what stage_split_t wrote;
    the sum over the positions equals X T exactly, in both planes."""
    rng = np.random.default_rng(R + 1)
    rows = rng.integers(-8, 8, (R, D)).astype(np.float64)
    x = rng.integers(-8, 8, (64, R)).astype(np.float64)
    mem = stage_split_t(rows)
    assert not np.isnan(mem[:2 * R * D]).any()
    want = x @ rows
    for v0 in (0, R):                               # hi, lo plane
        got = np.zeros((64, D))
        for j in range(R // 8):
            start = trans_col_bytes(v0 + 8 * j)
            b = np.array([[descriptor_read(mem, start, n, kp)
                           for kp in range(8)] for n in range(D)])
            for row in range(64):
                # the C fragment of block j: columns 8j + 2t, 8j + 2t + 1
                c = x[row, 8 * j:8 * j + 8]
                a = np.empty(8)
                for t in range(4):
                    a[t], a[t + 4] = c[2 * t], c[2 * t + 1]
                got[row] += b @ a
        assert np.array_equal(got, want)
    src = _source("wgmma.cuh")
    assert "const int row = r0 + (c >> 1) * 8 + (c & 1);" in src
    assert "return (v / 32) * D * 128 + (v % 32) * 4;" in src


def test_the_resident_fragment_slots_are_the_tf32_a_fragment():
    """load_frags' slot (kk, tid) holds rows 16w + g and + 8, columns
    8kk + t and + 4, in register order a0..a3 of the tf32 wgmma A
    fragment (a_i: row 16w + g + 8 (i % 2), column t + 4 (i / 2))."""
    src = _source("flash_tf32.cuh")
    assert "make_float4(oka ? __ldg(pa + 8 * kk) : 0.f," in src
    assert "okb ? __ldg(pb + 8 * kk) : 0.f," in src
    assert "oka ? __ldg(pa + 8 * kk + 4) : 0.f," in src
    assert "okb ? __ldg(pb + 8 * kk + 4) : 0.f);" in src
    for tid in range(NT):
        w, g, t = tid >> 5, (tid & 31) >> 2, tid & 3
        slot = [(16 * w + g, t), (16 * w + g + 8, t), (16 * w + g, t + 4),
                (16 * w + g + 8, t + 4)]
        frag = [(16 * w + g + 8 * (i % 2), t + 4 * (i // 2))
                for i in range(4)]
        assert slot == frag


def test_the_shared_memory_budgets():
    """Cfg::smem() of each kernel within a CTA's 232,448 bytes, and the
    byte counts the header states."""
    def smem(two):
        R, npl = (16, 3) if two else (32, 2)
        return (1024 + (2 if two else 1) * 64 * D * 4 + npl * 2 * R * D * 4
                + 2 * 2 * R * 4 + 2 * npl * 8)

    src = _source("flash_tf32.cuh")
    assert ("return 1024 + RES + NPL * PAIR + 2 * 2 * R * 4 + 2 * NPL * 8;"
            in src)
    for two in (False, True):
        assert smem(two) <= 232448
        assert f"{smem(two):,}" in src


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------

def test_fp32_d256_dispatches_to_the_tf32_kernels():
    fwd = _source("flash_attention_fwd.cu")
    assert "if (d == 256) return launch_tf32<DROP>(DS_FLASH_ARGS);" in fwd
    assert "tf32::launch<tf32::FWD>(tf32::flash_fwd_tf32_kernel<DROP>" in fwd
    assert 'static_assert(D <= 128, "d = 256 runs flash_fwd_tf32_kernel");' \
        in fwd
    bwd = _source("flash_attention_bwd.cu")
    dkv = bwd[bwd.index("int launch_dkv("):]
    dkv = dkv[:dkv.index("\n}\n")]
    assert dkv.index("tf32::flash_bwd_dv_tf32_kernel<DROP>") < dkv.index(
        "tf32::flash_bwd_dk_tf32_kernel<DROP>")
    dq = bwd[bwd.index("int launch_dq("):]
    assert "tf32::flash_bwd_dq_tf32_kernel<DROP>" in dq[:dq.index("\n}\n")]
    # the replaced kernels are gone: design (c)'s column split and the
    # forward's one-stage instance
    assert "cols_kernel" not in bwd and "one_stage" not in fwd


def test_fp32_d256_wrappers_call_the_fp32_entries(fake_lib):  # noqa: F811
    """Forward, dK/dV and dQ at d 256 in fp32 through a stand-in library:
    the fp32 entries (dtype code 0) with their argument counts and d 256;
    one launch counted each."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 70, 2, 256)).astype(np.float32)) for _ in range(4))
    before = (fa.flash_attention.launches,
              fa.flash_attention_bwd.dkv_launches,
              fa.flash_attention_bwd.dq_launches)
    o, lse = fa._launch(q, k, v, None, True, 256 ** -0.5, None)
    ops = fa.bwd_operands(q, k, v, o, lse, do, None)
    fa.launch_bwd_dkv(ops, True, 256 ** -0.5, None)
    fa.launch_bwd_dq(ops, True, 256 ** -0.5, None)
    assert [c[0] for c in fake_lib] == [
        "flash_attention_fwd", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq"]
    fwd, dkv, dq = (c[1] for c in fake_lib)
    assert fwd[6:12] == (0, 1, 2, 70, 70, 256)
    assert dkv[9:15] == (0, 1, 2, 70, 70, 256)
    assert dq[8:14] == (0, 1, 2, 70, 70, 256)
    for name, call in fake_lib:
        assert len(call) == len(SIGNATURES[name])
    after = (fa.flash_attention.launches,
             fa.flash_attention_bwd.dkv_launches,
             fa.flash_attention_bwd.dq_launches)
    assert np.subtract(after, before).tolist() == [1, 1, 1]


def test_the_kernels_gate_on_no_spill_and_name_every_instance():
    """chip_smoke.py's D256_ENTRIES name the four tf32 kernels, two
    instances each (dropout off, on), all gated on 0 spill bytes."""
    with open(os.path.join(os.path.dirname(CSRC), "..", "..",
                           "chip_smoke.py")) as f:
        text = f.read()
    block = text[text.index("D256_ENTRIES = ("):]
    block = block[:block.index("\n\n")]
    for kernel in ("flash_fwd_tf32_kernel", "flash_bwd_dq_tf32_kernel",
                   "flash_bwd_dk_tf32_kernel", "flash_bwd_dv_tf32_kernel"):
        assert re.search(rf'r"{kernel}I", 2\)', block), kernel
        assert f"void __launch_bounds__(2 * NT, 1)\n    {kernel}(" in \
            _source("flash_tf32.cuh")
    assert "gated" not in text[text.index("def check_d256_spills"):][:800]


def _literal(path, name):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == name):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no {name} in {path}")


@pytest.mark.parametrize("tool,name", [
    ("d256_ablation.py", "VARIANTS_FP32"),
    ("d256_phase_profile.py", "MARKS")])
def test_the_tools_find_their_text(tool, name):
    """``tools/d256_ablation.py --fp32`` edits and
    ``tools/d256_phase_profile.py``'s clock marks each find their text once
    in the fp32 sources, so a source change that moves one shows here, on
    the CPU, before a chip run."""
    path = os.path.join(os.path.dirname(CSRC), "..", "..", "tools", tool)
    found = _literal(path, name)
    edits = ([e for v in found.values() for e in v] if isinstance(found, dict)
             else list(found))
    assert edits
    texts = [_source(f) for f in ("flash_tf32.cuh", "wgmma.cuh",
                                  "flash_attention_fwd.cu",
                                  "flash_attention_bwd.cu")]
    for old, _ in edits:
        assert sum(t.count(old) for t in texts) == 1, old
