"""The head-dim-256 flash kernels on wgmma, from the CPU.

The bf16 and fp16 forward, dK/dV and dQ kernels at d 256 run on wgmma
warpgroups (``ops/csrc/wgmma.cuh``) behind the flash entry points that the
other head dims use: the wrappers pass d 256 to ``flash_attention_*_bf16``
and ``_fp16`` (no new C entry point, so ``test_torch_abi.py``'s arity test
covers them), and the C dispatch sends it to the wgmma launchers. Held
here: that dispatch, read from the sources; the wrappers' calls through a
stand-in library; the dK/dV kernel's hand-over of P with the dropped bit in
its sign, which must give the dS and P o D bits of P and D kept apart; the
128-byte swizzle the loader writes, against the hardware's address
function; and that every planted fault of ``chip_smoke.py`` still finds
the text it edits. The kernels themselves run only on the card
(``chip_smoke.py`` phases 2, 3 and 13).
"""

import ast
import importlib
import os
import re

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.op_builder import SIGNATURES
from tests.test_torch_abi import fake_lib  # noqa: F401  (a fixture)
from tests.torch_threads import share_cores

share_cores()

# the module (the package's ``ops.flash_attention`` name is the function)
fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
CSRC = os.path.join(os.path.dirname(op_builder.__file__), "csrc")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_the_forward_dispatches_d256_to_the_wgmma_kernel():
    src = _source("flash_attention_fwd_bf16.cu")
    assert ("if (d == 256) return launch_wgmma<T, DROP>(DS_FLASH_ARGS);"
            in src)
    launch = src[src.index("int launch_wgmma("):]
    assert "flash_fwd_wgmma_kernel<T, DROP><<<" in launch
    # the mma.sync kernel keeps the head dims up to 128
    assert 'static_assert(D <= 128, "d = 256 runs flash_fwd_wgmma_kernel")' \
        in src


@pytest.mark.parametrize("launcher,kernel", [
    ("launch_dkv", "flash_bwd_dkv_wgmma_kernel<T, DROP>"),
    ("launch_dq", "flash_bwd_dq_wgmma_kernel<T, DROP>")])
def test_the_backward_dispatches_d256_to_the_wgmma_kernels(launcher, kernel):
    src = _source("flash_attention_bwd_bf16.cu")
    body = src[src.index(f"int {launcher}("):]
    body = body[:body.index("\n}\n")]
    wgmma = body[body.index("if constexpr (D == WD) {"):
                 body.index("} else {")]
    assert f"auto* kernel = {kernel};" in wgmma
    assert "constexpr int WD = 256;" in src
    # design (c) of the mma.sync kernels, which split the output columns
    # over twin warps, is gone from the 16-bit file
    assert "cols_kernel" not in src


@pytest.mark.parametrize("dtype,suffix,code", [
    (torch.bfloat16, "_bf16", 1), (torch.float16, "_fp16", 2)],
    ids=["bf16", "fp16"])
def test_d256_wrappers_call_the_16bit_entries(
        fake_lib, dtype, suffix, code):  # noqa: F811
    """Forward, dK/dV and dQ at d 256 through a stand-in library: the
    entry of the dtype, with its argument count (the fixture checks it),
    dtype code and d; one launch counted each."""
    gen = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(gen.standard_normal(
        (1, 70, 2, 256)).astype(np.float32)).to(dtype) for _ in range(4))
    before = (fa.flash_attention.launches,
              fa.flash_attention_bwd.dkv_launches,
              fa.flash_attention_bwd.dq_launches)
    o, lse = fa._launch(q, k, v, None, True, 256 ** -0.5, None)
    ops = fa.bwd_operands(q, k, v, o, lse, do, None)
    fa.launch_bwd_dkv(ops, True, 256 ** -0.5, None)
    fa.launch_bwd_dq(ops, True, 256 ** -0.5, None)
    names = [c[0] for c in fake_lib]
    assert names == ["flash_attention_fwd" + suffix,
                     "flash_attention_bwd_dkv" + suffix,
                     "flash_attention_bwd_dq" + suffix]
    fwd, dkv, dq = (c[1] for c in fake_lib)
    # (dtype, b, h, sq, sk, d) after the forward's 6 and the backward's
    # 9 or 8 pointers
    assert fwd[6:12] == (code, 1, 2, 70, 70, 256)
    assert dkv[9:15] == (code, 1, 2, 70, 70, 256)
    assert dq[8:14] == (code, 1, 2, 70, 70, 256)
    for name, call in fake_lib:
        assert len(call) == len(SIGNATURES[name])
    after = (fa.flash_attention.launches,
             fa.flash_attention_bwd.dkv_launches,
             fa.flash_attention_bwd.dq_launches)
    assert np.subtract(after, before).tolist() == [1, 1, 1]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_p_handed_over_with_the_dropped_bit_as_its_sign(rate):
    """dK/dV hands P to the dS warpgroup as keep ? p : -p; the receiver
    takes |p| and the sign bit for D, then dS = p (D dP - delta) scale,
    and the sender P o D = keep ? p / (1 - rate) : 0. Both in fp32 equal,
    bit for bit, the values from P and D kept apart, p = 0 dropped (-0.0)
    included."""
    gen = np.random.default_rng(1)
    n = 1 << 16
    p = gen.random(n, dtype=np.float32)
    p[::7] = 0.0                                  # masked scores
    p[::11] = np.float32(1e-40)                   # subnormal probabilities
    keep = gen.random(n) >= rate
    dp = gen.standard_normal(n).astype(np.float32) * np.float32(16)
    delta = gen.standard_normal(n).astype(np.float32)
    scale = np.float32(256 ** -0.5)
    inv_keep = np.float32(1.0 / (1.0 - rate))
    dfac = np.where(keep, inv_keep, np.float32(0.0)).astype(np.float32)
    ds_ref = p * (dfac * dp - delta) * scale
    pd_ref = p * dfac
    handed = np.where(keep, p, -p).astype(np.float32)
    got_p = np.abs(handed)
    got_dfac = np.where(np.signbit(handed), np.float32(0.0),
                        inv_keep).astype(np.float32)
    ds = got_p * (got_dfac * dp - delta) * scale
    pd = np.where(keep, p * inv_keep, np.float32(0.0)).astype(np.float32)
    assert np.array_equal(ds.view(np.uint32), ds_ref.view(np.uint32))
    assert np.array_equal(pd.view(np.uint32), pd_ref.view(np.uint32))
    assert np.signbit(handed[(p == 0) & ~keep]).all()


@pytest.mark.parametrize("pitch", [32, 64, 128])
def test_the_loader_writes_the_hardware_128b_swizzle(pitch):
    """``load_tile_sw128``'s destination of 16-byte chunk c of row r (its
    formula, in elements: block c / 8 at pitch * 64, row r at 64, chunk
    (c % 8) ^ (r % 8)) is the SW128 address function (bits 4-6 XOR bits
    7-9) of the unswizzled [pitch][64] block, a permutation of each
    1024-byte atom; and a K-major 16-deep step kk starting 32 kk bytes on
    reads, for row r and 16-byte half h, the stored chunk 2 kk + h."""
    def swizzle(off):
        return off ^ (((off >> 7) & 7) << 4)

    seen = set()
    for r in range(pitch):
        for c in range(256 // 8):
            elem = ((c >> 3) * pitch * 64 + r * 64
                    + (((c & 7) ^ (r & 7)) << 3))
            plain = (c >> 3) * pitch * 128 + r * 128 + (c & 7) * 16
            assert elem * 2 == swizzle(plain)
            seen.add(elem * 2)
    assert len(seen) == pitch * 32
    for r in range(8):
        for kk in range(4):
            for h in range(2):
                addr = swizzle(r * 128 + kk * 32 + h * 16)
                assert addr == r * 128 + (((2 * kk + h) ^ r) * 16)


def _planted_faults():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "PLANTED_FAULTS"):
            return ast.literal_eval(node.value)
    raise AssertionError("no PLANTED_FAULTS in chip_smoke.py")


PLANTED = _planted_faults()


@pytest.mark.parametrize("name,src,edits,flag", PLANTED,
                         ids=[re.sub(r"\W+", "-", f[0])[:60]
                              for f in PLANTED])
def test_each_planted_fault_finds_its_text(name, src, edits, flag):
    """``run_in_copy`` makes each edit in a copy of the checkout and
    refuses a pattern that does not occur: a source change that moves one
    shows here, on the CPU, before a chip run."""
    path = os.path.join(REPO, "deepspeed_tpu_torch",
                        *(() if "/" in src else ("ops", "csrc")), src)
    with open(path) as f:
        text = f.read()
    for old, _ in edits:
        assert old in text, (name, old)
    assert flag.startswith("--")
