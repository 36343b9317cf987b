"""The C interface of the CUDA kernels and the host tables they read.

``ops/op_builder.py`` binds every ``extern "C"`` entry point of
``ops/csrc/*.cu`` with ``ctypes`` argtypes from ``SIGNATURES``; ``ctypes``
does not check them against the C declaration, so a wrong count passes
silently and the kernel reads garbage. Here each entry point's parameters
are counted from its source (parameter macros such as
``DS_DROPOUT_PARAMS`` expanded from their ``#define``) and held equal to
its entry. The block-sparse wrappers must pick the bf16 entry points for
bf16, the fp16 ones for fp16 (dtype code 2) and the fp32 ones (the
3xTF32 forward, dQ and dK/dV) for fp32, with exactly the bound
arguments, and the dropout wrapper its one entry point with the site's
words, threshold and 1 - rate; and the plan's count tables (``count_table``) must give the
kernels a deterministic heaviest-first launch order and the all-live
flag of every fine mask. The serving wrappers pass fp16's element code
(2) for fp16 tensors, and paged attention a page code for int8 pages
that no element dtype uses, on both sides of the interface.
"""

import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.flash_attention import Dropout
from deepspeed_tpu_torch.ops.op_builder import SIGNATURES, _DROPOUT
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as psc
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import (
    compile_layout, count_table, device_plan)
from tests.torch_threads import share_cores

share_cores()

CSRC = os.path.join(os.path.dirname(op_builder.__file__), "csrc")


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _macros(text):
    """Object-like ``#define NAME body`` (continuation lines joined)."""
    text = text.replace("\\\n", " ")
    return {m.group(1): m.group(2).strip() for m in re.finditer(
        r"^#define (\w+)(?!\()[ \t]+(.*)$", text, re.M)}


def _params(plist, macros):
    """The number of parameters of a C parameter list, macros expanded."""
    n = 0
    for p in (x.strip() for x in plist.split(",")):
        n += _params(macros[p], macros) if p in macros else bool(p)
    return n


def _entry_points():
    """{name: parameter count} of every extern "C" function in csrc."""
    common = _macros(_read("common.cuh"))
    out = {}
    for name in sorted(os.listdir(CSRC)):
        if not name.endswith(".cu"):
            continue
        text = _read(name)
        macros = {**common, **_macros(text)}
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            assert m.group(1) not in out, m.group(1)
            out[m.group(1)] = _params(m.group(2), macros)
    return out


ENTRY_POINTS = _entry_points()


def test_the_dropout_macro_is_the_dropout_argtypes():
    macros = _macros(_read("common.cuh"))
    assert _params("DS_DROPOUT_PARAMS", macros) == len(_DROPOUT)


def test_every_entry_point_has_a_signature():
    assert set(ENTRY_POINTS) == set(SIGNATURES)


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_signature_arity_matches_the_source(name):
    assert name in ENTRY_POINTS, f"{name}: no extern \"C\" function"
    assert ENTRY_POINTS[name] == len(SIGNATURES[name]), name


def test_bf16_entry_points_take_the_fma_kernels_arguments():
    for name in SIGNATURES:
        if name.endswith("_bf16"):
            assert SIGNATURES[name] == SIGNATURES[name[:-5]], name


# --------------------------------------------------------------------------
# the block-sparse wrappers' dispatch, through a stand-in library
# --------------------------------------------------------------------------

@pytest.fixture
def fake_lib(monkeypatch):
    """op_builder.load() returns a library whose entry points record
    (name, arguments) and check the count against SIGNATURES."""
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
    return calls


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "_bf16"),
                                          (torch.float32, ""),
                                          (torch.float16, "_fp16")],
                         ids=["bf16", "fp32", "fp16"])
def test_block_sparse_backward_picks_the_entry_for_the_dtype(fake_lib, dtype,
                                                             suffix):
    mod = sys.modules["deepspeed_tpu_torch.ops.block_sparse_attention"]
    plan = device_plan(psc.BigBirdSparsityConfig(2, block=64), 256, "cpu")
    q, k, v, do = (torch.zeros(1, 256, 2, 64, dtype=dtype) for _ in range(4))
    stats = [torch.zeros(1, 2, 256) for _ in range(3)]
    before = (mod.block_sparse_attention.dq_launches,
              mod.block_sparse_attention.dkv_launches)
    drop = Dropout(0.1, 1, 2, 2)
    mod.launch_dq(q, k, v, do, *stats, plan, 0.125, drop)
    mod.launch_dkv(q, k, v, do, *stats, plan, 0.125, drop)
    assert [c[0] for c in fake_lib] == [
        "block_sparse_attention_dq" + suffix,
        "block_sparse_attention_dkv" + suffix]
    # the count table stands where the counts stood: [12 + 1] pointers in
    assert fake_lib[0][1][9] == plan.kv_table.data_ptr()
    assert fake_lib[1][1][9] == plan.qt_table.data_ptr()
    assert fake_lib[0][1][9] == plan.kv_cnt.data_ptr()
    assert (mod.block_sparse_attention.dq_launches,
            mod.block_sparse_attention.dkv_launches) == (before[0] + 1,
                                                         before[1] + 1)


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "_bf16"),
                                          (torch.float32, ""),
                                          (torch.float16, "_fp16")],
                         ids=["bf16", "fp32", "fp16"])
def test_block_sparse_forward_picks_the_entry_for_the_dtype(fake_lib, dtype,
                                                            suffix):
    mod = sys.modules["deepspeed_tpu_torch.ops.block_sparse_attention"]
    plan = device_plan(psc.BigBirdSparsityConfig(2, block=64), 256, "cpu")
    q, k, v = (torch.zeros(1, 256, 2, 64, dtype=dtype) for _ in range(3))
    before = mod.block_sparse_attention.fwd_launches
    o, m, l = mod.launch_fwd(q, k, v, plan, 0.125, Dropout(0.1, 1, 2, 2))
    assert [c[0] for c in fake_lib] == ["block_sparse_attention_fwd" + suffix]
    args = fake_lib[0][1]
    # q, k, v, the kv lists with the count table in the counts' place,
    # masks, then o, m, l and the dtype code
    assert args[5] == plan.kv_table.data_ptr() == plan.kv_cnt.data_ptr()
    assert args[7:10] == (o.data_ptr(), m.data_ptr(), l.data_ptr())
    assert args[10] == {torch.float32: 0, torch.bfloat16: 1,
                        torch.float16: 2}[dtype]
    assert (o.dtype, m.dtype, l.dtype) == (dtype, torch.float32,
                                           torch.float32)
    assert mod.block_sparse_attention.fwd_launches == before + 1


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1),
                                        (torch.float16, 2)],
                         ids=["fp32", "bf16", "fp16"])
def test_dropout_entry_takes_the_sites_words(fake_lib, dtype, code):
    """One ``dropout_apply`` launch a map, with the element code, the
    [b, S, D] extents, 1 - rate, the site's words and the hash threshold,
    counted as a forward or a backward launch."""
    from deepspeed_tpu_torch.ops import dropout
    x = torch.zeros(2, 5, 24, dtype=dtype)
    before = (dropout.dropout_apply.fwd_launches,
              dropout.dropout_apply.bwd_launches)
    y = dropout._launch(x, (7, 9), 0.1, backward=False)
    dropout._launch(x, (7, 9), 0.1, backward=True)
    assert [c[0] for c in fake_lib] == ["dropout_apply"] * 2
    args = fake_lib[0][1]
    assert args[:2] == (x.data_ptr(), y.data_ptr())
    assert args[2:6] == (code, 240, 5, 24)
    assert args[6] == pytest.approx(0.9)
    assert args[7:10] == (7, 9, dropout.keep_threshold(0.1))
    assert y.shape == x.shape and y.dtype == dtype
    assert (dropout.dropout_apply.fwd_launches,
            dropout.dropout_apply.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)


# --------------------------------------------------------------------------
# the count tables
# --------------------------------------------------------------------------

TABLE_CONFIGS = [
    ("bigbird-64", lambda: psc.BigBirdSparsityConfig(
        12, block=64, num_random_blocks=3), 4096),
    ("bigbird-16", lambda: psc.BigBirdSparsityConfig(4, block=16), 512),
    ("fixed-uni-16", lambda: psc.FixedSparsityConfig(
        4, block=16, attention="unidirectional"), 512),
    ("longformer-16", lambda: psc.BSLongformerSparsityConfig(4, block=16),
     512),
]


@pytest.mark.parametrize("name,make,s", TABLE_CONFIGS,
                         ids=[c[0] for c in TABLE_CONFIGS])
def test_count_table_order_and_all_live_flags(name, make, s):
    plan = compile_layout(make(), s)
    dp = device_plan(make(), s, "cpu")
    rows = plan.kv_cnt.size
    for cnt, table in ((plan.kv_cnt, dp.kv_table), (plan.qt_cnt,
                                                    dp.qt_table)):
        t = table.numpy()
        assert t.dtype == np.int32 and t.shape == (2 * rows + len(
            plan.masks),)
        np.testing.assert_array_equal(t[:rows], cnt.reshape(-1))
        order = t[rows:2 * rows]
        np.testing.assert_array_equal(np.sort(order), np.arange(rows))
        # count descending, ties by row
        key = [(-int(cnt.reshape(-1)[r]), int(r)) for r in order]
        assert key == sorted(key)
        np.testing.assert_array_equal(
            t[2 * rows:], plan.masks.reshape(len(plan.masks), -1).all(1))
    np.testing.assert_array_equal(dp.kv_cnt.numpy(), plan.kv_cnt)
    np.testing.assert_array_equal(dp.qt_cnt.numpy(), plan.qt_cnt)


def test_count_table_is_the_same_on_every_build():
    """Two builds of one plan, without the plan caches, give the same
    table: the launch order is a pure function of the plan."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_kernel
    make = lambda: psc.BigBirdSparsityConfig(12, block=64,
                                             num_random_blocks=3)
    tables = []
    for _ in range(2):
        block_sparse_kernel._PLAN_CACHE.clear()
        plan = compile_layout(make(), 4096)
        tables.append(count_table(plan.qt_cnt, plan.masks))
    np.testing.assert_array_equal(tables[0], tables[1])
    # the global tiles' 64-entry rows lead: 2 a head
    rows = plan.qt_cnt.size
    lead = tables[0][rows:rows + 24]
    assert (plan.qt_cnt.reshape(-1)[lead] == 64).all()
    assert (plan.qt_cnt.reshape(-1)[tables[0][rows + 24:2 * rows]] < 64).all()


def test_bigbird_64_mask_is_all_live_and_block_16_masks_are_not():
    bb = compile_layout(psc.BigBirdSparsityConfig(12, block=64), 4096)
    assert count_table(bb.kv_cnt, bb.masks)[-len(bb.masks):].tolist() == [1]
    lf = compile_layout(psc.BSLongformerSparsityConfig(4, block=16), 512)
    flags = count_table(lf.kv_cnt, lf.masks)[-len(lf.masks):]
    assert 0 in flags


FAKE_NVCC = '''#!{python}
import os, sys
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "w").close()
with open(os.path.join(os.path.dirname(out), "..", "calls"), "a") as f:
    f.write("x")
if "-c" in sys.argv:
    src = os.path.basename(sys.argv[sys.argv.index("-c") + 1])
    print(f"ptxas info    : Compiling entry function 'k_{{src}}'")
    print("ptxas info    : Used 42 registers")
'''


def test_a_reused_build_keeps_its_nvcc_output(tmp_path, monkeypatch):
    """``build`` reuses a library of the same sources and flags; its
    ``build_log`` (the ``-Xptxas -v`` report that spill checks read) is
    the one the library was built with, not empty, on a reuse too."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(op_builder, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(op_builder, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(op_builder, "build_log", "")
    first = op_builder.build(verbose=True)
    log = op_builder.build_log
    calls = (tmp_path / "build" / "calls").read_text()
    assert len(calls) == len(op_builder.sources()) + 1    # compiles, link
    assert log.count("Used 42 registers") == len(op_builder.sources())
    monkeypatch.setattr(op_builder, "build_log", "")
    assert op_builder.build(verbose=True) == first
    assert (tmp_path / "build" / "calls").read_text() == calls
    assert op_builder.build_log == log


# --------------------------------------------------------------------------
# the serving kernels' dtype codes in fp16, through a stand-in library
# --------------------------------------------------------------------------

def _paged_pool(quant, B=2, H=2, d=64, page_len=16, max_pages=4):
    pool = torch.zeros(5, H, page_len, d,
                       dtype=torch.int8 if quant else torch.float16)
    scale = torch.zeros(5, H, page_len) if quant else None
    return (torch.zeros(B, H, d, dtype=torch.float16), pool, pool,
            torch.zeros(B, max_pages, dtype=torch.int32),
            torch.tensor([3, 40], dtype=torch.int32), scale)


def test_fp16_codes_the_serving_wrappers_pass(fake_lib):
    """decode: dtype 2; paged: (2, 2) over fp16 pages and (2,
    ``INT8_PAGES``) over int8 pages; the int8 matmul: (2, 2), both
    kernels; each launch counted as a bf16 one is."""
    from deepspeed_tpu_torch.ops import (decode_attention, paged_attention,
                                         wo_int8_matmul)
    from deepspeed_tpu_torch.ops.decode_attention import _launch as decode
    from deepspeed_tpu_torch.ops.paged_attention import (INT8_PAGES,
                                                         _launch as paged)
    from deepspeed_tpu_torch.ops.wo_int8_matmul import _launch as int8
    before = (decode_attention.launches, paged_attention.launches,
              wo_int8_matmul.small_m_launches, wo_int8_matmul.tiled_launches)
    q = torch.zeros(2, 2, 64, dtype=torch.float16)
    cache = torch.zeros(2, 2, 300, 64, dtype=torch.float16)
    decode(q, cache, cache, torch.tensor([5, 300], dtype=torch.int32), None,
           0.125)
    for quant in (False, True):
        q, kp, vp, table, lengths, scale = _paged_pool(quant)
        paged(q, kp, vp, table, lengths, q, q, None, scale, scale, 0.125)
    w = torch.zeros(256, 128, dtype=torch.int8)
    for m in (4, 40):
        int8(torch.zeros(m, 256, dtype=torch.float16), w, torch.ones(128),
             torch.float16)
    names = [c[0] for c in fake_lib]
    assert names == ["decode_attention", "paged_attention",
                     "paged_attention", "wo_int8_matmul", "wo_int8_matmul"]
    assert fake_lib[0][1][10] == 2                          # dtype
    assert fake_lib[1][1][15:17] == (2, 2)                  # dtype, pages
    assert fake_lib[2][1][15:17] == (2, INT8_PAGES)
    assert [c[1][5:7] for c in fake_lib[3:]] == [(2, 2), (2, 2)]
    assert [c[1][11] for c in fake_lib[3:]] == [1, 0]       # small-m, tiled
    after = (decode_attention.launches, paged_attention.launches,
             wo_int8_matmul.small_m_launches, wo_int8_matmul.tiled_launches)
    assert np.subtract(after, before).tolist() == [1, 2, 1, 1]


def test_int8_page_code_is_no_dtype_code():
    """``INT8_PAGES`` equals no element code of ``kernel_dtype_code``, and
    ``paged_attention.cu`` dispatches every int8-page instance on it and
    every float-page instance on its own element code."""
    from deepspeed_tpu_torch.ops._common import _KERNEL_DTYPES
    from deepspeed_tpu_torch.ops.paged_attention import INT8_PAGES
    assert INT8_PAGES not in _KERNEL_DTYPES.values()
    inst = re.findall(r"^  DS_PAGED_DIMS\((\w+), (\w+), (\d), (\d)\)",
                      _read("paged_attention.cu"), re.M)
    codes = {"float": 0, "bf16": 1, "f16": 2}
    assert {(t, p) for t, p, _, _ in inst} == {
        (t, p) for t in codes for p in (t, "int8_t")}
    for t, p, dt, pt in inst:
        assert int(dt) == codes[t]
        assert int(pt) == (INT8_PAGES if p == "int8_t" else codes[t])
