#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:

1. environment: a CUDA device, its name and power limit (nvidia-smi),
   TF32 and reduced-precision bf16 GEMM reductions switched off for
   every phase but 5a, which runs under torch's defaults;
2. build: the kernels of ``deepspeed_tpu_torch/ops/csrc`` with nvcc for
   sm_90a (register and spill counts printed);
3. kernels: every kernel of the serving and training paths against its
   plain PyTorch version on the card (the flash forward with dropout, both
   flash backward kernels and fused Adam over the training grid; bf16
   held by the largest error and by the rms error, ``Gate``), then
   timed at the serving and training shapes beside the plain version, one
   PyTorch library call computing the same function, and the least time
   the card could take;
4. the slice end to end: GPT-2 125M at full width and depth (random
   weights from a seed) served through ``init_inference(...).serve()``:
   (a) fp32, every request token-exact against the port's ``generate()``
   and the launch counters proving both kernels carried the serving run;
   (b) bf16 (the default config), first tokens exact, timings
   (``--profile`` adds a torch.profiler breakdown of the device time of
   one decode iteration and of each prefill bucket);
   (c) the first forward pass on the card against the CPU (plain
   versions, fp32);
5. training end to end through ``initialize(...)`` -> ``train_batch``:
   (a) GPT-2 125M, bf16 compute on fp32 master weights, attention dropout
   0.1, 8 steps on one seeded batch: finite losses that fall, exact
   launch counts of the flash forward, both backward kernels and fused
   Adam, step time and tokens/s under torch's default GEMM settings
   (``--profile`` adds the device-busy share of one step); (b) the card against the CPU in fp32 with dropout
   on: the loss of each step within 1e-4, the parameters within 4 lr.

The line before last is ``{"kernels": [...]}``, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
# max |out - ref| over max(1, max |ref|): fp32 at FMA order; bf16 at a few
# output ulps, which catches a wrong tile or element but not a misplaced
# rounding (that moves every element by under one ulp)
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# bf16 also: rms(out - ref) / rms(ref). The kernels round where their plain
# versions do, so only sparse one-ulp flips differ; a rounding step that is
# missing or misplaced moves every element, and reads far above this
BF16_RMS_TOL = 5e-4
ADAM_TOL = 1e-5   # fused Adam, relative to max(1, max |ref|): FMA contraction
GAP_STOP = 1e-3               # fp32 near-tie: stop comparing a request there
SEED = 0


def log(msg):
    print(msg, flush=True)


def gpu_ms(fn, iters=50):
    """Device time of one ``fn()`` in ms: CUDA events around ``iters``
    back-to-back calls queued behind a sleep kernel, so host launch
    overhead never shows as device time. Inputs stay in L2 (warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# The GEMM settings that phases 3, 4 and 5b run under (TF32 off, bf16
# reductions in fp32), so the card's products are the CPU's; phase 5a runs
# under torch's defaults, as a user's training run does.
GEMM_FLAGS = ((torch.backends.cuda.matmul, "allow_tf32"),
              (torch.backends.cudnn, "allow_tf32"),
              (torch.backends.cuda.matmul,
               "allow_bf16_reduced_precision_reduction"))


def gemm_flags():
    return tuple(getattr(mod, name) for mod, name in GEMM_FLAGS)


def set_gemm_flags(values):
    for (mod, name), value in zip(GEMM_FLAGS, values):
        setattr(mod, name, value)


def bound_ms(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _cache_mask_bias(sq, sk, dev):
    cols = torch.arange(sk, device=dev)[None, :]
    rows = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    from deepspeed_tpu_torch.ops._common import NEG_INF
    return torch.where(cols <= rows, 0.0, NEG_INF)[None, None]


def _padding_bias(b, sk, dev):
    """[b, 1, 1, sk]: row i masks its last (i + 1) * sk / 5 keys."""
    from deepspeed_tpu_torch.ops._common import NEG_INF
    keep = torch.ones(b, sk, dtype=torch.bool, device=dev)
    for i in range(b):
        keep[i, sk - (i + 1) * sk // 5:] = False
    return torch.where(keep, 0.0, NEG_INF)[:, None, None, :]


def check_flash(dev, gen):
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    gate = Gate("flash")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for sq in (128, 512):
                cases = [("causal", 1, True, sq, None),
                         ("cache_mask", 1, False, 1024,
                          _cache_mask_bias(sq, 1024, dev)),
                         ("padding", 2, True, sq, _padding_bias(2, sq, dev))]
                for name, b, causal, sk, bias in cases:
                    q = torch.randn(b, sq, 12, d, generator=gen, device=dev,
                                    dtype=dtype)
                    k = torch.randn(b, sk, 12, d, generator=gen, device=dev,
                                    dtype=dtype)
                    v = torch.randn(b, sk, 12, d, generator=gen, device=dev,
                                    dtype=dtype)
                    o, lse = flash_attention(q, k, v, bias=bias,
                                             causal=causal, return_lse=True)
                    bias_in = (None if bias is None else
                               bias.to(dtype if bias.shape[2] > 1
                                       else torch.float32))
                    ro, rlse = flash_attention_reference(
                        q, k, v, bias_in, causal=causal)
                    torch.cuda.synchronize()
                    gate.case(dtype, [o], [ro],
                              f"b={b} d={d:3d} sq={sq:3d} sk={sk:4d} {name}",
                              show=True, extra=(lse - rlse).abs().max().item()
                              if dtype == torch.float32 else 0.0)
    gate.close()


def check_decode(dev, gen):
    from deepspeed_tpu_torch.models.layers import alibi_slopes
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    B, H, S = 8, 12, 1024
    lengths = torch.tensor([0, 1, 77, 1024, 500, 333, 1000, 64],
                           dtype=torch.int32, device=dev)
    gate = Gate("decode")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for alibi in (False, True):
                q = torch.randn(B, 1, H, d, generator=gen, device=dev,
                                dtype=dtype)
                k = torch.randn(B, H, S, d, generator=gen, device=dev,
                                dtype=dtype)
                v = torch.randn(B, H, S, d, generator=gen, device=dev,
                                dtype=dtype)
                slopes = alibi_slopes(H).to(dev) if alibi else None
                o = decode_attention(q, k, v, lengths, alibi_slopes=slopes)
                ro = decode_attention_reference(q[:, 0], k, v, lengths,
                                                alibi_slopes=slopes)
                torch.cuda.synchronize()
                if o[0].float().any():
                    raise AssertionError("decode_attention: a row of length "
                                         "0 is not zero")
                gate.case(dtype, [o[:, 0]], [ro],
                          f"d={d:3d} S={S} alibi={alibi!s:5s}", show=True)
    gate.close()


def _alibi_bias(h, s, dev):
    """[1, h, 1, s] fp32 ALiBi rows, as the BLOOM-style models build."""
    from deepspeed_tpu_torch.models.layers import alibi_slopes
    return (alibi_slopes(h).to(dev)[None, :, None, None]
            * torch.arange(s, device=dev, dtype=torch.float32))


def _train_cases(dev, s):
    """(name, b, bias) of the training-path checks at sq = sk = s."""
    return [("causal", 2, None),
            ("padding", 2, _padding_bias(2, s, dev)),
            ("alibi", 2, _alibi_bias(12, s, dev))]


def _drop(rate, h, seed):
    from deepspeed_tpu_torch.ops.flash_attention import Dropout
    if rate == 0.0:
        return None
    # non-zero offsets place the block inside a larger hash lattice
    return Dropout(rate, 0x1234 + seed, 0x9E3779B9 ^ seed, 2 * h, 3, 1, 5,
                   7)


def _rel_err(out, ref):
    """max |out - ref| over max(1, max |ref|), in fp32."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max() / ref.abs().max().clamp_min(1.0)).item()


def _rms_err(out, ref):
    """rms(out - ref) / rms(ref), in fp32 (0 for an all-zero ref)."""
    out, ref = out.float(), ref.float()
    den = ref.square().mean().sqrt().item()
    return (out - ref).square().mean().sqrt().item() / den if den else 0.0


class Gate:
    """The agreement of one kernel with its plain version over a grid of
    cases: max_rel against TOL and, in bf16, rms_rel against BF16_RMS_TOL.
    Every case runs; a failing case is logged, and ``close`` raises after
    the grid with the worst reading of each metric per dtype."""

    def __init__(self, what):
        self.what, self.n, self.failed, self.worst = what, 0, 0, {}

    def case(self, dtype, outs, refs, label, show=False, extra=0.0):
        """``outs``/``refs``: the tensors to compare; ``extra``: a further
        max_rel reading (the LSE). Returns True when the case passes."""
        max_rel = max([_rel_err(o, r) for o, r in zip(outs, refs)] + [extra])
        rms_rel = (max(_rms_err(o, r) for o, r in zip(outs, refs))
                   if dtype == torch.bfloat16 else 0.0)
        ok = (all(bool(torch.isfinite(o).all()) for o in outs)
              and max_rel <= TOL[dtype] and rms_rel <= BF16_RMS_TOL)
        w = self.worst.setdefault(str(dtype)[6:], [0.0, 0.0])
        w[0], w[1] = max(w[0], max_rel), max(w[1], rms_rel)
        self.n += 1
        self.failed += not ok
        if show or not ok:
            log(f"{self.what} {str(dtype)[6:]:8s} {label} max_rel="
                f"{max_rel:.3e} rms_rel={rms_rel:.3e} "
                f"{'ok' if ok else 'FAIL'}")
        return ok

    def close(self):
        worst = "; ".join(f"{k} max_rel {v[0]:.3e} rms_rel {v[1]:.3e}"
                          for k, v in self.worst.items())
        log(f"  {self.what}: {self.n - self.failed}/{self.n} cases ok; worst "
            f"{worst} (tol max_rel fp32 {TOL[torch.float32]:.0e}, bf16 "
            f"{TOL[torch.bfloat16]:.0e}; rms_rel bf16 {BF16_RMS_TOL:.0e})")
        if self.failed:
            raise AssertionError(f"{self.what}: {self.failed} of {self.n} "
                                 "cases disagree with the plain version")


def check_flash_dropout(dev, gen, sizes=(128, 1024)):
    """The forward with dropout against its plain version: one wrong keep
    bit moves an output by far more than the fp32 tolerance."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        _bias_operand, flash_attention_fwd, flash_attention_reference)
    gate = Gate("flash+dropout")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for s in sizes:
                for name, b, bias in _train_cases(dev, s):
                    for rate in (0.1, 0.5):
                        q, k, v = (torch.randn(b, s, 12, d, generator=gen,
                                               device=dev, dtype=dtype)
                                   for _ in range(3))
                        bias_in = _bias_operand(bias, q, k)
                        drop = _drop(rate, 12, gate.n)
                        o, lse = flash_attention_fwd(
                            q, k, v, bias_in, causal=True, dropout=drop)
                        ro, rlse = flash_attention_reference(
                            q, k, v, bias_in, causal=True, dropout=drop)
                        torch.cuda.synchronize()
                        gate.case(dtype, [o], [ro],
                                  f"d={d:3d} s={s:4d} {name:7s} rate={rate}",
                                  show=s == 1024 and name == "causal",
                                  extra=(lse - rlse).abs().max().item()
                                  if dtype == torch.float32 else 0.0)
    gate.close()


def check_flash_bwd(dev, gen, sizes=(128, 1024)):
    """Both backward kernels against the plain backward: dK/dV and dQ."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        _bias_operand, flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd)
    gate = Gate("flash bwd")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for s in sizes:
                for name, b, bias in _train_cases(dev, s):
                    for rate in (0.0, 0.1, 0.5):
                        q, k, v, do = (torch.randn(b, s, 12, d, generator=gen,
                                                   device=dev, dtype=dtype)
                                       for _ in range(4))
                        bias_in = _bias_operand(bias, q, k)
                        drop = _drop(rate, 12, gate.n)
                        o, lse = flash_attention_fwd(
                            q, k, v, bias_in, causal=True, dropout=drop)
                        grads = flash_attention_bwd(
                            q, k, v, o, lse, do, bias_in, causal=True,
                            dropout=drop)
                        refs = flash_attention_bwd_reference(
                            q, k, v, o, lse, do, bias_in, causal=True,
                            dropout=drop)
                        torch.cuda.synchronize()
                        gate.case(dtype, grads, refs,
                                  f"d={d:3d} s={s:4d} {name:7s} rate={rate} "
                                  "(dq, dk, dv)",
                                  show=s == 1024 and name == "causal")
    gate.close()


@functools.lru_cache(maxsize=None)
def gpt2_param_shapes():
    """The parameter shapes of GPT-2 125M, in the port's GPT order."""
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS
    return [tuple(p.shape)
            for p in GPT(GPT2_PRESETS["gpt2-125m"]).parameters()]


def _adam_state(shapes, dev, gen):
    from deepspeed_tpu_torch.ops.fused_adam import FusedAdamState
    params = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    return FusedAdamState(params, grads)


def _clone_state(st):
    from deepspeed_tpu_torch.ops.fused_adam import FusedAdamState
    return FusedAdamState([p.clone() for p in st.params],
                          [g.clone() for g in st.grads])


def check_fused_adam(dev, gen):
    """The multi-tensor kernel against the plain update, 3 steps, both
    sides of the clip threshold."""
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam
    from deepspeed_tpu_torch.runtime.optimizers import Adam
    opt = Adam(lambda t: 6e-4 * min(1.0, t / 3), 0.9, 0.95, 1e-8, 0.1)
    tol = ADAM_TOL
    for label, shapes in (("sizes 1,127,128,4097,768x3072",
                           [(1,), (127,), (128,), (4097,), (768, 3072)]),
                          ("GPT-2 125M parameter list", gpt2_param_shapes())):
        st = _adam_state(shapes, dev, gen)
        ref = _clone_state(st)
        errs = []
        for step, norm in zip((1, 2, 3), (0.5, 2.0, 5.0)):
            gnorm = torch.tensor(norm, device=dev)
            sc = opt.scalars(step)
            fused_adam(st, sc, gnorm, 1.0)
            _plain_adam_step(ref, sc, gnorm)
        torch.cuda.synchronize()
        for group, rgroup in ((st.params, ref.params),
                              (st.exp_avg, ref.exp_avg),
                              (st.exp_avg_sq, ref.exp_avg_sq)):
            errs.append(max(_rel_err(a, b) for a, b in zip(group, rgroup)))
        n = sum(p.numel() for p in st.params)
        ok = max(errs) <= tol and all(bool(torch.isfinite(p).all())
                                      for p in st.params)
        log(f"fused_adam {label} ({len(shapes)} tensors, {n} params, 3 "
            f"steps, clip 1.0 at norms 0.5/2/5): rel_err p={errs[0]:.2e} "
            f"m={errs[1]:.2e} v={errs[2]:.2e} tol={tol:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("fused_adam kernel disagrees with its "
                                 "plain version")


def time_flash_train(dev, gen, s=1024, d=64, rate=0.1):
    """The training shape: GPT-2 micro batch 8, 12 heads, causal,
    attention dropout 0.1, bf16. Returns the forward and the two backward
    kernels' numbers."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import (
        Dropout, bwd_operands, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_reference, launch_bwd_dkv,
        launch_bwd_dq)
    b, h, dt = 8, 12, torch.bfloat16
    scale = 1.0 / d ** 0.5
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev,
                               dtype=dt) for _ in range(4))
    drop = Dropout(rate, 0x1234, 0x5678, h)
    fwd = lambda: flash_attention_fwd(q, k, v, causal=True, dropout=drop)
    o, lse = fwd()
    ops = bwd_operands(q, k, v, o, lse, do, None)
    dkv = lambda: launch_bwd_dkv(ops, True, scale, drop)
    dq = lambda: launch_bwd_dq(ops, True, scale, drop)
    plain_fwd = gpu_ms(lambda: flash_attention_reference(
        q, k, v, causal=True, dropout=drop), iters=5)
    plain_bwd = gpu_ms(lambda: flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=True, dropout=drop), iters=5)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_fwd = gpu_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, dropout_p=rate))
    lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        dropout_p=rate)
    dot = do.transpose(1, 2)
    lib_bwd = gpu_ms(lambda: torch.autograd.grad(
        lo, (qt, kt, vt), dot, retain_graph=True))
    visible = b * h * s * (s + 1) // 2
    elem = q.element_size()
    qkv = 3 * b * s * h * d * elem
    rows = b * h * s * 4                          # one fp32 per row
    out = {}
    for name, fn, products, nbytes, plain, lib in (
            ("flash_attention", fwd, 2, qkv + b * s * h * d * elem + rows,
             plain_fwd, lib_fwd),
            # S, dP, dV, dK; reads q k v dO lse delta, writes dk dv
            ("flash_attention_bwd_dkv", dkv, 4,
             qkv + b * s * h * d * elem + 2 * rows + 2 * b * s * h * d * elem,
             plain_bwd, lib_bwd),
            # S, dP, dQ; reads q k v dO lse delta, writes dq
            ("flash_attention_bwd_dq", dq, 3,
             qkv + b * s * h * d * elem + 2 * rows + b * s * h * d * elem,
             plain_bwd, lib_bwd)):
        bound, by = bound_ms(2 * products * visible * d, nbytes,
                             PEAK_BF16_FLOPS)
        out[name] = dict(
            shape=f"b={b} h={h} sq=sk={s} d={d} bf16 causal dropout={rate}",
            ms=gpu_ms(fn, iters=20), plain_ms=plain, library_ms=lib,
            bound_ms=bound, bound_by=by)
    ro, _ = flash_attention_reference(q, k, v, causal=True, dropout=drop)
    rdq, rdk, rdv = flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                  causal=True, dropout=drop)
    gk, gv = dkv()
    out["flash_attention"]["max_abs_err"] = (
        fwd()[0].float() - ro.float()).abs().max().item()
    out["flash_attention_bwd_dkv"]["max_abs_err"] = max(
        (gk.float() - rdk.float()).abs().max().item(),
        (gv.float() - rdv.float()).abs().max().item())
    out["flash_attention_bwd_dq"]["max_abs_err"] = (
        dq().float() - rdq.float()).abs().max().item()
    return out


def time_fused_adam(dev, gen):
    """One step over the 124M GPT-2 parameters: the kernel, the plain
    per-tensor update and torch.optim.AdamW(fused=True)."""
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam
    from deepspeed_tpu_torch.runtime.optimizers import Adam
    shapes = gpt2_param_shapes()
    st = _adam_state(shapes, dev, gen)
    opt = Adam(6e-4, 0.9, 0.95, 1e-8, 0.1)
    sc = opt.scalars(1)
    gnorm = torch.tensor(2.0, device=dev)
    kernel = gpu_ms(lambda: fused_adam(st, sc, gnorm, 1.0), iters=20)
    plain_state = _adam_state(shapes, dev, gen)
    plain = gpu_ms(lambda: _plain_adam_step(plain_state, sc, gnorm),
                   iters=5)
    del plain_state
    lib_params = [torch.nn.Parameter(p.clone()) for p in st.params]
    for p, g in zip(lib_params, st.grads):
        p.grad = g.clone()
    lib_opt = torch.optim.AdamW(lib_params, lr=6e-4, betas=(0.9, 0.95),
                                eps=1e-8, weight_decay=0.1, fused=True)
    library = gpu_ms(lib_opt.step, iters=20)
    n = sum(p.numel() for p in st.params)
    bound, by = bound_ms(0, 28 * n, PEAK_BF16_FLOPS)
    check = _adam_state(shapes[-3:], dev, gen)
    ref = _clone_state(check)
    fused_adam(check, sc, gnorm, 1.0)
    _plain_adam_step(ref, sc, gnorm)
    err = max((a - b).abs().max().item()
              for a, b in zip(check.params, ref.params))
    return dict(shape=f"{len(shapes)} tensors, {n} fp32 params",
                ms=kernel, plain_ms=plain, library_ms=library,
                bound_ms=bound, bound_by=by, max_abs_err=err)


def _plain_adam_step(state, sc, gnorm):
    """The plain version over every tensor of ``state``, on the card."""
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam_reference
    for p, g, m, v in zip(state.params, state.grads, state.exp_avg,
                          state.exp_avg_sq):
        fused_adam_reference(p, g, m, v, sc, gnorm, 1.0)


def time_flash(dev, gen, sq=512, d=64):
    """The serving prefill shape: one request, 12 heads, a causal bucket."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    b, h, dt = 1, 12, torch.bfloat16
    q, k, v = (torch.randn(b, sq, h, d, generator=gen, device=dev, dtype=dt)
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kernel = gpu_ms(lambda: flash_attention(q, k, v, causal=True))
    plain = gpu_ms(lambda: flash_attention_reference(q, k, v, causal=True),
                   iters=10)
    library = gpu_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    visible = sq * (sq + 1) // 2
    flops = 4 * b * h * d * visible
    nbytes = 4 * q.numel() * q.element_size() + b * h * sq * 4
    bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    err = (flash_attention(q, k, v, causal=True).float()
           - flash_attention_reference(q, k, v, causal=True)[0].float()
           ).abs().max().item()
    return dict(shape=f"b={b} h={h} sq=sk={sq} d={d} bf16 causal",
                ms=kernel, plain_ms=plain, library_ms=library,
                bound_ms=bound, bound_by=by, max_abs_err=err)


def time_decode(dev, gen, d=64):
    """The serving decode shape: 8 slots, 12 heads, capacity 1024, slot
    lengths drawn like the served traffic (prompt + part of the output)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    B, H, S, dt = 8, 12, 1024, torch.bfloat16
    rs = np.random.RandomState(SEED + 1)
    lens = rs.randint(16, 401, size=B) + rs.randint(1, 65, size=B)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(B, 1, H, d, generator=gen, device=dev, dtype=dt)
    k = torch.randn(B, H, S, d, generator=gen, device=dev, dtype=dt)
    v = torch.randn(B, H, S, d, generator=gen, device=dev, dtype=dt)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    kernel = gpu_ms(lambda: decode_attention(q, k, v, lengths))
    plain = gpu_ms(lambda: decode_attention_reference(q[:, 0], k, v,
                                                      lengths), iters=20)
    library = gpu_ms(lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask))
    total = int(lens.sum())
    flops = 4 * total * H * d
    nbytes = (2 * total * H * d + 2 * B * H * d) * 2 + B * 4
    bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    err = (decode_attention(q, k, v, lengths)[:, 0].float()
           - decode_attention_reference(q[:, 0], k, v, lengths).float()
           ).abs().max().item()
    return dict(shape=f"B={B} H={H} S={S} d={d} bf16 sum(lengths)={total}",
                ms=kernel, plain_ms=plain, library_ms=library,
                bound_ms=bound, bound_by=by, max_abs_err=err)


# --------------------------------------------------------------------------
# phase 4: the slice end to end
# --------------------------------------------------------------------------

def traffic(vocab, n=24, seed=SEED):
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, vocab, size=rs.randint(16, 401)).astype(np.int32)
               for _ in range(n)]
    outs = [int(rs.randint(16, 65)) for _ in range(n)]
    return prompts, outs


def serve_traffic(engine, prompts, outs, config):
    """Serve the traffic with the launch counters read over this run
    alone; returns (requests, server, counts, wall seconds)."""
    from deepspeed_tpu_torch.ops import decode_attention, flash_attention
    srv = engine.serve(config)
    torch.cuda.synchronize()
    flash_attention.launches = decode_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=o) for p, o in zip(prompts, outs)]
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"flash_attention": flash_attention.launches,
              "decode_attention": decode_attention.launches}
    snap = srv.metrics.snapshot()
    n_layers = engine.module.config.n_layers
    want = {"flash_attention": n_layers * snap["requests_admitted"],
            "decode_attention": n_layers * snap["decode_iterations"]}
    log(f"  launches over the serving run: {counts} (want {want}: "
        f"{n_layers} layers x {snap['requests_admitted']} admissions, "
        f"x {snap['decode_iterations']} decode iterations)")
    if counts != want or not all(counts.values()):
        raise AssertionError("the serving run did not go through both "
                             "kernels once per layer per program")
    if snap["requests_finished"] != len(prompts):
        raise AssertionError(f"only {snap['requests_finished']} of "
                             f"{len(prompts)} requests finished")
    return reqs, srv, counts, wall


def top2_gaps(model, prompt, generated):
    """Top-2 logit gap at every generated position, from one cache-free
    forward over prompt + generated tokens."""
    seq = torch.tensor(np.concatenate([prompt, generated])[None],
                       device=model.wte.device)
    with torch.no_grad():
        logits = model(seq)[0, len(prompt) - 1:-1].float()
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


def phase_fp32(model_fp32, prompts, outs, config):
    from deepspeed_tpu_torch import init_inference
    log("phase 4a: fp32 serving, token-exact against generate()")
    engine = init_inference(model_fp32, dtype=torch.float32)
    reqs, srv, _, wall = serve_traffic(engine, prompts, outs, config)
    stops = 0
    for i, (req, p, o) in enumerate(zip(reqs, prompts, outs)):
        ref = engine.generate(p[None], max_new_tokens=o)[0, len(p):]
        ref = ref.cpu().numpy()
        gaps = top2_gaps(engine.module, p, ref)
        near = np.nonzero(gaps < GAP_STOP)[0]
        upto = int(near[0]) if near.size else o
        stops += bool(near.size)
        got = np.asarray(req.output_tokens)
        if got.shape != (o,) or not np.array_equal(got[:upto], ref[:upto]):
            raise AssertionError(
                f"request {i}: served {got.tolist()} != generate() "
                f"{ref.tolist()} (compared up to step {upto})")
    log(f"  {len(reqs)}/{len(reqs)} requests token-exact against "
        f"generate(); {stops} compared only up to a near-tie step "
        f"(reference top-2 logit gap "
        f"< {GAP_STOP}); served {srv.metrics.tokens_generated} tokens in "
        f"{wall:.3f} s")


def phase_bf16(model_bf16, prompts, outs, config, card, profile=False):
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.cache import make_row_cache
    from deepspeed_tpu_torch.serving.engine import _decode_iter_impl
    log("phase 4b: bf16 serving (the default config)")
    engine = init_inference(model_bf16)
    reqs, srv, counts, wall = serve_traffic(engine, prompts, outs, config)
    first_ok, agree, total = 0, 0, 0
    for i, (req, p, o) in enumerate(zip(reqs, prompts, outs)):
        ref = engine.generate(p[None], max_new_tokens=o)[0, len(p):]
        ref = ref.cpu().numpy()
        got = np.asarray(req.output_tokens)
        if got.shape != (o,) or got[0] != ref[0]:
            raise AssertionError(f"request {i}: first token {got[:1]} != "
                                 f"generate() {ref[:1]}")
        first_ok += 1
        agree += int((got == ref).sum())
        total += o
    tokens = srv.metrics.tokens_generated
    log(f"  first tokens: {first_ok}/{len(reqs)} exact against "
        f"generate(); all tokens: {agree}/{total} agree (bf16 near-ties "
        f"may flip with the batch size of the GEMMs; not gated)")
    log(f"  serving: {tokens} tokens, {srv.metrics.decode_iterations} decode "
        f"iterations, wall {wall:.3f} s, {tokens / wall:.1f} tokens/s "
        f"[{card}]")

    model, dev = engine.module, engine.device
    prefill, runs = {}, {}
    for bucket in sorted({config["prefill_bucket"]
                          * -(-len(p) // config["prefill_bucket"])
                          for p in prompts}):
        ids = torch.randint(0, model.config.vocab_size, (1, bucket),
                            device=dev)
        pos = torch.arange(bucket, device=dev)

        def run_prefill(ids=ids, pos=pos):
            model(ids, positions=pos, cache=make_row_cache(srv._cache))
        runs[f"prefill {bucket}"] = run_prefill
        prefill[bucket] = wall_ms(run_prefill, iters=10)
    log("  prefill wall ms per bucket (one request): " + ", ".join(
        f"{b}: {ms:.3f}" for b, ms in prefill.items()) + f" [{card}]")

    rs = np.random.RandomState(SEED + 2)
    n = config["num_slots"]
    state = {
        "lengths": torch.tensor(rs.randint(16, 401, n) + rs.randint(1, 33, n),
                                dtype=torch.int32, device=dev),
        "last_token": torch.randint(0, model.config.vocab_size, (n,),
                                    device=dev),
        "active": torch.ones(n, dtype=torch.bool, device=dev),
        "remaining": torch.full((n,), 10 ** 6, dtype=torch.int32,
                                device=dev),
    }
    mode = srv._mode

    def run_decode():
        _decode_iter_impl(model, srv._cache, state, srv._gen, -1, mode)
    runs["decode"] = run_decode
    decode = wall_ms(run_decode, iters=20)
    log(f"  decode wall ms per iteration (8 slots, mean slot length "
        f"{state['lengths'].float().mean().item():.0f}): {decode:.3f} "
        f"[{card}]")
    if profile:
        walls = {"decode": decode, **{f"prefill {b}": ms
                                      for b, ms in prefill.items()}}
        for name, fn in runs.items():
            device_profile(name, fn, walls[name], card)
    return counts


def wall_ms(fn, iters):
    """Host-clock ms of one ``fn()``, ending in a synchronize (the step
    time a caller sees, host overhead included)."""
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def device_profile(name, fn, wall, card, iters=10, grad=False):
    """Device time of ``fn`` by kernel from a torch.profiler trace: busy
    ms per call (union of kernel, memcpy and memset intervals), its share
    of the unprofiled wall time ``wall``, and the kernels that take it.
    ``grad``: run ``fn`` with autograd on (a training step)."""
    from torch.profiler import ProfilerActivity, profile
    out_dir = os.path.join(REPO, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name.replace(" ", "_") + ".json")
    with torch.set_grad_enabled(grad):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        key = (e["name"].replace("(anonymous namespace)::", "")
               .replace("void ", "").split("(")[0][:70])
        by_name[key] = by_name.get(key, 0.0) + float(e["dur"])
    busy_ms = busy / iters / 1e3
    log(f"  profile {name}: {len(events) / iters:.0f} device ops per call, "
        f"device busy {busy_ms:.4f} ms of {wall:.3f} ms wall "
        f"({100 * (1 - busy_ms / wall):.1f}% idle) [{card}]")
    for key, dur in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {dur / iters / 1e3:8.4f} ms  {key}")


def phase_cpu_parity(model_fp32):
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import GPT
    log("phase 4c: first forward pass, card against CPU (fp32)")
    gpu = init_inference(model_fp32, dtype=torch.float32)
    cpu_model = GPT(model_fp32.config, seed=SEED)
    cpu_model.load_state_dict(model_fp32.state_dict())
    cpu = init_inference(cpu_model, device="cpu")
    rs = np.random.RandomState(SEED + 3)
    tol = 2e-3   # fp32 through 12 layers summed in two orders; |logits|~3
    vocab = model_fp32.config.vocab_size
    for n in (48, 100):
        ids = rs.randint(0, vocab, size=(1, n))
        out = gpu(torch.tensor(ids, device="cuda")).float().cpu()
        ref = cpu(torch.tensor(ids)).float()
        err = (out - ref).abs().max().item()
        ok = (out.shape == (1, n, vocab) and bool(torch.isfinite(out).all())
              and err <= tol)
        log(f"  prompt of {n}: logits {tuple(out.shape)} max_abs_err "
            f"{err:.3e} tol {tol:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("card and CPU logits disagree")


# --------------------------------------------------------------------------
# phase 5: the training slice end to end
# --------------------------------------------------------------------------

TRAIN_CONFIG = {
    "train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "FusedAdam",
                  "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                             "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_num_steps": 3, "warmup_max_lr": 6e-4}},
    "gradient_clipping": 1.0, "bf16": {"enabled": True},
}


def gpt_train_loss(model, batch, rng, train):
    """loss_fn(model, batch, rng, train): next-token cross entropy."""
    from deepspeed_tpu_torch.models import gpt_loss_fn
    ids = batch["input_ids"].long()
    logits = model(ids, dropout_seed=rng)
    return gpt_loss_fn(logits[:, :-1], ids[:, 1:])


def phase_train_bf16(card, profile=False, steps=8):
    """GPT-2 125M, attention dropout 0.1, bf16 compute on fp32 master
    weights, 8 train_batch calls on one seeded [16, 1024] batch; the
    launch counters of exactly these steps."""
    import dataclasses
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS
    from deepspeed_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                         fused_adam)
    log("phase 5a: GPT-2 125M trained through initialize() -> train_batch "
        f"(bf16, attention dropout 0.1; GEMM flags {list(gemm_flags())})")
    cfg = dataclasses.replace(GPT2_PRESETS["gpt2-125m"],
                              attn_dropout_rate=0.1)
    engine, _, _, _ = initialize(model=GPT(cfg, seed=SEED),
                                 config=TRAIN_CONFIG, loss_fn=gpt_train_loss,
                                 seed=SEED)
    rs = np.random.RandomState(SEED + 4)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size, size=(16, 1024))
             .astype(np.int32)}
    torch.cuda.synchronize()
    flash_attention.launches = fused_adam.launches = 0
    flash_attention_bwd.dkv_launches = flash_attention_bwd.dq_launches = 0
    losses, marks = [], []
    for _ in range(steps):
        losses.append(engine.train_batch(batch))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    counts = {"flash_attention": flash_attention.launches,
              "flash_attention_bwd_dkv": flash_attention_bwd.dkv_launches,
              "flash_attention_bwd_dq": flash_attention_bwd.dq_launches,
              "fused_adam": fused_adam.launches}
    per_attn = cfg.n_layers * TRAIN_CONFIG["gradient_accumulation_steps"]
    want = {"flash_attention": per_attn * steps,
            "flash_attention_bwd_dkv": per_attn * steps,
            "flash_attention_bwd_dq": per_attn * steps,
            "fused_adam": steps}
    log(f"  launches over the {steps} steps: {counts} (want {want}: "
        f"{cfg.n_layers} layers x 2 microbatches x {steps} steps; one "
        f"optimizer launch a step)")
    if counts != want:
        raise AssertionError("the training run did not go through every "
                             "kernel of its path the expected number of "
                             "times")
    losses = [float(x) for x in losses]
    log("  losses: " + ", ".join(f"{x:.4f}" for x in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("training losses are not finite or did not "
                             "fall on the repeated batch")
    step_ms = (marks[-1] - marks[0]) / (steps - 1) * 1e3
    tokens = TRAIN_CONFIG["train_batch_size"] * 1024
    log(f"  step wall {step_ms:.2f} ms (mean of steps 2-{steps}, each ending "
        f"in a synchronize), {tokens / step_ms * 1e3:.0f} tokens/s, grad "
        f"norm {engine.get_global_grad_norm():.4f} [{card}]")
    if profile:
        device_profile("train step", lambda: engine.train_batch(batch),
                       step_ms, card, iters=3, grad=True)
    return counts, step_ms


def phase_train_parity():
    """The card against the CPU, fp32, attention dropout on: the same
    weights and seed words give the same keep bits on both devices."""
    import dataclasses
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS
    log("phase 5b: training, card against CPU (fp32, attention dropout "
        "0.1, GPT-2 125M at full width and depth)")
    cfg = dataclasses.replace(GPT2_PRESETS["gpt2-125m"], dtype=torch.float32,
                              attn_dropout_rate=0.1)
    lr = 1e-4
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "FusedAdam",
                            "params": {"lr": lr, "weight_decay": 0.1}}}
    rs = np.random.RandomState(SEED + 5)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size, size=(4, 128))
             .astype(np.int32)}
    runs = {}
    for dev in ("cuda", "cpu"):
        engine, _, _, _ = initialize(model=GPT(cfg, seed=SEED), config=config,
                                     loss_fn=gpt_train_loss, seed=SEED,
                                     device=dev)
        losses = [float(engine.train_batch(batch)) for _ in range(2)]
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                              engine.module.state_dict().items()})
    loss_err = max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                              runs["cpu"][0]))
    diffs = torch.cat([(runs["cuda"][1][k] - v).abs().flatten()
                       for k, v in runs["cpu"][1].items()])
    # Adam moves a parameter by about lr a step whatever its gradient's
    # size, so a gradient near 0 whose sign differs between two fp32
    # summation orders moves it by up to 2 lr a step: 4 lr over 2 steps
    p_tol = 4 * lr
    ok = loss_err <= 1e-4 and diffs.max().item() <= p_tol
    log(f"  losses card {runs['cuda'][0]} cpu {runs['cpu'][0]}: max diff "
        f"{loss_err:.3e} (tol 1e-4); parameters after 2 steps: max diff "
        f"{diffs.max().item():.3e} (tol 4 lr = {p_tol:.0e}), mean diff "
        f"{diffs.mean().item():.3e}, {int((diffs > lr).sum())} of "
        f"{diffs.numel()} differ by more than lr {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training on the card and on the CPU disagree")


# --------------------------------------------------------------------------

def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; it drives the port on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "deepspeed_tpu_torch", "ops",
                                       "csrc")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(deepspeed_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS
    from deepspeed_tpu_torch.ops import op_builder
    import dataclasses

    log("phase 1: environment")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"  {torch.cuda.device_count()} device(s); device 0: "
        f"{torch.cuda.get_device_name(0)}")
    defaults = gemm_flags()
    set_gemm_flags((False, False, False))
    log(f"  GEMM flags {[n for _, n in GEMM_FLAGS]}: torch's defaults "
        f"{list(defaults)}; off for every phase but 5a (TF32 off for matmul "
        f"and cuDNN, bf16 GEMM reductions in fp32)")

    log("phase 2: build")
    t0 = time.perf_counter()
    op_builder.load(verbose=True)
    log(f"  built {len(op_builder.sources())} sources with nvcc for sm_90a "
        f"in {time.perf_counter() - t0:.1f} s")
    for line in op_builder.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())

    log("phase 3: kernels against their plain versions")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    check_flash(dev, gen)
    check_decode(dev, gen)
    check_flash_dropout(dev, gen)
    check_flash_bwd(dev, gen)
    check_fused_adam(dev, gen)
    flash_t = time_flash(dev, gen)
    decode_t = time_decode(dev, gen)
    train_t = time_flash_train(dev, gen)
    train_t["fused_adam"] = time_fused_adam(dev, gen)
    for name, t in (("flash_attention (serving prefill)", flash_t),
                    ("decode_attention", decode_t), *train_t.items()):
        log(f"  {name} [{t['shape']}]: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) [{card}]")

    log("phase 4: GPT-2 125M served end to end")
    base = GPT2_PRESETS["gpt2-125m"]
    model_fp32 = GPT(dataclasses.replace(base, dtype=torch.float32),
                     seed=SEED)
    model_bf16 = GPT(base, seed=SEED)     # the same weights: same seed
    prompts, outs = traffic(base.vocab_size)
    config = {"num_slots": 8, "max_len": 1024, "prefill_bucket": 128}
    phase_fp32(model_fp32, prompts, outs, config)
    counts = phase_bf16(model_bf16, prompts, outs, config, card,
                        profile="--profile" in sys.argv[1:])
    phase_cpu_parity(model_fp32)
    del model_fp32, model_bf16
    torch.cuda.empty_cache()

    log("phase 5: GPT-2 125M trained end to end")
    set_gemm_flags(defaults)
    train_counts, _ = phase_train_bf16(card,
                                       profile="--profile" in sys.argv[1:])
    set_gemm_flags((False, False, False))
    phase_train_parity()

    # flash_attention and decode_attention: the serving path's shapes and
    # launches; the other four: the training shape and phase 5a's launches
    flash_t["launches"] = counts["flash_attention"]
    decode_t["launches"] = counts["decode_attention"]
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq", "fused_adam"):
        train_t[name]["launches"] = train_counts[name]
    csrc, pallas = ("deepspeed_tpu_torch/ops/csrc/",
                    "deepspeed_tpu/ops/pallas/")
    kernels = []
    for name, t, src, replaces in (
            ("flash_attention", flash_t, csrc + "flash_attention_fwd.cu",
             pallas + "flash_attention.py:662"),
            ("decode_attention", decode_t, csrc + "decode_attention.cu",
             pallas + "decode_attention.py:118"),
            ("flash_attention_train", train_t["flash_attention"],
             csrc + "flash_attention_fwd.cu", pallas + "flash_attention.py:662"),
            ("flash_attention_bwd_dkv", train_t["flash_attention_bwd_dkv"],
             csrc + "flash_attention_bwd.cu", pallas + "flash_attention.py:773"),
            ("flash_attention_bwd_dq", train_t["flash_attention_bwd_dq"],
             csrc + "flash_attention_bwd.cu", pallas + "flash_attention.py:773"),
            ("fused_adam", train_t["fused_adam"], csrc + "fused_adam.cu",
             pallas + "fused_adam.py:46")):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": t["launches"],
            "max_abs_err": t["max_abs_err"], "max_err": t["max_abs_err"],
            "tol": ADAM_TOL if name == "fused_adam" else TOL[torch.bfloat16],
            "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
