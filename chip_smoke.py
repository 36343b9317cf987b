#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:

1. environment: a CUDA device, its name and power limit (nvidia-smi),
   TF32 and reduced-precision bf16 GEMM reductions switched off;
2. build: the kernels of ``deepspeed_tpu_torch/ops/csrc`` with nvcc for
   sm_90a (register and spill counts printed);
3. kernels: every kernel of the serving path against its plain PyTorch
   version on the card, then timed at the serving path's shapes beside
   the plain version, one PyTorch library call computing the same
   function, and the least time the card could take;
4. the slice end to end: GPT-2 125M at full width and depth (random
   weights from a seed) served through ``init_inference(...).serve()``:
   (a) fp32, every request token-exact against the port's ``generate()``
   and the launch counters proving both kernels carried the serving run;
   (b) bf16 (the default config), first tokens exact, timings
   (``--profile`` adds a torch.profiler breakdown of the device time of
   one decode iteration and of each prefill bucket);
   (c) the first forward pass on the card against the CPU (plain
   versions, fp32).

The line before last is ``{"kernels": [...]}``, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

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
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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
                    err = max((o.float() - ro.float()).abs().max().item(),
                              (lse - rlse).abs().max().item()
                              if dtype == torch.float32 else 0.0)
                    ok = bool(torch.isfinite(o).all()) and err <= TOL[dtype]
                    log(f"flash {str(dtype)[6:]:8s} b={b} d={d:3d} "
                        f"sq={sq:3d} sk={sk:4d} {name:10s} "
                        f"max_abs_err={err:.3e} "
                        f"tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError("flash_attention kernel "
                                             "disagrees with its plain "
                                             "version")


def check_decode(dev, gen):
    from deepspeed_tpu_torch.models.layers import alibi_slopes
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    B, H, S = 8, 12, 1024
    lengths = torch.tensor([0, 1, 77, 1024, 500, 333, 1000, 64],
                           dtype=torch.int32, device=dev)
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
                err = (o[:, 0].float() - ro.float()).abs().max().item()
                ok = (bool(torch.isfinite(o).all()) and err <= TOL[dtype]
                      and not o[0].float().any())
                log(f"decode {str(dtype)[6:]:8s} d={d:3d} S={S} "
                    f"alibi={alibi!s:5s} max_abs_err={err:.3e} "
                    f"tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("decode_attention kernel disagrees "
                                         "with its plain version")


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


def device_profile(name, fn, wall, card, iters=10):
    """Device time of ``fn`` by kernel from a torch.profiler trace: busy
    ms per call (union of kernel, memcpy and memset intervals), its share
    of the unprofiled wall time ``wall``, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile
    out_dir = os.path.join(REPO, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name.replace(" ", "_") + ".json")
    with torch.no_grad():
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log("  TF32 off for matmul and cuDNN; bf16 GEMM reductions in fp32")

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
    flash_t = time_flash(dev, gen)
    decode_t = time_decode(dev, gen)
    for name, t in (("flash_attention", flash_t),
                    ("decode_attention", decode_t)):
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

    kernels = []
    for name, t, src, replaces in (
            ("flash_attention", flash_t,
             "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
             "deepspeed_tpu/ops/pallas/flash_attention.py:662"),
            ("decode_attention", decode_t,
             "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
             "deepspeed_tpu/ops/pallas/decode_attention.py:118")):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": t["max_abs_err"], "max_err": t["max_abs_err"],
            "tol": TOL[torch.bfloat16], "ms": t["ms"], "kernel_ms": t["ms"],
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
