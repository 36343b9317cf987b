#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile | --checks-only | --8c-only |
                           --7a-only | --loop-only | --fp16-only |
                           --inject-only | --11b-only | --gptj-only |
                           --gptj-train-only | --fp16-serve-only |
                           --published-only | --serving-only |
                           --serving-timing [dir] | --decode-timing [dir] |
                           --serving-ab dir | --chunk-sweep |
                           --planted-faults [name]]

Phases, each fatal on failure:

1. environment: a CUDA device, its name and power limit (nvidia-smi),
   TF32 and reduced-precision bf16 and fp16 GEMM reductions switched off
   for every phase but 5a, 7a, 8a, 8b, 13a and 15a, which run under torch's
   defaults;
2. build: the kernels of ``deepspeed_tpu_torch/ops/csrc`` with nvcc for
   sm_90a (register and spill counts printed; the bf16 and fp16 flash
   forward's and backward's head-dim-256 instances, on wgmma, must not
   spill, the fp32 backward's are logged);
3. kernels: every kernel of the serving and training paths against its
   plain PyTorch version on the card (the flash forward with dropout, both
   flash backward kernels and fused Adam over the training grid, the
   attention kernels at head_dim 64, 80, 96 and 128, the flash forward and
   backward, decode and paged kernels also at 256 (GPT-J-6B's; the
   backward also at GPT-J-6B's attention, b 1, s 2048, 16 heads, causal,
   dropout 0 and 0.1, in bf16, fp16 and fp32, and 20 repeated launches bit
   for bit), the bf16 flash kernels again at phases 5a's and 8a's shapes;
   bf16 held by the largest error and by the rms error, ``Gate``), then
   timed at the serving and
   training shapes beside the plain version, one PyTorch library call
   computing the same function, and the least time the card could take
   (the flash kernels in bf16 on the tensor cores at dropout 0.1 and 0,
   and in fp32 on 3xTF32 tensor-core products, also at head_dim 128; the
   split-KV decode and paged kernels also at the chunk boundaries, in 20
   repeated launches bit for bit, and timed at long rows);
4. the slice end to end: GPT-2 125M at full width and depth (random
   weights from a seed) served through ``init_inference(...).serve()``:
   (a) fp32, every request token-exact against the port's ``generate()``
   and the launch counters proving both kernels carried the serving run;
   (b) bf16 (the default config), first tokens exact against
   ``generate()``, the rest classified (each request that differs before
   its first near tie logged with the step and the reference gap there;
   exempt, as cuBLAS rounds a dense layer's row by the batch's row
   count), timings (``--profile`` adds a torch.profiler breakdown of the
   device time of one decode iteration and of each prefill bucket);
   (c) the first forward pass on the card against the CPU (plain
   versions, fp32); (d) gpt2-760m's widths (head_dim 96) cut to 2 layers,
   fp32, served token-exact against ``generate()`` (near-tie rule);
5. training end to end through ``initialize(...)`` -> ``train_batch``:
   (a) GPT-2 125M, bf16 compute on fp32 master weights, attention dropout
   0.1, 8 steps on one seeded batch: finite losses that fall, exact
   launch counts of the flash forward, both backward kernels and fused
   Adam, step time and tokens/s under torch's default GEMM settings
   (``--profile`` adds the device-busy share of one step); (b) the card
   against the CPU in fp32 with dropout on: the loss of each step within
   1e-4, the parameters within 4 lr;
6. the paged slice end to end: GPT-2 125M served from a paged pool (16
   slots on 64 pages of 128 tokens, the memory of 8 full-length rows;
   prefix cache, prefill chunks of 256), 24 requests sharing a 256-token
   system prompt, with the launch counters of every run exact:
   (a) fp32, token-exact against ``generate()`` (near-tie rule);
   (b) bf16, first tokens exact and the rest classified, as 4b, tokens/s,
   decode wall ms, pool bytes
   (``--profile``: the device time of one paged decode iteration);
   (c) bf16 with int8 weights, token-exact against ``generate()`` over the
   same int8 model (near-tie rule), decode wall ms (``--profile``: its
   device time);
   (d) bf16 with int8 weights and int8 KV pages: greedy agreement with
   (c) >= 0.9 and one decode step's logits within 0.2 of the bf16 pool.
   Phase 3 holds the paged-attention kernel (fp32, bf16 and int8 pages
   over NaN-poisoned pools) and both int8 matmul kernels against their
   plain versions first (and their one summation order bit for bit:
   across m, across a row's place in its 16-row tile, at a ragged k, and
   with the tiled kernel's k segments split over CTAs or not), and times
   them at phase 6's shapes;
7. the sparse slice end to end: BERT-base made sparse with the BigBird-64
   pattern (``SparseAttentionUtils``, position table extended to 4096)
   and trained through ``initialize(...)`` -> ``train_batch`` with
   FusedLamb: (a) bf16 on fp32 masters, attention dropout 0.1, micro 2 x
   gas 2 sequences of 4096 tokens, 8 steps on one seeded MLM + NSP batch:
   finite losses whose mean over the last period (two steps) lies at
   least ``LOSS_FALL`` below the first period's, exact launch counts of
   the three block-sparse
   kernels (12 layers x 2 microbatches a step) and the two LAMB launches
   (one each a step), no flash or Adam launch, step time and tokens/s
   (``--profile``: the device-busy share of one step); (b) the card
   against the CPU in fp32 with dropout on (4 layers, 1024 tokens, 2
   steps): the loss of each step within 1e-4, each parameter tensor
   within 0.02 of the sum of its largest LAMB step per step. Phase 3 holds
   the block-sparse forward, dQ and dK/dV kernels (five patterns, 256 and
   4096 tokens, dropout off and on; bf16 on the tensor cores, fp32 on
   3xTF32 tensor-core products; every kernel in both dtypes launched
   twice for the same bits; q tiles with empty lists writing O = 0,
   m = NEG_INF, l = 1)
   and the LAMB kernels (both clip sides, no clip, a zero tensor) against
   their plain versions first, and times them at phase 7's shapes (bf16
   at 7a's, fp32 at 7b's with 7b's launches, and logged at 7a's);
8. the compression slice end to end: a BERT-large stack of
   ``DeepSpeedTransformerLayer``s (d 1024, 24 layers, 16 heads, d_ff
   4096, pre-LN, word and position embeddings, a final LayerNorm and the
   tied MLM decoder; ``DSBertMLM``) trained through ``initialize(...)``
   -> ``train_batch`` with FusedLamb, bf16 on fp32 masters, attention
   dropout 0.1 and a padding mask, 64 x 128 tokens a step (gas 1), 8
   steps on one seeded batch: (a) 8-bit symmetric weight quantization of
   the four matrices of every layer from step 2
   (``compression_training``); (b) MoQ from 10 to 8 bits, period 1, on
   every matrix (``quantize_training``). Each: finite losses, after each
   projecting step every projected matrix holds at most 2^bits - 1
   values per column, exact launch counts (49 LayerNorm forward and
   backward launches and 24 of each flash kernel a microbatch, two LAMB
   launches a step, one quantize and one dequantize per projected matrix
   a projecting step, nothing else), step time, tokens/s and the
   projection's device time (``--profile``: the device-busy share of a
   step). (c) the card against the CPU in fp32 (4 layers, 4 x 128 tokens,
   gas 2, 3 steps, both blocks on): the loss of each step within 1e-4,
   every element of a snapped (2-D) parameter within 1e-6 except
   elements one grid step of their column apart (an fp32 tie in x /
   scale), at most 1e-4 of them, each 1-D parameter within 0.02 of the
   sum of its largest LAMB step (phase 7b's rule); then the same run
   with both blocks off as a control: losses within 1e-4, every 2-D
   parameter within 1e-6 after each step, the 1-D rule. Phase 3
   holds the LayerNorm kernels (rows 1-8193, widths 768-8192 on both
   sides of the warp-per-row kernels' limit and one not a whole vector,
   fp32 max_rel <= 1e-5, bf16 ``Gate``, an offset row set and a constant
   row; two backward launches bit-equal)
   and the quantize / dequantize kernels and ``fake_quantize`` (bit-equal:
   sym, asym, stochastic; bits 4/8/12; groups 1/16/1024; fp32 and bf16;
   an all-zero group; stochastic rounding reproducible and unbiased)
   against their plain versions first, and times them at phase 8's
   shapes;
9. the engine's own loop end to end: GPT-2 125M (bf16 on fp32 masters,
   FusedAdam, WarmupLR, clip 1.0, micro 4 x gas 2 x 1024 tokens) fed by
   ``initialize(training_data=...)``'s dataloader and trained through
   ``loss = engine(mb); engine.backward(loss); engine.step()``: (a) with
   attention dropout 0.1, run A takes 6 steps (exact launch counts of
   the flash forward, both backward kernels and fused Adam: 144, 144,
   144 and 6); run B takes 3, saves asynchronously (``latest`` must stay
   unpublished until ``wait_checkpoint``), trains on and waits; run C
   loads through ``latest`` and takes steps 4-6: its losses, parameters
   and Adam moments bit-equal to A's; the same resume without the
   optimizer states must differ (the control); save, load and 16-bit
   export seconds and bytes printed; (b) dropout off, ``train_batch``
   against forward/backward/step on the same batches, bit-equal after 2
   steps, and the step wall ms of each in turns; (c) Adagrad and SGD
   (momentum 0.9, Nesterov), fp32 at 4 x 128 tokens, card against CPU
   over 2 steps: losses within 1e-4, parameters within
   ``ADAGRAD_SGD_TOL`` of the largest parameter move. Checkpoints go to
   a ``tempfile`` directory deleted at the end of the phase;
10. the one-card training modes: (a) GPT-2 125M in fp16 (fp32 masters,
   FusedAdam, attention dropout 0.1, micro 8 x gas 2 x 1024 tokens,
   ``gpt_chunked_loss_fn`` at chunk 256, dynamic loss scale from 2**26 so
   the first steps overflow and are skipped), 8 steps three ways: no
   remat, ``activation_checkpointing`` ``full`` and ``attn_out``. Gates:
   finite losses; the (scale, growth, overflows, hysteresis) trajectory
   equal to a host replay of ``update_scale`` fed the card's own finite
   flags; the remat runs' losses, last gradients and parameters bit-equal
   to the run without; exact launch counts (the flash forward twice a
   layer and microbatch under ``full``, once otherwise; one Adam launch a
   step taken); peak device memory lower under ``full`` than without, and
   lower with the chunked loss than with ``gpt_loss_fn`` over full logits;
   step ms and peak bytes printed, and the host read of the finite flag.
   (b) an fp16 save at step 3 and a resume through ``latest``: losses,
   loss scale, skips and parameters bit-equal to (a)'s uninterrupted run.
   (c) BERT-base in bf16 with bf16 gradient accumulation, progressive
   layer drop and FusedLamb (128 tokens, micro 32 x gas 4, 8 steps) and
   GPT-2 125M in bf16 with bf16 accumulation and FusedAdam (4 steps):
   finite losses, exact launch counts of the bf16-gradient kernels, the
   gradient-buffer bytes saved; then GPT-2 fp32 with bf16 accumulation,
   card against CPU (4 x 128 tokens, 2 steps): losses within 1e-4,
   parameters within 4 lr. Phase 3 holds the fp16 flash kernels (the
   training grid and GPT-2's shape; fp16 ``Gate``) and Adam and LAMB over
   bf16 gradients against their plain versions first, and times them at
   10a's and 10c's shapes;
11. checkpoint injection end to end: (a) Pythia-1.4B (EleutherAI's
   ``config.json``: d 2048, 16 heads of 128, 24 layers, d_ff 8192, rotary
   over 32 dims, vocab 50304, parallel residual, exact GELU, untied head;
   cut to ``PYTHIA_LAYERS`` 12 layers) drawn from a seed, exported to HuggingFace's layout in fp16
   (``export_hf_state_dict``), written as two ``pytorch_model-*.bin``
   shards with their index and a ``config.json`` of the non-default
   fields, loaded through ``init_inference(read_hf_config(dir),
   checkpoint=dir, replace_with_kernel_inject=True, dtype=bf16)``: the
   checkpoint reads back bit-equal and the model holds its bf16 rounding
   (LayerNorms fp32); parameter bytes on the card; phase 6's trace served
   paged, launch counts exact, prefix hits, allocator clean, first tokens
   exact against ``generate()`` (the rest classified, as 6b), tokens/s
   and decode wall ms; (c) the same model with int8 weights (the untied
   head too) against the int8 model's ``generate()``: first tokens exact
   (11a's tie rule), the rest classified (at d 2048 the eager
   LayerNorm's variance rounds a row by the batch's row count), small-m
   and tiled launches exact; (b) fp32 at the
   same widths and 2 layers: the injected state exports back bit-equal,
   card logits within 2e-3 of the CPU's, prefill and decode steps
   through the cache within 2e-3 of the cache-free forward, contiguous
   and paged serving and a ragged ``generate()`` token-exact against
   ``generate()`` (near-tie rule), decode, paged and flash launches
   exact; (d) a flash forward at a head dim no flash kernel takes (160)
   that needs a gradient refused by name, naming the kernels' head dims,
   with no launch and no device allocation; (e) ``BertSparseSelfAttention`` at
   BERT-base widths with HF-named query/key/value weights, BigBird-64 at
   4096 tokens, bf16, against its plain version (``Gate``), one
   block-sparse forward launch;
12. head dim 256 end to end: (a) GPT-J-6B (EleutherAI's ``config.json``:
   d 4096, 16 heads of 256, 28 layers, d_ff 16384, rotary over 64 of
   each head's dims, vocab 50400, a parallel residual with one shared
   LayerNorm, no attention biases, a head with a bias) at full width and
   4 layers drawn from a seed, exported to HuggingFace's layout in fp16,
   written as a sharded checkpoint and loaded through
   ``init_inference(read_hf_config(dir), checkpoint=dir,
   replace_with_kernel_inject=True, dtype=bf16)`` (read back bit-equal,
   held as its bf16 rounding); then ``GPTJ_LAYERS`` (14) of its 28
   layers from weights the policy draws, through ``init_inference(config,
   replace_with_kernel_inject=True, dtype=bf16)``, serving phase 6's
   trace paged: launch counts exact (14 flash forward launches a prefill
   chunk, 14 paged a decode iteration), first tokens exact against
   ``generate()`` (11a's tie rule, the rest classified), its decode
   launches exact, tokens/s, decode wall ms, parameter, KV pool and host
   peak bytes; (c) the same model with int8 KV pages (6d's logit rung;
   the greedy agreement classified against 12a's own with
   ``generate()``); (b)
   fp32 at GPT-J-6B's widths and 2 layers, 11b's gates;
13. head dim 256 trained: (a) GPT-J-6B's layout (its injection policy's
   ``GPTConfig``: d 4096, 16 heads of 256, rotary 64, d_ff 16384, vocab
   50400, parallel residual, shared LayerNorm, no attention biases, an
   untied head with a bias) at full width and 8 of its 28 layers, seeded
   weights, through ``initialize(...)`` -> ``train_batch``: bf16 on fp32
   masters, FusedAdam, micro 2 x gas 2 x 2048 tokens, 6 steps on one
   seeded batch under torch's default GEMM flags: exact launch counts of
   the d-256 flash forward and both backward kernels and of fused Adam,
   finite losses that fall, peak device memory, step time and tokens/s
   (``--profile`` adds the device-busy share of one step); (b) the same
   width in fp16 at 2 layers, 4 steps, dynamic loss scale from 2**16: the
   scale trajectory equal to the host replay of ``update_scale``, at
   least one step taken, exact launches of the fp16 d-256 instances; (c)
   the card against the CPU in fp32 at GPT-J-6B's layout cut to d 1024 (4
   heads of 256), 2 layers, 4 x 256 tokens, 2 steps: phase 5b's gates;
14. serving in fp16, fp16 GEMM reductions in fp32: (a) Pythia-1.4B
   (``PYTHIA_LAYERS`` layers) from its own fp16 checkpoint (phase 11a's;
   written as 11a writes it under ``--fp16-serve-only``) through
   ``init_inference(config, checkpoint=dir, replace_with_kernel_inject=
   True, dtype=torch.float16)``: every served weight the checkpoint's
   fp16 tensor bit for bit (LayerNorms widened to fp32), phase 6's trace
   served paged with launch counts of the fp16 flash, paged and decode
   instances exact, first tokens exact against ``generate()`` unless the
   reference top-2 gap is at most ``FP16_TIE_ULPS`` fp16 ulps of the top
   logit (the rest classified), tokens/s, decode wall ms, its device busy
   ms and idle share, parameter bytes; (b) the same model with int8
   weights and int8 KV pages: the int8 launches exact (4 x layers + 1 a
   program), one decode step's logits within 0.2 of the fp16 pool's,
   every served token's deficit < 0.4 (12c's gate); (c) GPT-J-6B's config
   at full width, 2 layers, fp16, served paged through the d-256 fp16
   instances, (a)'s gates. Phase 3 holds the fp16 decode, paged (fp16
   and int8 pages) and int8 matmul instances against their plain versions
   first (the fp16 ``Gate``) and times them at the bf16 rows' shapes;
15. sparse BERT at its published settings: (a) phase 7a's BERT-base made
   sparse (BigBird-64, 4096 tokens, micro 2 x gas 2, FusedLamb, 7a's
   batch) in fp16 on fp32 masters with bing_bert's dynamic loss scaling
   (``PUBLISHED_FP16``) and attention, MLP and embedding dropout 0.1 (BERT's
   ``bert_config.json``), 8 ``train_batch`` calls under torch's default
   GEMM flags: exact launch counts of the block-sparse kernels through
   their ``_fp16`` entry points (12 layers x 2 microbatches x 8 steps) and
   of the dropout kernel (13 sites x 2 microbatches x 8 steps each way),
   LAMB twice a step taken, no flash or Adam launch; finite losses that
   fall over whole periods (``LOSS_FALL``); the loss-scale record equal to
   the host replay of ``update_scale``; step wall, tokens/s, peak device
   memory, skipped steps and the device-busy share of a step; (b) fp32,
   card against CPU, every dropout at 0.1: sparse BERT (d 128, 2 layers,
   512 tokens) and two ``DeepSpeedTransformerLayer``s at BERT-large's
   widths with hidden dropout: every dropout map's zeros equal on both
   sides, outputs within 1e-5 and gradients within 1e-5 of the largest,
   every activation site's words distinct and none a layer's; (c) GPT-2
   125M's widths at 2 layers, bf16, every dropout 0.1: loss and gradients
   under remat ``full`` and ``attn_out`` bit-equal to ``none``. Phase 3
   holds the fp16 block-sparse instances (the grid of the bf16 ones:
   every layout at 256 tokens and head dims 64-128, and at 4096 tokens;
   fp16 ``Gate``) and the dropout kernel (bit-equal: fp32, bf16, fp16,
   rates 0.1 and 0.5, 15a's activation, an odd shape, a misaligned base,
   forward and backward) against their plain versions first, and times
   them at 7a's shape (beside the bf16 twins) and 15a's activation.

``--checks-only`` stops after phase 3's checks (the quick proof that
edited kernels build and agree; it prints no result line).
``--8c-only`` builds the kernels and runs phase 8c alone (no result);
``--7a-only`` phase 7a likewise, ``--loop-only`` phase 9,
``--fp16-only`` phase 10, ``--inject-only`` phase 11, ``--11b-only``
phase 11b, ``--gptj-only`` phase 12, ``--gptj-train-only`` phase 13,
``--fp16-serve-only`` phase 14, ``--published-only`` phase 15,
``--serving-only`` phases 4b and 6b.
``--serving-ab dir`` times 4b's and 6b's decode iteration in one process
with this checkout's decode and paged ops and with those of the checkout
``dir`` in turns (no result).
``--decode-timing [dir]`` likewise times the decode and paged kernels
at phase 3's shapes and at long rows (no result); ``--chunk-sweep`` runs
it on copies built with each split-KV chunk width of ``SWEEP_CHUNKS``.
``--serving-timing [dir]`` builds and times 4b's and 6b's serving,
prefill and decode with no gate, on the package of the checkout ``dir``
(default this one), and prints them as one JSON line: run on a change's
and its parent's checkouts in turns, it compares the two (no result).
``--d256-ab dir`` times the bf16, fp16 and fp32 d-256 flash forward,
dK/dV and dQ kernels of this checkout and of the checkout ``dir`` (its
package copied under another name, both libraries built) in turns in one
process, at GPT-J-6B's attention and the serving prefill bucket, one line
each with the parent's and the change's times beside the bound and SDPA,
and holds the bf16 and fp16 instances at every head dim and the fp32 ones
at d <= 128 bit-equal to the parent's (no result).
``--planted-faults [name]`` runs ``--checks-only`` (fifty-five faults;
``d-256`` picks the fifteen of the head-dim-256 instances, ``bwd-d256``
the six of the flash backward's, ``wgmma`` the eight of the d-256
kernels on wgmma and of wgmma.cuh's tf32 stagers, ``tf32`` the six of
the fp32 d-256 kernels on tf32 wgmma, ``fp16-serving`` the three of the
serving kernels' fp16 instances),
``--8c-only`` (two), ``--7a-only`` (one), ``--11b-only`` (three: the
injection path's Python), ``--gptj-only`` (one, ``12c``: int8 pages at
head dim 256 in every slot but the first) or ``--published-only`` (one:
the MLP dropout site on its layer's words; ``published:`` picks it and
phase 15's two kernel faults) in copies of the checkout,
each with one kernel fault planted (``PLANTED_FAULTS``; only those
whose source file name or description contains ``name``, when given;
``instance:`` picks the four of the fp16 and bf16-gradient instances),
and fails unless
every copy fails; it
prints no result line either. 8c also reads the step-1 gradient of the
1-D element that differs most between card and CPU.

The card's name and power limit come on the line before the
``{"kernels": [...]}`` line, which is the line before last; the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

import functools
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16/fp16 tensor-core rate
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12      # H100 SXM dense TF32 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
# max |out - ref| over max(1, max |ref|): fp32 at FMA order; bf16 at a few
# output ulps, which catches a wrong tile or element but not a misplaced
# rounding (that moves every element by under one ulp)
# fp16: ~2 output ulps at 2^-10 (H100 readings of the fp16 flash kernels
# over the training grid: max_rel <= 9.6e-4)
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}
# bf16 also: rms(out - ref) / rms(ref). The kernels round where their plain
# versions do, so only sparse one-ulp flips differ; a rounding step that is
# missing or misplaced moves every element, and reads far above this
# (5e-4); fp16 likewise, 8x finer ulps (H100 readings: rms_rel <= 8.4e-5)
RMS_TOL = {torch.bfloat16: 5e-4, torch.float16: 2.5e-4}
ADAM_TOL = 1e-5   # fused Adam, relative to max(1, max |ref|): FMA contraction
# near tie: stop comparing a request at a step whose reference top-2 logit
# gap is below this (in bf16, where a logit's ulp is ~0.03, only exact ties)
GAP_STOP = 1e-3
SEED = 0
DS_SEQ, DS_MICRO = 128, 64    # phase 8: bing_bert's seq-128 LAMB schedule


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


# The GEMM settings that phases 3, 4 and 5b run under (TF32 off, bf16 and
# fp16 reductions in fp32), so the card's products are the CPU's and
# fp16 serving is read under the rounding it logs; phase 5a runs under
# torch's defaults, as a user's training run does.
GEMM_FLAGS = ((torch.backends.cuda.matmul, "allow_tf32"),
              (torch.backends.cudnn, "allow_tf32"),
              (torch.backends.cuda.matmul,
               "allow_bf16_reduced_precision_reduction"),
              (torch.backends.cuda.matmul,
               "allow_fp16_reduced_precision_reduction"))
GEMM_OFF = (False,) * len(GEMM_FLAGS)


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
# phase 2: the build
# --------------------------------------------------------------------------

# the flash kernels' d-256 instances in nvcc's -Xptxas -v output (dropout
# off and on each), whose fp32 accumulator alone takes 128 registers a
# thread: the bf16/fp16 forward, dK/dV and dQ on wgmma, and the fp32
# (3xTF32) forward, dQ, dK and dV on tf32 wgmma (flash_tf32.cuh)
D256_ENTRIES = (
    ("flash forward bf16/fp16 (wgmma)", r"flash_fwd_wgmma_kernelI"
     r"(13__nv_bfloat16|6__half)", 4),
    ("flash backward dK/dV bf16/fp16 (wgmma)", r"flash_bwd_dkv_wgmma_kernelI"
     r"(13__nv_bfloat16|6__half)", 4),
    ("flash backward dQ bf16/fp16 (wgmma)", r"flash_bwd_dq_wgmma_kernelI"
     r"(13__nv_bfloat16|6__half)", 4),
    ("flash forward fp32 (tf32 wgmma)", r"flash_fwd_tf32_kernelI", 2),
    ("flash backward dQ fp32 (tf32 wgmma)", r"flash_bwd_dq_tf32_kernelI", 2),
    ("flash backward dK fp32 (tf32 wgmma)", r"flash_bwd_dk_tf32_kernelI", 2),
    ("flash backward dV fp32 (tf32 wgmma)", r"flash_bwd_dv_tf32_kernelI", 2))


def d256_spills(build_log, pattern):
    """{entry: [spill bytes, registers]} of every kernel instance matching
    ``pattern`` in nvcc's ``-Xptxas -v`` output."""
    name, seen = None, {}
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            name = m[1] if re.search(pattern, m[1]) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            seen[name] = [int(m[1]) + int(m[2]), None]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in seen:
            seen[name][1] = int(m[1])
    return seen


def check_d256_spills(build_log):
    """Registers and spill bytes of the flash kernels' d-256 instances
    (``D256_ENTRIES``): each family present with its count of instances,
    none spilling."""
    bad = []
    for what, pattern, count in D256_ENTRIES:
        seen = d256_spills(build_log, pattern)
        log(f"  {what} d-256 instances (dropout off, on): "
            + ", ".join(f"{regs} registers / {spill} spill bytes"
                        for spill, regs in seen.values()))
        if len(seen) != count or any(spill for spill, _ in seen.values()):
            bad.append((what, seen))
    if bad:
        raise AssertionError("flash d-256 instances spill or were not "
                             f"found: {bad}")


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
        FWD_HEAD_DIMS, flash_attention, flash_attention_reference)
    gate = Gate("flash")
    for dtype in (torch.float32, torch.bfloat16):
        for d in FWD_HEAD_DIMS:
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


def boundary_lengths(capacity):
    """Row lengths at the split-KV kernels' chunk boundaries: one short of
    a chunk, a chunk, one past it, two chunks and one short of the
    capacity."""
    from deepspeed_tpu_torch.ops.decode_split import CHUNK
    return [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK, capacity - 1]


def check_decode(dev, gen):
    from deepspeed_tpu_torch.models.layers import alibi_slopes
    from deepspeed_tpu_torch.ops.decode_attention import (
        HEAD_DIMS, decode_attention, decode_attention_reference)
    S = 1024
    lengths = torch.tensor([0, 1, 77, 1024, 500, 333, 1000, 64,
                            *boundary_lengths(S)],
                           dtype=torch.int32, device=dev)
    B, H = len(lengths), 12
    gate = Gate("decode")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in HEAD_DIMS:
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


def _paged_case(dev, gen, dtype, quant, page_len, d, lengths, B=8, H=12,
                capacity=1024, poison=True):
    """A page pool for ``paged_attention``: each slot owns ceil(length /
    page_len) pages of a shuffled pool, the rest of its table row is the
    null page 0; with ``poison`` every (page, offset) no slot may read,
    the null page included, holds NaN (int8 pools: NaN scales). Returns
    (q, k_new, v_new, k, v, k_scale, v_scale, table, lengths)."""
    max_pages = capacity // page_len
    owned = [-(-int(n) // page_len) for n in lengths]
    num_pages = sum(owned) + 1
    perm = torch.randperm(num_pages - 1, generator=torch.Generator()
                          .manual_seed(len(lengths) * page_len + d)) + 1
    table = torch.zeros(B, max_pages, dtype=torch.int32)
    valid = torch.zeros(num_pages, page_len, dtype=torch.bool)
    at = 0
    for b, (n, own) in enumerate(zip(lengths, owned)):
        pages = perm[at:at + own]
        at += own
        table[b, :own] = pages
        for i, p in enumerate(pages.tolist()):
            valid[p, :min(page_len, int(n) - i * page_len)] = True
    shape = (num_pages, H, page_len, d)
    mask = valid.to(dev)[:, None, :] | (not poison)   # [pages, 1, page_len]
    q, kn, vn = (torch.randn(B, H, d, generator=gen, device=dev, dtype=dtype)
                 for _ in range(3))
    if quant:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.where(mask, torch.rand(shape[:3], generator=gen,
                                               device=dev) * 0.03, np.nan)
                  for _ in range(2))
    else:
        k, v = (torch.where(mask[..., None],
                            torch.randn(shape, generator=gen, device=dev),
                            np.nan).to(dtype) for _ in range(2))
        ks = vs = None
    return (q, kn, vn, k, v, ks, vs, table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def check_paged(dev, gen):
    """The paged kernel against its plain version in fp32, bf16 and fp16
    compute over pages of the compute dtype and int8 pages, page_len 16
    and 128, d 64, 80, 96, 128 and 256, ALiBi on and off, lengths 0, 1,
    ragged, at the chunk boundaries and a full table, with NaN in every
    unreadable position; with float pages also bit-equal to the decode
    kernel over the same tokens."""
    from deepspeed_tpu_torch.models.layers import alibi_slopes
    from deepspeed_tpu_torch.ops.paged_attention import (
        HEAD_DIMS, paged_attention, paged_attention_reference)
    gate = Gate("paged")
    lengths = [0, 1, 77, 1024, 500, 333, 1000, 128, *boundary_lengths(1024)]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for quant in (False, True):
            for page_len in (16, 128):
                for d in HEAD_DIMS:
                    for alibi in (False, True):
                        args = _paged_case(dev, gen, dtype, quant, page_len,
                                           d, lengths, B=len(lengths))
                        q, kn, vn, k, v, ks, vs, table, lens = args
                        slopes = alibi_slopes(12).to(dev) if alibi else None
                        o = paged_attention(q, k, v, table, lens, kn, vn,
                                            alibi_slopes=slopes, k_scale=ks,
                                            v_scale=vs)
                        ro = paged_attention_reference(
                            q, k, v, table, lens, kn, vn,
                            alibi_slopes=slopes, k_scale=ks, v_scale=vs)
                        torch.cuda.synchronize()
                        if not torch.equal(o[0], vn[0]):
                            raise AssertionError("paged_attention: a slot of "
                                                 "length 0 does not return "
                                                 "its own value")
                        gate.case(dtype, [o], [ro],
                                  f"pages={'int8' if quant else 'same'} "
                                  f"page_len={page_len:3d} d={d:3d} "
                                  f"alibi={alibi!s:5s}",
                                  show=page_len == 128 and not alibi)
                        if not quant:
                            _paged_is_decode(q, kn, vn, k, v, table, lens,
                                             lengths, page_len, slopes)
    gate.close()
    log("  paged: bit-equal to the decode kernel over the same tokens "
        "(fp32, bf16 and fp16 pages, every case)")


def _paged_is_decode(q, kn, vn, k, v, table, lens, lengths, page_len,
                     slopes):
    """The paged kernel over a slot's pages plus the current token gives
    the contiguous decode kernel's bits over the same tokens, as serving
    must give ``generate()``'s."""
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention
    B, H, d = q.shape
    kc = torch.zeros(B, H, max(lengths) + 1, d, device=q.device,
                     dtype=q.dtype)
    vc = torch.zeros_like(kc)
    for b, n in enumerate(lengths):
        pages = table[b, :-(-n // page_len)].long()
        kc[b, :, :n] = k[pages].transpose(0, 1).reshape(H, -1, d)[:, :n]
        vc[b, :, :n] = v[pages].transpose(0, 1).reshape(H, -1, d)[:, :n]
        kc[b, :, n], vc[b, :, n] = kn[b], vn[b]
    o = paged_attention(q, k, v, table, lens, kn, vn, alibi_slopes=slopes)
    ref = decode_attention(q, kc, vc, lens + 1, alibi_slopes=slopes)
    if not torch.equal(o, ref):
        raise AssertionError(
            f"paged_attention {q.dtype} d={d} page_len={page_len}: "
            f"{int((o != ref).sum())} of {o.numel()} outputs differ from "
            "the decode kernel over the same tokens")


def check_repeat(dev, gen, launches=20):
    """``launches`` launches each of the decode kernel and the paged kernel
    (pages of the compute dtype and int8 pages), bf16 and fp16, at rows
    of 4 to 8 live chunks, every output kept alive and bit-equal to the
    first: the merging chunk reads the partials only after the row's
    counter says they are written, and leaves the counter at 0 for the
    next launch."""
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.decode_split import CHUNK
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention
    B, H, S, d = 8, 12, 1024, 64
    lengths = [3 * CHUNK + 1 + 80 * i for i in range(B)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    runs = {}
    for dt in (torch.bfloat16, torch.float16):
        name = str(dt)[6:]
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=dt)
                   for shape in ((B, 1, H, d), (B, H, S, d), (B, H, S, d)))
        runs[f"decode {name}"] = (
            lambda a=(q, k, v, lens): decode_attention(*a))
        for quant in (False, True):
            qp, kn, vn, kp, vp, ks, vs, table, plens = _paged_case(
                dev, gen, dt, quant, 128, d, lengths, B=B)
            runs[f"paged {name} ({'int8' if quant else name} pages)"] = (
                lambda a=(qp, kp, vp, table, plens, kn, vn), kw=dict(
                    k_scale=ks, v_scale=vs): paged_attention(*a, **kw))
    for name, fn in runs.items():
        outs = [fn() for _ in range(launches)]
        torch.cuda.synchronize()
        same = sum(torch.equal(o, outs[0]) for o in outs[1:])
        if same != launches - 1:
            raise AssertionError(
                f"{name}: {launches - 1 - same} of {launches - 1} repeated "
                "launches differ from the first (the split-KV merge)")
    log(f"  repeat: {launches} launches each of {', '.join(runs)} "
        f"bit-equal (rows of {-(-min(lengths) // CHUNK)}-"
        f"{-(-max(lengths) // CHUNK)} live chunks)")


def check_int8(dev, gen):
    """Both int8 kernels against the plain version over m 1, 8, 16, 256,
    1000, the four GPT-2 125M weight shapes and a ragged k (200: neither
    a whole segment nor a whole 16-row step), fp32, bf16 and fp16 x, and
    over Pythia-1.4B's and GPT-J-6B's five matrices (GPT-J's head: n
    50400, not a multiple of 64) at m 1, 16 and 256, bf16 and fp16 x; and
    the summation order, bit for bit: rows of an m = 16 call (small-m
    kernel) and of an m = 1 call equal the same rows of an m = 1000 call
    (tiled), rows 5..20 of the m = 1000 call equal an m = 16 call on
    those rows (so each row sits elsewhere in its 16-row tile), and
    (16-bit x) the tiled kernel's m = 256 and m = 1000 calls give the
    same bits with the k segments split over CTAs as in one CTA a
    tile."""
    from deepspeed_tpu_torch.ops.wo_int8_matmul import (
        SEG, _launch, tiled_splits, wo_int8_matmul, wo_int8_matmul_reference)
    gate = Gate("wo_int8")
    splits_seen = set()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for k, n in GPT2_WEIGHTS + INT8_RAGGED:
            q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            scale = torch.rand(1, n, generator=gen, device=dev) * 0.01
            x = torch.randn(1000, k, generator=gen, device=dev, dtype=dtype)
            outs = {}
            for m in (1, 8, 16, 256, 1000):
                outs[m] = wo_int8_matmul(x[:m], q, scale)
                ref = wo_int8_matmul_reference(x[:m], q, scale)
                torch.cuda.synchronize()
                gate.case(dtype, [outs[m]], [ref],
                          f"k={k:4d} n={n:4d} m={m:4d}",
                          show=m in (16, 256) and dtype != torch.float32)
            window = wo_int8_matmul(x[5:21], q, scale)
            if not (torch.equal(outs[16], outs[1000][:16])
                    and torch.equal(outs[1], outs[1000][:1])
                    and torch.equal(outs[256][:16], outs[16])
                    and torch.equal(window, outs[1000][5:21])):
                raise AssertionError(
                    f"wo_int8_matmul k={k} n={n} {dtype}: a row's result "
                    "depends on m or on its place in the batch (the "
                    "kernels' summation orders differ)")
            if dtype == torch.float32:
                continue
            for m in (256, 1000):
                segs = -(-k // SEG)
                runs = {s: _launch(x[:m], q, scale, dtype, splits=s)
                        for s in sorted({1, 2, segs,
                                         tiled_splits(m, k, n)})}
                splits_seen.update(s for s in runs if s > 1)
                if not all(torch.equal(y, outs[m]) for y in runs.values()):
                    raise AssertionError(
                        f"wo_int8_matmul k={k} n={n} m={m} {dtype}: the "
                        f"tiled kernel's bits depend on the k split "
                        f"({sorted(runs)} CTAs along k)")
    # phase 11c's and 14b's shapes: Pythia-1.4B's five int8 matrices (the
    # untied head too) at m 1 (generate()), 16 (a decode step of 16 slots)
    # and 256 (a prefill chunk), bf16 and fp16 x, and GPT-J-6B's; their
    # own generator leaves the later checks' inputs as they were
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    for model, (k, n) in [("Pythia-1.4B", w) for w in pythia_int8_weights()] \
            + [("GPT-J-6B", w) for w in gptj_int8_weights()]:
        q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand(1, n, generator=gen, device=dev) * 0.01
        x32 = torch.randn(256, k, generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float16):
            x = x32.to(dtype)
            outs = {}
            for m in (1, 16, 256):
                outs[m] = wo_int8_matmul(x[:m], q, scale)
                ref = wo_int8_matmul_reference(x[:m], q, scale)
                torch.cuda.synchronize()
                gate.case(dtype, [outs[m]], [ref],
                          f"{model} k={k:5d} n={n:5d} m={m:3d}",
                          show=m != 1)
            segs = -(-k // SEG)
            runs = {s: _launch(x, q, scale, dtype, splits=s)
                    for s in sorted({1, segs, tiled_splits(256, k, n)})}
            splits_seen.update(s for s in runs if s > 1)
            if not (torch.equal(outs[1], outs[256][:1])
                    and torch.equal(outs[16], outs[256][:16])
                    and all(torch.equal(y, outs[256])
                            for y in runs.values())):
                raise AssertionError(
                    f"wo_int8_matmul {model} k={k} n={n} {dtype}: a row's "
                    "result depends on m or on the k split")
            del x, outs, runs
        del q, x32
    gate.close()
    log("  wo_int8: rows of m = 1, 16, 256 and 1000 calls and rows 5..20 "
        "bit-equal (one summation order in both kernels, fp32 FMAs and "
        "bf16 and fp16 mma.sync); bf16 and fp16 tiled bit-equal split over "
        f"{sorted(splits_seen)} CTAs along k and unsplit (GPT-2 125M's, "
        "Pythia-1.4B's and GPT-J-6B's matrices)")


GPT2_WEIGHTS = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
INT8_RAGGED = ((200, 768),)   # k % 128 != 0 and k % 16 != 0


def pythia_int8_weights():
    """(k, n) of Pythia-1.4B's int8 matrices: qkv, the attention output,
    the MLP's two and the untied head."""
    d, ff = PYTHIA_1_4B["hidden_size"], PYTHIA_1_4B["intermediate_size"]
    return ((d, 3 * d), (d, d), (d, ff), (ff, d),
            (d, PYTHIA_1_4B["vocab_size"]))


def gptj_int8_weights():
    """(k, n) of GPT-J-6B's matrices as the port holds them: the fused
    qkv, the attention output, the MLP's two and the untied head (n
    50400, a multiple of 16 but not of 64)."""
    d = GPTJ_6B["n_embd"]
    return ((d, 3 * d), (d, d), (d, 4 * d), (4 * d, d),
            (d, GPTJ_6B["vocab_size"]))


def served_lengths(n, seed):
    """Pool lengths of ``n`` slots drawn like phase 6's traffic: the
    shared system prompt, a tail and part of the output."""
    rs = np.random.RandomState(seed)
    return (SYSTEM_PROMPT + rs.randint(16, 401, size=n)
            + rs.randint(1, 65, size=n))


def time_paged(dev, gen, quant, d=64, H=12, dt=torch.bfloat16):
    """The paged decode shape of phase 6: 16 slots, 12 heads, d 64,
    page_len 128, capacity 1024, bf16 compute, bf16 or int8 pages (phase
    12's: 16 heads of 256, bf16, int8 or fp32). The library
    comparison is two calls: the page gather (an index, with the
    dequantizing product for int8) and SDPA over the gathered rows."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)
    B, page_len = 16, 128
    lengths = [int(n) for n in served_lengths(B, SEED + 6)]
    q, kn, vn, k, v, ks, vs, table, lens = _paged_case(
        dev, gen, dt, quant, page_len, d, lengths, B=B, H=H, poison=False)
    kw = dict(k_scale=ks, v_scale=vs)
    kernel = gpu_ms(lambda: paged_attention(q, k, v, table, lens, kn, vn,
                                            **kw))
    plain = gpu_ms(lambda: paged_attention_reference(
        q, k, v, table, lens, kn, vn, **kw), iters=10)
    ptab = table.long()
    S = ptab.shape[1] * page_len

    def gather(pool, scale):
        g = pool[ptab]                                   # [B, M, H, p, d]
        if scale is not None:
            g = (g.float() * scale[ptab][..., None]).to(dt)
        return g.permute(0, 2, 1, 3, 4).reshape(B, H, S, d)

    kg, vg = gather(k, ks), gather(v, vs)
    mask = (torch.arange(S, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    qt = q[:, :, None]
    lib_gather = gpu_ms(lambda: (gather(k, ks), gather(v, vs)))
    lib_sdpa = gpu_ms(lambda: F.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=mask))
    total = sum(lengths)
    psize = k.element_size()
    nbytes = (2 * total * H * d * psize + (2 * total * H * 4 if quant else 0)
              + 4 * B * H * d * q.element_size() + table.numel() * 4 + B * 4)
    bound, by = bound_ms(4 * (total + B) * H * d, nbytes, PEAK_FP32_FLOPS
                         if dt == torch.float32 else PEAK_BF16_FLOPS)
    err = (paged_attention(q, k, v, table, lens, kn, vn, **kw).float()
           - paged_attention_reference(q, k, v, table, lens, kn, vn, **kw)
           .float()).abs().max().item()
    dname = str(dt)[6:]
    return dict(shape=f"B={B} H={H} d={d} page_len={page_len} {dname}, "
                f"{'int8' if quant else dname} pages, sum(lengths)={total}; "
                f"library = gather {lib_gather:.4f} ms + SDPA "
                f"{lib_sdpa:.4f} ms",
                ms=kernel, plain_ms=plain, library_ms=lib_gather + lib_sdpa,
                bound_ms=bound, bound_by=by, max_abs_err=err)


def time_int8(dev, gen, m, dt=torch.bfloat16):
    """One layer's four GPT-2 125M matrices at ``m`` rows (16: a decode
    step of phase 6's slot batch, the small-m kernel; 256: a prefill
    chunk, the tiled kernel), bf16 (or fp16) x. Library: dequantize +
    torch.matmul; also the torch.matmul with the dense weight alone."""
    from deepspeed_tpu_torch.ops.wo_int8_matmul import (
        SMALL_M, _launch, tiled_splits, wo_int8_matmul,
        wo_int8_matmul_reference)
    mats = []
    for k, n in GPT2_WEIGHTS:
        q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand(1, n, generator=gen, device=dev) * 0.01
        x = torch.randn(m, k, generator=gen, device=dev, dtype=dt)
        mats.append((x, q, scale, (q.float() * scale).to(dt)))
    kernel = gpu_ms(lambda: [wo_int8_matmul(x, q, s) for x, q, s, _ in mats])
    unsplit = (None if m <= SMALL_M else gpu_ms(
        lambda: [_launch(x, q, s, dt, splits=1) for x, q, s, _ in mats]))
    plain = gpu_ms(lambda: [wo_int8_matmul_reference(x, q, s)
                            for x, q, s, _ in mats], iters=10)
    library = gpu_ms(lambda: [x @ (q.float() * s).to(dt)
                              for x, q, s, _ in mats])
    dense = gpu_ms(lambda: [x @ w for x, _, _, w in mats])
    nbytes = sum(k * n + 4 * n + 2 * m * k + 2 * m * n
                 for k, n in GPT2_WEIGHTS)
    flops = sum(2 * m * k * n for k, n in GPT2_WEIGHTS)
    bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    err = max((wo_int8_matmul(x, q, s).float()
               - wo_int8_matmul_reference(x, q, s).float()).abs().max().item()
              for x, q, s, _ in mats)
    split = ("" if unsplit is None else
             "; k split over " + "/".join(str(tiled_splits(m, k, n))
                                          for k, n in GPT2_WEIGHTS)
             + f" CTAs, unsplit {unsplit:.4f} ms")
    name = str(dt)[6:]
    return dict(shape=f"m={m}, one layer's four matrices "
                f"768x2304, 768x768, 768x3072, 3072x768, {name} x; library "
                f"= dequantize + matmul; dense {name} matmul {dense:.4f} ms"
                + split, ms=kernel, plain_ms=plain, library_ms=library,
                dense_matmul_ms=dense, bound_ms=bound, bound_by=by,
                max_abs_err=err,
                **({} if unsplit is None else {"ms_unsplit": unsplit}))


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
    cases: max_rel against TOL and, in bf16 and fp16, rms_rel against
    RMS_TOL.
    Every case runs; a failing case is logged, and ``close`` raises after
    the grid with the worst reading of each metric per dtype."""

    def __init__(self, what, tol=None):
        self.what, self.n, self.failed, self.worst = what, 0, 0, {}
        self.tol = {**TOL, **(tol or {})}

    def case(self, dtype, outs, refs, label, show=False, extra=0.0):
        """``outs``/``refs``: the tensors to compare; ``extra``: a further
        max_rel reading (the LSE). Returns True when the case passes."""
        max_rel = max([_rel_err(o, r) for o, r in zip(outs, refs)] + [extra])
        rms_rel = (max(_rms_err(o, r) for o, r in zip(outs, refs))
                   if dtype in RMS_TOL else 0.0)
        ok = (all(bool(torch.isfinite(o).all()) for o in outs)
              and max_rel <= self.tol[dtype]
              and rms_rel <= RMS_TOL.get(dtype, 0.0))
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
            f"{worst} (tol max_rel fp32 {self.tol[torch.float32]:.0e}, bf16 "
            f"{self.tol[torch.bfloat16]:.0e}, fp16 "
            f"{self.tol[torch.float16]:.0e}; rms_rel bf16 "
            f"{RMS_TOL[torch.bfloat16]:.0e}, fp16 "
            f"{RMS_TOL[torch.float16]:.1e})")
        if self.failed:
            raise AssertionError(f"{self.what}: {self.failed} of {self.n} "
                                 "cases disagree with the plain version")


def check_flash_dropout(dev, gen, sizes=(128, 1024)):
    """The forward on the training grid against its plain version, with
    dropout (one wrong keep bit moves an output by far more than the fp32
    tolerance) and without; logs fp32's worst reading per bias (ALiBi's
    scores reach ~1000, where the exp's argument loses bits first)."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        FWD_HEAD_DIMS, _bias_operand, flash_attention_fwd,
        flash_attention_reference)
    gate = Gate("flash+dropout")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in FWD_HEAD_DIMS:
            for s in sizes:
                for name, b, bias in _train_cases(dev, s):
                    for rate in (0.0, 0.1, 0.5):
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
                        gap = (lse - rlse).abs().max().item()
                        gate.case(dtype, [o], [ro],
                                  f"d={d:3d} s={s:4d} {name:7s} rate={rate}",
                                  show=s == 1024 and name == "causal",
                                  extra=gap if dtype == torch.float32
                                  else 0.0)
                        if dtype == torch.float32:
                            w = worst.setdefault(name, [0.0, 0.0])
                            w[0] = max(w[0], _rel_err(o, ro))
                            w[1] = max(w[1], gap)
    log("  flash+dropout float32 worst by bias, o max_rel / LSE gap: "
        + ", ".join(f"{k} {v[0]:.3e} / {v[1]:.3e}"
                    for k, v in worst.items()))
    gate.close()


def check_flash_bwd(dev, gen, sizes=(128, 1024)):
    """Both backward kernels against the plain backward: dK/dV and dQ."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        BWD_HEAD_DIMS, _bias_operand, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_fwd)
    gate = Gate("flash bwd")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in BWD_HEAD_DIMS:
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


# GPT-J-6B's attention at its context (phase 13's shape: b 1 of 13a's
# micro batch of 2, 16 heads of 256, 2048 tokens, causal)
GPTJ_ATTN = dict(b=1, h=16, s=2048, d=256)


def check_flash_bwd_d256(dev, gen, launches=20):
    """The backward's d-256 instances (bf16, fp16, fp32) at GPT-J-6B's
    attention shape (``GPTJ_ATTN``), dropout 0 and 0.1, against the plain
    backward (``Gate``), the fp32 forward (tf32 wgmma) against its plain
    version too; then ``launches`` repeated launches of each kernel at
    dropout 0.1, bit for bit (one owner per output element); then the fp32
    forward and backward at a ragged prefix (sq 1000 of sk 2048, causal)
    under a padding bias, dropout 0 and 0.1."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        Dropout, _bias_operand, bwd_operands, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_fwd,
        flash_attention_reference, launch_bwd_dkv, launch_bwd_dq)
    b, h, s, d = (GPTJ_ATTN[x] for x in "bhsd")
    gate = Gate("flash bwd d-256")
    unequal = []
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev,
                                   dtype=dtype) for _ in range(4))
        for rate in (0.0, 0.1):
            drop = Dropout(rate, 0x2468, 0x1357, h) if rate else None
            o, lse = flash_attention_fwd(q, k, v, None, causal=True,
                                         dropout=drop)
            grads = flash_attention_bwd(q, k, v, o, lse, do, None,
                                        causal=True, dropout=drop)
            refs = flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                                 causal=True, dropout=drop)
            torch.cuda.synchronize()
            gate.case(dtype, grads, refs, f"b={b} h={h} s={s} d={d} causal "
                      f"rate={rate} (dq, dk, dv)", show=True)
            if dtype == torch.float32:
                ro, rlse = flash_attention_reference(q, k, v, None,
                                                     causal=True,
                                                     dropout=drop)
                gate.case(dtype, [o], [ro], f"b={b} h={h} s={s} d={d} causal "
                          f"rate={rate} (o)", show=True,
                          extra=(lse - rlse).abs().max().item())
        ops = bwd_operands(q, k, v, o, lse, do, None)
        first = (*launch_bwd_dkv(ops, True, d ** -0.5, drop),
                 launch_bwd_dq(ops, True, d ** -0.5, drop))
        for _ in range(launches - 1):
            again = (*launch_bwd_dkv(ops, True, d ** -0.5, drop),
                     launch_bwd_dq(ops, True, d ** -0.5, drop))
            if not _same_bits(first, again):
                unequal.append(str(dtype)[6:])
                break
        del q, k, v, do, o, lse, grads, refs, ops, first
    # fp32 at a ragged prefix over a longer cache, padding bias
    sq, sk = 1000, s
    q, do = (torch.randn(2, sq, h, d, generator=gen, device=dev)
             for _ in range(2))
    k, v = (torch.randn(2, sk, h, d, generator=gen, device=dev)
            for _ in range(2))
    bias = _bias_operand(_padding_bias(2, sk, dev), q, k)
    for rate in (0.0, 0.1):
        drop = Dropout(rate, 0x2468, 0x1357, h) if rate else None
        kw = dict(causal=True, dropout=drop)
        o, lse = flash_attention_fwd(q, k, v, bias, **kw)
        ro, rlse = flash_attention_reference(q, k, v, bias, **kw)
        grads = flash_attention_bwd(q, k, v, o, lse, do, bias, **kw)
        refs = flash_attention_bwd_reference(q, k, v, o, lse, do, bias, **kw)
        torch.cuda.synchronize()
        label = f"b=2 h={h} sq={sq} sk={sk} d={d} causal padding rate={rate}"
        gate.case(torch.float32, [o], [ro], label + " (o)", show=True,
                  extra=(lse - rlse).abs().max().item())
        gate.case(torch.float32, grads, refs, label + " (dq, dk, dv)",
                  show=True)
    del q, k, v, do, o, lse, grads, refs
    gate.close()
    log(f"  flash bwd d-256: {launches} launches of dK/dV and dQ at rate "
        f"0.1 bit-equal: {'all' if not unequal else 'FAIL ' + str(unequal)}")
    if unequal:
        raise AssertionError(f"flash bwd d-256 {unequal}: repeated launches "
                             "differ")


def check_flash_train_shapes(dev, gen):
    """The bf16 forward and both backward kernels at the shapes phases 5a
    and 8a give them, grids several waves deep: GPT-2's micro batch (b 8,
    h 12, s 1024, causal) and phase 8's (b 64, h 16, s 128, padding
    bias), dropout 0.1 and 0; the fp32 forward at both shapes too, and the
    fp16 kernels at GPT-2's (phase 10a's)."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        Dropout, _bias_operand, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_fwd,
        flash_attention_reference)
    gate = Gate("flash train shapes")
    dt = torch.bfloat16
    for b, h, s, padded in ((8, 12, 1024, False), (DS_MICRO, 16, DS_SEQ,
                                                    True)):
        q, k, v, do, bias, _ = _flash_train_inputs(dev, gen, b, h, s, 64, dt,
                                                   padded)
        bias_in = _bias_operand(bias, q, k)
        for rate in (0.1, 0.0):
            drop = Dropout(rate, 0x4321, 0x8765, h) if rate else None
            kw = dict(causal=not padded, dropout=drop)
            o, lse = flash_attention_fwd(q, k, v, bias_in, **kw)
            ro, _ = flash_attention_reference(q, k, v, bias_in, **kw)
            grads = flash_attention_bwd(q, k, v, o, lse, do, bias_in, **kw)
            refs = flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                 bias_in, **kw)
            torch.cuda.synchronize()
            label = (f"b={b} h={h} s={s} {'padding' if padded else 'causal'}"
                     f" rate={rate}")
            gate.case(dt, [o], [ro], label + " (o)", show=True)
            gate.case(dt, grads, refs, label + " (dq, dk, dv)", show=True)
            q32, k32, v32 = (t.float() for t in (q, k, v))
            b32 = _bias_operand(bias, q32, k32)
            o, lse = flash_attention_fwd(q32, k32, v32, b32, **kw)
            ro, rlse = flash_attention_reference(q32, k32, v32, b32, **kw)
            torch.cuda.synchronize()
            gate.case(torch.float32, [o], [ro], label + " fp32 (o)",
                      show=True, extra=(lse - rlse).abs().max().item())
            if padded:
                continue
            q16, k16, v16, do16 = (t.half() for t in (q, k, v, do))
            o, lse = flash_attention_fwd(q16, k16, v16, None, **kw)
            ro, _ = flash_attention_reference(q16, k16, v16, None, **kw)
            grads = flash_attention_bwd(q16, k16, v16, o, lse, do16, None,
                                        **kw)
            refs = flash_attention_bwd_reference(q16, k16, v16, o, lse, do16,
                                                 None, **kw)
            torch.cuda.synchronize()
            gate.case(torch.float16, [o], [ro], label + " fp16 (o)",
                      show=True)
            gate.case(torch.float16, grads, refs,
                      label + " fp16 (dq, dk, dv)", show=True)
    gate.close()


@functools.lru_cache(maxsize=None)
def gpt2_param_shapes():
    """The parameter shapes of GPT-2 125M, in the port's GPT order."""
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS
    return [tuple(p.shape)
            for p in GPT(GPT2_PRESETS["gpt2-125m"]).parameters()]


def _opt_state(shapes, dev, gen, lamb=False, zero=(),
               grad_dtype=torch.float32):
    """A fused Adam (or LAMB) state of random tensors; the tensors at
    ``zero`` are 0; gradient buffers of ``grad_dtype``."""
    from deepspeed_tpu_torch.ops.fused_adam import FusedAdamState
    from deepspeed_tpu_torch.ops.fused_lamb import FusedLambState
    params = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    for i in zero:
        params[i].zero_()
    grads = [torch.randn(s, generator=gen, device=dev).to(grad_dtype)
             for s in shapes]
    return (FusedLambState if lamb else FusedAdamState)(params, grads)


def _clone_state(st):
    return type(st)([p.clone() for p in st.params],
                    [g.clone() for g in st.grads])


def check_fused_adam(dev, gen):
    """The multi-tensor kernel against the plain update, 3 steps, both
    sides of the clip threshold; its fp32- and bf16-gradient instances."""
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam
    from deepspeed_tpu_torch.runtime.optimizers import Adam
    opt = Adam(lambda t: 6e-4 * min(1.0, t / 3), 0.9, 0.95, 1e-8, 0.1)
    tol = ADAM_TOL
    for label, shapes, gdt in (
            ("sizes 1,127,128,4097,768x3072",
             [(1,), (127,), (128,), (4097,), (768, 3072)], torch.float32),
            ("GPT-2 125M parameter list", gpt2_param_shapes(),
             torch.float32),
            ("sizes 1,127,128,4097,768x3072, bf16 gradients",
             [(1,), (127,), (128,), (4097,), (768, 3072)], torch.bfloat16),
            ("GPT-2 125M parameter list, bf16 gradients",
             gpt2_param_shapes(), torch.bfloat16)):
        st = _opt_state(shapes, dev, gen, grad_dtype=gdt)
        ref = _clone_state(st)
        errs = []
        for step, norm in zip((1, 2, 3), (0.5, 2.0, 5.0)):
            gnorm = torch.tensor(norm, device=dev)
            sc = opt.scalars(step)
            fused_adam(st, sc, gnorm, 1.0)
            _plain_step(ref, sc, gnorm)
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


# the flash kernels' products; the fp32 forward's design also names where
# K and V are split into their tf32 halves
FLASH_IMPL = {torch.bfloat16: "tensor-core bf16 (mma.sync)",
              torch.float16: "tensor-core fp16 (mma.sync)",
              torch.float32: "3xTF32 tensor cores (mma.sync)"}
FLASH_FWD_FP32_IMPL = ("3xTF32 tensor cores (mma.sync), K and V split once "
                       "a CTA, exp as ex2 of (x - m) log2 e")


def flash_impl(dtype, d, forward):
    """The products of the flash kernel for ``dtype`` at head dim ``d``:
    the instances at d 256 run on wgmma warpgroups."""
    if dtype == torch.float32 and d == 256:
        return ("3xTF32 tensor cores (tf32 wgmma warpgroups, a loading "
                "warpgroup staging split swizzled tiles; flash_tf32.cuh)")
    if dtype == torch.float32:
        return FLASH_FWD_FP32_IMPL if forward else FLASH_IMPL[dtype]
    if d == 256:
        return (f"tensor-core {FLASH_IMPL[dtype].split()[1]} (wgmma "
                "warpgroups, cp.async ring of swizzled tiles)")
    return FLASH_IMPL[dtype]


def _flash_train_inputs(dev, gen, b, h, s, d, dtype, padded):
    """q, k, v, dO and the bias of a training-shape flash call: phase 8's
    padding bias from ``mlm_batch`` (rows of 96-128 tokens) when
    ``padded``, else None (causal)."""
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev,
                               dtype=dtype) for _ in range(4))
    if not padded:
        return q, k, v, do, None, b * h * s * (s + 1) // 2
    from deepspeed_tpu_torch.ops._common import NEG_INF
    mask = torch.from_numpy(mlm_batch(b, s, 30522, SEED + 11)[
        "attention_mask"]).to(dev).bool()
    bias = torch.where(mask, 0.0, NEG_INF)[:, None, None, :]
    return q, k, v, do, bias, h * s * int(mask.sum())


def time_flash_train(dev, gen, b=8, h=12, s=1024, d=64, rate=0.1,
                     dtype=torch.bfloat16, padded=False):
    """The flash forward and both backward kernels at a training shape:
    GPT-2 (micro batch 8, 12 heads, 1024 tokens, causal) by default;
    ``padded``: phase 8's BERT-large shape (64 x 128 tokens, 16 heads, not
    causal, padding bias). Each kernel's time at ``rate`` and at rate 0
    (``ms_rate0``), the plain version's, one PyTorch call's (SDPA forward;
    its whole backward) and the bound of the visible (q, k) pairs."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import (
        Dropout, _bias_operand, bwd_operands, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_reference, launch_bwd_dkv,
        launch_bwd_dq)
    causal = not padded
    scale = 1.0 / d ** 0.5
    q, k, v, do, bias, visible = _flash_train_inputs(dev, gen, b, h, s, d,
                                                     dtype, padded)
    bias_in = _bias_operand(bias, q, k)
    times, plain, lib, errs = {}, {}, {}, {}
    for r in dict.fromkeys((rate, 0.0)):
        drop = Dropout(r, 0x1234, 0x5678, h) if r else None
        fwd = (lambda drop=drop: flash_attention_fwd(
            q, k, v, bias_in, causal=causal, dropout=drop))
        o, lse = fwd()
        ops = bwd_operands(q, k, v, o, lse, do, bias_in)
        dkv = lambda drop=drop, ops=ops: launch_bwd_dkv(ops, causal, scale,
                                                        drop)
        dq = lambda drop=drop, ops=ops: launch_bwd_dq(ops, causal, scale,
                                                      drop)
        times[r] = {name: gpu_ms(fn, iters=20) for name, fn in (
            ("flash_attention", fwd), ("flash_attention_bwd_dkv", dkv),
            ("flash_attention_bwd_dq", dq))}
        if r != rate:
            continue
        plain["fwd"] = gpu_ms(lambda: flash_attention_reference(
            q, k, v, bias_in, causal=causal, dropout=drop), iters=5)
        plain["bwd"] = gpu_ms(lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, bias_in, causal=causal, dropout=drop),
            iters=5)
        ro, _ = flash_attention_reference(q, k, v, bias_in, causal=causal,
                                          dropout=drop)
        rdq, rdk, rdv = flash_attention_bwd_reference(
            q, k, v, o, lse, do, bias_in, causal=causal, dropout=drop)
        gk, gv = dkv()
        errs["flash_attention"] = (fwd()[0].float() - ro.float()).abs(
            ).max().item()
        errs["flash_attention_bwd_dkv"] = max(
            (gk.float() - rdk.float()).abs().max().item(),
            (gv.float() - rdv.float()).abs().max().item())
        errs["flash_attention_bwd_dq"] = (dq().float() - rdq.float()).abs(
            ).max().item()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    mask = None if bias is None else bias.to(dtype)
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal, dropout_p=rate)
    lib["fwd"] = gpu_ms(sdpa)
    lo = sdpa()
    dot = do.transpose(1, 2)
    lib["bwd"] = gpu_ms(lambda: torch.autograd.grad(
        lo, (qt, kt, vt), dot, retain_graph=True))
    elem = q.element_size()
    act = b * s * h * d * elem                    # one [b, s, h, d] tensor
    rows = b * h * s * 4                          # one fp32 per row
    nbias = 0 if bias is None else bias.numel() * 4
    # fp32: 3xTF32 products, three TF32 products for each fp32 one (the
    # FMA bound beside it)
    peak = (PEAK_BF16_FLOPS if dtype in (torch.bfloat16, torch.float16)
            else PEAK_TF32_FLOPS / 3)
    out = {}
    for name, products, nbytes, pl, lb in (
            # QK^T, PV; reads q k v (bias), writes o lse
            ("flash_attention", 2, 4 * act + rows + nbias, plain["fwd"],
             lib["fwd"]),
            # S, dP, dV, dK; reads q k v dO lse delta (bias), writes dk dv
            ("flash_attention_bwd_dkv", 4, 6 * act + 2 * rows + nbias,
             plain["bwd"], lib["bwd"]),
            # S, dP, dQ; reads q k v dO lse delta (bias), writes dq
            ("flash_attention_bwd_dq", 3, 5 * act + 2 * rows + nbias,
             plain["bwd"], lib["bwd"])):
        flops = 2 * products * visible * d
        bound, by = bound_ms(flops, nbytes, peak)
        fma = ""
        if dtype == torch.float32:
            fma = (f"; bound at 3xTF32 (165 TFLOP/s), on FMAs (67) "
                   f"{bound_ms(flops, nbytes, PEAK_FP32_FLOPS)[0]:.4f} ms")
        out[name] = dict(
            shape=(f"b={b} h={h} sq=sk={s} d={d} {str(dtype)[6:]} "
                   + ("padding bias" if padded else "causal")
                   + f" dropout={rate}" + fma),
            impl=flash_impl(dtype, d, name == "flash_attention"),
            ms=times[rate][name],
            ms_rate0=times[0.0][name], plain_ms=pl, library_ms=lb,
            bound_ms=bound, bound_by=by, max_abs_err=errs[name])
    return out


def time_fused_adam(dev, gen, grad_dtype=torch.float32):
    """One step over the 124M GPT-2 parameters: the kernel, the plain
    per-tensor update and torch.optim.AdamW(fused=True). With bf16
    gradients the library call steps over the gradients widened to fp32
    (it takes no bf16 gradient of an fp32 parameter)."""
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam
    from deepspeed_tpu_torch.runtime.optimizers import Adam
    shapes = gpt2_param_shapes()
    st = _opt_state(shapes, dev, gen, grad_dtype=grad_dtype)
    opt = Adam(6e-4, 0.9, 0.95, 1e-8, 0.1)
    sc = opt.scalars(1)
    gnorm = torch.tensor(2.0, device=dev)
    kernel = gpu_ms(lambda: fused_adam(st, sc, gnorm, 1.0), iters=20)
    plain_state = _opt_state(shapes, dev, gen, grad_dtype=grad_dtype)
    plain = gpu_ms(lambda: _plain_step(plain_state, sc, gnorm),
                   iters=5)
    del plain_state
    lib_params = [torch.nn.Parameter(p.clone()) for p in st.params]
    for p, g in zip(lib_params, st.grads):
        p.grad = g.float()
    lib_opt = torch.optim.AdamW(lib_params, lr=6e-4, betas=(0.9, 0.95),
                                eps=1e-8, weight_decay=0.1, fused=True)
    library = gpu_ms(lib_opt.step, iters=20)
    del lib_opt, lib_params
    n = sum(p.numel() for p in st.params)
    # p, m, v read and written, g read once
    gbytes = torch.empty((), dtype=grad_dtype).element_size()
    bound, by = bound_ms(0, (24 + gbytes) * n, PEAK_BF16_FLOPS)
    check = _opt_state(shapes[-3:], dev, gen, grad_dtype=grad_dtype)
    ref = _clone_state(check)
    fused_adam(check, sc, gnorm, 1.0)
    _plain_step(ref, sc, gnorm)
    err = max((a - b).abs().max().item()
              for a, b in zip(check.params, ref.params))
    shape = f"{len(shapes)} tensors, {n} fp32 params"
    if grad_dtype == torch.bfloat16:
        shape += (", bf16 gradients; library: AdamW(fused) over the "
                  "gradients widened to fp32")
    return dict(shape=shape, ms=kernel, plain_ms=plain, library_ms=library,
                bound_ms=bound, bound_by=by, max_abs_err=err)


def _plain_step(state, sc, gnorm):
    """The plain Adam or LAMB version over every tensor of ``state``, on
    the card, clipping at 1.0."""
    from deepspeed_tpu_torch.ops.fused_adam import (FusedAdamState,
                                                    fused_adam_reference)
    from deepspeed_tpu_torch.ops.fused_lamb import fused_lamb_reference
    ref = (fused_adam_reference if isinstance(state, FusedAdamState)
           else fused_lamb_reference)
    for p, g, m, v in zip(state.params, state.grads, state.exp_avg,
                          state.exp_avg_sq):
        ref(p, g, m, v, sc, gnorm, 1.0)


def time_flash(dev, gen, sq=512, d=64, h=12, dt=torch.bfloat16):
    """The serving prefill shape: one request, ``h`` heads (GPT-2's 12;
    GPT-J's 16 at d 256), a causal bucket."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    b = 1
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
    bound, by = bound_ms(flops, nbytes, PEAK_TF32_FLOPS / 3
                         if dt == torch.float32 else PEAK_BF16_FLOPS)
    err = (flash_attention(q, k, v, causal=True).float()
           - flash_attention_reference(q, k, v, causal=True)[0].float()
           ).abs().max().item()
    return dict(shape=f"b={b} h={h} sq=sk={sq} d={d} {str(dt)[6:]} causal",
                impl=flash_impl(dt, d, True), ms=kernel, plain_ms=plain,
                library_ms=library, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def time_decode(dev, gen, d=64, H=12, dt=torch.bfloat16):
    """The serving decode shape: 8 slots, ``H`` heads, capacity 1024, slot
    lengths drawn like the served traffic (prompt + part of the output)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    B, S = 8, 1024
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
    nbytes = (2 * total * H * d + 2 * B * H * d) * q.element_size() + B * 4
    bound, by = bound_ms(flops, nbytes, PEAK_FP32_FLOPS
                         if dt == torch.float32 else PEAK_BF16_FLOPS)
    err = (decode_attention(q, k, v, lengths)[:, 0].float()
           - decode_attention_reference(q[:, 0], k, v, lengths).float()
           ).abs().max().item()
    return dict(shape=f"B={B} H={H} S={S} d={d} {str(dt)[6:]} "
                f"sum(lengths)={total}",
                ms=kernel, plain_ms=plain, library_ms=library,
                bound_ms=bound, bound_by=by, max_abs_err=err)


def time_long_rows(dev, gen, B=2, H=12, d=64, capacity=8192):
    """Both kernels at long rows (logged, no gate): B rows of ~8000 keys,
    bf16, a contiguous cache of ``capacity`` and a pool of 128-token
    pages of the same capacity."""
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention
    dt = torch.bfloat16
    lengths = [capacity - 192 - 61 * i for i in range(B)]
    q = torch.randn(B, 1, H, d, generator=gen, device=dev, dtype=dt)
    k, v = (torch.randn(B, H, capacity, d, generator=gen, device=dev,
                        dtype=dt) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    qp, kn, vn, kp, vp, _, _, table, plens = _paged_case(
        dev, gen, dt, False, 128, d, lengths, B=B, capacity=capacity,
        poison=False)
    total = sum(lengths)
    decode_bound, _ = bound_ms(4 * total * H * d,
                               (2 * total * H * d + 2 * B * H * d) * 2,
                               PEAK_BF16_FLOPS)
    paged_bound, _ = bound_ms(4 * (total + B) * H * d,
                              (2 * (total + B) * H * d + 2 * B * H * d) * 2,
                              PEAK_BF16_FLOPS)
    return dict(
        shape=f"B={B} H={H} d={d} bf16 lengths={lengths}",
        decode_ms=gpu_ms(lambda: decode_attention(q, k, v, lens)),
        decode_bound_ms=decode_bound,
        paged_ms=gpu_ms(lambda: paged_attention(qp, kp, vp, table, plens,
                                                kn, vn)),
        paged_bound_ms=paged_bound)


def decode_timing(card):
    """The decode and paged kernels at phase 3's shapes and at long rows,
    with no gate, on the package this process imported (``--decode-timing
    DIR`` imports DIR's): run on two checkouts in turns, it compares a
    change with its parent on one card. One JSON line holds the times."""
    import deepspeed_tpu_torch
    log(f"decode timing of {os.path.dirname(deepspeed_tpu_torch.__file__)}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"decode": time_decode(dev, gen)["ms"],
           "paged": time_paged(dev, gen, quant=False)["ms"],
           "paged_int8": time_paged(dev, gen, quant=True)["ms"]}
    longs = time_long_rows(dev, gen)
    out["decode long rows"] = longs["decode_ms"]
    out["paged long rows"] = longs["paged_ms"]
    log("  " + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
        + f" [{card}]")
    print(json.dumps({"decode_timing": out}), flush=True)


SWEEP_CHUNKS = (64, 128, 256)


def time_variants(card, variants):
    """``--decode-timing`` on copies of this checkout's package, one a
    variant: ``variants`` maps a label to its edits ``(path under the
    package, old, new)``, made as ``sed`` would (each ``old`` must occur).
    One JSON line holds each variant's times (no gate)."""
    import shutil
    import tempfile
    times = {}
    for label, edits in variants.items():
        with tempfile.TemporaryDirectory() as tmp:
            pkg = os.path.join(tmp, "deepspeed_tpu_torch")
            shutil.copytree(os.path.join(REPO, "deepspeed_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("__pycache__"))
            for rel, old, new in edits:
                path = os.path.join(pkg, rel)
                with open(path) as f:
                    text = f.read()
                if old not in text:
                    raise AssertionError(f"{label}: {old!r} not in {rel}")
                with open(path, "w") as f:
                    f.write(text.replace(old, new))
            res = subprocess.run(
                [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                 "--decode-timing", tmp], capture_output=True, text=True,
                timeout=600)
            lines = [ln for ln in res.stdout.splitlines()
                     if ln.startswith('{"decode_timing"')]
            if res.returncode != 0 or not lines:
                raise AssertionError(f"{label}: --decode-timing failed:\n"
                                     f"{res.stdout[-2000:]}"
                                     f"{res.stderr[-2000:]}")
            times[label] = json.loads(lines[0])["decode_timing"]
            log(f"  {label}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in times[label].items())
                + f" [{card}]")
    print(json.dumps({"variant_timing": times}), flush=True)
    return times


def chunk_sweep(card):
    """``time_variants`` over the chunk widths of ``SWEEP_CHUNKS``
    (``DS_SPLIT_CHUNK`` in ``decode_split.cuh``, ``CHUNK`` in
    ``ops/decode_split.py``)."""
    time_variants(card, {f"CHUNK {c}": (
        ("ops/csrc/decode_split.cuh", "#define DS_SPLIT_CHUNK 128",
         f"#define DS_SPLIT_CHUNK {c}"),
        ("ops/decode_split.py", "CHUNK = 128", f"CHUNK = {c}"))
        for c in SWEEP_CHUNKS})


def bigbird_64(heads=12):
    """The sparse slice's pattern: BigBird-base's blocks (64 tokens, 3
    random, a 3-block window, first and last block global)."""
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    return BigBirdSparsityConfig(num_heads=heads, block=64,
                                 num_random_blocks=3,
                                 num_sliding_window_blocks=3,
                                 num_global_blocks=1)


def sparse_configs():
    """(name, config) of the block-sparse kernel checks, 12 heads."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig,
        DenseSparsityConfig, FixedSparsityConfig)
    return [("bigbird-64", bigbird_64()),
            ("bigbird-16", BigBirdSparsityConfig(num_heads=12, block=16)),
            ("fixed-uni-16", FixedSparsityConfig(
                num_heads=12, block=16, attention="unidirectional")),
            ("longformer-16", BSLongformerSparsityConfig(num_heads=12,
                                                         block=16)),
            ("dense-64", DenseSparsityConfig(num_heads=12, block=64))]


def _without_rows(plan, every=3):
    """``plan`` with the kv lists of every ``every``-th row (of the count
    table's rows, head by head, tile by tile) cut to length 0: those q
    tiles see no live key (the forward's contract for them: O = 0,
    m = NEG_INF, l = 1). The launch order is unchanged."""
    n = plan.kv_cnt.numel()
    table = plan.kv_table.clone()
    table[:n:every] = 0
    return plan._replace(kv_table=table, kv_cnt=table[:n].view(
        plan.kv_cnt.shape))


def check_block_sparse(dev, gen, sizes=(256, 4096), b=2, h=12,
                       dtypes=(torch.float32, torch.bfloat16)):
    """The three block-sparse kernels against their plain versions: every
    config of ``sparse_configs`` at each size, in each of ``dtypes``
    (fp32 and bf16; the fp16 instances in a second call), dropout off
    and 0.1, head_dim 64 (and 80, 96, 128 at the smaller size). Both
    backward versions take the kernel forward's (o, m, l). bf16 and fp16
    reach the tensor-core kernels, fp32 the 3xTF32 ones; every case
    launches the forward, dQ and dK/dV twice, and each pair must give the
    same bits. Then the
    forward alone on BigBird-64 plans with a third of the q tiles' lists
    cut to nothing (``_without_rows``): those rows must write O = 0,
    m = NEG_INF and l = 1."""
    from deepspeed_tpu_torch.ops._common import NEG_INF
    from deepspeed_tpu_torch.ops.block_sparse_attention import (
        HEAD_DIMS, block_sparse_dkv_reference, block_sparse_dq_reference,
        block_sparse_fwd_reference, launch_dkv, launch_dq, launch_fwd)
    from deepspeed_tpu_torch.ops.flash_attention import Dropout
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import \
        device_plan
    names = " and ".join(str(dt)[6:] for dt in dtypes)
    gates = {k: Gate(f"block_sparse {k} ({names})")
             for k in ("fwd", "dq", "dkv")}
    repeats = {"fwd": [0, []], "bwd": [0, []]}   # cases, labels that differ

    def repeat(which, label, first, again):
        repeats[which][0] += 1
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            repeats[which][1].append(label)

    cases = [(s, d) for s in sizes for d in (HEAD_DIMS if s == min(sizes)
                                             else (64,))]
    for s, d in cases:
        scale = 1.0 / d ** 0.5
        for name, cfg in sparse_configs():
            plan = device_plan(cfg, s, dev)
            if plan is None:
                raise AssertionError(f"{name} does not tile at S={s}")
            for dtype in dtypes:
                for rate in (0.0, 0.1):
                    q, k, v, do = (torch.randn(b, s, h, d, generator=gen,
                                               device=dev, dtype=dtype)
                                   for _ in range(4))
                    drop = (Dropout(rate, 0x1234 + s, 0x9E3779B9, h)
                            if rate else None)
                    o, m, l = launch_fwd(q, k, v, plan, scale, drop)
                    ro, rm, rl = block_sparse_fwd_reference(q, k, v, plan,
                                                            scale, drop)
                    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
                    dq = launch_dq(q, k, v, do, delta, m, l, plan, scale, drop)
                    dk, dv = launch_dkv(q, k, v, do, delta, m, l, plan, scale,
                                        drop)
                    rdq = block_sparse_dq_reference(q, k, v, do, delta, m, l,
                                                    plan, scale, drop)
                    rdk, rdv = block_sparse_dkv_reference(
                        q, k, v, do, delta, m, l, plan, scale, drop)
                    label = (f"S={s:4d} d={d:3d} {name:13s} rate={rate} "
                             f"({plan.plan.active_tiles} tiles, "
                             f"{len(plan.plan.masks)} masks)")
                    repeat("fwd", f"{str(dtype)[6:]} {label}", (o, m, l),
                           launch_fwd(q, k, v, plan, scale, drop))
                    repeat("bwd", f"{str(dtype)[6:]} {label}", (dq, dk, dv),
                           (launch_dq(q, k, v, do, delta, m, l, plan, scale,
                                      drop),
                            *launch_dkv(q, k, v, do, delta, m, l, plan,
                                        scale, drop)))
                    torch.cuda.synchronize()
                    show = (s, d) == (max(sizes), 64) and \
                        name == "bigbird-64"
                    stats = (max(_rel_err(m, rm), _rel_err(l, rl))
                             if dtype == torch.float32 else 0.0)
                    gates["fwd"].case(dtype, [o], [ro], label, show, stats)
                    gates["dq"].case(dtype, [dq], [rdq], label, show)
                    gates["dkv"].case(dtype, [dk, dv], [rdk, rdv], label, show)
    s, d = min(sizes), 64
    plan = _without_rows(device_plan(bigbird_64(h), s, dev))
    empty = (plan.kv_cnt == 0)[None, :, :, None].expand(
        b, h, -1, 64).reshape(b, h, s)
    for dtype in dtypes:
        for rate in (0.0, 0.1):
            q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev,
                                   dtype=dtype) for _ in range(3))
            drop = Dropout(rate, 0x4321, 0x9E3779B9, h) if rate else None
            o, m, l = launch_fwd(q, k, v, plan, 0.125, drop)
            ro, rm, rl = block_sparse_fwd_reference(q, k, v, plan, 0.125,
                                                    drop)
            torch.cuda.synchronize()
            label = (f"S={s:4d} d={d:3d} bigbird-64 rate={rate}, "
                     f"{int(empty[0].sum()) // 64} of {h * s // 64} q tiles "
                     "with empty lists")
            stats = (max(_rel_err(m, rm), _rel_err(l, rl))
                     if dtype == torch.float32 else 0.0)
            ok = gates["fwd"].case(dtype, [o], [ro], label, True, stats)
            rows_ok = (bool((o.transpose(1, 2)[empty] == 0).all())
                       and bool((m[empty] == NEG_INF).all())
                       and bool((l[empty] == 1).all()))
            log(f"  block_sparse fwd {str(dtype)[6:]} {label}: those rows "
                f"O = 0, m = NEG_INF, l = 1: {rows_ok}")
            if not (ok and rows_ok):
                raise AssertionError("block_sparse fwd: rows with no live "
                                     "tile disagree with the contract")
    for g in gates.values():
        g.close()
    for which, what in (("fwd", f"fwd ({names})"),
                        ("bwd", f"dq, dkv ({names})")):
        n, differ = repeats[which]
        log(f"  block_sparse {what}: two launches bit-equal in "
            f"{n - len(differ)}/{n} cases")
        if differ:
            raise AssertionError(f"block_sparse {what}: two launches differ "
                                 f"in {differ}")


@functools.lru_cache(maxsize=None)
def bert_param_shapes():
    """The parameter shapes of the sparse slice's BERT-base (position
    table extended to 4096), in the port's order."""
    import dataclasses
    from deepspeed_tpu_torch.models import BERT_PRESETS, BertForPreTraining
    cfg = dataclasses.replace(BERT_PRESETS["bert-base"], max_seq_len=4096)
    return [tuple(p.shape) for p in BertForPreTraining(cfg).parameters()]


def check_fused_lamb(dev, gen):
    """The two LAMB kernels against the plain update, 3 steps, both sides
    of the clip threshold, a tensor that is all zeros, and no clipping;
    two kernel runs from the same state give the same bits."""
    from deepspeed_tpu_torch.ops import fused_lamb
    from deepspeed_tpu_torch.runtime.optimizers import Lamb
    opt = Lamb(lambda t: 2e-3 * min(1.0, t / 3), 0.9, 0.999, 1e-6, 0.01)
    for label, shapes, zero in (
            ("sizes 1,127,128,16385,768x3072 and a zero 768",
             [(1,), (127,), (128,), (16385,), (768, 3072), (768,)], (5,)),
            ("BERT-base parameter list (+ a zero tensor)",
             bert_param_shapes() + [(768,)], (len(bert_param_shapes()),))):
        for clip, gdt in ((True, torch.float32), (False, torch.float32),
                          (True, torch.bfloat16)):
            st = _opt_state(shapes, dev, gen, lamb=True, zero=zero,
                            grad_dtype=gdt)
            ref, again = _clone_state(st), _clone_state(st)
            for step, norm in zip((1, 2, 3), (0.5, 2.0, 5.0)):
                gnorm = torch.tensor(norm, device=dev) if clip else None
                sc = opt.scalars(step)
                fused_lamb(st, sc, gnorm, 1.0)
                fused_lamb(again, sc, gnorm, 1.0)
                _plain_step(ref, sc, gnorm)
            torch.cuda.synchronize()
            errs = [max(_rel_err(a, b) for a, b in zip(group, rgroup))
                    for group, rgroup in ((st.params, ref.params),
                                          (st.exp_avg, ref.exp_avg),
                                          (st.exp_avg_sq, ref.exp_avg_sq))]
            same = all(torch.equal(a, b) for a, b in zip(st.params,
                                                         again.params))
            ok = (max(errs) <= ADAM_TOL and same
                  and all(bool(torch.isfinite(p).all()) for p in st.params))
            n = sum(p.numel() for p in st.params)
            log(f"fused_lamb {label} ({len(shapes)} tensors, {n} params, "
                f"{str(gdt)[6:]} gradients, 3 steps, "
                f"{'clip 1.0 at norms 0.5/2/5' if clip else 'no clip'}"
                f"): rel_err p={errs[0]:.2e} m={errs[1]:.2e} v={errs[2]:.2e} "
                f"tol={ADAM_TOL:.0e}; two runs bit-equal {same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("fused_lamb kernels disagree with their "
                                     "plain version or between two runs")


def _natural_order(plan):
    """``plan`` with its count tables' launch order replaced by the rows'
    own order (head by head, tile by tile): the tail that the
    heaviest-first order removes shows as the difference."""
    n = plan.kv_cnt.numel()
    tables = []
    for t in (plan.kv_table, plan.qt_table):
        t = t.clone()
        t[n:2 * n] = torch.arange(n, dtype=t.dtype, device=t.device)
        tables.append(t)
    return plan._replace(kv_table=tables[0], qt_table=tables[1])


# the block-sparse kernels' designs, by (kernel, dtype)
SPARSE_IMPL = {
    ("fwd", torch.bfloat16): "tensor-core bf16 (mma.sync), count-table "
    "order, fresh accumulators per tile",
    ("fwd", torch.float32): "3xTF32 tensor cores (mma.sync), K and V split "
    "once a CTA, count-table order, fresh accumulators per tile",
    ("bwd", torch.bfloat16): "tensor-core bf16 (mma.sync)",
    ("fwd", torch.float16): "tensor-core fp16 (mma.sync), the bf16 "
    "kernel's fp16 instance",
    ("bwd", torch.float16): "tensor-core fp16 (mma.sync), the bf16 "
    "kernels' fp16 instances",
    ("bwd", torch.float32): "3xTF32 tensor cores (mma.sync), operands "
    "split at fragment load, count-table order, fresh accumulators per "
    "tile"}


def _heaviest_rows(plan):
    """``plan`` with only its longest lists (both families): the other
    rows' counts are 0. Timed alone, those rows' CTAs each have an SM to
    themselves: the time the longest rows take, against which the whole
    kernel's time shows whether they set its pace."""
    n = plan.kv_cnt.numel()
    tables = []
    for t in (plan.kv_table, plan.qt_table):
        t = t.clone()
        t[:n] = torch.where(t[:n] == t[:n].max(), t[:n], 0)
        tables.append(t)
    return plan._replace(kv_table=tables[0], qt_table=tables[1],
                         kv_cnt=tables[0][:n].view(plan.kv_cnt.shape),
                         qt_cnt=tables[1][:n].view(plan.qt_cnt.shape))


def time_block_sparse(dev, gen, b=2, h=12, s=4096, d=64, rate=0.1,
                      dtype=torch.bfloat16):
    """The three kernels in ``dtype`` at one shape of the BigBird-64
    pattern, attention dropout 0.1: phase 7a's (BERT-base heads, 4096
    tokens, micro batch 2) by default; the fp32 kernels are the parity
    mode, whose launches phase 7b counts at b 1, S 1024. Each kernel's
    time, also with the rows in their own order (``ms_natural_order``),
    the plain version's, the longest rows' alone (``ms_heaviest_rows``,
    ``_heaviest_rows``), one PyTorch call's (SDPA with the layout's dense
    mask, forward and whole backward, in ``dtype``) and the bound of the
    layout's live (q, k) pairs: bf16 at the tensor cores' rate, fp32 at
    3xTF32's (the FMA bound beside it)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.block_sparse_attention import (
        block_sparse_dkv_reference, block_sparse_dq_reference,
        block_sparse_fwd_reference, launch_dkv, launch_dq, launch_fwd)
    from deepspeed_tpu_torch.ops.flash_attention import Dropout
    from deepspeed_tpu_torch.ops.sparse_attention import layout_to_dense_mask
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import \
        device_plan
    scale = 1.0 / d ** 0.5
    cfg = bigbird_64(h)
    plan = device_plan(cfg, s, dev)
    natural, heaviest = _natural_order(plan), _heaviest_rows(plan)
    drop = Dropout(rate, 0x1234, 0x5678, h)
    mask = layout_to_dense_mask(cfg, s, dev)
    pairs = b * plan.plan.live_pairs
    rows = b * h * s * 4                         # one fp32 per row
    # the lists as the kernels read them: the live (index, pattern id)
    # entries of each row (not the padding), the counts, the fine masks
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    kv_lists = 8 * int(plan.plan.kv_cnt.sum()) + nb(plan.kv_cnt, plan.masks)
    qt_lists = 8 * int(plan.plan.qt_cnt.sum()) + nb(plan.qt_cnt, plan.masks)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev,
                               dtype=dtype) for _ in range(4))
    o, m, l = launch_fwd(q, k, v, plan, scale, drop)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, delta, m, l)
    runs = {"block_sparse_attention_fwd": (
                lambda p=plan: launch_fwd(q, k, v, p, scale, drop),
                lambda: block_sparse_fwd_reference(q, k, v, plan, scale,
                                                   drop)),
            "block_sparse_attention_dq": (
                lambda p=plan: launch_dq(*bwd, p, scale, drop),
                lambda: block_sparse_dq_reference(*bwd, plan, scale, drop)),
            "block_sparse_attention_dkv": (
                lambda p=plan: launch_dkv(*bwd, p, scale, drop),
                lambda: block_sparse_dkv_reference(*bwd, plan, scale, drop))}
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_fwd = gpu_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, dropout_p=rate), iters=10)
    lo = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                        dropout_p=rate)
    dot = do.transpose(1, 2)
    lib_bwd = gpu_ms(lambda: torch.autograd.grad(
        lo, (qt, kt, vt), dot, retain_graph=True), iters=10)
    del lo
    x = b * s * h * d * q.element_size()         # one [b, s, h, d] tensor
    out = {}
    for name, products, nbytes, lib in (
            # Q K^T, P V; reads q k v and the plan, writes o m l
            ("block_sparse_attention_fwd", 2,
             4 * x + 2 * rows + kv_lists, lib_fwd),
            # S, dP, dQ; reads q k v dO delta m l and the lists, writes dq
            ("block_sparse_attention_dq", 3, 5 * x + 3 * rows + kv_lists,
             lib_bwd),
            # S, dP, dV, dK; reads q k v dO delta m l and the transposed
            # lists, writes dk dv
            ("block_sparse_attention_dkv", 4,
             6 * x + 3 * rows + qt_lists, lib_bwd)):
        kernel, plain = runs[name]
        fwd = name.endswith("fwd")
        flops = 2 * products * pairs * d
        peak = (PEAK_BF16_FLOPS if dtype in (torch.bfloat16, torch.float16)
                else PEAK_TF32_FLOPS / 3)
        bound, by = bound_ms(flops, nbytes, peak)
        fma = ""
        if dtype == torch.float32:
            fma = (f"; bound at 3xTF32 (165 TFLOP/s), on FMAs (67) "
                   f"{bound_ms(flops, nbytes, PEAK_FP32_FLOPS)[0]:.4f} ms")
        got, ref = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max((a.float() - r.float()).abs().max().item()
                  for a, r in zip(got, ref) if a.dtype == dtype)
        out[name] = dict(
            shape=f"b={b} h={h} S={s} d={d} {str(dtype)[6:]} BigBird-64 "
            f"(live pairs {pairs}, "
            f"{100 * plan.plan.live_pairs / (h * s * s):.1f}% of S^2) "
            f"dropout={rate}; library = SDPA with the dense layout mask"
            f"{'' if fwd else ' (whole backward)'}{fma}",
            impl=SPARSE_IMPL["fwd" if fwd else "bwd", dtype],
            ms=gpu_ms(kernel, iters=10),
            ms_natural_order=gpu_ms(lambda: kernel(natural), iters=10),
            ms_heaviest_rows=gpu_ms(lambda: kernel(heaviest), iters=10),
            plain_ms=gpu_ms(plain, iters=2), library_ms=lib,
            bound_ms=bound, bound_by=by, max_abs_err=err)
    del q, k, v, do, o, qt, kt, vt
    torch.cuda.empty_cache()
    return out


# phase 15a's activation: BERT-base's micro batch at 4096 tokens
DROPOUT_SHAPE = (2, 4096, 768)
DROPOUT_SHAPES = (DROPOUT_SHAPE, (3, 5, 7), (2, 128, 1024))


def _dropout_input(shape, dtype, dev, gen, offset=0):
    """A [b, s, d] tensor whose first element sits ``offset`` elements
    into its storage (1: a base that no 16-byte vector load may take)."""
    n = int(np.prod(shape))
    buf = torch.randn(n + offset, generator=gen, device=dev).to(dtype)
    return buf[offset:].view(shape)


def check_dropout(dev, gen):
    """The dropout kernel against its plain version, bit for bit: fp32,
    bf16 and fp16, rates 0.1 and 0.5, at phase 15a's activation, an odd
    shape (the one-element path) and a misaligned base (likewise), as a
    forward and as a backward launch (the same map)."""
    from deepspeed_tpu_torch.ops import dropout
    n, differ = 0, []
    for shape in DROPOUT_SHAPES:
        for offset in ((0, 1) if shape == DROPOUT_SHAPES[-1] else (0,)):
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                for rate in (0.1, 0.5):
                    x = _dropout_input(shape, dtype, dev, gen, offset)
                    words = (0x51ED + n, 0x9E3779B9 ^ n)
                    ref = dropout.dropout_reference(x, words, rate)
                    for backward in (False, True):
                        got = dropout._launch(x, words, rate, backward)
                        n += 1
                        if not torch.equal(_bits(got), _bits(ref)):
                            differ.append(f"{shape} +{offset} "
                                          f"{str(dtype)[6:]} rate {rate}")
    torch.cuda.synchronize()
    log(f"  dropout: kernel bit-equal to its plain version in "
        f"{n - len(differ)}/{n} launches (fp32, bf16, fp16; rates 0.1 and "
        f"0.5; {DROPOUT_SHAPES}, a misaligned base; forward and backward)")
    if differ:
        raise AssertionError(f"dropout: the kernel differs from its plain "
                             f"version in {differ}")


def time_dropout(dev, gen):
    """One site's dropout kernel at phase 15a's activation (fp16): its
    time, the plain version's and the bound of reading and writing each
    element once. No PyTorch call computes this function (F.dropout
    draws Philox bits, not the counter hash), so library_ms is null."""
    from deepspeed_tpu_torch.ops import dropout
    shape, dtype, rate = DROPOUT_SHAPE, torch.float16, PUBLISHED_DROPOUT
    x = _dropout_input(shape, dtype, dev, gen)
    words = (0x1234, 0x5678)
    got = dropout._launch(x, words, rate, False)
    ref = dropout.dropout_reference(x, words, rate)
    err = (got.float() - ref.float()).abs().max().item()
    bound, by = bound_ms(0, 2 * x.numel() * x.element_size(), PEAK_BF16_FLOPS)
    return dict(
        shape=f"{list(shape)} {str(dtype)[6:]} rate {rate} (phase 15a: one "
        f"site of BERT-base at 4096 tokens, micro 2); library: none, no "
        f"PyTorch call draws the counter hash",
        ms=gpu_ms(lambda: dropout._launch(x, words, rate, False)),
        plain_ms=gpu_ms(lambda: dropout.dropout_reference(x, words, rate),
                        iters=5),
        library_ms=None, bound_ms=bound, bound_by=by, max_abs_err=err)


def time_fused_lamb(dev, gen, grad_dtype=torch.float32):
    """One step over the sparse slice's BERT-base parameters: both kernels
    (one launch each), and the plain per-tensor update. No PyTorch call
    computes LAMB: no library time."""
    from deepspeed_tpu_torch.ops import fused_lamb
    from deepspeed_tpu_torch.runtime.optimizers import Lamb
    shapes = bert_param_shapes()
    st = _opt_state(shapes, dev, gen, lamb=True, grad_dtype=grad_dtype)
    sc = Lamb(2e-3, 0.9, 0.999, 1e-6, 0.01).scalars(1)
    gnorm = torch.tensor(2.0, device=dev)
    kernel = gpu_ms(lambda: fused_lamb(st, sc, gnorm, 1.0), iters=20)
    plain_state = _opt_state(shapes, dev, gen, lamb=True,
                             grad_dtype=grad_dtype)
    plain = gpu_ms(lambda: _plain_step(plain_state, sc, gnorm), iters=5)
    del plain_state
    n = sum(p.numel() for p in st.params)
    # p, g, m, v read once, p, m, v written once
    gbytes = torch.empty((), dtype=grad_dtype).element_size()
    bound, by = bound_ms(0, (24 + gbytes) * n, PEAK_BF16_FLOPS)
    check = _opt_state(shapes[:5], dev, gen, lamb=True,
                       grad_dtype=grad_dtype)
    ref = _clone_state(check)
    fused_lamb(check, sc, gnorm, 1.0)
    _plain_step(ref, sc, gnorm)
    err = max((a - b).abs().max().item()
              for a, b in zip(check.params, ref.params))
    return dict(shape=f"{len(shapes)} tensors, {n} fp32 params, "
                f"{str(grad_dtype)[6:]} gradients, two launches (phase 1 + "
                "apply); library: none, no PyTorch call computes LAMB",
                ms=kernel, plain_ms=plain, library_ms=None,
                bound_ms=bound, bound_by=by, max_abs_err=err)


LN_TOL = 1e-5        # fp32 LayerNorm kernels against their plain versions
LN_ROWS = (1, 255, 8192, 8193)
# 1024 and 1032: the two sides of the warp-per-row kernels' limit
# (layernorm.cu WARP_ROW_MAX_D); 1023: no whole 16-byte vectors (the
# CTA-per-row ones)
LN_WIDTHS = (768, 1023, 1024, 1032, 4096, 8192)


def _ln_case(dev, gen, n, d, dtype, offset, constant=False):
    x = (torch.randn(n, d, generator=gen, device=dev) + offset).to(dtype)
    if constant:
        x.fill_(3.0)                       # variance 0: rstd = 1/sqrt(eps)
    gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    beta = 0.1 * torch.randn(d, generator=gen, device=dev)
    dy = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    return x, gamma, beta, dy


def check_layernorm(dev, gen, rows=LN_ROWS, widths=LN_WIDTHS):
    """The LayerNorm forward and backward kernels against their plain
    versions: rows 1, 255, 8192 and 8193 (the backward's CTAs own 1 to 32
    rows, a warp 0 to 8), widths 768-8192 through both the warp-per-row
    and the CTA-per-row kernels, fp32 (max_rel <= 1e-5) and bf16
    (``Gate``), widths 1024 and 8192 with an offset of 100 (mean/std 100:
    a one-pass variance reads ~6e-4 there, the two-pass ~2e-6), and a
    constant row."""
    from deepspeed_tpu_torch.ops.layernorm import (
        launch_bwd, launch_fwd, layer_norm_bwd_reference,
        layer_norm_fwd_reference)
    gates = {"fwd": Gate("layernorm_fwd", {torch.float32: LN_TOL}),
             "bwd": Gate("layernorm_bwd", {torch.float32: LN_TOL})}
    cases = [(n, d, 100.0 if d in (1024, 8192) else 0.0, False)
             for n in rows for d in widths] + [(4, 1024, 0.0, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, offset, constant in cases:
            x, gamma, beta, dy = _ln_case(dev, gen, n, d, dtype, offset,
                                          constant)
            eps = 1e-5 if constant else 1e-12
            y, mean, rstd = launch_fwd(x, gamma, beta, eps)
            ry, rmean, rrstd = layer_norm_fwd_reference(x, gamma, beta, eps)
            dx, dg, db = launch_bwd(dy, x, gamma, mean, rstd)
            rdx, rdg, rdb = layer_norm_bwd_reference(dy, x, gamma, rmean,
                                                     rrstd)
            torch.cuda.synchronize()
            label = (f"rows={n:5d} d={d:5d} offset={offset:5.1f}"
                     f"{' constant' if constant else ''}")
            show = n == 8192 and d == 1024
            gates["fwd"].case(dtype, [y, mean, rstd], [ry, rmean, rrstd],
                              label, show)
            gates["bwd"].case(dtype, [dx, dg, db], [rdx, rdg, rdb], label,
                              show)
    for g in gates.values():
        g.close()


def time_layernorm(dev, gen, n=DS_MICRO * DS_SEQ, d=1024):
    """Phase 8's LayerNorm shape: BERT-large rows of one microbatch (64 x
    128 tokens, d 1024), bf16 x, fp32 gamma and beta. The library call is
    torch.nn.functional.layer_norm (forward; its autograd backward for the
    backward row), which on the card takes gamma and beta in x's dtype.
    Bound: bytes, each input read and each output written once (the
    backward's partials are scratch)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.layernorm import (
        launch_bwd, launch_fwd, layer_norm_bwd_reference,
        layer_norm_fwd_reference)
    dt = torch.bfloat16
    x, gamma, beta, dy = _ln_case(dev, gen, n, d, dt, 0.0)
    eps = 1e-12
    y, mean, rstd = launch_fwd(x, gamma, beta, eps)
    ry, rmean, rrstd = layer_norm_fwd_reference(x, gamma, beta, eps)
    bwd_args = (dy, x, gamma, mean, rstd)
    got, ref = launch_bwd(*bwd_args), layer_norm_bwd_reference(*bwd_args)
    if not all(torch.equal(a, b) for a, b in zip(got, launch_bwd(*bwd_args))):
        raise AssertionError("layernorm_bwd: two launches differ in dx, "
                             "dgamma or dbeta")
    # torch's layer_norm takes gamma and beta in x's dtype on the card
    xl = x.detach().requires_grad_()
    gl, bl = (t.to(dt).requires_grad_() for t in (gamma, beta))
    lib_fwd = gpu_ms(lambda: F.layer_norm(xl, (d,), gl, bl, eps))
    yl = F.layer_norm(xl, (d,), gl, bl, eps)
    lib_bwd = gpu_ms(lambda: torch.autograd.grad(yl, (xl, gl, bl), dy,
                                                 retain_graph=True))
    elem = x.element_size()
    shape = (f"[{n}, {d}] bf16 x, fp32 gamma/beta (phase 8: BERT-large, 64 "
             f"x {DS_SEQ} tokens); library = F.layer_norm with bf16 "
             "gamma/beta")
    out = {}
    for name, kernel, plain, nbytes, lib, err in (
            ("layernorm_fwd", lambda: launch_fwd(x, gamma, beta, eps),
             lambda: layer_norm_fwd_reference(x, gamma, beta, eps),
             # x in, y out, gamma and beta in, mean and rstd out
             2 * n * d * elem + 8 * d + 8 * n, lib_fwd,
             max((a.float() - b.float()).abs().max().item()
                 for a, b in zip((y, mean, rstd), (ry, rmean, rrstd)))),
            ("layernorm_bwd", lambda: launch_bwd(*bwd_args),
             lambda: layer_norm_bwd_reference(*bwd_args),
             # dy, x in, dx out, gamma, mean, rstd in, dgamma, dbeta out
             3 * n * d * elem + 12 * d + 8 * n, lib_bwd,
             max((a.float() - b.float()).abs().max().item()
                 for a, b in zip(got, ref)))):
        bound, by = bound_ms(10 * n * d, nbytes, PEAK_FP32_FLOPS)
        out[name] = dict(
            shape=shape + (" backward (autograd.grad)"
                           if name == "layernorm_bwd" else " forward"),
            ms=gpu_ms(kernel), plain_ms=gpu_ms(plain, iters=10),
            library_ms=lib, bound_ms=bound, bound_by=by, max_abs_err=err)
    return out


QUANT_BITS = (4, 8, 12)
QUANT_GROUPS = (1, 16, 1024)


def check_quantizer(dev, gen, shape=(1024, 1024)):
    """quantize and dequantize against their plain versions, bit for bit
    (codes, scales, zero points, values): symmetric, asymmetric and
    stochastic, bits 4/8/12, groups 1/16/1024, fp32 and bf16 input, one
    all-zero group (the scale floor); fake_quantize on the card against
    the plain version on the CPU (per channel, a 1-D leaf; sym and asym);
    stochastic rounding reproducible under one seed and unbiased over 64
    seeds (mean error under 3 standard errors)."""
    from deepspeed_tpu_torch.compression.compress import fake_quantize
    from deepspeed_tpu_torch.ops.quantizer import (
        _MODES, dequantize_reference, launch_dequantize, launch_quantize,
        pallas_floor, quantize_reference)
    n_cases, bad = 0, []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=gen, device=dev) * torch.rand(
            shape[0], 1, generator=gen, device=dev) * 3
        x[7] = 0.0
        x = x.to(dtype)
        for mode in ("symmetric", "asymmetric", "stochastic"):
            for bits in QUANT_BITS:
                for groups in QUANT_GROUPS:
                    x2d = x.reshape(groups, -1)
                    kw = dict(mode=_MODES[mode], bits=bits, seed=bits,
                              scale_floor=pallas_floor(
                                  bits, mode == "asymmetric"))
                    got = launch_quantize(x2d, **kw)
                    ref = quantize_reference(x2d, **kw)
                    same = all(a is b is None or torch.equal(a, b)
                               for a, b in zip(got, ref))
                    dq = launch_dequantize(got[0], got[1], got[2], dtype)
                    rdq = dequantize_reference(ref[0], ref[1], ref[2], dtype)
                    same = same and torch.equal(dq, rdq)
                    n_cases += 1
                    if not same:
                        bad.append(f"{mode} bits={bits} groups={groups} "
                                   f"{str(dtype)[6:]}")
    for sym in (True, False):
        for w in (torch.randn(4096, 1024, generator=gen, device=dev) * 0.02,
                  torch.randn(4096, generator=gen, device=dev)):
            if w.dim() == 2:
                w[:, 3] = 0.0
            for bits in QUANT_BITS:
                n_cases += 1
                if not torch.equal(fake_quantize(w, bits, sym).cpu(),
                                   fake_quantize(w.cpu(), bits, sym)):
                    bad.append(f"fake_quantize {tuple(w.shape)} bits={bits} "
                               f"{'sym' if sym else 'asym'}")
    torch.cuda.synchronize()
    x = torch.randn(64, 4096, generator=gen, device=dev)
    sr = [launch_quantize(x, mode=_MODES["stochastic"], bits=8, seed=s,
                          scale_floor=pallas_floor(8, False))
          for s in (5, 5)]
    again = torch.equal(sr[0][0], sr[1][0])
    errs = torch.stack([
        launch_dequantize(*launch_quantize(
            x, mode=_MODES["stochastic"], bits=8, seed=s,
            scale_floor=pallas_floor(8, False))[:2], None, torch.float32) - x
        for s in range(64)])
    mean = errs.mean().item()
    stderr = errs.std().item() / errs.numel() ** 0.5
    log(f"quantizer: {n_cases - len(bad)}/{n_cases} cases bit-equal to the "
        f"plain versions (codes, scales, zero points, dequantized values; "
        f"fake_quantize card vs CPU); stochastic rounding: same seed "
        f"bit-equal {again}, mean error over 64 seeds {mean:.3e} (3 "
        f"standard errors {3 * stderr:.3e})")
    for b in bad:
        log(f"  quantizer FAIL {b}")
    if bad or not again or abs(mean) > 3 * stderr:
        raise AssertionError("the quantizer kernels disagree with their "
                             "plain versions, or stochastic rounding is "
                             "not reproducible or not unbiased")


def time_quantizer(dev, gen, shape=(4096, 1024)):
    """Phase 8's largest projected leaf, inter_w [4096, 1024] fp32, as
    fake_quantize runs it: per-column groups (1024 of 4096 elements, made
    contiguous by a transpose, timed with it), 8-bit symmetric. Library:
    none for quantize (no single PyTorch call computes absmax-scaled
    group quantization; the fake_quantize ops take their scales as
    inputs); for dequantize ``torch.mul(q, scales[:, None])``, which must
    be bit-equal to the kernel. Bound: bytes."""
    from deepspeed_tpu_torch.compression.compress import (FAKE_QUANT_FLOOR,
                                                          fake_quantize)
    from deepspeed_tpu_torch.ops.quantizer import (
        _MODES, dequantize_reference, launch_dequantize, launch_quantize,
        quantize_reference)
    w = torch.randn(shape, generator=gen, device=dev) * 0.02
    groups = shape[1]
    xt = w.t().contiguous()
    kw = dict(mode=_MODES["symmetric"], bits=8, scale_floor=FAKE_QUANT_FLOOR)
    q, s, _ = launch_quantize(xt, **kw)
    rq, rs_, _ = quantize_reference(xt, **kw)
    dq = launch_dequantize(q, s, None, torch.float32)
    library_dq = lambda: torch.mul(q, s[:, None])
    if not torch.equal(library_dq(), dq):
        raise AssertionError("torch.mul(q, scales[:, None]) differs from "
                             "the dequantize kernel")
    n = w.numel()
    fq_ms = gpu_ms(lambda: fake_quantize(w, 8, True), iters=20)
    transpose_ms = gpu_ms(lambda: w.t().contiguous(), iters=20)
    common = (f"inter_w {list(shape)} fp32 as {groups} groups of "
              f"{n // groups}, 8-bit symmetric (phase 8); fake_quantize "
              f"whole {fq_ms:.4f} ms incl. the transpose to groups "
              f"({transpose_ms:.4f} ms; the engine's copy of the result "
              f"back into [out, in] is another)")
    out = {}
    for name, kernel, plain, library, lib_note, err in (
            ("quantize", lambda: launch_quantize(xt, **kw),
             lambda: quantize_reference(xt, **kw), None, "library: none",
             max(float((q.int() - rq.int()).abs().max()),
                 float((s - rs_).abs().max()))),
            ("dequantize",
             lambda: launch_dequantize(q, s, None, torch.float32),
             lambda: dequantize_reference(q, s, None, torch.float32),
             library_dq, "library = torch.mul(q, scales[:, None]), "
             "bit-equal to the kernel",
             float((dq - dequantize_reference(q, s, None, torch.float32)
                    ).abs().max()))):
        bound, by = bound_ms(2 * n, 5 * n + 4 * groups, PEAK_FP32_FLOPS)
        out[name] = dict(
            shape=f"{common}; {lib_note}", ms=gpu_ms(kernel, iters=20),
            plain_ms=gpu_ms(plain, iters=10),
            library_ms=None if library is None else gpu_ms(library,
                                                           iters=20),
            bound_ms=bound, bound_by=by, max_abs_err=err,
            fake_quantize_ms=fq_ms)
    return out


# --------------------------------------------------------------------------
# phase 4: the slice end to end
# --------------------------------------------------------------------------

SERVING_CONFIG = {"num_slots": 8, "max_len": 1024, "prefill_bucket": 128}


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
    """Top-2 logit gap and top logit at every generated position, from one
    cache-free forward over prompt + generated tokens."""
    seq = torch.tensor(np.concatenate([prompt, generated])[None],
                       device=model.wte.device)
    with torch.no_grad():
        logits = model(seq)[0, len(prompt) - 1:-1].float()
    top = logits.topk(2, dim=-1).values
    gaps = (top[:, 0] - top[:, 1]).cpu().numpy()
    return gaps, top[:, 0].cpu().numpy()


def served_deficits(model, prompts, tokens, outs):
    """For every served token: the reference's top logit less its logit
    for the served token, from one cache-free forward over prompt + served
    tokens a request (so every step shares its history with the
    reference). Greedy serving whose logits are within e of the
    reference's picks tokens whose deficit is at most 2 e."""
    out = []
    for t, p, o in zip(tokens, prompts, outs):
        got = np.asarray(t)
        if got.shape != (o,):
            raise AssertionError(f"a request served {got.shape} tokens, "
                                 f"not {o}")
        seq = torch.tensor(np.concatenate([p, got])[None],
                           device=model.wte.device)
        with torch.no_grad():
            logits = model(seq)[0, len(p) - 1:-1].float()
        picked = logits.gather(1, seq[0, len(p):, None].long()).squeeze(1)
        out.append((logits.max(-1).values - picked).cpu().numpy())
    return np.concatenate(out)


def bf16_ulp(x):
    """The bf16 spacing at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
                   - 7)


def fp16_ulp(x):
    """The fp16 spacing at |x| (11 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -14)))
                   - 10)


def phase_fp32(model_fp32, prompts, outs, config,
               label="phase 4a: fp32 serving"):
    from deepspeed_tpu_torch import init_inference
    log(f"{label}, token-exact against generate()")
    engine = init_inference(model_fp32, dtype=torch.float32)
    reqs, srv, counts, wall = serve_traffic(engine, prompts, outs, config)
    stops = 0
    for i, (req, p, o) in enumerate(zip(reqs, prompts, outs)):
        ref = engine.generate(p[None], max_new_tokens=o)[0, len(p):]
        ref = ref.cpu().numpy()
        gaps, _ = top2_gaps(engine.module, p, ref)
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
    return counts


def phase_wide_heads():
    """4d: gpt2-760m's widths (d 1536, 16 heads, head_dim 96) cut to 2
    layers, fp32, 8 requests through 4 slots: token-exact against
    ``generate()`` (near-tie rule), the flash and decode kernels launched
    at head_dim 96."""
    import dataclasses
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS
    cfg = dataclasses.replace(GPT2_PRESETS["gpt2-760m"], n_layers=2,
                              dtype=torch.float32)
    model = GPT(cfg, seed=SEED)
    prompts, outs = traffic(cfg.vocab_size, n=8, seed=SEED + 9)
    phase_fp32(model, prompts, outs,
               {"num_slots": 4, "max_len": 1024, "prefill_bucket": 128},
               label=f"phase 4d: fp32 serving at gpt2-760m widths (d "
               f"{cfg.d_model}, {cfg.n_heads} heads, head_dim "
               f"{cfg.d_model // cfg.n_heads}, {cfg.n_layers} layers)")
    del model
    torch.cuda.empty_cache()


def phase_bf16(model_bf16, prompts, outs, config, card, profile=False):
    from deepspeed_tpu_torch import init_inference
    log("phase 4b: bf16 serving (the default config), first tokens against "
        "generate()")
    engine = init_inference(model_bf16)
    reqs, srv, counts, wall = serve_traffic(engine, prompts, outs, config)
    check_against_generate(engine, reqs, prompts, outs, GAP_STOP, "4b bf16",
                           first_token_only=True)
    tokens = srv.metrics.tokens_generated
    log(f"  serving: {tokens} tokens, {srv.metrics.decode_iterations} decode "
        f"iterations, wall {wall:.3f} s, {tokens / wall:.1f} tokens/s "
        f"[{card}]")

    runs, mean_len = row_runners(srv, engine.module, config, prompts)
    walls = {name: wall_ms(fn, iters=20 if name == "decode" else 10)
             for name, fn in runs.items()}
    log("  prefill wall ms per bucket (one request): " + ", ".join(
        f"{name.split()[1]}: {ms:.3f}" for name, ms in walls.items()
        if name != "decode") + f" [{card}]")
    log(f"  decode wall ms per iteration (8 slots, mean slot length "
        f"{mean_len:.0f}): {walls['decode']:.3f} [{card}]")
    if profile:
        for name, fn in runs.items():
            device_profile(name, fn, walls[name], card)
    return counts


def row_runners(srv, model, config, prompts):
    """Closures over the contiguous server ``srv``: one prefill of each
    bucket that ``prompts`` reach (``"prefill <bucket>"``) and one decode
    iteration over every slot at seeded lengths (``"decode"``); returns
    them with the mean slot length."""
    from deepspeed_tpu_torch.inference.cache import make_row_cache
    from deepspeed_tpu_torch.serving.engine import _decode_iter_impl
    dev, runs = srv.device, {}
    for bucket in sorted({config["prefill_bucket"]
                          * -(-len(p) // config["prefill_bucket"])
                          for p in prompts}):
        ids = torch.randint(0, model.config.vocab_size, (1, bucket),
                            device=dev)
        pos = torch.arange(bucket, device=dev)

        def run_prefill(ids=ids, pos=pos):
            model(ids, positions=pos, cache=make_row_cache(srv._cache))
        runs[f"prefill {bucket}"] = run_prefill

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
    return runs, state["lengths"].float().mean().item()


def serving_timing(card, blocks=10):
    """Phases 4b's and 6b's serving tokens/s, prefill and decode wall ms,
    with no gate, on the package this process imported
    (``--serving-timing DIR`` imports DIR's): run on two checkouts in
    turns, it compares a change with its parent on one card. Each prefill
    and decode time is the median of ``blocks`` ``wall_ms`` runs; one JSON
    line holds them."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS
    log(f"serving timing of {os.path.dirname(deepspeed_tpu_torch.__file__)}")
    model = GPT(GPT2_PRESETS["gpt2-125m"], seed=SEED)
    vocab = model.config.vocab_size
    prompts, outs = traffic(vocab)
    engine = init_inference(model)
    _, srv, _, wall = serve_traffic(engine, prompts, outs, SERVING_CONFIG)
    out = {"4b tokens/s": srv.metrics.tokens_generated / wall}
    runs, _ = row_runners(srv, engine.module, SERVING_CONFIG, prompts)
    for name, fn in runs.items():
        out[f"4b {name} ms"] = float(np.median(
            [wall_ms(fn, 20 if name == "decode" else 10)
             for _ in range(blocks)]))
    engine = init_inference(model)
    _, srv, _, wall = serve_paged(engine, *paged_traffic(vocab),
                                  PAGED_CONFIG)
    out["6b tokens/s"] = srv.metrics.tokens_generated / wall
    fn = _paged_decode_runner(srv, engine.module, served_lengths(16, SEED + 7))
    out["6b decode ms"] = float(np.median([wall_ms(fn, 20)
                                           for _ in range(blocks)]))
    log("  " + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
        + f" [{card}]")
    print(json.dumps({"serving_timing": out}), flush=True)


def serving_ab(card, parent_dir, blocks=100):
    """Phases 4b's and 6b's decode wall ms in one process: this
    checkout's decode and paged attention (wrappers and CUDA kernels)
    against those of the checkout ``parent_dir``, imported from a copy of
    its package under another name, in turns (the first side alternating
    by block). Everything else of the decode iteration is this
    checkout's, so only the two ops' host and device time differs, and
    no process-to-process spread enters; each block pairs the sides, and
    the median of the blocks' change / parent ratios is the reading. Also
    the host time of one call of each side's ops at 4b's and 6b's shapes
    (200 calls queued on a busy stream, best of 5). One JSON line holds
    the readings (no gate)."""
    import importlib
    import shutil
    import tempfile
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS, layers
    tmp = tempfile.mkdtemp()
    shutil.copytree(os.path.join(os.path.abspath(parent_dir),
                                 "deepspeed_tpu_torch"),
                    os.path.join(tmp, "parent_ops_pkg"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    sys.path.insert(0, tmp)
    ops = {"parent": tuple(
        getattr(importlib.import_module(f"parent_ops_pkg.ops.{name}"), name)
        for name in ("decode_attention", "paged_attention")),
        "change": (layers.decode_attention, layers.paged_attention)}
    model = GPT(GPT2_PRESETS["gpt2-125m"], seed=SEED)
    vocab = model.config.vocab_size
    prompts, outs = traffic(vocab)
    engine = init_inference(model)
    _, srv, _, _ = serve_traffic(engine, prompts, outs, SERVING_CONFIG)
    runs = {"4b decode ms": row_runners(srv, engine.module, SERVING_CONFIG,
                                        prompts)[0]["decode"]}
    engine = init_inference(model)
    _, srv, _, _ = serve_paged(engine, *paged_traffic(vocab), PAGED_CONFIG)
    runs["6b decode ms"] = _paged_decode_runner(
        srv, engine.module, served_lengths(16, SEED + 7))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    H, d, dt = 12, 64, torch.bfloat16
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=dt)
               for shape in ((8, 1, H, d), (8, H, 1024, d), (8, H, 1024, d)))
    lens = torch.tensor(served_lengths(8, SEED + 1), dtype=torch.int32,
                        device=dev)
    pq, kn, vn, kp, vp, _, _, table, plens = _paged_case(
        dev, gen, dt, False, 128, d, [int(n) for n in
                                      served_lengths(16, SEED + 6)], B=16)
    calls = {"decode call us": lambda dec, pag: dec(q, k, v, lens),
             "paged call us": lambda dec, pag: pag(pq, kp, vp, table, plens,
                                                   kn, vn)}
    out = {}
    try:
        times = {side: {name: [] for name in runs} for side in ops}
        for block in range(blocks):
            for side in (("parent", "change") if block % 2 == 0
                         else ("change", "parent")):
                layers.decode_attention, layers.paged_attention = ops[side]
                for name, fn in runs.items():
                    times[side][name].append(wall_ms(fn, 10))
        for name in runs:
            p, c = (np.array(times[side][name])
                    for side in ("parent", "change"))
            out[name] = {"parent": float(np.median(p)),
                         "change": float(np.median(c)),
                         "paired ratio": float(np.median(c / p)),
                         "change faster": int((c < p).sum()),
                         "blocks": blocks}
        for name, call in calls.items():
            out[name] = {}
            for side in ("parent", "change"):
                best = []
                for _ in range(5):
                    torch.cuda._sleep(50_000_000)   # keep the stream busy
                    t0 = time.perf_counter()
                    for _ in range(200):
                        call(*ops[side])
                    best.append((time.perf_counter() - t0) / 200 * 1e6)
                    torch.cuda.synchronize()
                out[name][side] = min(best)
    finally:
        layers.decode_attention, layers.paged_attention = ops["change"]
        shutil.rmtree(tmp, ignore_errors=True)
    for name, r in out.items():
        log(f"  {name}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()) + f" [{card}]")
    print(json.dumps({"serving_ab": out}), flush=True)


def d256_ab(card, parent_dir, rounds=2):
    """The flash kernels of this checkout against those of the checkout
    ``parent_dir`` in one process: both kernel libraries built from their
    own sources and launched through this checkout's wrappers in turns
    (parent, change, change, parent, ``rounds`` times; each side's median).
    Times the bf16, fp16 and fp32 d-256 forward, dK/dV and dQ at GPT-J-6B's
    attention (``GPTJ_ATTN``, dropout 0 and 0.1) and the forward at the
    serving prefill bucket (``time_flash``'s shape at d 256), one line
    each beside the bound and SDPA; then holds the bf16 and fp16 instances
    at every head dim and the fp32 ones at d <= 128 bit-equal to the
    parent's over phase 3's training grid and times them at GPT-2's micro
    batch (d 64). One JSON line holds the readings (no gate, no result
    line)."""
    import importlib
    import shutil
    import tempfile
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.flash_attention import (
        BWD_HEAD_DIMS, Dropout, _bias_operand, bwd_operands,
        flash_attention_fwd, launch_bwd_dkv, launch_bwd_dq)
    tmp = tempfile.mkdtemp()
    shutil.copytree(os.path.join(os.path.abspath(parent_dir),
                                 "deepspeed_tpu_torch"),
                    os.path.join(tmp, "parent_ops_pkg"),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    sys.path.insert(0, tmp)
    libs = {"parent": importlib.import_module(
        "parent_ops_pkg.ops.op_builder").load(), "change": op_builder.load()}
    real_load = op_builder.load

    def side(name):
        op_builder.load = lambda *a, **k: libs[name]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    order = ("parent", "change", "change", "parent") * rounds

    def ab(fns):
        """{kernel: {side: median ms}} of ``fns`` {kernel: fn} in turns."""
        seen = {k: {"parent": [], "change": []} for k in fns}
        for who in order:
            side(who)
            for k, fn in fns.items():
                seen[k][who].append(gpu_ms(fn, iters=20))
        return {k: {w: float(np.median(v)) for w, v in sides.items()}
                for k, sides in seen.items()}

    def kernels(q, k, v, do, bias, causal, drop):
        d = q.shape[-1]
        o, lse = flash_attention_fwd(q, k, v, bias, causal=causal,
                                     dropout=drop)
        ops = bwd_operands(q, k, v, o, lse, do, bias)
        return {
            "flash_attention": lambda: flash_attention_fwd(
                q, k, v, bias, causal=causal, dropout=drop),
            "flash_attention_bwd_dkv": lambda: launch_bwd_dkv(
                ops, causal, d ** -0.5, drop),
            "flash_attention_bwd_dq": lambda: launch_bwd_dq(
                ops, causal, d ** -0.5, drop)}

    out = {"card": card, "d256": [], "unchanged_times": []}
    b, h, s, d = (GPTJ_ATTN[x] for x in "bhsd")
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev,
                                   dtype=dt) for _ in range(4))
        for rate in (0.0, 0.1):
            # the bound and SDPA (with the same dropout rate) at this rate
            side("change")
            ref = time_flash_train(dev, gen, b=b, h=h, s=s, d=d, rate=rate,
                                   dtype=dt)
            drop = Dropout(rate, 0x1234, 0x5678, h) if rate else None
            times = ab(kernels(q, k, v, do, None, True, drop))
            for name, t in times.items():
                row = dict(kernel=name, dtype=str(dt)[6:], rate=rate,
                           shape=f"b={b} h={h} s={s} d={d} causal",
                           parent_ms=t["parent"], change_ms=t["change"],
                           bound_ms=ref[name]["bound_ms"],
                           sdpa_ms=ref[name]["library_ms"])
                out["d256"].append(row)
                log(f"  d-256 A/B {name} {row['dtype']} {row['shape']} "
                    f"rate={rate}: parent {t['parent']:.4f} ms, change "
                    f"{t['change']:.4f} ms (change/parent "
                    f"{t['change'] / t['parent']:.3f}); bound "
                    f"{row['bound_ms']:.4f} ms, SDPA {row['sdpa_ms']:.4f} "
                    f"ms [{card}]")
        # the serving prefill bucket: the forward alone (time_flash's)
        qp, kp, vp = (torch.randn(1, 512, h, d, generator=gen, device=dev,
                                  dtype=dt) for _ in range(3))
        side("change")
        pref = time_flash(dev, gen, d=d, h=h, dt=dt)
        t = ab({"flash_attention": lambda: flash_attention_fwd(
            qp, kp, vp, None, causal=True)})["flash_attention"]
        row = dict(kernel="flash_attention", dtype=str(dt)[6:], rate=0.0,
                   shape=pref["shape"], parent_ms=t["parent"],
                   change_ms=t["change"], bound_ms=pref["bound_ms"],
                   sdpa_ms=pref["library_ms"])
        out["d256"].append(row)
        log(f"  d-256 A/B flash_attention {row['dtype']} prefill bucket "
            f"{pref['shape']}: parent {t['parent']:.4f} ms, change "
            f"{t['change']:.4f} ms (change/parent "
            f"{t['change'] / t['parent']:.3f}); bound {pref['bound_ms']:.4f}"
            f" ms, SDPA {pref['library_ms']:.4f} ms [{card}]")
        del q, k, v, do, qp, kp, vp

    # the kernels this change leaves alone: bit for bit over phase 3's grid
    cases, unequal = 0, []
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for d in BWD_HEAD_DIMS:
            if d == 256 and dt == torch.float32:
                continue
            for s in (128, 1024):
                for name, b, bias in _train_cases(dev, s):
                    for rate in (0.0, 0.1):
                        q, k, v, do = (torch.randn(
                            b, s, 12, d, generator=gen, device=dev,
                            dtype=dt) for _ in range(4))
                        bias_in = _bias_operand(bias, q, k)
                        drop = _drop(rate, 12, cases)
                        res = {}
                        for who in ("parent", "change"):
                            side(who)
                            o, lse = flash_attention_fwd(
                                q, k, v, bias_in, causal=True, dropout=drop)
                            ops = bwd_operands(q, k, v, o, lse, do, bias_in)
                            res[who] = (o, lse, *launch_bwd_dkv(
                                ops, True, d ** -0.5, drop),
                                launch_bwd_dq(ops, True, d ** -0.5, drop))
                        cases += 1
                        if not _same_bits(res["parent"], res["change"]):
                            unequal.append(f"{str(dt)[6:]} d={d} s={s} "
                                           f"{name} rate={rate}")
    out["unchanged_cases"], out["unchanged_unequal"] = cases, unequal
    log(f"  bf16/fp16 instances and fp32 d <= 128 against the parent's: "
        f"{cases - len(unequal)}/{cases} cases bit-equal (o, lse, dk, dv, "
        f"dq){'; differ: ' + str(unequal) if unequal else ''}")
    for dt, shape in ((torch.bfloat16, dict(b=8, h=12, s=1024, d=64)),
                      (torch.float16, dict(b=8, h=12, s=1024, d=64)),
                      (torch.float32, dict(b=8, h=12, s=1024, d=64))):
        q, k, v, do = (torch.randn(shape["b"], shape["s"], shape["h"],
                                   shape["d"], generator=gen, device=dev,
                                   dtype=dt) for _ in range(4))
        drop = Dropout(0.1, 0x1234, 0x5678, shape["h"])
        for name, t in ab(kernels(q, k, v, do, None, True, drop)).items():
            label = (f"{str(dt)[6:]} b={shape['b']} h={shape['h']} "
                     f"s={shape['s']} d={shape['d']} causal rate=0.1")
            out["unchanged_times"].append(dict(
                kernel=name, shape=label, parent_ms=t["parent"],
                change_ms=t["change"]))
            log(f"  unchanged {name} {label}: parent {t['parent']:.4f} ms, "
                f"change {t['change']:.4f} ms [{card}]")
        del q, k, v, do
    op_builder.load = real_load
    print(json.dumps(out), flush=True)


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
    ln = {k: v for k, v in by_name.items() if k.startswith("ln_")}
    if ln:
        log(f"    LayerNorm kernels {sum(ln.values()) / iters / 1e3:.4f} ms "
            "per call: " + ", ".join(f"{k} {v / iters / 1e3:.4f}"
                                     for k, v in sorted(ln.items())))
    return busy_ms


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
    from deepspeed_tpu_torch.models import GPT2_PRESETS
    log("phase 5b: training, card against CPU (fp32, attention dropout "
        "0.1, GPT-2 125M at full width and depth)")
    cfg = dataclasses.replace(GPT2_PRESETS["gpt2-125m"], dtype=torch.float32,
                              attn_dropout_rate=0.1)
    rs = np.random.RandomState(SEED + 5)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size, size=(4, 128))
             .astype(np.int32)}
    return card_vs_cpu_training(cfg, batch)


def card_vs_cpu_training(cfg, batch, lr=1e-4):
    """``GPT(cfg)`` trained 2 steps through ``initialize()`` ->
    ``train_batch`` (FusedAdam at ``lr``, micro 2 x gas 2, clip 1.0) on the
    card and on the CPU from the same seed: each step's loss within 1e-4,
    every parameter within 4 lr after the 2 steps. Returns the card run's
    flash launch counts."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import GPT
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "FusedAdam",
                            "params": {"lr": lr, "weight_decay": 0.1}}}
    runs = {}
    counters = {k: v for k, v in _ds_counters().items()
                if k.startswith("flash_attention")}
    for dev in ("cuda", "cpu"):
        engine, _, _, _ = initialize(model=GPT(cfg, seed=SEED), config=config,
                                     loss_fn=gpt_train_loss, seed=SEED,
                                     device=dev)
        reset_counters(counters)
        losses = [float(engine.train_batch(batch)) for _ in range(2)]
        if dev == "cuda":
            counts = read_counters(counters)    # the fp32 3xTF32 kernels'
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
    log(f"  launches of the card run: {counts}")
    if not ok:
        raise AssertionError("training on the card and on the CPU disagree")
    return counts


# --------------------------------------------------------------------------
# phase 6: paged serving with a prefix cache, chunked prefill, int8 KV pages
# and int8 weights
# --------------------------------------------------------------------------

SYSTEM_PROMPT = 256           # tokens of the system prompt every request shares
PAGED_CONFIG = {
    "num_slots": 16, "max_len": 1024, "prefill_bucket": 128,
    # 64 usable pages of 128 tokens: the memory of 8 full-length rows
    "paging": {"page_len": 128, "prefill_chunk": 256, "num_pages": 65,
               "max_chunks_per_iter": 1, "enable_prefix_cache": True}}
INT8_KV_AGREE = 0.9           # the JAX package's rungs
INT8_KV_LOGIT_ERR = 0.2


def paged_traffic(vocab, n=24, seed=SEED):
    """24 greedy requests: a seeded 256-token system prompt shared by all,
    plus a 16-400-token tail each; 16-64 new tokens each."""
    rs = np.random.RandomState(seed + 10)
    system = rs.randint(0, vocab, size=SYSTEM_PROMPT)
    prompts = [np.concatenate([system, rs.randint(0, vocab, size=rs.randint(
        16, 401))]).astype(np.int32) for _ in range(n)]
    outs = [int(rs.randint(16, 65)) for _ in range(n)]
    return prompts, outs


def serve_paged(engine, prompts, outs, config):
    """Serve the traffic on the paged engine with every launch counter
    set to 0 just before and read just after the run; checks the exact
    counts, the prefix hits and the allocator. Returns (requests, server,
    counts, wall seconds)."""
    from deepspeed_tpu_torch.ops import (decode_attention, flash_attention,
                                         paged_attention, wo_int8_matmul)
    srv = engine.serve(config)
    torch.cuda.synchronize()
    flash_attention.launches = decode_attention.launches = 0
    paged_attention.launches = 0
    wo_int8_matmul.small_m_launches = wo_int8_matmul.tiled_launches = 0
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=o) for p, o in zip(prompts, outs)]
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"flash_attention": flash_attention.launches,
              "decode_attention": decode_attention.launches,
              "paged_attention": paged_attention.launches,
              "wo_int8_matmul_small_m": wo_int8_matmul.small_m_launches,
              "wo_int8_matmul": wo_int8_matmul.tiled_launches}
    snap = srv.metrics.snapshot()
    n_layers = engine.module.config.n_layers
    chunks, iters = snap["prefill_chunks"], snap["decode_iterations"]
    # every int8 matrix runs once a program: 4 a layer, and the head when
    # it is untied (phase 11's Pythia)
    from deepspeed_tpu_torch.models.layers import QDense
    cfg = engine.module.config
    n_int8 = (4 * n_layers + (0 if cfg.tie_embeddings else 1)
              if srv.config.weights_int8 else 0)
    held = sum(isinstance(m, QDense) and m.quantized
               for m in srv.module.modules())
    if held != n_int8:
        raise AssertionError(f"the served model holds {held} int8 matrices, "
                             f"its config {n_int8}")
    want = {"flash_attention": n_layers * chunks, "decode_attention": 0,
            "paged_attention": n_layers * iters,
            "wo_int8_matmul_small_m": n_int8 * iters,
            "wo_int8_matmul": n_int8 * chunks}
    log(f"  launches over the serving run: {counts} (want {want}: "
        f"{n_layers} layers x {iters} decode iterations, x {chunks} "
        f"prefill chunks{f'; {n_int8} int8 matrices' if n_int8 else ''})")
    if counts != want:
        raise AssertionError("the paged serving run did not go through its "
                             "kernels the expected number of times")
    if snap["requests_finished"] != len(prompts):
        raise AssertionError(f"only {snap['requests_finished']} of "
                             f"{len(prompts)} requests finished")
    log(f"  prefix cache: {snap['prefix_lookups']} lookups, "
        f"{snap['prefix_hits']} hits, {snap['prefix_pages_reused']} pages "
        f"reused, {snap['prefix_pages_evicted']} evicted; "
        f"{snap['prefill_tokens_reused']} prompt tokens reused, "
        f"{snap['prefill_tokens_computed']} computed; peak "
        f"{snap['concurrent_requests_peak']} concurrent requests")
    if snap["prefix_hits"] < 1:
        raise AssertionError("no request hit the shared system prompt")
    srv._paged.allocator.check()
    if srv._paged.allocator.pages_in_use != snap["prefix_nodes"]:
        raise AssertionError("pages still held after every request ended")
    return reqs, srv, counts, wall


def check_against_generate(engine, reqs, prompts, outs, gap_stop, what,
                           first_token_only=False, first_tie_ulps=0,
                           ulp=bf16_ulp):
    """Every request token-exact against ``engine.generate()`` up to its
    first near-tie step (reference top-2 logit gap < ``gap_stop``). With
    ``first_token_only`` (bf16 serving, exempt from that rule: cuBLAS
    rounds a row of a dense layer's product by the batch's row count,
    PERF.md's tolerance table) only each request's first token is gated,
    and the rest is classified. ``first_tie_ulps`` (11a's 24 bf16 layers,
    whose prefill GEMMs also round by m: chunks of 256 against the whole
    prompt) exempts a first token whose reference top-2 gap is at most
    that many ulps of the top logit (``ulp``: ``bf16_ulp`` or
    ``fp16_ulp``). Every request that differs is logged with its first
    differing step and the reference gap there before the phase fails.
    Returns the share of tokens that agree."""
    unit = ulp.__name__[:4]
    stops = compared = agree = 0
    early, bad, tied = [], [], []
    for i, (req, p, o) in enumerate(zip(reqs, prompts, outs)):
        ref = engine.generate(p[None], max_new_tokens=o)[0, len(p):]
        ref = ref.cpu().numpy()
        gaps, tops = top2_gaps(engine.module, p, ref)
        near = np.nonzero(gaps < gap_stop)[0]
        upto = int(near[0]) if near.size else o
        stops += bool(near.size)
        compared += upto
        got = np.asarray(req.output_tokens)
        diff = np.nonzero(got[:o] != ref[:len(got)])[0] if got.shape == (o,) \
            else np.array([0])
        agree += o - diff.size
        if diff.size:
            j = int(diff[0])
            log(f"  {what} request {i}: first difference at step {j} of {o}"
                f" (reference top-2 gap there {gaps[j]:.4g}, smallest gap "
                f"before it {gaps[:j].min() if j else float('nan'):.4g}); "
                f"compared up to {upto}")
            if j < upto:
                early.append(i)
            if (first_tie_ulps and j == 0
                    and gaps[0] <= first_tie_ulps * ulp(tops[0])):
                tied.append(i)
            elif (j == 0) if first_token_only else (j < upto):
                bad.append(i)
    log(f"  {what}: {len(reqs) - len(early)}/{len(reqs)} requests "
        f"token-exact against generate() up to their first near tie "
        f"(reference top-2 gap < {gap_stop}: {stops} requests, {compared} "
        f"of {sum(outs)} tokens before the first); {agree} of {sum(outs)} "
        f"tokens agree" + (
            f"; first tokens {len(reqs) - len(bad) - len(tied)}/{len(reqs)} "
            f"exact (the gate; requests {early} differ before a near tie, "
            f"exempt" + (f"; requests {tied} in the first token at a "
                         f"reference gap <= {first_tie_ulps} {unit} ulps of "
                         "the top logit, exempt" if first_tie_ulps else "")
            + ")" if first_token_only else ""))
    if bad:
        where = "in the first token" if first_token_only else \
            "before a near tie"
        raise AssertionError(f"{what}: requests {bad} differ from "
                             f"generate() {where}")
    return agree / sum(outs)


def _paged_decode_runner(srv, model, lengths):
    """A decode iteration of the server's paged path at 16 active slots
    with pool ``lengths`` (page-table rows cycling through the pool)."""
    from deepspeed_tpu_torch.serving.paging.manager import \
        _paged_decode_iter_impl
    mgr, dev = srv._paged, srv.device
    n, usable = srv.config.num_slots, mgr.num_pages - 1
    table = torch.tensor([[1 + (b * mgr.max_pages + j) % usable
                           for j in range(mgr.max_pages)] for b in range(n)],
                         dtype=torch.int32, device=dev)
    state = {"lengths": torch.tensor(lengths, dtype=torch.int32, device=dev),
             "last_token": torch.randint(0, model.config.vocab_size, (n,),
                                         device=dev),
             "active": torch.ones(n, dtype=torch.bool, device=dev),
             "remaining": torch.full((n,), 10 ** 6, dtype=torch.int32,
                                     device=dev)}
    return lambda: _paged_decode_iter_impl(model, mgr.pool, table, state,
                                           srv._gen, -1, srv._mode, True)


def phase_paged_fp32(model_fp32, prompts, outs):
    from deepspeed_tpu_torch import init_inference
    log("phase 6a: paged fp32 serving, token-exact against generate()")
    engine = init_inference(model_fp32, dtype=torch.float32)
    reqs, _, _, wall = serve_paged(engine, prompts, outs, PAGED_CONFIG)
    check_against_generate(engine, reqs, prompts, outs, GAP_STOP, "6a fp32")
    log(f"  served {sum(len(r.output_tokens) for r in reqs)} tokens in "
        f"{wall:.3f} s")


def phase_paged_bf16(model_bf16, prompts, outs, card, profile=False):
    from deepspeed_tpu_torch import init_inference
    log("phase 6b: paged bf16 serving, first tokens against generate()")
    engine = init_inference(model_bf16)
    reqs, srv, counts, wall = serve_paged(engine, prompts, outs,
                                          PAGED_CONFIG)
    check_against_generate(engine, reqs, prompts, outs, GAP_STOP, "6b bf16",
                           first_token_only=True)
    tokens = srv.metrics.tokens_generated
    cfg = engine.module.config
    contiguous = (2 * cfg.n_layers * PAGED_CONFIG["num_slots"] * cfg.n_heads
                  * PAGED_CONFIG["max_len"] * cfg.head_dim * 2)
    log(f"  serving: {tokens} tokens, {srv.metrics.decode_iterations} decode "
        f"iterations, {srv.metrics.prefill_chunks} prefill chunks, wall "
        f"{wall:.3f} s, {tokens / wall:.1f} tokens/s [{card}]")
    log(f"  KV pool {srv._paged.pool_bytes()} bytes for 16 slots against "
        f"{contiguous} bytes for 16 contiguous bf16 rows of 1024")
    run_decode = _paged_decode_runner(srv, engine.module,
                                      served_lengths(16, SEED + 7))
    decode = wall_ms(run_decode, iters=20)
    log(f"  paged decode wall ms per iteration (16 slots): {decode:.3f} "
        f"[{card}]")
    if profile:
        device_profile("paged decode", run_decode, decode, card)
    return counts, decode, tokens / wall


def phase_paged_int8_weights(model_bf16, prompts, outs, card,
                             profile=False):
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.module_inject.module_quantize import \
        quantized_nbytes
    log("phase 6c: paged bf16 serving, int8 weights")
    engine = init_inference(model_bf16, quantize_weights=True)
    config = {**PAGED_CONFIG, "quantize": {"weights": "int8"}}
    reqs, srv, counts, wall = serve_paged(engine, prompts, outs, config)
    if srv.module is not engine.module:
        raise AssertionError("the server re-quantized an int8 model")
    nb = quantized_nbytes(engine.module)
    log(f"  weights {nb['quantized']} bytes int8 against "
        f"{nb['dense_equivalent']} bf16-equivalent; served "
        f"{srv.metrics.tokens_generated} tokens in {wall:.3f} s "
        f"({srv.metrics.tokens_generated / wall:.1f} tokens/s) [{card}]")
    check_against_generate(engine, reqs, prompts, outs, GAP_STOP,
                           "6c int8 weights")
    run_decode = _paged_decode_runner(srv, engine.module,
                                      served_lengths(16, SEED + 7))
    decode = wall_ms(run_decode, iters=20)
    log(f"  paged decode wall ms per iteration (16 slots, int8 weights): "
        f"{decode:.3f} [{card}]")
    if profile:
        device_profile("paged decode int8 weights", run_decode, decode, card)
    return engine, [list(r.output_tokens) for r in reqs], counts


def decode_logit_err(model, prompt):
    """One paged decode step's logits over an int8 pool against a pool in
    the compute dtype, both holding the same 256 prompt tokens written
    through the chunk scatter."""
    from deepspeed_tpu_torch.inference.cache import (
        gather_pages, init_page_pool, make_paged_view, scatter_chunk_pages)
    dev = model.wte.device
    ids = torch.tensor(prompt[None, :256], device=dev).long()
    table = torch.zeros(1, 8, dtype=torch.int32, device=dev)
    table[0, :3] = torch.tensor([1, 2, 3])
    logits = []
    with torch.no_grad():
        for kv_int8 in (False, True):
            pool = init_page_pool(model, 4, 128, kv_int8=kv_int8)
            row = gather_pages(pool, table, dequant_dtype=model.config.dtype)
            row.index = 0
            model(ids, positions=torch.arange(256, device=dev), cache=row)
            scatter_chunk_pages(pool, row.k[:, 0, :, :256],
                                row.v[:, 0, :, :256], table[0, :2])
            view = make_paged_view(pool, table,
                                   torch.tensor([256], device=dev))
            logits.append(model(ids[:, -1:], positions=torch.tensor(
                [[256]], device=dev), cache=view).float())
    return (logits[0] - logits[1]).abs().max().item()


def phase_paged_int8_kv(engine_int8, ref_tokens, prompts, outs, card):
    log("phase 6d: paged bf16 serving, int8 weights and int8 KV pages")
    config = {**PAGED_CONFIG, "quantize": {"weights": "int8", "kv": "int8"}}
    reqs, srv, counts, wall = serve_paged(engine_int8, prompts, outs, config)
    pairs = [(a, b) for r, ref in zip(reqs, ref_tokens)
             for a, b in zip(r.output_tokens, ref)]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    err = decode_logit_err(engine_int8.module, prompts[0])
    log(f"  KV pool {srv._paged.pool_bytes()} bytes (int8 pages + fp32 "
        f"scales); greedy agreement with 6c {agree:.4f} (gate >= "
        f"{INT8_KV_AGREE}); one decode step's logit max abs err against the "
        f"bf16 pool {err:.4f} (gate < {INT8_KV_LOGIT_ERR}); "
        f"{srv.metrics.tokens_generated / wall:.1f} tokens/s [{card}]")
    if agree < INT8_KV_AGREE or not err < INT8_KV_LOGIT_ERR:
        raise AssertionError("int8 KV pages outside the bounded-error rungs")
    return counts


# --------------------------------------------------------------------------
# phase 7: BERT-base pretraining with block-sparse attention and FusedLamb
# --------------------------------------------------------------------------

SPARSE_SEQ = 4096
BERT_TRAIN_CONFIG = {
    "train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "FusedLamb",
                  "params": {"lr": 2e-3, "betas": [0.9, 0.999], "eps": 1e-6,
                             "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_num_steps": 3, "warmup_max_lr": 2e-3}},
    "gradient_clipping": 1.0, "bf16": {"enabled": True},
}


def sparse_bert(base, seq, seed=SEED):
    """BERT made sparse as a user does: a model built from ``base``, then
    ``replace_model_self_attention_with_sparse_self_attention`` (the
    position table extended to ``seq`` rows, the BigBird-64 pattern);
    returns (model, config)."""
    from deepspeed_tpu_torch.models import BertForPreTraining
    from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils
    dense = BertForPreTraining(base, seed=seed)
    cfg, state = SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            base, dense.state_dict(), seq, bigbird_64(base.n_heads))
    model = BertForPreTraining(cfg, seed=seed)
    model.load_state_dict(state)
    return model, cfg


def bert_batch(n, seq, vocab, seed):
    """One seeded MLM + NSP batch: 15% of positions masked with id 103
    ([MASK]) and labelled with the original token (-1 elsewhere), token
    types 0 for the first half and 1 for the second, random NSP labels,
    no attention_mask."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1000, vocab, size=(n, seq)).astype(np.int32)
    masked = rs.rand(n, seq) < 0.15
    labels = np.where(masked, ids, -1).astype(np.int32)
    ids[masked] = 103
    types = np.zeros((n, seq), np.int32)
    types[:, seq // 2:] = 1
    return {"input_ids": ids, "token_type_ids": types, "mlm_labels": labels,
            "nsp_labels": rs.randint(0, 2, size=n).astype(np.int32)}


def bert_train_loss(model, batch, rng, train):
    """loss_fn(model, batch, rng, train): MLM + NSP cross entropy."""
    from deepspeed_tpu_torch.models import bert_pretrain_loss
    mlm, nsp = model(batch["input_ids"].long(),
                     token_type_ids=batch["token_type_ids"].long(),
                     dropout_seed=rng)
    return bert_pretrain_loss(mlm, nsp, batch["mlm_labels"],
                              batch["nsp_labels"])


# phase 7a: the least fall of the mean loss over a period (the first two
# steps against the last two). Readings (H100): the sound run 1.5298, a run
# whose LAMB apply launch is skipped 0.0017; 0.05 is ~30x from each
LOSS_FALL = 0.05


def phase_sparse_bert_bf16(card, profile=False, steps=8):
    """BERT-base (12 layers, d 768) made sparse at 4096 tokens, bf16 on
    fp32 masters, attention dropout 0.1, FusedLamb, 8 train_batch calls on
    one seeded batch; the launch counters of exactly these steps."""
    import dataclasses
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import BERT_PRESETS
    from deepspeed_tpu_torch.ops import (block_sparse_attention,
                                         flash_attention, flash_attention_bwd,
                                         fused_adam, fused_lamb)
    log("phase 7a: BERT-base with BigBird-64 block-sparse attention at "
        f"{SPARSE_SEQ} tokens trained through initialize() -> train_batch "
        f"(bf16, attention dropout 0.1, FusedLamb; GEMM flags "
        f"{list(gemm_flags())})")
    base = dataclasses.replace(BERT_PRESETS["bert-base"],
                               attn_dropout_rate=0.1)
    model, cfg = sparse_bert(base, SPARSE_SEQ)
    engine, _, _, _ = initialize(model=model, config=BERT_TRAIN_CONFIG,
                                 loss_fn=bert_train_loss, seed=SEED)
    n = BERT_TRAIN_CONFIG["train_batch_size"]
    batch = bert_batch(n, SPARSE_SEQ, cfg.vocab_size, SEED + 8)
    torch.cuda.synchronize()
    block_sparse_attention.fwd_launches = 0
    block_sparse_attention.dq_launches = 0
    block_sparse_attention.dkv_launches = 0
    fused_lamb.phase1_launches = fused_lamb.apply_launches = 0
    flash_attention.launches = fused_adam.launches = 0
    flash_attention_bwd.dkv_launches = flash_attention_bwd.dq_launches = 0
    losses, marks = [], []
    for _ in range(steps):
        losses.append(engine.train_batch(batch))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    counts = {"block_sparse_attention_fwd": block_sparse_attention.fwd_launches,
              "block_sparse_attention_dq": block_sparse_attention.dq_launches,
              "block_sparse_attention_dkv":
                  block_sparse_attention.dkv_launches,
              "fused_lamb": fused_lamb.phase1_launches,
              "fused_lamb_apply": fused_lamb.apply_launches,
              "flash_attention": flash_attention.launches,
              "flash_attention_bwd_dkv": flash_attention_bwd.dkv_launches,
              "flash_attention_bwd_dq": flash_attention_bwd.dq_launches,
              "fused_adam": fused_adam.launches}
    per_attn = cfg.n_layers * BERT_TRAIN_CONFIG["gradient_accumulation_steps"]
    want = {name: 0 for name in counts}
    want.update({"block_sparse_attention_fwd": per_attn * steps,
                 "block_sparse_attention_dq": per_attn * steps,
                 "block_sparse_attention_dkv": per_attn * steps,
                 "fused_lamb": steps, "fused_lamb_apply": steps})
    log(f"  launches over the {steps} steps: {counts} (want {want}: "
        f"{cfg.n_layers} layers x 2 microbatches x {steps} steps; two LAMB "
        "launches a step; no flash or Adam launch)")
    if counts != want:
        raise AssertionError("the sparse BERT run did not go through every "
                             "kernel of its path the expected number of "
                             "times")
    losses = [float(x) for x in losses]
    log("  losses: " + ", ".join(f"{x:.4f}" for x in losses))
    # the losses bounce with period 2: compare whole periods
    fall = np.mean(losses[:2]) - np.mean(losses[-2:])
    log(f"  mean of the first two losses - mean of the last two: "
        f"{fall:.4f} (gate >= {LOSS_FALL})")
    if not all(np.isfinite(losses)) or not fall >= LOSS_FALL:
        raise AssertionError("sparse BERT losses are not finite or did not "
                             "fall over a period on the repeated batch")
    step_ms = (marks[-1] - marks[0]) / (steps - 1) * 1e3
    tokens = n * SPARSE_SEQ
    log(f"  step wall {step_ms:.2f} ms (mean of steps 2-{steps}, each ending "
        f"in a synchronize), {tokens / step_ms * 1e3:.0f} tokens/s, grad "
        f"norm {engine.get_global_grad_norm():.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    if profile:
        device_profile("sparse bert train step",
                       lambda: engine.train_batch(batch), step_ms, card,
                       iters=3, grad=True)
    return counts, step_ms


PARAM_TOL = 0.02    # phase 7b: of a tensor's summed largest LAMB steps


def phase_sparse_bert_parity():
    """The card against the CPU, fp32, attention dropout on: BERT-base
    width, 4 layers, BigBird-64 at 1024 tokens, FusedLamb, 2 steps."""
    import dataclasses
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import BERT_PRESETS
    log("phase 7b: sparse BERT training, card against CPU (fp32, attention "
        "dropout 0.1, BERT-base width, 4 layers, BigBird-64 at 1024)")
    base = dataclasses.replace(BERT_PRESETS["bert-base"], n_layers=4,
                               dtype=torch.float32, attn_dropout_rate=0.1)
    lr, steps, seq = 2e-3, 2, 1024
    config = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 1,
              "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "FusedLamb",
                            "params": {"lr": lr, "weight_decay": 0.01}}}
    runs = {}
    counters = {k: v for k, v in _ds_counters().items()
                if k.startswith("block_sparse")}
    for dev in ("cuda", "cpu"):
        model, cfg = sparse_bert(base, seq)
        batch = bert_batch(2, seq, cfg.vocab_size, SEED + 9)
        engine, _, _, _ = initialize(model=model, config=config,
                                     loss_fn=bert_train_loss, seed=SEED,
                                     device=dev)
        reset_counters(counters)
        losses, moves = [], []
        prev = {k: v.detach().cpu().clone() for k, v in
                engine.module.state_dict().items()}
        for _ in range(steps):
            losses.append(float(engine.train_batch(batch)))
            now = {k: v.detach().cpu().clone() for k, v in
                   engine.module.state_dict().items()}
            moves.append({k: (now[k] - prev[k]).abs().max().item()
                          for k in now})
            prev = now
        if dev == "cuda":
            counts = read_counters(counters)    # the fp32 kernels'
        runs[dev] = (losses, prev, moves)
    loss_err = max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                              runs["cpu"][0]))
    # A LAMB step moves element i of a tensor by lr * trust * |u_i|, with
    # trust = |p| / |u| the tensor's trust ratio. Each tensor is held to
    # PARAM_TOL of the sum of its largest step per step (the CPU run's
    # steps): sound runs read 0.002 of that sum; PERF.md gives the
    # readings of trust ratios planted 2% and 10% off.
    worst, ratio_at, diffs = 0.0, "", []
    for k, ref in runs["cpu"][1].items():
        tol = PARAM_TOL * sum(m[k] for m in runs["cpu"][2])
        d = (runs["cuda"][1][k] - ref).abs()
        diffs.append(d.flatten())
        r = d.max().item() / tol if tol > 0 else (0.0 if d.max() == 0
                                                  else float("inf"))
        if r > worst:
            worst, ratio_at = r, k
    diffs = torch.cat(diffs)
    ok = loss_err <= 1e-4 and worst <= 1.0
    log(f"  losses card {runs['cuda'][0]} cpu {runs['cpu'][0]}: max diff "
        f"{loss_err:.3e} (tol 1e-4); parameters after {steps} steps: max "
        f"diff {diffs.max().item():.3e}, mean {diffs.mean().item():.3e}; "
        f"worst tensor {ratio_at} at {worst:.3f} of its tolerance "
        f"({PARAM_TOL} x the sum of its largest LAMB step per step, lr {lr} "
        f"x trust ratio) "
        f"{'ok' if ok else 'FAIL'}")
    log(f"  launches of the card run: {counts}")
    if not ok:
        raise AssertionError("sparse BERT training on the card and on the "
                             "CPU disagree")
    return counts


# --------------------------------------------------------------------------
# phase 8: a BERT-large stack of DeepSpeedTransformerLayers with 8-bit
# compression-aware training and MoQ
# --------------------------------------------------------------------------

DS_BERT_CONFIG = {
    "train_batch_size": DS_MICRO, "train_micro_batch_size_per_gpu": DS_MICRO,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "FusedLamb",
                  "params": {"lr": 2e-3, "betas": [0.9, 0.999], "eps": 1e-6,
                             "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_num_steps": 3, "warmup_max_lr": 2e-3}},
    "gradient_clipping": 1.0, "bf16": {"enabled": True},
}
DS_MATRICES = ["attn_qkvw", "attn_ow", "inter_w", "output_w"]
COMPRESSION_8BIT = {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 2},
    "different_groups": {"wq8": {
        "params": {"start_bits": 8, "target_bits": 8,
                   "quantization_type": "symmetric"},
        "modules": DS_MATRICES}}}}
MOQ = {"enabled": True, "quantize_bits_start": 10, "quantize_bits_target": 8,
       "quantize_period": 1, "quantize_type": "symmetric"}


class DSBertMLM(torch.nn.Module):
    """BERT with DeepSpeedTransformerLayers, as bing_bert builds it with the
    fused layer and pre-LN: word and position embeddings, the layer stack,
    a final LayerNorm (``fused_layer_norm``) and the MLM decoder tied to
    the word embeddings. Parameters fp32, drawn on the CPU from ``seed``
    (embeddings ~ N(0, 0.02), layer ``i`` from ``seed + 1 + i``). The
    forward returns the MLM logits in the layers' compute dtype. The
    JAX twin of this module is in tests/test_torch_compression.py."""

    def __init__(self, config, vocab_size=30522, max_positions=512,
                 seed=SEED):
        from deepspeed_tpu_torch.ops.transformer import \
            DeepSpeedTransformerLayer
        super().__init__()
        self.config = config
        h = config.hidden_size
        gen = torch.Generator().manual_seed(seed)
        self.word_embeddings = torch.nn.Parameter(
            torch.randn(vocab_size, h, generator=gen) * 0.02)
        self.position_embeddings = torch.nn.Parameter(
            torch.randn(max_positions, h, generator=gen) * 0.02)
        self.layers = torch.nn.ModuleList(
            DeepSpeedTransformerLayer(config, seed=seed + 1 + i)
            for i in range(config.num_hidden_layers))
        self.ln_f_scale = torch.nn.Parameter(torch.ones(h))
        self.ln_f_bias = torch.nn.Parameter(torch.zeros(h))

    def forward(self, input_ids, attention_mask=None, *, dropout_seed=None):
        from deepspeed_tpu_torch.ops import fused_layer_norm
        from deepspeed_tpu_torch.ops.dropout import fold_seed
        s = input_ids.shape[1]
        h = (self.word_embeddings[input_ids]
             + self.position_embeddings[:s][None])
        for i, layer in enumerate(self.layers):
            h = layer(h, attention_mask,
                      dropout_seed=(None if dropout_seed is None
                                    else fold_seed(dropout_seed, i)))
        h = fused_layer_norm(h, self.ln_f_scale, self.ln_f_bias,
                             self.config.layer_norm_eps)
        return h @ self.word_embeddings.to(h.dtype).t()


def ds_bert_config(n_layers=None, dtype_fp16=True, attn_dropout=0.1,
                   hidden_dropout=0.0):
    """BERT-large's widths (``BERT_PRESETS["bert-large"]``: d 1024, 16
    heads, d_ff 4096, 24 layers) as a DeepSpeedTransformerConfig, pre-LN,
    eps 1e-12, attention dropout 0.1, hidden dropout 0 unless asked (phase
    8's runs keep it off, as they did before it was ported), bf16 compute
    (``fp16=True``)."""
    from deepspeed_tpu_torch.models import BERT_PRESETS
    from deepspeed_tpu_torch.ops.transformer import \
        DeepSpeedTransformerConfig
    p = BERT_PRESETS["bert-large"]
    return DeepSpeedTransformerConfig(
        hidden_size=p.d_model, intermediate_size=p.ffn_dim, heads=p.n_heads,
        num_hidden_layers=n_layers or p.n_layers, initializer_range=0.02,
        attn_dropout_ratio=attn_dropout, hidden_dropout_ratio=hidden_dropout,
        layer_norm_eps=1e-12, pre_layer_norm=True, fp16=dtype_fp16,
        training=True)


def mlm_batch(n, seq, vocab, seed):
    """One seeded MLM batch with padding: row lengths in [seq - 32, seq],
    ``attention_mask`` 1 on tokens and 0 on padding (id 0), 15% of the
    tokens masked with id 103 ([MASK]) and labelled with the original id
    (-1 elsewhere)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1000, vocab, size=(n, seq)).astype(np.int32)
    lengths = rs.randint(seq - 32, seq + 1, size=n)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    masked = (rs.rand(n, seq) < 0.15) & (mask == 1)
    labels = np.where(masked, ids, -1).astype(np.int32)
    ids[masked] = 103
    return {"input_ids": ids, "attention_mask": mask, "mlm_labels": labels}


def mlm_loss(logits, labels):
    """Cross entropy in fp32, averaged over the labelled positions."""
    logits, labels = logits.float(), labels.long()
    keep = labels != -1
    safe = torch.where(keep, labels, 0)
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, safe[..., None])[
        ..., 0]
    return (nll * keep).sum() / keep.sum().clamp_min(1)


def ds_bert_loss(model, batch, rng, train):
    """loss_fn(model, batch, rng, train) of ``DSBertMLM``."""
    logits = model(batch["input_ids"].long(), batch["attention_mask"],
                   dropout_seed=rng)
    return mlm_loss(logits, batch["mlm_labels"])


def max_distinct_per_column(tensors):
    """The largest number of distinct values in one column (one per-channel
    group: the last axis) over ``tensors``; one host read."""
    counts = []
    for w in tensors:
        s = w.detach().reshape(-1, w.shape[-1]).t().sort(dim=1).values
        counts.append((1 + (s[:, 1:] != s[:, :-1]).sum(1)).max())
    return int(torch.stack(counts).max())


def _ds_counters():
    from deepspeed_tpu_torch.ops import (block_sparse_attention, dequantize,
                                         flash_attention, flash_attention_bwd,
                                         fused_adam, fused_lamb,
                                         fused_layer_norm, quantize,
                                         wo_int8_matmul)
    return {
        "layernorm_fwd": (fused_layer_norm, "fwd_launches"),
        "layernorm_bwd": (fused_layer_norm, "bwd_launches"),
        "flash_attention": (flash_attention, "launches"),
        "flash_attention_bwd_dkv": (flash_attention_bwd, "dkv_launches"),
        "flash_attention_bwd_dq": (flash_attention_bwd, "dq_launches"),
        "fused_lamb": (fused_lamb, "phase1_launches"),
        "fused_lamb_apply": (fused_lamb, "apply_launches"),
        "quantize": (quantize, "launches"),
        "dequantize": (dequantize, "launches"),
        "fused_adam": (fused_adam, "launches"),
        "block_sparse_attention_fwd": (block_sparse_attention,
                                       "fwd_launches"),
        "block_sparse_attention_dq": (block_sparse_attention, "dq_launches"),
        "block_sparse_attention_dkv": (block_sparse_attention,
                                       "dkv_launches"),
        "wo_int8_matmul": (wo_int8_matmul, "launches")}


def reset_counters(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counters(counters):
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def phase_ds_bert(card, which, profile=False, steps=8):
    """8a (``which="compression"``) or 8b (``"moq"``): the BERT-large
    DeepSpeedTransformerLayer stack trained through initialize() ->
    train_batch, 64 x 128 tokens a step (gas 1), bf16 on fp32 masters,
    attention dropout 0.1, FusedLamb, ``steps`` steps on one seeded batch;
    after each step the projected matrices' grid (distinct values per
    column) and at the end the exact launch counts of those steps."""
    from deepspeed_tpu_torch import initialize
    cfg = ds_bert_config()
    n_layers = cfg.num_hidden_layers
    config = dict(DS_BERT_CONFIG)
    if which == "compression":
        config["compression_training"] = COMPRESSION_8BIT
    else:
        config["quantize_training"] = MOQ
    model = DSBertMLM(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    engine, _, _, _ = initialize(model=model, config=config,
                                 loss_fn=ds_bert_loss, seed=SEED)
    named = engine._named_params
    if which == "compression":
        watched = [p for path, p in named
                   if any(m in path for m in DS_MATRICES)]
        first = COMPRESSION_8BIT["weight_quantization"][
            "shared_parameters"]["schedule_offset"]
        bits_of = lambda step: 8
    else:
        watched = [p for _, p in named if p.dim() >= 2]
        first = 1
        bits_of = engine.moq_quantizer.bits_at
    batch = mlm_batch(DS_MICRO, DS_SEQ, model.word_embeddings.shape[0],
                      SEED + 10)
    counters = _ds_counters()
    torch.cuda.synchronize()
    reset_counters(counters)
    losses, times, grid = [], [], []
    for step in range(1, steps + 1):
        t0 = time.perf_counter()
        losses.append(engine.train_batch(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if step >= first:
            grid.append((step, bits_of(step),
                         max_distinct_per_column(watched)))
    counts = read_counters(counters)
    snapped = steps - first + 1
    want = {name: 0 for name in counts}
    want.update({
        "layernorm_fwd": (2 * n_layers + 1) * steps,
        "layernorm_bwd": (2 * n_layers + 1) * steps,
        "flash_attention": n_layers * steps,
        "flash_attention_bwd_dkv": n_layers * steps,
        "flash_attention_bwd_dq": n_layers * steps,
        "fused_lamb": steps, "fused_lamb_apply": steps,
        "quantize": len(watched) * snapped,
        "dequantize": len(watched) * snapped})
    tag = "8a" if which == "compression" else "8b"
    log(f"  {tag} launches over the {steps} steps: {counts} (want {want}: "
        f"{2 * n_layers} + 1 LayerNorms and {n_layers} attentions a "
        f"microbatch, two LAMB launches a step, {len(watched)} projected "
        f"matrices a step from step {first} on; no Adam, sparse or int8 "
        f"launch)")
    if counts != want:
        raise AssertionError(f"phase {tag} did not go through every kernel "
                             "of its path the expected number of times")
    log("  grid after each step (step, bits, largest distinct values in a "
        "column): " + ", ".join(f"({s}, {b}, {d})" for s, b, d in grid))
    if any(d > 2 ** b - 1 for _, b, d in grid):
        raise AssertionError(f"phase {tag}: a projected matrix holds more "
                             "values per column than its bit grid")
    losses = [float(x) for x in losses]
    log("  losses: " + ", ".join(f"{x:.4f}" for x in losses))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase {tag}: a loss is not finite")
    step_ms = float(np.mean(times[1:])) * 1e3
    proj = gpu_ms(engine._apply_weight_projections, iters=3)
    log(f"  {tag}: {n_layers} layers, {n_params} parameters, step wall "
        f"{step_ms:.2f} ms (mean of steps 2-{steps}, each ending in a "
        f"synchronize), {DS_MICRO * DS_SEQ / step_ms * 1e3:.0f} tokens/s, "
        f"projection {proj:.3f} ms of device time ({len(watched)} "
        f"matrices), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    if profile:
        device_profile(f"ds bert {which} train step",
                       lambda: engine.train_batch(batch), step_ms, card,
                       iters=3, grad=True)
    return counts, step_ms, proj


FLIP_SHARE = 1e-4     # phase 8c: elements allowed one grid step apart
CLOSE = 1e-6          # phase 8c: parameters that no snap has moved apart


def _ds_parity_run(dev, cfg, config, batch, steps):
    """One 8c training run on ``dev``: the losses, the state before and
    after each step (on the CPU), the MoQ width of each step's snap (None
    when MoQ is off) and the gradients of step 1's 1-D parameters."""
    from deepspeed_tpu_torch import initialize
    engine, _, _, _ = initialize(model=DSBertMLM(cfg), config=config,
                                 loss_fn=ds_bert_loss, seed=SEED, device=dev)
    state = lambda: {k: v.detach().cpu().clone() for k, v in
                     engine.module.state_dict().items()}
    losses, states = [], [state()]
    for t in range(steps):
        losses.append(float(engine.train_batch(batch)))
        states.append(state())
        if t == 0:   # .grad holds the step's gradient until the next step
            grads1 = {k: p.grad.detach().cpu().clone() for k, p in
                      engine.module.named_parameters() if p.dim() < 2}
    moq = engine.moq_quantizer
    bits = [moq.bits_at(t) if moq else None for t in range(1, steps + 1)]
    return losses, states, bits, grads1


def _grad_reading(card_state, cpu_state, card_grads, cpu_grads, eps=1e-6):
    """The 1-D element with the largest card-CPU gap after step 1: its
    name, index, gap, and step 1's gradient on both devices against LAMB's
    eps (its first update is g / (|g| + eps): near eps, a small gradient
    gap moves it most)."""
    k = max(cpu_grads, key=lambda n: (card_state[n] - cpu_state[n]).abs()
            .max().item())
    gap = (card_state[k] - cpu_state[k]).abs()
    i = int(gap.argmax())
    gc, gu = card_grads[k].flatten()[i].item(), cpu_grads[k].flatten()[i].item()
    return (f"{k}[{i}]: gap {gap.flatten()[i].item():.3e}; step-1 gradient "
            f"card {gc:.6e} cpu {gu:.6e} (diff {abs(gc - gu):.3e}, |g| / "
            f"LAMB eps {abs(gu) / eps:.3f}); first update g / (|g| + eps): "
            f"card {gc / (abs(gc) + eps):.6f} cpu {gu / (abs(gu) + eps):.6f}")


def _ds_parity_reading(card, cpu, moves, bits):
    """Card state against CPU state after one step. 1-D parameters: the
    largest gap, the elements beyond CLOSE, and the worst tensor's gap
    over PARAM_TOL x ``moves`` (its summed largest LAMB step). 2-D
    parameters: the elements beyond CLOSE and, when ``bits`` is given
    (the last snap's width), how many of them lie one grid step of their
    column apart (a flip) and a description of each tensor with others."""
    from deepspeed_tpu_torch.ops.quantizer import inv_qmax
    r = dict(gap_1d=0.0, n_1d=0, ratio_1d=0.0, at_1d="", n_2d=0, gap_2d=0.0,
             n_snapped=0, n_flip=0, n_bad=0, offenders=[])
    for k, ref in cpu.items():
        d = (card[k] - ref).abs()
        if ref.dim() < 2:
            tol = PARAM_TOL * moves[k]
            ratio = d.max().item() / tol if tol > 0 else (
                0.0 if d.max() == 0 else float("inf"))
            r["gap_1d"] = max(r["gap_1d"], d.max().item())
            r["n_1d"] += int((d > CLOSE).sum())
            if ratio > r["ratio_1d"]:
                r["ratio_1d"], r["at_1d"] = ratio, k
            continue
        r["n_snapped"] += d.numel()
        r["n_2d"] += int((d > CLOSE).sum())
        r["gap_2d"] = max(r["gap_2d"], d.max().item())
        if bits is None:
            continue
        # the column's grid step at the last snap's width
        col = ref.reshape(-1, ref.shape[-1]).abs().amax(0)
        step = torch.clamp_min(col * inv_qmax(bits, False), 1e-8)
        d2 = d.reshape(-1, ref.shape[-1])
        far = d2 > CLOSE
        one = (d2 - step).abs() <= CLOSE
        r["n_flip"] += int((far & one).sum())
        bad = far & ~one
        if bad.any():
            r["n_bad"] += int(bad.sum())
            off = (d2 / step)[bad]
            r["offenders"].append(
                f"{k} {list(ref.shape)}: {int(bad.sum())} beyond {CLOSE}, "
                f"max {d2[bad].max().item():.3e} ({off.min().item():.3f}-"
                f"{off.max().item():.3f} grid steps)")
    return r


def phase_ds_bert_parity(devices=("cuda", "cpu"), n_layers=4):
    """8c: the card against the CPU, fp32, no dropout: BERT-large width
    with 4 layers, 4 x 128 tokens (micro 2, gas 2), 3 steps, trained
    twice, with both projections on and as a control with both off.

    Both runs: each step's loss within 1e-4, and after the last step
    each 1-D parameter (biases, LayerNorm weights; never snapped) within
    PARAM_TOL of the sum of its largest LAMB step per step (phase 7b's
    rule; with nothing snapped one bias element already differs by
    ~1.4e-6 after step 1, and the flips move the next steps' gradients:
    PERF.md gives the readings). Projections on: every element of a
    snapped (2-D) parameter within CLOSE, except elements that landed
    one grid step of their column apart (an fp32 tie in x / scale can
    flip), at most FLIP_SHARE of all elements. Control: every 2-D
    parameter within CLOSE after each step. Every step's readings are
    logged before any gate is read."""
    log("phase 8c: DeepSpeedTransformerLayer stack with 8-bit compression "
        f"and MoQ, card against CPU (fp32, BERT-large width, {n_layers} "
        "layers, 4 x 128 tokens, gas 2, 3 steps), then the same with both "
        "projections off")
    cfg = ds_bert_config(n_layers=n_layers, dtype_fp16=False,
                         attn_dropout=0.0)
    steps = 3
    comp = json.loads(json.dumps(COMPRESSION_8BIT))
    comp["weight_quantization"]["shared_parameters"]["schedule_offset"] = 1
    base = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "optimizer": {"type": "FusedLamb",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    batch = mlm_batch(4, DS_SEQ, 30522, SEED + 11)
    failed = []
    for label, config in (
            ("projections on", {**base, "compression_training": comp,
                                "quantize_training": MOQ}),
            ("control, projections off", base)):
        runs = {dev: _ds_parity_run(dev, cfg, config, batch, steps)
                for dev in devices}
        ((card_losses, card_states, bits, card_grads),
         (cpu_losses, cpu_states, _, cpu_grads)) = (runs[devices[0]],
                                                    runs[devices[1]])
        loss_err = max(abs(a - b) for a, b in zip(card_losses, cpu_losses))
        log(f"  {label}: losses card {card_losses} cpu {cpu_losses}: max "
            f"diff {loss_err:.3e} (tol 1e-4)")
        moves, readings = {}, []
        for t in range(1, steps + 1):
            for k, now in cpu_states[t].items():
                moves[k] = moves.get(k, 0.0) + (
                    now - cpu_states[t - 1][k]).abs().max().item()
            r = _ds_parity_reading(card_states[t], cpu_states[t], moves,
                                   bits[t - 1])
            readings.append(r)
            snap = (f"snap at {bits[t - 1]} bits: {r['n_flip']} one-grid-"
                    f"step flips, {r['n_bad']} others; "
                    if bits[t - 1] else "")
            log(f"    after step {t}: 2-D ({r['n_snapped']} elements) "
                f"{r['n_2d']} beyond {CLOSE}, max gap {r['gap_2d']:.3e}; "
                f"{snap}1-D max gap {r['gap_1d']:.3e}, {r['n_1d']} elements "
                f"beyond {CLOSE}, worst {r['at_1d']} at {r['ratio_1d']:.4f} "
                f"of {PARAM_TOL} x its summed largest LAMB step")
            if t == 1:
                log("      largest 1-D gap after step 1 at " + _grad_reading(
                    card_states[1], cpu_states[1], card_grads, cpu_grads))
        last = readings[-1]
        if label == "projections on":
            for line in last["offenders"][:12]:
                log("      " + line)
            ok = (last["n_bad"] == 0
                  and last["n_flip"] <= FLIP_SHARE * last["n_snapped"])
            share = last["n_flip"] / last["n_snapped"]
            what = (f"{last['n_flip']} flips ({share:.2e} of the snapped "
                    f"elements; limit {FLIP_SHARE:.0e}), "
                    f"{last['n_bad']} other snapped elements beyond {CLOSE}")
        else:
            worst = max(r["gap_2d"] for r in readings)
            ok = worst <= CLOSE
            what = (f"largest 2-D gap over the {steps} steps {worst:.3e} "
                    f"(limit {CLOSE})")
        ok = ok and loss_err <= 1e-4 and last["ratio_1d"] <= 1.0
        log(f"  {label}: after {steps} steps {what}; worst 1-D tensor "
            f"{last['at_1d']} at {last['ratio_1d']:.4f} of its limit "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
    if failed:
        raise AssertionError("the DeepSpeedTransformerLayer stack trains "
                             "differently on the card and on the CPU ("
                             + ", ".join(failed) + ")")


# --------------------------------------------------------------------------
# phase 9: the engine's own loop, checkpoints, the dataloader, Adagrad/SGD
# --------------------------------------------------------------------------

LOOP_CONFIG = {
    "train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "FusedAdam",
                  "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                             "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_num_steps": 3, "warmup_max_lr": 6e-4}},
    "gradient_clipping": 1.0, "bf16": {"enabled": True},
}
LOOP_STEPS, LOOP_SAVE_AT, LOOP_SEQ = 6, 3, 1024


def loop_data(vocab, seed=SEED):
    """One epoch of seeded token ids: LOOP_STEPS global batches."""
    rs = np.random.RandomState(seed + 20)
    rows = LOOP_STEPS * LOOP_CONFIG["train_batch_size"]
    return {"input_ids": rs.randint(0, vocab, size=(rows, LOOP_SEQ))
            .astype(np.int32)}


def loop_model(rate=0.1, dtype=None):
    """GPT-2 125M at full width and depth, random weights from SEED (the
    same weights at every rate and dtype). Built once a configuration;
    each engine takes a ``copy.deepcopy`` (the engine moves its module to
    the card)."""
    import dataclasses
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS
    cfg = dataclasses.replace(GPT2_PRESETS["gpt2-125m"],
                              attn_dropout_rate=rate,
                              **({"dtype": dtype} if dtype else {}))
    return GPT(cfg, seed=SEED)


def loop_engine(template, data, config=LOOP_CONFIG, device=None):
    """A copy of ``template`` through ``initialize(...,
    training_data=data)``: (engine, dataloader)."""
    import copy
    from deepspeed_tpu_torch import initialize
    engine, _, loader, _ = initialize(
        model=copy.deepcopy(template), config=config,
        loss_fn=gpt_train_loss, seed=SEED, training_data=data, device=device)
    return engine, loader


def split_steps(engine, batches):
    """One optimizer step a global batch of ``batches`` through ``loss =
    engine(mb); engine.backward(loss); engine.step()``; returns the
    microbatch losses (device tensors)."""
    micro = engine.train_micro_batch_size_per_gpu()
    losses = []
    for batch in batches:
        for g in range(engine.gradient_accumulation_steps()):
            loss = engine({n: v[g * micro:(g + 1) * micro]
                           for n, v in batch.items()})
            engine.backward(loss)
            engine.step()
            losses.append(loss.detach())
    return losses


def engine_state(engine):
    """Copies of the parameters and the optimizer's slots, and the
    counters."""
    opt = engine.optimizer_state
    return ([p.detach().clone() for p in engine.module.parameters()],
            [t.clone() for slot in opt.SLOTS for t in getattr(opt, slot)],
            (opt.count, engine.global_steps, engine.global_samples,
             engine.micro_steps))


def same_state(a, b):
    return (a[2] == b[2]
            and all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
            and all(torch.equal(x, y) for x, y in zip(a[1], b[1])))


def tag_bytes(path):
    return sum(os.path.getsize(os.path.join(root, n))
               for root, _, names in os.walk(path) for n in names)


def phase_loop_resume(card):
    """9a: 6 steps of the split convention (run A); run B takes 3, saves
    asynchronously, trains on and waits; run C loads through ``latest``
    and takes steps 4-6: bit-equal to A. A load without the optimizer
    states (D) is the control that must differ."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch.models import GPT2_PRESETS
    log("phase 9a: GPT-2 125M trained through initialize(training_data=...) "
        "-> loss = engine(mb); engine.backward(loss); engine.step(), then "
        f"saved at step {LOOP_SAVE_AT} and resumed (bf16, attention dropout "
        f"0.1, micro 4 x gas 2 x {LOOP_SEQ} tokens, FusedAdam)")
    data = loop_data(GPT2_PRESETS["gpt2-125m"].vocab_size)
    counters = {k: v for k, v in _ds_counters().items()
                if k.startswith("flash_attention") or k == "fused_adam"}
    out = {}
    template = loop_model()
    tmp = tempfile.mkdtemp(prefix="ds_loop_")
    try:
        run_a, loader = loop_engine(template, data)
        torch.cuda.synchronize()
        reset_counters(counters)
        full = split_steps(run_a, loader)           # one epoch: 6 steps
        torch.cuda.synchronize()
        counts = read_counters(counters)
        per_attn = 12 * LOOP_CONFIG["gradient_accumulation_steps"]
        want = {name: per_attn * LOOP_STEPS for name in counters}
        want["fused_adam"] = LOOP_STEPS
        log(f"  launches over run A's {LOOP_STEPS} steps: {counts} (want "
            f"{want}: 12 layers x 2 microbatches x {LOOP_STEPS} steps; one "
            "optimizer launch a step)")
        if counts != want:
            raise AssertionError("the forward/backward/step loop did not go "
                                 "through every kernel of its path the "
                                 "expected number of times")
        ref = engine_state(run_a)
        losses = [float(x) for x in full]
        log("  run A microbatch losses: " + ", ".join(
            f"{x:.4f}" for x in losses))
        if not all(np.isfinite(losses)):
            raise AssertionError("run A's losses are not finite")
        del run_a

        run_b, loader = loop_engine(template, data)
        batches = iter(loader)
        head = split_steps(run_b, itertools.islice(batches, LOOP_SAVE_AT))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = run_b.save_checkpoint(tmp, client_state={
            "batches": LOOP_SAVE_AT}, async_save=True)
        out["async_save_return_s"] = time.perf_counter() - t0
        unpublished = not os.path.exists(os.path.join(tmp, "latest"))
        tail = split_steps(run_b, batches)          # steps 4-6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_b.wait_checkpoint()
        out["async_wait_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = tag_bytes(path)
        b_equal = (all(torch.equal(x, y) for x, y in zip(full, head + tail))
                   and same_state(ref, engine_state(run_b)))
        t0 = time.perf_counter()
        sync_path = run_b.save_checkpoint(tmp, tag="sync", save_latest=False)
        out["sync_save_s"] = time.perf_counter() - t0
        out["sync_bytes"] = tag_bytes(sync_path)
        run_b.destroy()
        del run_b
        log(f"  run B: async save of {os.path.basename(path)} returned in "
            f"{out['async_save_return_s']:.3f} s (latest unpublished until "
            f"wait_checkpoint: {unpublished}), wait after 3 more steps "
            f"{out['async_wait_s']:.3f} s, {out['checkpoint_bytes']} bytes; "
            f"a sync save {out['sync_save_s']:.3f} s, {out['sync_bytes']} "
            f"bytes; B's 6 steps bit-equal to A's: {b_equal} [{card}]")
        if not unpublished:
            raise AssertionError("latest was published before the async "
                                 "save was waited for")

        run_c, loader = loop_engine(template, data)
        t0 = time.perf_counter()
        loaded, client = run_c.load_checkpoint(tmp)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        # the batches the checkpoint's client state says were consumed
        rest = split_steps(run_c, itertools.islice(
            iter(loader), client["batches"], None))
        n = LOOP_SAVE_AT * LOOP_CONFIG["gradient_accumulation_steps"]
        resumed = (all(torch.equal(x, y) for x, y in zip(full[n:], rest))
                   and same_state(ref, engine_state(run_c)))
        t0 = time.perf_counter()
        export = run_c.save_16bit_model(tmp)
        out["export_s"] = time.perf_counter() - t0
        out["export_bytes"] = os.path.getsize(export)
        del run_c

        run_d, loader = loop_engine(template, data)
        run_d.load_checkpoint(tmp, load_optimizer_states=False)
        control = split_steps(run_d, itertools.islice(
            iter(loader), LOOP_SAVE_AT, None))
        control_equal = (all(torch.equal(x, y)
                             for x, y in zip(full[n:], control))
                         and same_state(ref, engine_state(run_d)))
        del run_d
        log(f"  run C: loaded {os.path.basename(loaded)} through latest in "
            f"{out['load_s']:.3f} s; steps {LOOP_SAVE_AT + 1}-{LOOP_STEPS} "
            f"losses {[round(float(x), 4) for x in rest]}; losses, "
            f"parameters and Adam moments bit-equal to run A's: {resumed} "
            f"{'ok' if resumed else 'FAIL'}")
        log(f"  control, loaded with load_optimizer_states=False: bit-equal "
            f"to run A's: {control_equal} (must be False) "
            f"{'ok' if not control_equal else 'FAIL'}; max loss gap "
            f"{max(abs(float(x) - float(y)) for x, y in zip(full[n:], control)):.3e}")
        log(f"  16-bit export (flax msgpack, bf16): {out['export_bytes']} "
            f"bytes in {out['export_s']:.3f} s [{card}]")
        if not resumed:
            raise AssertionError("the resumed run did not continue the "
                                 "uninterrupted one bit for bit")
        if control_equal:
            raise AssertionError("the control resume without the optimizer "
                                 "states matched: the gate cannot fail")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return counts, out


def phase_loop_conventions(card, blocks=2, steps=4):
    """9b: dropout off, train_batch against forward/backward/step on the
    same batches: bit-equal after 2 steps; then the step wall ms of each
    in turns (train_batch, split, split, train_batch per block)."""
    from deepspeed_tpu_torch.models import GPT2_PRESETS
    log("phase 9b: train_batch against forward/backward/step (bf16, dropout "
        f"off, micro 4 x gas 2 x {LOOP_SEQ} tokens)")
    data = loop_data(GPT2_PRESETS["gpt2-125m"].vocab_size, seed=SEED + 1)
    template = loop_model(rate=0.0)
    fused, loader = loop_engine(template, data)
    split, _ = loop_engine(template, data)
    del template
    batches = list(loader)
    micro = LOOP_CONFIG["train_micro_batch_size_per_gpu"]

    def split_step(batch):
        total = torch.zeros((), device=split.device)
        for g in range(LOOP_CONFIG["gradient_accumulation_steps"]):
            loss = split({n: v[g * micro:(g + 1) * micro]
                          for n, v in batch.items()})
            split.backward(loss)
            split.step()
            total += loss.detach()
        return total / LOOP_CONFIG["gradient_accumulation_steps"]

    pairs = [(fused.train_batch(b), split_step(b)) for b in batches[:2]]
    equal = (all(torch.equal(a, b) for a, b in pairs)
             and same_state(engine_state(fused), engine_state(split)))
    log(f"  losses train_batch {[float(a) for a, _ in pairs]}, "
        f"forward/backward/step {[float(b) for _, b in pairs]}; after 2 "
        f"steps losses, parameters and Adam moments bit-equal: {equal} "
        f"{'ok' if equal else 'FAIL'}")
    if not equal:
        raise AssertionError("the two calling conventions disagree with "
                             "dropout off")

    def timed(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(steps):
            step(batches[k % len(batches)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    walls = {"train_batch": [], "split": []}
    fused.train_batch(batches[2]), split_step(batches[2])       # warm
    for _ in range(blocks):
        walls["train_batch"].append(timed(fused.train_batch))
        walls["split"].append(timed(split_step))
        walls["split"].append(timed(split_step))
        walls["train_batch"].append(timed(fused.train_batch))
    ms = {k: float(np.median(v)) for k, v in walls.items()}
    log(f"  step wall ms (median of {2 * blocks} runs of {steps} steps, each "
        f"ending in a synchronize): train_batch {ms['train_batch']:.2f} "
        f"{[round(x, 2) for x in walls['train_batch']]}, forward/backward/"
        f"step {ms['split']:.2f} {[round(x, 2) for x in walls['split']]} "
        f"({ms['split'] / ms['train_batch']:.3f}x) [{card}]")
    del fused, split
    torch.cuda.empty_cache()
    return ms


ADAGRAD_SGD_TOL = 1e-3   # of the largest parameter move (phase 9c)


def phase_adagrad_sgd_parity(card):
    """9c: Adagrad and SGD, card against CPU in fp32 (GPT-2 125M, 2 x 2
    sequences of 128 tokens, 2 steps, clip 1.0): the loss of each step
    within 1e-4; every parameter within ADAGRAD_SGD_TOL of the largest
    move any parameter made. Both updates are Lipschitz in the gradient
    (SGD linear, Adagrad within 1/sqrt(0.1) of it), so fp32 gradients
    that agree to ~1e-5 of their scale move parameters alike to ~1e-5 of
    the largest move; 1e-3 leaves a 100x margin."""
    from deepspeed_tpu_torch.models import GPT2_PRESETS
    log("phase 9c: Adagrad and SGD (momentum 0.9, Nesterov), card against "
        "CPU (fp32, GPT-2 125M, 4 x 128 tokens, 2 steps)")
    vocab = GPT2_PRESETS["gpt2-125m"].vocab_size
    rs = np.random.RandomState(SEED + 21)
    data = {"input_ids": rs.randint(0, vocab, size=(8, 128))
            .astype(np.int32)}
    template = loop_model(rate=0.0, dtype=torch.float32)
    for opt, params in (("Adagrad", {"lr": 1e-2}),
                        ("SGD", {"lr": 0.5, "momentum": 0.9,
                                 "nesterov": True})):
        config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
                  "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
                  "optimizer": {"type": opt, "params": params}}
        runs = {}
        for dev in ("cuda", "cpu"):
            engine, loader = loop_engine(template, data, config=config,
                                         device=dev)
            p0 = [p.detach().cpu().clone() for p in engine.module.parameters()]
            losses = [float(engine.train_batch(b)) for b in loader]
            runs[dev] = (losses, [p.detach().cpu() for p in
                                  engine.module.parameters()], p0)
            del engine
        loss_err = max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                                  runs["cpu"][0]))
        gap = max((a - b).abs().max().item()
                  for a, b in zip(runs["cuda"][1], runs["cpu"][1]))
        move = max((a - b).abs().max().item()
                   for a, b in zip(runs["cpu"][1], runs["cpu"][2]))
        ok = (len(runs["cpu"][0]) == 2 and loss_err <= 1e-4
              and gap <= ADAGRAD_SGD_TOL * move)
        log(f"  {opt}: losses card {runs['cuda'][0]} cpu {runs['cpu'][0]} "
            f"(max diff {loss_err:.3e}, tol 1e-4); parameters max diff "
            f"{gap:.3e} against the largest move {move:.3e} (tol "
            f"{ADAGRAD_SGD_TOL:.0e} x move = {ADAGRAD_SGD_TOL * move:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{opt} on the card and on the CPU disagree")
    torch.cuda.empty_cache()


def phase_loop(card):
    """Phase 9; returns 9a's launch counts and logs its figures (and each
    part's wall seconds) as one JSON line."""
    t0 = time.perf_counter()
    counts, figures = phase_loop_resume(card)
    t1 = time.perf_counter()
    walls = phase_loop_conventions(card)
    t2 = time.perf_counter()
    phase_adagrad_sgd_parity(card)
    t3 = time.perf_counter()
    figures.update({f"{k}_step_ms": v for k, v in walls.items()})
    figures.update({"9a_s": t1 - t0, "9b_s": t2 - t1, "9c_s": t3 - t2})
    log("  phase 9 figures: " + json.dumps({**figures, "card": card}))
    return counts


# --------------------------------------------------------------------------
# phase 10: fp16 with dynamic loss scaling, activation checkpointing, the
# chunked loss, bf16 gradient accumulation and progressive layer drop
# --------------------------------------------------------------------------

FP16_CONFIG = {
    "train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "FusedAdam",
                  "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                             "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_num_steps": 3, "warmup_max_lr": 6e-4}},
    "gradient_clipping": 1.0,
    # 2**26: the fp16 gradients of the first steps overflow (on the H100
    # some of these batches' gradients overflow from 2**24 on; at 2**20
    # three steps grew the scale cleanly); a window of 3 grows it back
    # within the 8 steps, so the run spends and refills hysteresis
    "fp16": {"enabled": True, "initial_scale_power": 26,
             "loss_scale_window": 3, "hysteresis": 2,
             "min_loss_scale": 1.0},
}
FP16_STEPS, FP16_SAVE_AT, FP16_CHUNK = 8, 3, 256
FP16_REMAT = {"none": None, "full": {"remat_policy": "full"},
              "attn_out": {"remat_policy": "attn_out"}}


def fp16_data(vocab, seed=SEED):
    """One seeded [16, 1025] batch a step: 1024 positions and their next
    tokens, so the chunked loss takes 4 chunks of 256."""
    rs = np.random.RandomState(seed + 30)
    return [{"input_ids": rs.randint(0, vocab, size=(16, 1025))
             .astype(np.int32)} for _ in range(FP16_STEPS)]


def gpt_chunked_train_loss(model, batch, rng, train):
    """loss_fn: next-token cross entropy through ``gpt_chunked_loss_fn``
    (no [b, s, vocab] logits)."""
    from deepspeed_tpu_torch.models import gpt_chunked_loss_fn
    ids = batch["input_ids"].long()
    hidden, wte = model(ids[:, :-1], dropout_seed=rng, return_hidden=True)
    return gpt_chunked_loss_fn(hidden, wte, ids[:, 1:], FP16_CHUNK)


def gpt_full_logits_loss(model, batch, rng, train):
    """The same loss over the full [b, s, vocab] logits (``gpt_loss_fn``),
    the chunked loss's memory yardstick."""
    from deepspeed_tpu_torch.models import gpt_loss_fn
    ids = batch["input_ids"].long()
    return gpt_loss_fn(model(ids[:, :-1], dropout_seed=rng), ids[:, 1:])


def _fp16_counters():
    from deepspeed_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                         fused_adam)
    return {"flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd_dkv": (flash_attention_bwd, "dkv_launches"),
            "flash_attention_bwd_dq": (flash_attention_bwd, "dq_launches"),
            "fused_adam": (fused_adam, "launches"),
            "fused_adam_bf16": (fused_adam, "bf16_launches")}


def _scale_fields(engine):
    s = engine.loss_scale_state
    return (float(s.scale), int(s.growth_tracker), int(s.overflows),
            int(s.hysteresis_left))


def _bits(t):
    """A tensor's bits (NaN and inf compare as the bits they are)."""
    return t.detach().contiguous().view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _same_bits(a, b):
    return len(a) == len(b) and all(torch.equal(_bits(x), _bits(y))
                                    for x, y in zip(a, b))


def fp16_run(template, data, config, steps, loss_fn=gpt_chunked_train_loss,
             engine=None):
    """Steps of ``train_batch`` on a copy of ``template`` (or on
    ``engine``): per step the loss tensor, the loss-scale fields, the
    skip count and the wall ms; the launch counts, the peak device memory
    and the engine."""
    import copy
    from deepspeed_tpu_torch import initialize
    if engine is None:
        engine, _, _, _ = initialize(model=copy.deepcopy(template),
                                     config=config, loss_fn=loss_fn,
                                     seed=SEED)
    counters = _fp16_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    rows = []
    for batch in data[:steps]:
        t0 = time.perf_counter()
        loss = engine.train_batch(batch)
        torch.cuda.synchronize()
        rows.append((loss, _scale_fields(engine), engine.skipped_steps,
                     (time.perf_counter() - t0) * 1e3))
    return (rows, read_counters(counters),
            torch.cuda.max_memory_allocated(), engine)


def replay_scale(rows, fp16):
    """The loss-scale trajectory of ``update_scale`` on the host, fed the
    card's own finite flags (a step is finite when it skipped nothing)."""
    from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
        init_loss_scale, update_scale)
    state = init_loss_scale(0.0, fp16["initial_scale_power"],
                            hysteresis=fp16["hysteresis"])
    out, skipped = [], 0
    for _, _, skips, _ in rows:
        finite = skips == skipped
        skipped = skips
        state = update_scale(state, torch.tensor(finite),
                             scale_window=fp16["loss_scale_window"],
                             hysteresis=fp16["hysteresis"],
                             min_scale=fp16["min_loss_scale"])
        out.append((float(state.scale), int(state.growth_tracker),
                    int(state.overflows), int(state.hysteresis_left)))
    return out


def phase_fp16(card):
    """10a and 10b: GPT-2 125M in fp16 through the chunked loss, three
    ways (no remat, ``full``, ``attn_out``), then a save at step 3 and a
    resume through ``latest``. Returns the no-remat run's launch counts."""
    import dataclasses
    import shutil
    import tempfile
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS
    f16 = FP16_CONFIG["fp16"]
    log(f"phase 10a: GPT-2 125M in fp16 (dynamic loss scale from "
        f"2**{f16['initial_scale_power']}, hysteresis {f16['hysteresis']}, "
        f"window {f16['loss_scale_window']}), attention dropout 0.1, "
        f"FusedAdam, micro "
        f"8 x gas 2 x 1024 tokens, gpt_chunked_loss_fn at chunk "
        f"{FP16_CHUNK}, {FP16_STEPS} steps; no remat, remat 'full', remat "
        f"'attn_out' (GEMM flags {list(gemm_flags())})")
    cfg = dataclasses.replace(GPT2_PRESETS["gpt2-125m"], dtype=torch.float16,
                              attn_dropout_rate=0.1)
    template = GPT(cfg, seed=SEED)
    data = fp16_data(cfg.vocab_size)
    fp16 = FP16_CONFIG["fp16"]
    per_attn = cfg.n_layers * FP16_CONFIG["gradient_accumulation_steps"]
    runs = {}
    for name, block in FP16_REMAT.items():
        config = dict(FP16_CONFIG)
        if block is not None:
            config["activation_checkpointing"] = block
        rows, counts, peak, engine = fp16_run(template, data, config,
                                              FP16_STEPS)
        runs[name] = dict(
            rows=rows, counts=counts, peak=peak,
            losses=[r[0] for r in rows],
            params=[p.detach().clone() for p in engine._params],
            grads=[g.clone() for g in engine._grads])
        skipped = rows[-1][2]
        want = {"flash_attention": per_attn * FP16_STEPS
                * (2 if name == "full" else 1),
                "flash_attention_bwd_dkv": per_attn * FP16_STEPS,
                "flash_attention_bwd_dq": per_attn * FP16_STEPS,
                "fused_adam": FP16_STEPS - skipped, "fused_adam_bf16": 0}
        replay = replay_scale(rows, fp16)
        losses = [float(r[0]) for r in rows]
        ms = [r[3] for r in rows]
        log(f"  {name}: losses " + ", ".join(f"{x:.4f}" for x in losses))
        log(f"  {name}: (scale, growth, overflows, hysteresis) per step "
            f"{[r[1] for r in rows]}; skipped {skipped}")
        log(f"  {name}: launches {counts} (want {want}: the flash forward "
            f"{'twice' if name == 'full' else 'once'} a layer and "
            f"microbatch, one optimizer launch a step taken); step wall "
            f"ms {[round(x, 2) for x in ms]}, mean of steps 2-"
            f"{FP16_STEPS} {np.mean(ms[1:]):.2f} ms; peak "
            f"{peak} bytes ({peak / 2 ** 30:.2f} GiB) [{card}]")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"10a {name}: a loss is not finite")
        if [r[1] for r in rows] != replay:
            raise AssertionError(f"10a {name}: the loss-scale trajectory "
                                 f"differs from the host replay {replay}")
        if counts != want:
            raise AssertionError(f"10a {name}: the launch counts differ")
        if not (rows[0][2] == 1 and 0 < skipped < FP16_STEPS):
            raise AssertionError("10a: the first step did not overflow, or "
                                 "no step (or every step) was taken")
        del engine
        torch.cuda.empty_cache()
    base = runs["none"]
    for name in ("full", "attn_out"):
        same = (_same_bits(runs[name]["losses"], base["losses"])
                and _same_bits(runs[name]["params"], base["params"])
                and _same_bits(runs[name]["grads"], base["grads"]))
        log(f"  remat '{name}': losses, last gradients and parameters "
            f"bit-equal to no remat: {same}")
        if not same:
            raise AssertionError(f"10a: remat '{name}' changed the bits")
    # the same steps with the loss over full [8, 1024, 50257] logits
    _, _, full_peak, engine = fp16_run(template, data, FP16_CONFIG, 2,
                                       loss_fn=gpt_full_logits_loss)
    del engine
    torch.cuda.empty_cache()
    log(f"  peak device memory: no remat {base['peak']} bytes, remat full "
        f"{runs['full']['peak']}, remat attn_out {runs['attn_out']['peak']}"
        f"; the loss over full logits (2 steps, no remat) {full_peak} "
        f"[{card}]")
    if not (runs["full"]["peak"] < base["peak"] < full_peak):
        raise AssertionError("10a: remat 'full' does not lower the peak, or "
                             "the chunked loss does not")
    # the host read of the finite flag: a 0-dim device bool to the host
    flag = torch.ones((), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        bool(flag)
    read_us = (time.perf_counter() - t0) / 100 * 1e6
    log(f"  the fp16 step's host read of its finite flag: {read_us:.1f} us "
        f"on an idle card (it also drains the queue: the next step's "
        f"launches start from an empty card) [{card}]")

    log("phase 10b: an fp16 save at step 3 and a resume through 'latest' "
        "repeat the uninterrupted run (losses, loss scale) bit for bit")
    tmp = tempfile.mkdtemp(prefix="fp16_ckpt_")
    try:
        rows_b, _, _, engine = fp16_run(template, data, FP16_CONFIG,
                                        FP16_SAVE_AT)
        engine.save_checkpoint(tmp)
        del engine
        import copy
        from deepspeed_tpu_torch import initialize
        engine, _, _, _ = initialize(model=copy.deepcopy(template),
                                     config=FP16_CONFIG,
                                     loss_fn=gpt_chunked_train_loss,
                                     seed=SEED)
        path, _ = engine.load_checkpoint(tmp)
        rows_c, _, _, engine = fp16_run(template, data[FP16_SAVE_AT:],
                                        FP16_CONFIG,
                                        FP16_STEPS - FP16_SAVE_AT,
                                        engine=engine)
        params_c = [p.detach().clone() for p in engine._params]
        del engine
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    want = base["rows"]
    ok = (path is not None
          and _same_bits([r[0] for r in rows_b],
                         [r[0] for r in want[:FP16_SAVE_AT]])
          and _same_bits([r[0] for r in rows_c],
                         [r[0] for r in want[FP16_SAVE_AT:]])
          and [r[1:3] for r in rows_c] == [r[1:3]
                                          for r in want[FP16_SAVE_AT:]]
          and _same_bits(params_c, base["params"]))
    log(f"  resumed from {os.path.basename(str(path))}: steps "
        f"{FP16_SAVE_AT + 1}-{FP16_STEPS} losses "
        + ", ".join(f"{float(r[0]):.4f}" for r in rows_c)
        + f", scale {[r[1][0] for r in rows_c]}: losses, loss scale, skips "
        f"and final parameters bit-equal to the uninterrupted run: {ok}")
    if not ok:
        raise AssertionError("10b: the resumed fp16 run differs from the "
                             "uninterrupted one")
    return base["counts"]


BERT_PLD_CONFIG = {
    "train_batch_size": 128, "train_micro_batch_size_per_gpu": 32,
    "gradient_accumulation_steps": 4,
    "optimizer": {"type": "FusedLamb",
                  "params": {"lr": 2e-3, "betas": [0.9, 0.999], "eps": 1e-6,
                             "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_num_steps": 3, "warmup_max_lr": 2e-3}},
    "gradient_clipping": 1.0, "bf16": {"enabled": True},
    "data_types": {"grad_accum_dtype": "bf16"},
    "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                               "gamma": 0.001},
}
BF16_ACCUM_CONFIG = {**TRAIN_CONFIG,
                     "data_types": {"grad_accum_dtype": "bf16"}}
# 10c's card-vs-CPU parameter gates (GPT-2 fp32, bf16 buffers, 2 Adam
# steps at lr 1e-4): the mean |diff| and the share of elements more than
# lr / 100 apart. Readings on an H100: sound 7.65e-9 and 7.4e-5; fp32
# buffers on the card (the planted fault) 1.167e-7 and 5.86e-3
BF16_ACCUM_MEAN_TOL = 3e-8
BF16_ACCUM_SHARE_TOL = 1e-3


def bert_pld_loss(model, batch, rng, train, layer_keep_prob=None):
    """loss_fn of BertForPreTraining taking PLD's keep probability."""
    from deepspeed_tpu_torch.models import bert_pretrain_loss
    mlm, nsp = model(batch["input_ids"].long(),
                     token_type_ids=batch["token_type_ids"].long(),
                     dropout_seed=rng, layer_keep_prob=layer_keep_prob)
    return bert_pretrain_loss(mlm, nsp, batch["mlm_labels"],
                              batch["nsp_labels"])


def phase_bf16_accum(card):
    """10c: BERT-base bf16 with bf16 gradient accumulation, PLD and
    FusedLamb; GPT-2 125M bf16 with bf16 accumulation and FusedAdam; an
    fp32 GPT-2 with bf16 accumulation, card against CPU. Returns the
    launch counts of the bf16-gradient kernels."""
    import copy
    import dataclasses
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import (BERT_PRESETS, GPT, GPT2_PRESETS,
                                            BertForPreTraining)
    from deepspeed_tpu_torch.ops import fused_lamb
    log("phase 10c: BERT-base (bf16, attention dropout 0.1, 128 tokens, "
        "micro 32 x gas 4) with bf16 gradient accumulation, progressive "
        "layer drop (theta 0.5, gamma 0.001) and FusedLamb, 8 steps "
        f"(GEMM flags {list(gemm_flags())})")
    bcfg = dataclasses.replace(BERT_PRESETS["bert-base"], max_seq_len=128,
                               attn_dropout_rate=0.1)
    engine, _, _, _ = initialize(model=BertForPreTraining(bcfg, seed=SEED),
                                 config=BERT_PLD_CONFIG, loss_fn=bert_pld_loss,
                                 seed=SEED)
    counters = {**_fp16_counters(),
                "fused_lamb": (fused_lamb, "phase1_launches"),
                "fused_lamb_bf16": (fused_lamb, "bf16_phase1_launches"),
                "fused_lamb_apply": (fused_lamb, "apply_launches")}
    batches = [bert_batch(128, 128, bcfg.vocab_size, SEED + 40 + i)
               for i in range(8)]
    torch.cuda.synchronize()
    reset_counters(counters)
    losses, thetas, marks = [], [], [time.perf_counter()]
    for batch in batches:
        losses.append(float(engine.train_batch(batch)))
        thetas.append(engine.progressive_layer_drop.get_theta())
        marks.append(time.perf_counter())
    bert_counts = read_counters(counters)
    per_attn = bcfg.n_layers * 4 * 8
    want = {"flash_attention": per_attn, "flash_attention_bwd_dkv": per_attn,
            "flash_attention_bwd_dq": per_attn, "fused_adam": 0,
            "fused_adam_bf16": 0, "fused_lamb": 0, "fused_lamb_bf16": 8,
            "fused_lamb_apply": 8}
    buf = sum(g.numel() * g.element_size() for g in engine._grads)
    log(f"  losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; theta per step {[round(float(t), 6) for t in thetas]}; step "
        f"wall {(marks[-1] - marks[1]) / 7 * 1e3:.2f} ms (mean of steps 2-8); "
        f"gradient buffers {buf} bytes (bf16) [{card}]")
    log(f"  launches {bert_counts} (want {want})")
    if not all(np.isfinite(losses)) or bert_counts != want:
        raise AssertionError("10c BERT: a loss is not finite or the "
                             "bf16-gradient LAMB did not run once a step")
    del engine
    torch.cuda.empty_cache()

    log("phase 10c: GPT-2 125M (bf16, attention dropout 0.1) with bf16 "
        "gradient accumulation and FusedAdam, 4 steps")
    gcfg = dataclasses.replace(GPT2_PRESETS["gpt2-125m"],
                               attn_dropout_rate=0.1)
    rs = np.random.RandomState(SEED + 4)
    batch = {"input_ids": rs.randint(0, gcfg.vocab_size, size=(16, 1024))
             .astype(np.int32)}
    torch.cuda.reset_peak_memory_stats()
    engine, _, _, _ = initialize(model=GPT(gcfg, seed=SEED),
                                 config=BF16_ACCUM_CONFIG,
                                 loss_fn=gpt_train_loss, seed=SEED)
    reset_counters(counters)
    losses, marks = [], [time.perf_counter()]
    for _ in range(4):
        losses.append(float(engine.train_batch(batch)))
        marks.append(time.perf_counter())
    gpt_counts = read_counters(counters)
    peak_bf16 = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in engine._params)
    saved = sum(p.numel() * 4 - g.numel() * g.element_size()
                for p, g in zip(engine._params, engine._grads))
    del engine
    torch.cuda.empty_cache()
    # the same model and batch with fp32 gradient buffers: the peak that
    # bf16 accumulation has to beat (2 steps: the peak is a step's)
    torch.cuda.reset_peak_memory_stats()
    engine, _, _, _ = initialize(model=GPT(gcfg, seed=SEED),
                                 config=TRAIN_CONFIG,
                                 loss_fn=gpt_train_loss, seed=SEED)
    for _ in range(2):
        float(engine.train_batch(batch))
    peak_fp32 = torch.cuda.max_memory_allocated()
    del engine
    torch.cuda.empty_cache()
    log(f"  losses " + ", ".join(f"{x:.4f}" for x in losses) + f"; step "
        f"wall {(marks[-1] - marks[1]) / 3 * 1e3:.2f} ms (mean of steps "
        f"2-4; 5a's batch, GEMM flags off) [{card}]; "
        f"fused_adam_bf16 launches {gpt_counts['fused_adam_bf16']}, "
        f"fused_adam (fp32 gradients) {gpt_counts['fused_adam']}; gradient "
        f"buffers {n} x 2 bytes: {saved} bytes saved against fp32 "
        f"({n} x 2 = {n * 2}); peak device memory {peak_bf16} bytes with "
        f"bf16 buffers, {peak_fp32} with fp32 ones (max_memory_allocated; "
        f"{peak_fp32 - peak_bf16} lower)")
    if (not all(np.isfinite(losses)) or gpt_counts["fused_adam_bf16"] != 4
            or gpt_counts["fused_adam"] != 0 or saved != n * 2):
        raise AssertionError("10c GPT: a loss is not finite or the "
                             "bf16-gradient Adam did not run once a step")
    if peak_bf16 >= peak_fp32:
        raise AssertionError("10c GPT: bf16 gradient accumulation does not "
                             "lower the peak device memory")

    log("phase 10c: card against CPU, GPT-2 125M fp32 with bf16 gradient "
        "accumulation (FusedAdam, attention dropout 0.1, 4 x 128 tokens, 2 "
        "steps)")
    cfg = dataclasses.replace(GPT2_PRESETS["gpt2-125m"], dtype=torch.float32,
                              attn_dropout_rate=0.1)
    lr = 1e-4
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
              "data_types": {"grad_accum_dtype": "bf16"},
              "optimizer": {"type": "FusedAdam",
                            "params": {"lr": lr, "weight_decay": 0.1}}}
    rs = np.random.RandomState(SEED + 5)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size, size=(4, 128))
             .astype(np.int32)}
    template = GPT(cfg, seed=SEED)
    runs = {}
    # "planted": the card with fp32 buffers, a bf16-accumulation path that
    # never rounds; the parameter gates must tell it from the sound one
    fp32_config = {k: v for k, v in config.items() if k != "data_types"}
    for run, dev, cfg_run in (("cuda", "cuda", config), ("cpu", "cpu", config),
                              ("planted", "cuda", fp32_config)):
        engine, _, _, _ = initialize(model=copy.deepcopy(template),
                                     config=cfg_run, loss_fn=gpt_train_loss,
                                     seed=SEED, device=dev)
        reset_counters(counters)
        losses = [float(engine.train_batch(batch)) for _ in range(2)]
        if run == "cuda":
            parity_counts = read_counters(counters)
        runs[run] = (losses, [p.detach().cpu() for p in engine._params],
                     engine.get_global_grad_norm())
        del engine
    loss_err = max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                              runs["cpu"][0]))

    def gaps(run):
        """max and mean |diff| to the CPU run, and the share of elements
        more than lr / 100 apart."""
        d = torch.cat([(a - b).abs().flatten()
                       for a, b in zip(runs[run][1], runs["cpu"][1])])
        return (d.max().item(), d.mean().item(),
                (d > lr / 100).double().mean().item())
    (p_max, p_mean, p_share), planted = gaps("cuda"), gaps("planted")
    # Adam's step bound (phase 5b): 2 lr a step, which any two Adam runs
    # meet; the mean and the share of elements apart are what a wrong
    # rounding moves (a bf16 buffer rounding a gradient to the
    # neighbouring bf16 value on one device moves only that element)
    p_tol = 4 * lr
    ok = (loss_err <= 1e-4 and p_max <= p_tol
          and p_mean <= BF16_ACCUM_MEAN_TOL
          and p_share <= BF16_ACCUM_SHARE_TOL
          and parity_counts["fused_adam_bf16"] == 2)
    blind = (planted[1] <= BF16_ACCUM_MEAN_TOL
             or planted[2] <= BF16_ACCUM_SHARE_TOL)
    log(f"  losses card {runs['cuda'][0]} cpu {runs['cpu'][0]}: max diff "
        f"{loss_err:.3e} (tol 1e-4); grad norm card {runs['cuda'][2]:.6f} "
        f"cpu {runs['cpu'][2]:.6f}; parameters after 2 steps: max diff "
        f"{p_max:.3e} (tol 4 lr = {p_tol:.0e}), mean diff {p_mean:.3e} "
        f"(tol {BF16_ACCUM_MEAN_TOL:.1e}), share of elements > lr/100 apart "
        f"{p_share:.3e} (tol {BF16_ACCUM_SHARE_TOL:.1e}); card launches of "
        f"fused_adam_bf16 {parity_counts['fused_adam_bf16']} "
        f"{'ok' if ok else 'FAIL'}")
    log(f"  planted fault (card with fp32 buffers against the CPU's bf16): "
        f"losses {runs['planted'][0]}, parameters max diff {planted[0]:.3e}, "
        f"mean diff {planted[1]:.3e}, share > lr/100 {planted[2]:.3e}: "
        f"{'caught by both gates' if not blind else 'NOT CAUGHT'}")
    if not ok:
        raise AssertionError("10c: bf16 accumulation on the card and on "
                             "the CPU disagree")
    if blind:
        raise AssertionError("10c: the parameter gates do not tell fp32 "
                             "buffers from bf16 ones")
    return {"fused_adam_bf16": gpt_counts["fused_adam_bf16"],
            "fused_lamb_bf16": bert_counts["fused_lamb_bf16"],
            "fused_lamb_apply": bert_counts["fused_lamb_apply"]}


def phase_training_modes(card):
    """Phase 10; returns the launch counts of its kernel instances."""
    t0 = time.perf_counter()
    counts = phase_fp16(card)
    t1 = time.perf_counter()
    counts.update(phase_bf16_accum(card))
    log(f"  phase 10 wall: 10a+10b {t1 - t0:.1f} s, 10c "
        f"{time.perf_counter() - t1:.1f} s")
    return counts


# --------------------------------------------------------------------------
# phase 11: a HuggingFace-layout checkpoint served through injection
# --------------------------------------------------------------------------

# EleutherAI/pythia-1.4b's config.json (the HuggingFace Hub), the fields
# the GPT-NeoX policy reads; the weights are drawn from SEED
PYTHIA_1_4B = {
    "model_type": "gpt_neox", "architectures": ["GPTNeoXForCausalLM"],
    "hidden_size": 2048, "num_attention_heads": 16,
    "num_hidden_layers": 24, "intermediate_size": 8192, "rotary_pct": 0.25,
    "rotary_emb_base": 10000, "max_position_embeddings": 2048,
    "vocab_size": 50304, "use_parallel_residual": True, "hidden_act": "gelu",
    "layer_norm_eps": 1e-5, "tie_word_embeddings": False,
    "torch_dtype": "float16"}
# 11a, 11c: 12 of the 24 layers, full width (the checkpoint's host
# round trip scales with depth; a slow host took 1,040 s of the 1,200 s
# limit at 24 layers with phase 12)
PYTHIA_LAYERS = 12
PARITY_LAYERS = 2           # 11b: fp32 parity at the same widths
CACHE_STEPS = 8             # 11b: decode steps against the cache-free forward
# 11a, 11c: a first token may differ from generate()'s where the
# reference top-2 gap is within this many bf16 ulps of the top logit
# (the chip runs' first tokens: one of 24 requests, at 2 ulps)
BF16_TIE_ULPS = 2
# 14a, 14c: the same rule in fp16 ulps. The dense GEMMs still round a
# row by the batch's m, by a few output ulps, and an fp16 ulp is 8x finer
# than a bf16 one: 4 fp16 ulps is half a bf16 ulp, still below 11a's 2
# bf16 ulps in absolute terms
FP16_TIE_ULPS = 4
BERT_BASE = (768, 12)       # 11e: BERT-base's width and heads


def hf_dir(path, fields):
    """Write ``config.json`` as ``save_pretrained`` would: only the fields
    that differ from HuggingFace's defaults for the model type (and the
    model type, architecture and dtype); returns the port's reading of it
    and the fields written."""
    from deepspeed_tpu_torch.module_inject import read_hf_config
    from deepspeed_tpu_torch.module_inject.load_checkpoint import \
        HF_CONFIG_DEFAULTS
    defaults = HF_CONFIG_DEFAULTS[fields["model_type"]]
    written = {k: v for k, v in fields.items()
               if k not in defaults or defaults[k] != v}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(written, f, indent=2)
    return read_hf_config(path), written


def pythia_dir(path, n_layers):
    return hf_dir(path, {**PYTHIA_1_4B, "num_hidden_layers": n_layers})


def draw_model(ns, dtype):
    """The port's GPT at the configuration ``ns`` as its model type's
    policy builds it (fp32 parameters), weights from SEED, and its
    config."""
    from deepspeed_tpu_torch.models import GPT
    from deepspeed_tpu_torch.module_inject import POLICY_REGISTRY
    cfg = POLICY_REGISTRY[ns.model_type].build_config(ns, dtype)
    return GPT(cfg, seed=SEED), cfg


def write_sharded_bin(path, state, n_shards=2):
    """``state`` (name -> tensor) as ``pytorch_model-0000i-of-0000n.bin``
    shards and ``pytorch_model.bin.index.json``, as ``save_pretrained``
    writes a sharded torch checkpoint; returns the bytes written."""
    names = list(state)
    per = -(-len(names) // n_shards)
    weight_map, total = {}, 0
    for i in range(n_shards):
        fname = f"pytorch_model-{i + 1:05d}-of-{n_shards:05d}.bin"
        part = {k: state[k] for k in names[i * per:(i + 1) * per]}
        torch.save(part, os.path.join(path, fname))
        weight_map.update({k: fname for k in part})
        total += sum(t.numel() * t.element_size() for t in part.values())
    with open(os.path.join(path, "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return total


def _ln_key(key):
    return "layernorm" in key or "layer_norm" in key


def write_checkpoint(tmp, ns, written):
    """The model of the configuration ``ns`` drawn from SEED, exported to
    HuggingFace's layout in fp16 and written to ``tmp`` as a sharded torch
    checkpoint beside its config.json; returns the fp16 tensors."""
    from deepspeed_tpu_torch.module_inject import export_hf_state_dict
    t0 = time.perf_counter()
    model, cfg = draw_model(ns, torch.bfloat16)
    t1 = time.perf_counter()
    fp16 = {k: torch.from_numpy(v).half() for k, v in
            export_hf_state_dict(ns.model_type, model, cfg).items()}
    del model
    nbytes = write_sharded_bin(tmp, fp16)
    t2 = time.perf_counter()
    log(f"  config.json {written}")
    log(f"  drew the model in {t1 - t0:.1f} s; exported and wrote "
        f"{len(fp16)} fp16 tensors, {nbytes} bytes in 2 shards in "
        f"{t2 - t1:.1f} s")
    return fp16


def load_written_checkpoint(card, tmp, ns, written, phase):
    """The model of the configuration ``ns`` drawn from SEED, exported to
    HuggingFace's layout in fp16, written to ``tmp`` as a sharded torch
    checkpoint beside its config.json (the non-default fields
    ``written``), loaded through ``init_inference(config, checkpoint=dir,
    replace_with_kernel_inject=True, dtype=bf16)``: the checkpoint must
    read back bit-equal and the model hold its bf16 rounding (LayerNorms
    fp32). Returns (engine, load seconds, parameter bytes on the card)."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.module_inject import export_hf_state_dict
    from deepspeed_tpu_torch.module_inject.load_checkpoint import \
        load_state_dict_from_checkpoint
    fp16 = write_checkpoint(tmp, ns, written)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = init_inference(ns, checkpoint=tmp,
                            replace_with_kernel_inject=True,
                            dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    n_params = sum(p.numel() for p in engine.module.parameters())
    log(f"  init_inference(config, checkpoint=dir, replace_with_kernel_"
        f"inject=True, dtype=bf16): {load_s:.1f} s; {n_params} parameters, "
        f"torch.cuda.memory_allocated() {held} bytes after the load [{card}]")
    # the reader is bit-exact, and the model holds the checkpoint rounded
    # once to bf16 (LayerNorms in fp32, as JAX's)
    read = load_state_dict_from_checkpoint(tmp)
    back = export_hf_state_dict(ns.model_type, engine.module,
                                engine.module.config)
    bad_read = [k for k, t in fp16.items()
                if not np.array_equal(read[k], t.float().numpy())]
    bad_held = [k for k, t in fp16.items() if not np.array_equal(
        back[k], (t.float() if _ln_key(k) else t.bfloat16().float()).numpy())]
    log(f"  checkpoint read back bit-equal to the export: "
        f"{len(fp16) - len(bad_read)}/{len(fp16)} tensors; the served "
        f"model's weights equal to the checkpoint's bf16 rounding: "
        f"{len(fp16) - len(bad_held)}/{len(fp16)}")
    if bad_read or bad_held or set(read) != set(fp16):
        raise AssertionError(f"{phase}: the loaded state differs from the "
                             f"exported one: {(bad_read + bad_held)[:5]}")
    return engine, load_s, held


def serve_injected(engine, card, phase, profile=False):
    """Phase 6's trace served paged on an injected bf16 (or fp16) engine,
    launch counts exact; first tokens against ``generate()`` (the
    ``BF16_TIE_ULPS`` rule, fp16: ``FP16_TIE_ULPS``; the rest
    classified), with the decode launches of those ``generate()`` calls
    exact; tokens/s, KV pool bytes and the paged decode wall ms at 16
    slots (``profile``: and its device busy ms). Returns (launch counts,
    readings, the served tokens)."""
    from deepspeed_tpu_torch.ops import decode_attention
    cfg = engine.module.config
    fp16 = cfg.dtype == torch.float16
    prompts, outs = paged_traffic(cfg.vocab_size)
    reqs, srv, counts, wall = serve_paged(engine, prompts, outs,
                                          PAGED_CONFIG)
    torch.cuda.synchronize()
    decode_attention.launches = 0
    agree = check_against_generate(
        engine, reqs, prompts, outs, GAP_STOP,
        f"{phase} {str(cfg.dtype)[6:]}", first_token_only=True,
        first_tie_ulps=FP16_TIE_ULPS if fp16 else BF16_TIE_ULPS,
        ulp=fp16_ulp if fp16 else bf16_ulp)
    torch.cuda.synchronize()
    counts["generate_decode_attention"] = decode_attention.launches
    want = cfg.n_layers * sum(o - 1 for o in outs)
    log(f"  the generate() references: {decode_attention.launches} decode "
        f"launches (want {want}: {cfg.n_layers} layers x the "
        f"{sum(o - 1 for o in outs)} decode steps of {len(outs)} requests)")
    if decode_attention.launches != want:
        raise AssertionError(f"{phase}: generate() did not decode through "
                             "the decode kernel")
    tokens = srv.metrics.tokens_generated
    pool = srv._paged.pool_bytes()
    log(f"  serving: {tokens} tokens, {srv.metrics.decode_iterations} decode "
        f"iterations, {srv.metrics.prefill_chunks} prefill chunks, wall "
        f"{wall:.3f} s, {tokens / wall:.1f} tokens/s; KV pool {pool} bytes "
        f"[{card}]")
    run_decode = _paged_decode_runner(srv, engine.module,
                                      served_lengths(16, SEED + 7))
    decode = wall_ms(run_decode, iters=20)
    log(f"  paged decode wall ms per iteration (16 slots): {decode:.3f} "
        f"[{card}]")
    busy = (device_profile(f"{phase} paged decode", run_decode, decode, card)
            if profile else None)
    return counts, {"tokens_per_s": tokens / wall, "decode_wall_ms": decode,
                    "pool_bytes": pool, "generate_agreement": agree,
                    "decode_busy_ms": busy}, [
                        list(r.output_tokens) for r in reqs]


def host_peak_rss():
    """This process's peak resident host memory so far, in bytes."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def phase_inject_serve(card, tmp, profile=False):
    """11a: Pythia-1.4B drawn from SEED, exported to HuggingFace's layout in
    fp16, written as a sharded torch checkpoint with a config.json of the
    non-default fields, loaded through ``init_inference(config, checkpoint=
    dir, replace_with_kernel_inject=True, dtype=bf16)`` and served paged
    (phase 6's trace). Returns (engine, launch counts, readings)."""
    log(f"phase 11a: Pythia-1.4B ({PYTHIA_LAYERS} layers) written as a "
        "HuggingFace checkpoint, loaded through checkpoint injection, served "
        "paged in bf16")
    ns, written = pythia_dir(tmp, PYTHIA_LAYERS)
    engine, load_s, held = load_written_checkpoint(card, tmp, ns, written,
                                                   "11a")
    icfg = engine.module.config
    if not (engine.injected and icfg.rotary
            and icfg.rotary_dim == icfg.head_dim // 4):     # rotary_pct 0.25
        raise AssertionError("11a: not an injected rotary model")
    counts, readings, _ = serve_injected(engine, card, "11a", profile)
    readings.update(load_s=load_s, param_bytes=held,
                    host_peak_rss=host_peak_rss())
    log(f"  host peak RSS so far {readings['host_peak_rss']} bytes")
    return engine, counts, readings


def phase_inject_int8(engine, card):
    """11c: int8 weights on the loaded checkpoint, served paged, against
    the int8 model's own ``generate()``: first tokens exact (11a's tie
    rule), the rest classified. 6c's token-exact gate needs every op of a
    decode step to round a row alike at 16 rows and at 1; at d 2048 the
    eager LayerNorm's fp32 variance does not (torch's reduction splits a
    row by the row count; PERF.md's tolerance table)."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.module_inject.module_quantize import \
        quantized_nbytes
    log("phase 11c: the loaded checkpoint with int8 weights, served paged")
    engine_int8 = init_inference(engine.module, quantize_weights=True)
    prompts, outs = paged_traffic(engine.module.config.vocab_size)
    config = {**PAGED_CONFIG, "quantize": {"weights": "int8"}}
    reqs, srv, counts, wall = serve_paged(engine_int8, prompts, outs, config)
    if srv.module is not engine_int8.module:
        raise AssertionError("11c: the server re-quantized an int8 model")
    nb = quantized_nbytes(engine_int8.module)
    log(f"  weights {nb['quantized']} bytes int8 against "
        f"{nb['dense_equivalent']} bf16-equivalent; served "
        f"{srv.metrics.tokens_generated} tokens in {wall:.3f} s "
        f"({srv.metrics.tokens_generated / wall:.1f} tokens/s) [{card}]")
    check_against_generate(engine_int8, reqs, prompts, outs, GAP_STOP,
                           "11c int8 weights", first_token_only=True,
                           first_tie_ulps=BF16_TIE_ULPS)
    # why 6c's gate cannot hold here: the LayerNorm variance of a row at
    # 16 rows against the same row alone (seeded bf16 rows, d 2048)
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x = torch.randn(16, 1, engine.module.config.d_model, generator=g,
                    device="cuda").bfloat16().float() * 3

    def var(t):
        return (t - t.mean(-1, keepdim=True)).square().mean(-1)
    alone = torch.cat([var(x[i:i + 1]) for i in range(16)])
    diff = (var(x) - alone).abs()
    log(f"  LayerNorm variance at 16 rows against each row alone: "
        f"{int((diff > 0).sum())} of 16 rows differ, by up to "
        f"{diff.max().item():.3e} [{card}]")
    del reqs, srv
    int8_in_turns(engine, engine_int8, prompts, outs, config, card)
    return counts


def int8_in_turns(engine, engine_int8, prompts, outs, config, card):
    """bf16 and int8 weights in turns in one process (bf16, int8, int8,
    bf16): the whole trace served paged, then 20 decode iterations at 16
    slots on that server; logs each turn's tokens/s and decode wall ms."""
    lengths = served_lengths(16, SEED + 7)
    turns = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        eng, cfg = ((engine, PAGED_CONFIG) if name == "bf16"
                    else (engine_int8, config))
        _, srv, _, wall = serve_paged(eng, prompts, outs, cfg)
        decode = wall_ms(_paged_decode_runner(srv, eng.module, lengths),
                         iters=20)
        turns[name].append((srv.metrics.tokens_generated / wall, decode))
        del srv
        torch.cuda.empty_cache()
    for name, runs in turns.items():
        log(f"  in turns, {name} weights: tokens/s "
            f"{[round(t, 1) for t, _ in runs]}, paged decode wall ms "
            f"{[round(d, 3) for _, d in runs]} [{card}]")
    (b1, b2), (i1, i2) = turns["bf16"], turns["int8"]
    log(f"  int8 / bf16 in turns: tokens/s "
        f"{(i1[0] + i2[0]) / (b1[0] + b2[0]):.3f}, decode wall ms "
        f"{(i1[1] + i2[1]) / (b1[1] + b2[1]):.3f} [{card}]")


def paged_step_err(model, prompt, steps=CACHE_STEPS):
    """Logits of the paged engine's own decode iteration
    (``_paged_decode_iter_impl``, which places the token's position) over
    a pool holding ``prompt`` (page-aligned, written through the chunk
    scatter) against the contiguous cache path's decode steps at the same
    positions; returns the largest difference over ``steps`` steps."""
    from deepspeed_tpu_torch.inference.cache import (
        gather_pages, init_page_pool, scatter_chunk_pages)
    from deepspeed_tpu_torch.inference.generation import (_sampling_mode,
                                                          init_cache)
    from deepspeed_tpu_torch.serving.paging.manager import \
        _paged_decode_iter_impl
    dev, n = model.wte.device, len(prompt)
    page = PAGED_CONFIG["paging"]["page_len"]
    ids = torch.tensor(prompt[None], device=dev).long()
    table = torch.zeros(1, 8, dtype=torch.int32, device=dev)
    table[0, :8] = torch.arange(1, 9)
    pool = init_page_pool(model, 9, page)
    seen = []
    hook = model.register_forward_hook(
        lambda m, a, out: seen.append(out[:, -1].float()))
    with torch.no_grad():
        row = gather_pages(pool, table, dequant_dtype=model.config.dtype)
        row.index = 0
        model(ids, positions=torch.arange(n, device=dev), cache=row)
        scatter_chunk_pages(pool, row.k[:, 0, :, :n], row.v[:, 0, :, :n],
                            table[0, :n // page])
        cache = init_cache(model, 1, n + steps + 1)
        model(ids, positions=torch.arange(n, device=dev), cache=cache)
        tok = torch.tensor([int(prompt[-1])], device=dev)
        state = {"lengths": torch.tensor([n], dtype=torch.int32, device=dev),
                 "last_token": tok, "active": torch.ones(
                     1, dtype=torch.bool, device=dev),
                 "remaining": torch.full((1,), 10 ** 6, dtype=torch.int32,
                                         device=dev)}
        err = 0.0
        for i in range(steps):
            seen.clear()
            state, _, _ = _paged_decode_iter_impl(
                model, pool, table, state, None, -1,
                _sampling_mode(None, None, None), True)
            paged = seen[-1]
            ref = model(tok[:, None], positions=torch.tensor(
                [[n + i]], device=dev), cache=cache)[:, -1].float()
            err = max(err, (paged - ref).abs().max().item())
            tok = state["last_token"]
    hook.remove()
    return err


def phase_inject_parity(card, n_layers=PARITY_LAYERS, write_dir=pythia_dir,
                        name="Pythia-1.4B", phase="11b"):
    """11b (12b): Pythia-1.4B's (GPT-J-6B's) widths at ``n_layers`` layers,
    fp32, injected from its HuggingFace-layout state dict: the state
    round-trips bit for bit; card logits against the CPU's; the cache path
    (prefill, then decode steps) against the cache-free forward;
    contiguous and paged serving and a ragged ``generate()`` token-exact
    against ``generate()`` (near-tie rule), with exact launch counts.
    Returns the launch counts."""
    import tempfile
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.generation import init_cache
    from deepspeed_tpu_torch.module_inject import export_hf_state_dict
    from deepspeed_tpu_torch.ops import decode_attention, flash_attention
    log(f"phase {phase}: fp32 parity at {name}'s widths, {n_layers} layers")
    with tempfile.TemporaryDirectory() as tmp:
        ns, _ = write_dir(tmp, n_layers)
    src, cfg = draw_model(ns, torch.float32)
    sd = export_hf_state_dict(ns.model_type, src, cfg)
    del src
    engine = init_inference(ns, checkpoint=dict(sd),
                            replace_with_kernel_inject=True,
                            dtype=torch.float32)
    back = export_hf_state_dict(ns.model_type, engine.module,
                                engine.module.config)
    bad = [k for k in sd if not np.array_equal(back[k], sd[k])]
    log(f"  the injected state exports back bit-equal: "
        f"{len(sd) - len(bad)}/{len(sd)} tensors")
    if bad or set(back) != set(sd):
        raise AssertionError(f"{phase}: the injected state differs from the "
                             f"checkpoint: {bad[:5]}")
    cpu = init_inference(ns, checkpoint=dict(sd),
                         replace_with_kernel_inject=True,
                         dtype=torch.float32, device="cpu")
    del sd
    rs = np.random.RandomState(SEED + 11)
    tol = 2e-3      # 4c's gate
    vocab = cfg.vocab_size
    for n in (48, 100):
        ids = rs.randint(0, vocab, size=(1, n))
        out = engine(torch.tensor(ids, device="cuda")).float().cpu()
        ref = cpu(torch.tensor(ids)).float()
        err = (out - ref).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= tol
        log(f"  prompt of {n}: card logits against the CPU's max_abs_err "
            f"{err:.3e} tol {tol:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{phase}: card and CPU logits disagree")
    del cpu
    # the cache path against the cache-free forward, on the card
    model = engine.module
    seq = torch.tensor(rs.randint(0, vocab, size=(1, 100 + CACHE_STEPS)),
                       device="cuda")
    with torch.no_grad():
        full = model(seq).float()
        cache = init_cache(model, 1, 128)
        got = [model(seq[:, :100], positions=torch.arange(100, device="cuda"),
                     cache=cache)[:, -1].float()]
        for i in range(CACHE_STEPS - 1):
            got.append(model(seq[:, 100 + i:101 + i], positions=torch.tensor(
                [100 + i], device="cuda"), cache=cache)[:, -1].float())
    err = max((g - full[:, 99 + i]).abs().max().item()
              for i, g in enumerate(got))
    log(f"  prefill and {CACHE_STEPS - 1} decode steps through the cache "
        f"against the cache-free forward: max_abs_err {err:.3e} tol "
        f"{tol:.0e} {'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError(f"{phase}: the cache path disagrees with the "
                             "cache-free forward")
    err = paged_step_err(model, rs.randint(
        0, vocab, size=2 * PAGED_CONFIG["paging"]["page_len"]))
    log(f"  {CACHE_STEPS} paged decode iterations (the serving engine's) "
        f"against the cache path's decode steps: max_abs_err {err:.3e} tol "
        f"{tol:.0e} {'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError(f"{phase}: the paged decode iteration "
                             "disagrees with the cache path")
    counts = phase_fp32(model, *traffic(vocab), SERVING_CONFIG,
                        label=f"phase {phase}: contiguous fp32 serving")
    prompts, outs = paged_traffic(vocab)
    reqs, _, paged_counts, _ = serve_paged(engine, prompts, outs,
                                           PAGED_CONFIG)
    check_against_generate(engine, reqs, prompts, outs, GAP_STOP,
                           f"{phase} paged fp32")
    # a ragged generate() over 8 prompts against each prompt's own
    ragged_prompts = prompts[:8]
    lens = [len(p) for p in ragged_prompts]
    ids = np.zeros((len(lens), max(lens)), np.int64)
    for row, p in enumerate(ragged_prompts):
        ids[row, :len(p)] = p
    new = 16
    torch.cuda.synchronize()
    flash_attention.launches = decode_attention.launches = 0
    ragged = engine.generate(ids, max_new_tokens=new,
                             prompt_lengths=lens).cpu().numpy()
    torch.cuda.synchronize()
    rc = {"flash_attention": flash_attention.launches,
          "decode_attention": decode_attention.launches}
    want = {"flash_attention": n_layers, "decode_attention":
            n_layers * (new - 1)}
    log(f"  ragged generate() launches {rc} (want {want})")
    if rc != want:
        raise AssertionError(f"{phase}: the ragged generate() did not go "
                             "through the flash and decode kernels")
    for row, p in enumerate(ragged_prompts):
        ref = engine.generate(p[None], max_new_tokens=new)[0, len(p):]
        ref = ref.cpu().numpy()
        gaps, _ = top2_gaps(model, p, ref)
        near = np.nonzero(gaps < GAP_STOP)[0]
        upto = int(near[0]) if near.size else new
        got = ragged[row, len(p):len(p) + new]
        if not np.array_equal(got[:upto], ref[:upto]):
            raise AssertionError(
                f"{phase}: ragged row {row} {got.tolist()} != generate() "
                f"{ref.tolist()} (up to {upto})")
    log(f"  ragged generate(): {len(lens)}/{len(lens)} rows token-exact "
        "against generate() up to their first near tie")
    return {"flash_attention": counts["flash_attention"],
            "decode_attention": counts["decode_attention"],
            "paged_attention": paged_counts["paged_attention"]}


# 11d's head dim: one that neither flash kernel takes (GPT-J-6B's 256 is
# taken by both since the backward's d-256 instances)
UNTAKEN_HEAD_DIM = 160


def phase_inject_refusal():
    """11d: a flash forward at a head dim no flash kernel takes
    (``UNTAKEN_HEAD_DIM``; 16 heads, bf16) whose q requires a gradient is
    refused by name, naming the kernels' head dims, before any launch or
    device allocation."""
    from deepspeed_tpu_torch.ops import flash_attention
    from deepspeed_tpu_torch.ops.flash_attention import BWD_HEAD_DIMS
    d = UNTAKEN_HEAD_DIM
    log(f"phase 11d: a head-dim-{d} flash forward that needs a gradient "
        "refused")
    g = torch.Generator(device="cuda").manual_seed(SEED + 16)
    q, k, v = (torch.randn(1, 128, 16, d, generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    q.requires_grad_()
    torch.cuda.synchronize()
    before, launches = torch.cuda.memory_allocated(), flash_attention.launches
    t0 = time.perf_counter()
    try:
        flash_attention(q, k, v, causal=True)
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError(f"11d: a d-{d} forward with a gradient was not "
                             "refused")
    after = torch.cuda.memory_allocated()
    log(f"  ValueError in {time.perf_counter() - t0:.3f} s: {msg}; device "
        f"memory {before} -> {after} bytes, flash launches "
        f"{flash_attention.launches - launches}")
    if (f"got {d}" not in msg or str(BWD_HEAD_DIMS) not in msg
            or after != before or flash_attention.launches != launches):
        raise AssertionError("11d: the refusal does not name the head dim "
                             "and the kernels' dims, or came after an "
                             "allocation or a launch")


def phase_bert_sparse_hf(card):
    """11e: ``BertSparseSelfAttention`` at BERT-base widths (768, 12 heads)
    with query/key/value loaded by name from an HF-layout state dict,
    BigBird-64 at 4096 tokens, bf16: its output against its plain version
    (the bf16 ``Gate``), one block-sparse forward launch a call."""
    import sys as _sys
    from deepspeed_tpu_torch.ops import block_sparse_attention
    from deepspeed_tpu_torch.ops.sparse_attention import \
        BertSparseSelfAttention
    log("phase 11e: an HF BERT's attention weights by name through the "
        f"block-sparse kernel (BigBird-64, {SPARSE_SEQ} tokens, bf16)")
    d, heads = BERT_BASE
    g = torch.Generator().manual_seed(SEED + 12)
    hf = {}
    for name in ("query", "key", "value"):
        hf[f"{name}.weight"] = torch.randn(d, d, generator=g) * 0.03
        hf[f"{name}.bias"] = torch.randn(d, generator=g) * 0.02
    layer = BertSparseSelfAttention(d, heads, bigbird_64(heads),
                                    dtype=torch.bfloat16)
    missing = layer.load_state_dict(hf)
    layer = layer.to("cuda")
    x = torch.randn(2, SPARSE_SEQ, d, generator=g).to("cuda")
    torch.cuda.synchronize()
    block_sparse_attention.fwd_launches = 0
    with torch.no_grad():
        out = layer(x)
    torch.cuda.synchronize()
    launches = block_sparse_attention.fwd_launches
    mod = _sys.modules["deepspeed_tpu_torch.ops.block_sparse_attention"]
    use_kernel = mod.use_kernel
    mod.use_kernel = lambda t: False
    try:
        with torch.no_grad():
            plain = layer(x)
    finally:
        mod.use_kernel = use_kernel
    gate = Gate("11e BertSparseSelfAttention")
    gate.case(torch.bfloat16, [out.float()], [plain.float()],
              f"[2, {SPARSE_SEQ}, {d}]", show=True)
    log(f"  loaded {sorted(hf)} by name ({missing}); block-sparse forward "
        f"launches {launches} (want 1) [{card}]")
    gate.close()
    if launches != 1:
        raise AssertionError("11e: the layer did not go through the "
                             "block-sparse forward kernel once")
    return {"block_sparse_attention_fwd": launches}


def phase_inject(card, profile=False, ckpt_dir=None):
    """Phase 11; returns the launch counts of its serving runs. 11a's
    checkpoint is written to ``ckpt_dir`` when given (phase 14a serves
    it in fp16), else to a directory deleted after 11a."""
    import contextlib
    import tempfile
    t0 = time.perf_counter()
    with (contextlib.nullcontext(ckpt_dir) if ckpt_dir else
          tempfile.TemporaryDirectory()) as tmp:
        engine, counts_a, serve = phase_inject_serve(card, tmp, profile)
    t1 = time.perf_counter()
    counts_c = phase_inject_int8(engine, card)
    del engine
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    counts_b = phase_inject_parity(card)
    torch.cuda.empty_cache()
    phase_inject_refusal()
    counts_e = phase_bert_sparse_hf(card)
    log(f"  phase 11 wall: 11a {t1 - t0:.1f} s, 11c {t2 - t1:.1f} s, "
        f"11b, 11d and 11e {time.perf_counter() - t2:.1f} s")
    return {"11a": counts_a, "11b": counts_b, "11c": counts_c,
            "11e": counts_e, "serve": serve}


# --------------------------------------------------------------------------
# phase 12: GPT-J-6B (head dim 256) served through injection
# --------------------------------------------------------------------------

# EleutherAI/gpt-j-6b's config.json (the HuggingFace Hub), the fields the
# GPT-J policy reads (every one HuggingFace's GPTJConfig default); the
# weights are drawn from SEED
GPTJ_6B = {
    "model_type": "gptj", "architectures": ["GPTJForCausalLM"],
    "vocab_size": 50400, "n_positions": 2048, "n_embd": 4096, "n_layer": 28,
    "n_head": 16, "rotary_dim": 64, "n_inner": None,
    "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
    "tie_word_embeddings": False, "torch_dtype": "float16"}
# 12a serves 14 of the 28 layers, weights drawn by the policy: at 28 the
# whole script took 842 s of its 1,200 s limit with phase 14 (NVIDIA H100
# 80GB HBM3, 700 W), and the host-bound phases run ~45% slower on a
# slower host
GPTJ_LAYERS = 14
# 12a's checkpoint round trip, at full width: 28 layers through the fp32
# host loader would take ~8 minutes and 70-90 GB of host memory
GPTJ_CKPT_LAYERS = 4


def gptj_dir(path, n_layers):
    return hf_dir(path, {**GPTJ_6B, "n_layer": n_layers})


def phase_gptj_serve(card, profile=False):
    """12a: GPT-J-6B's checkpoint round trip at full width and
    ``GPTJ_CKPT_LAYERS`` layers (``load_written_checkpoint``), then all
    ``GPTJ_LAYERS`` layers from weights the policy draws from SEED,
    through ``init_inference(config, replace_with_kernel_inject=True,
    dtype=bf16)``, served paged (``serve_injected``: phase 6's trace).
    Returns (engine, launch counts, readings, the served tokens)."""
    import tempfile
    from deepspeed_tpu_torch import init_inference
    log(f"phase 12a: GPT-J-6B (d 4096, 16 heads of 256, rotary over 64 "
        f"dims) written as a HuggingFace checkpoint at {GPTJ_CKPT_LAYERS} "
        f"layers and loaded through checkpoint injection; {GPTJ_LAYERS} "
        "layers served paged in bf16")
    with tempfile.TemporaryDirectory() as tmp:
        ns, written = gptj_dir(tmp, GPTJ_CKPT_LAYERS)
        engine, ckpt_load_s, ckpt_bytes = load_written_checkpoint(
            card, tmp, ns, written, "12a")
        del engine
        torch.cuda.empty_cache()
        ns, _ = gptj_dir(tmp, GPTJ_LAYERS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = init_inference(ns, replace_with_kernel_inject=True,
                            dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    cfg = engine.module.config
    shape = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.rotary_dim,
             cfg.n_layers, cfg.ffn_dim, cfg.vocab_size)
    log(f"  init_inference(config, replace_with_kernel_inject=True, "
        f"dtype=bf16), weights drawn by the policy: {load_s:.1f} s; "
        f"{sum(p.numel() for p in engine.module.parameters())} parameters, "
        f"torch.cuda.memory_allocated() {held} bytes [{card}]; (d_model, "
        f"heads, head_dim, rotary_dim, layers, d_ff, vocab) {shape}")
    want = (GPTJ_6B["n_embd"], GPTJ_6B["n_head"], 256, GPTJ_6B["rotary_dim"],
            GPTJ_LAYERS, 4 * GPTJ_6B["n_embd"], GPTJ_6B["vocab_size"])
    if not (engine.injected and cfg.rotary and cfg.shared_parallel_ln
            and cfg.lm_head_bias and cfg.attn_use_bias is False
            and shape == want):
        raise AssertionError("12a: not GPT-J-6B's injected configuration")
    counts, readings, served = serve_injected(engine, card, "12a", profile)
    readings.update(load_s=load_s, param_bytes=held,
                    ckpt_load_s=ckpt_load_s, ckpt_param_bytes=ckpt_bytes,
                    host_peak_rss=host_peak_rss())
    log(f"  host peak RSS so far {readings['host_peak_rss']} bytes")
    return engine, counts, readings, served


def phase_gptj_int8_kv(engine, served, floor, card):
    """12c: the same engine with int8 KV pages, served paged: launch counts
    exact; one decode step's logits against the bf16 pool inside the JAX
    package's rung (6d's, < ``INT8_KV_LOGIT_ERR``); and every served token
    of every request a near-argmax of the bf16 cache-free forward over
    its own history (``served_deficits`` < ``2 * INT8_KV_LOGIT_ERR``: the
    rung's error on either of two logits), with 12a's bf16 tokens' worst
    deficit logged beside it. The greedy agreement with 12a's tokens is
    logged beside ``floor``, 12a's own agreement with ``generate()`` on
    the same bf16 weights, and not gated: the seeded 28-layer model's bf16
    logits tie at the top at most requests, so its greedy tokens follow
    the batch's rounding (6d's 0.9 rung needs a model whose bf16 serving
    repeats ``generate()``)."""
    log("phase 12c: GPT-J-6B with int8 KV pages, served paged")
    prompts, outs = paged_traffic(engine.module.config.vocab_size)
    config = {**PAGED_CONFIG, "quantize": {"kv": "int8"}}
    reqs, srv, counts, wall = serve_paged(engine, prompts, outs, config)
    pairs = [(a, b) for r, ref in zip(reqs, served)
             for a, b in zip(r.output_tokens, ref)]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    err = decode_logit_err(engine.module, prompts[0])
    deficit = served_deficits(engine.module, prompts,
                              [r.output_tokens for r in reqs], outs)
    bf16_deficit = served_deficits(engine.module, prompts, served, outs)
    log(f"  KV pool {srv._paged.pool_bytes()} bytes (int8 pages + fp32 "
        f"scales); greedy agreement with 12a {agree:.4f} (classified: 12a's "
        f"bf16 serving agrees with generate() on {floor:.4f}); one decode "
        f"step's logit max abs err against the bf16 pool {err:.4f} (gate < "
        f"{INT8_KV_LOGIT_ERR}); served tokens' deficit against the bf16 "
        f"cache-free forward: max {deficit.max():.4f}, mean "
        f"{deficit.mean():.4f} over {deficit.size} tokens of "
        f"{len(reqs)} requests (gate < {2 * INT8_KV_LOGIT_ERR}; 12a's bf16 "
        f"tokens: max {bf16_deficit.max():.4f}, mean "
        f"{bf16_deficit.mean():.4f}); "
        f"{srv.metrics.tokens_generated / wall:.1f} tokens/s [{card}]")
    if not err < INT8_KV_LOGIT_ERR:
        raise AssertionError("12c: int8 KV pages outside the bounded-error "
                             "rung")
    if not deficit.max() < 2 * INT8_KV_LOGIT_ERR:
        worst = int(deficit.argmax())
        raise AssertionError(f"12c: served token {worst} (of all requests' "
                             f"tokens in order) is {deficit[worst]:.4f} "
                             "below the reference's top logit")
    return counts


def phase_gptj(card, profile=False):
    """Phase 12; returns the launch counts of its runs and 12a's
    readings."""
    t0 = time.perf_counter()
    engine, counts_a, serve, served = phase_gptj_serve(card, profile)
    t1 = time.perf_counter()
    counts_c = phase_gptj_int8_kv(engine, served,
                                  serve["generate_agreement"], card)
    del engine
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    counts_b = phase_inject_parity(card, PARITY_LAYERS, gptj_dir, "GPT-J-6B",
                                   "12b")
    torch.cuda.empty_cache()
    log(f"  phase 12 wall: 12a {t1 - t0:.1f} s, 12c {t2 - t1:.1f} s, 12b "
        f"{time.perf_counter() - t2:.1f} s")
    return {"12a": counts_a, "12b": counts_b, "12c": counts_c,
            "serve": serve}


# --------------------------------------------------------------------------
# phase 13: GPT-J-6B's layout trained (head dim 256 in the flash backward)
# --------------------------------------------------------------------------

# 13a: 8 of GPT-J-6B's 28 layers (2,023,777,504 parameters): 28 layers'
# fp32 master weights, gradients and Adam moments (16 bytes a parameter,
# 6,050,882,784 parameters) would take 96.8 GB, over the card's 80 GB
GPTJ_TRAIN_LAYERS = 8
GPTJ_TRAIN_STEPS = 6
GPTJ_FP16_LAYERS, GPTJ_FP16_STEPS = 2, 4      # 13b
GPTJ_PARITY = dict(d_model=1024, n_heads=4, n_layers=2, seq=256)   # 13c
# micro 2 x gas 2 sequences of GPT-J-6B's context (n_positions 2048):
# 8,192 tokens a step; FusedAdam at GPT-J-6B's published peak lr 1.2e-4
GPTJ_TRAIN_CONFIG = {
    "train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "FusedAdam",
                  "params": {"lr": 1.2e-4, "betas": [0.9, 0.95],
                             "weight_decay": 0.1}},
    "gradient_clipping": 1.0, "bf16": {"enabled": True},
}
# 13b: fp16 masters' loss scale from DeepSpeed's default 2**16
GPTJ_FP16_CONFIG = {
    **{k: v for k, v in GPTJ_TRAIN_CONFIG.items() if k != "bf16"},
    "fp16": {"enabled": True, "initial_scale_power": 16,
             "loss_scale_window": 2, "hysteresis": 2, "min_loss_scale": 1.0},
}


def gptj_train_config(dtype, **fields):
    """GPT-J-6B's ``GPTConfig`` as its injection policy builds it from
    ``GPTJ_6B`` (untied head with a bias, rotary over 64 dims, one shared
    LayerNorm, no attention biases), with ``fields`` replaced."""
    import dataclasses
    import types
    from deepspeed_tpu_torch.module_inject.replace_policy import \
        HFGPTJLayerPolicy
    cfg = HFGPTJLayerPolicy.build_config(types.SimpleNamespace(**GPTJ_6B),
                                         dtype)
    return dataclasses.replace(cfg, **fields)


def gptj_batch(cfg, rows, seq, seed):
    rs = np.random.RandomState(seed)
    return {"input_ids": rs.randint(0, cfg.vocab_size, size=(rows, seq))
            .astype(np.int32)}


def _gptj_want(cfg, config, steps, taken):
    per_attn = cfg.n_layers * config["gradient_accumulation_steps"]
    return {"flash_attention": per_attn * steps,
            "flash_attention_bwd_dkv": per_attn * steps,
            "flash_attention_bwd_dq": per_attn * steps,
            "fused_adam": taken, "fused_adam_bf16": 0}


def phase_gptj_train_bf16(card, profile=False):
    """13a: GPT-J-6B's layout at full width and ``GPTJ_TRAIN_LAYERS``
    layers, bf16 compute on fp32 master weights, FusedAdam, micro 2 x gas
    2 x 2048 tokens, ``GPTJ_TRAIN_STEPS`` train_batch calls on one seeded
    batch: exact launch counts of the flash forward and both backward
    kernels at head dim 256 and of fused Adam, finite losses that fall,
    peak device memory, step wall ms and tokens/s."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import GPT
    cfg = gptj_train_config(torch.bfloat16, n_layers=GPTJ_TRAIN_LAYERS)
    steps, config = GPTJ_TRAIN_STEPS, GPTJ_TRAIN_CONFIG
    seq = cfg.max_seq_len
    log(f"phase 13a: GPT-J-6B's layout (d {cfg.d_model}, {cfg.n_heads} heads "
        f"of {cfg.head_dim}, rotary {cfg.rotary_dim}, d_ff {cfg.ffn_dim}, "
        f"vocab {cfg.vocab_size}, untied head with bias) at "
        f"{cfg.n_layers} of its 28 layers trained through initialize() -> "
        f"train_batch (bf16 on fp32 masters, FusedAdam, micro 2 x gas 2 x "
        f"{seq} tokens, {steps} steps; GEMM flags {list(gemm_flags())})")
    t0 = time.perf_counter()
    model = GPT(cfg, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    draw_s = time.perf_counter() - t0
    engine, _, _, _ = initialize(model=model, config=config,
                                 loss_fn=gpt_train_loss, seed=SEED)
    del model
    batch = gptj_batch(cfg, config["train_batch_size"], seq, SEED + 40)
    counters = _fp16_counters()
    torch.cuda.synchronize()
    log(f"  {n_params} parameters drawn on the host in {draw_s:.1f} s, "
        f"engine built in {time.perf_counter() - t0 - draw_s:.1f} s; "
        f"torch.cuda.memory_allocated() {torch.cuda.memory_allocated()} "
        f"bytes")
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    losses, marks = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    counts = read_counters(counters)
    peak = torch.cuda.max_memory_allocated()
    want = _gptj_want(cfg, config, steps, steps)
    log(f"  launches over the {steps} steps: {counts} (want {want}: "
        f"{cfg.n_layers} layers x 2 microbatches x {steps} steps; one "
        f"optimizer launch a step)")
    log("  losses: " + ", ".join(f"{x:.4f}" for x in losses))
    step_ms = (marks[-1] - marks[0]) / (steps - 1) * 1e3
    tokens = config["train_batch_size"] * seq
    log(f"  step wall {step_ms:.2f} ms (mean of steps 2-{steps}, each ending "
        f"in a synchronize), {tokens / step_ms * 1e3:.0f} tokens/s, peak "
        f"device memory {peak} bytes ({peak / 2 ** 30:.2f} GiB), grad norm "
        f"{engine.get_global_grad_norm():.4f} [{card}]")
    if counts != want:
        raise AssertionError("13a: the training run did not go through every "
                             "kernel of its path the expected number of "
                             "times")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("13a: training losses are not finite or did not "
                             "fall on the repeated batch")
    if profile:
        device_profile("gptj train step", lambda: engine.train_batch(batch),
                       step_ms, card, iters=2, grad=True)
    del engine
    torch.cuda.empty_cache()
    return counts, dict(step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
                        peak_bytes=peak, params=n_params)


def phase_gptj_train_fp16(card):
    """13b: the same width in fp16 (fp32 masters, dynamic loss scale) at
    ``GPTJ_FP16_LAYERS`` layers, ``GPTJ_FP16_STEPS`` steps: finite losses,
    the (scale, growth, overflows, hysteresis) trajectory equal to the host
    replay of ``update_scale`` fed the card's finite flags, at least one
    step taken, exact launches of the fp16 d-256 forward and backward."""
    from deepspeed_tpu_torch.models import GPT
    cfg = gptj_train_config(torch.float16, n_layers=GPTJ_FP16_LAYERS)
    config, steps = GPTJ_FP16_CONFIG, GPTJ_FP16_STEPS
    f16 = config["fp16"]
    log(f"phase 13b: GPT-J-6B's layout at {cfg.n_layers} layers in fp16 "
        f"(dynamic loss scale from 2**{f16['initial_scale_power']}, "
        f"hysteresis {f16['hysteresis']}, window "
        f"{f16['loss_scale_window']}), FusedAdam, micro 2 x gas 2 x "
        f"{cfg.max_seq_len} tokens, {steps} steps")
    batch = gptj_batch(cfg, config["train_batch_size"], cfg.max_seq_len,
                       SEED + 41)
    rows, counts, peak, engine = fp16_run(
        GPT(cfg, seed=SEED), [batch] * steps, config, steps,
        loss_fn=gpt_train_loss)
    del engine
    torch.cuda.empty_cache()
    skipped = rows[-1][2]
    want = _gptj_want(cfg, config, steps, steps - skipped)
    replay = replay_scale(rows, f16)
    losses = [float(r[0]) for r in rows]
    log("  losses " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"  (scale, growth, overflows, hysteresis) per step "
        f"{[r[1] for r in rows]} (host replay {replay}); skipped {skipped}")
    log(f"  launches {counts} (want {want}); step wall ms "
        f"{[round(r[3], 2) for r in rows]}; peak {peak} bytes [{card}]")
    if not all(np.isfinite(losses)):
        raise AssertionError("13b: a loss is not finite")
    if [r[1] for r in rows] != replay:
        raise AssertionError("13b: the loss-scale trajectory differs from "
                             "the host replay")
    if counts != want or skipped == steps:
        raise AssertionError("13b: the launch counts differ, or no step was "
                             "taken")
    return counts


def phase_gptj_train_parity():
    """13c: the card against the CPU in fp32 (the 3xTF32 d-256 backward)
    at GPT-J-6B's layout cut to ``GPTJ_PARITY`` (4 heads of 256, rotary
    64, 2 layers, 256 tokens), 2 FusedAdam steps: 5b's gates."""
    par = GPTJ_PARITY
    cfg = gptj_train_config(torch.float32, d_model=par["d_model"],
                            n_heads=par["n_heads"], n_layers=par["n_layers"],
                            d_ff=4 * par["d_model"])
    log(f"phase 13c: training, card against CPU (fp32, GPT-J-6B's layout at "
        f"d {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, rotary "
        f"{cfg.rotary_dim}, {cfg.n_layers} layers, vocab {cfg.vocab_size}, "
        f"4 x {par['seq']} tokens)")
    return card_vs_cpu_training(
        cfg, gptj_batch(cfg, 4, par["seq"], SEED + 42))


def phase_gptj_train(card, defaults, profile=False):
    """Phase 13, 13a under torch's GEMM flags ``defaults`` (as phase 5a);
    returns the launch counts of its runs and 13a's readings."""
    t0 = time.perf_counter()
    off = gemm_flags()
    set_gemm_flags(defaults)
    try:
        counts_a, readings = phase_gptj_train_bf16(card, profile)
    finally:
        set_gemm_flags(off)
    t1 = time.perf_counter()
    counts_b = phase_gptj_train_fp16(card)
    t2 = time.perf_counter()
    counts_c = phase_gptj_train_parity()
    log(f"  phase 13 wall: 13a {t1 - t0:.1f} s, 13b {t2 - t1:.1f} s, 13c "
        f"{time.perf_counter() - t2:.1f} s")
    return {"13a": counts_a, "13b": counts_b, "13c": counts_c,
            "train": readings}


# --------------------------------------------------------------------------
# phase 14: serving in fp16 (the serving kernels' fp16 instances)
# --------------------------------------------------------------------------

GPTJ_FP16_SERVE_LAYERS = 2    # 14c: GPT-J-6B's widths in fp16, 2 layers


def _is_ln(name):
    return ".ln_" in name or name.startswith("ln_f")


def phase_fp16_serve_pythia(card, ckpt_dir):
    """14a: Pythia-1.4B's fp16 HuggingFace checkpoint in ``ckpt_dir``
    (phase 11a's, or written here as 11a writes it) loaded through
    ``init_inference(config, checkpoint=dir, replace_with_kernel_inject=
    True, dtype=torch.float16)``: every served weight is the checkpoint's
    fp16 tensor bit for bit (LayerNorms widened to fp32, which is exact);
    served paged (``serve_injected``: phase 6's trace, launch counts of
    the fp16 flash, paged and decode instances exact, first tokens by the
    ``FP16_TIE_ULPS`` rule) with the decode iteration's device profile.
    Returns (engine, launch counts, readings)."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.module_inject import (export_hf_state_dict,
                                                   read_hf_config)
    from deepspeed_tpu_torch.module_inject.load_checkpoint import \
        load_state_dict_from_checkpoint
    log(f"phase 14a: Pythia-1.4B ({PYTHIA_LAYERS} layers) served in fp16 "
        "from its own fp16 checkpoint")
    if torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction:
        raise AssertionError("14a: fp16 GEMM reductions are not in fp32")
    if os.path.exists(os.path.join(ckpt_dir, "config.json")):
        ns = read_hf_config(ckpt_dir)
        log(f"  phase 11a's fp16 checkpoint ({ns.num_hidden_layers} layers)")
    else:
        ns, written = pythia_dir(ckpt_dir, PYTHIA_LAYERS)
        write_checkpoint(ckpt_dir, ns, written)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = init_inference(ns, checkpoint=ckpt_dir,
                            replace_with_kernel_inject=True,
                            dtype=torch.float16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    n_params = sum(p.numel() for p in engine.module.parameters())
    log(f"  init_inference(config, checkpoint=dir, replace_with_kernel_"
        f"inject=True, dtype=fp16): {load_s:.1f} s; {n_params} parameters, "
        f"torch.cuda.memory_allocated() {held} bytes after the load [{card}]")
    icfg = engine.module.config
    wrong = [n for n, p in engine.module.named_parameters()
             if p.dtype != (torch.float32 if _is_ln(n) else torch.float16)]
    if not (engine.injected and icfg.rotary and icfg.dtype == torch.float16
            and icfg.n_layers == PYTHIA_LAYERS) or wrong:
        raise AssertionError(f"14a: not the injected fp16 Pythia-1.4B "
                             f"(parameters of another dtype: {wrong[:5]})")
    # the reader widens fp16 to fp32 exactly; the served weights, exported,
    # are the same fp16 bits
    read = load_state_dict_from_checkpoint(ckpt_dir)
    back = export_hf_state_dict(ns.model_type, engine.module, icfg)

    def bits(a):
        h = np.asarray(a).astype(np.float16)
        if not np.array_equal(h.astype(np.float32), a):
            return None                      # not an fp16 value
        return h.view(np.uint16)
    bad = [k for k in read if k not in back or bits(back[k]) is None
           or not np.array_equal(bits(back[k]), bits(read[k]))]
    log(f"  the served model's weights bit-equal to the checkpoint's fp16 "
        f"tensors: {len(read) - len(bad)}/{len(read)} (every non-LayerNorm "
        f"parameter held in fp16, LayerNorms in fp32)")
    if bad or set(back) != set(read):
        raise AssertionError(f"14a: served weights differ from the fp16 "
                             f"checkpoint: {bad[:5]}")
    del read, back
    counts, readings, _ = serve_injected(engine, card, "14a", profile=True)
    readings.update(load_s=load_s, param_bytes=held,
                    host_peak_rss=host_peak_rss())
    return engine, counts, readings


def phase_fp16_serve_int8(engine, card):
    """14b: the same model with int8 weights and int8 KV pages under fp16
    compute, served paged: launch counts exact (``serve_paged``: the int8
    matmuls 4 x n_layers + 1 a program, the untied head too); one decode
    step's logits over the int8 pool within ``INT8_KV_LOGIT_ERR`` of the
    fp16 pool's; every served token's deficit against the int8-weight
    model's cache-free fp16 forward below ``2 * INT8_KV_LOGIT_ERR`` (12c's
    gate). Returns (launch counts, readings)."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.module_inject.module_quantize import \
        quantized_nbytes
    log("phase 14b: the fp16 model with int8 weights and int8 KV pages, "
        "served paged")
    engine_int8 = init_inference(engine.module, quantize_weights=True)
    model = engine_int8.module
    prompts, outs = paged_traffic(model.config.vocab_size)
    config = {**PAGED_CONFIG, "quantize": {"weights": "int8", "kv": "int8"}}
    reqs, srv, counts, wall = serve_paged(engine_int8, prompts, outs, config)
    if srv.module is not model or model.config.dtype != torch.float16:
        raise AssertionError("14b: the server re-quantized the model or "
                             "left fp16")
    nb = quantized_nbytes(model)
    err = decode_logit_err(model, prompts[0])
    deficit = served_deficits(model, prompts,
                              [r.output_tokens for r in reqs], outs)
    tokens = srv.metrics.tokens_generated
    log(f"  weights {nb['quantized']} bytes int8 against "
        f"{nb['dense_equivalent']} fp16-equivalent; KV pool "
        f"{srv._paged.pool_bytes()} bytes (int8 pages + fp32 scales); one "
        f"decode step's logit max abs err against the fp16 pool {err:.4f} "
        f"(gate < {INT8_KV_LOGIT_ERR}); served tokens' deficit against the "
        f"int8 model's cache-free fp16 forward: max {deficit.max():.4f}, "
        f"mean {deficit.mean():.4f} over {deficit.size} tokens (gate < "
        f"{2 * INT8_KV_LOGIT_ERR}); {tokens} tokens in {wall:.3f} s, "
        f"{tokens / wall:.1f} tokens/s [{card}]")
    if not err < INT8_KV_LOGIT_ERR:
        raise AssertionError("14b: int8 KV pages outside the bounded-error "
                             "rung")
    if not deficit.max() < 2 * INT8_KV_LOGIT_ERR:
        worst = int(deficit.argmax())
        raise AssertionError(f"14b: served token {worst} (of all requests' "
                             f"tokens in order) is {deficit[worst]:.4f} "
                             "below the reference's top logit")
    return counts, {"tokens_per_s": tokens / wall, "logit_err": err,
                    "max_deficit": float(deficit.max())}


def phase_fp16_serve_gptj(card):
    """14c: GPT-J-6B's config at full width and
    ``GPTJ_FP16_SERVE_LAYERS`` layers, weights the policy draws from SEED,
    ``init_inference(config, replace_with_kernel_inject=True,
    dtype=torch.float16)``, served paged through the head-dim-256 fp16
    instances (``serve_injected``: exact counts, 14a's first-token rule).
    Returns (launch counts, readings)."""
    import tempfile
    from deepspeed_tpu_torch import init_inference
    log(f"phase 14c: GPT-J-6B (16 heads of 256) at {GPTJ_FP16_SERVE_LAYERS} "
        "layers served paged in fp16")
    with tempfile.TemporaryDirectory() as tmp:
        ns, _ = gptj_dir(tmp, GPTJ_FP16_SERVE_LAYERS)
    t0 = time.perf_counter()
    engine = init_inference(ns, replace_with_kernel_inject=True,
                            dtype=torch.float16)
    torch.cuda.synchronize()
    cfg = engine.module.config
    log(f"  init_inference(config, replace_with_kernel_inject=True, "
        f"dtype=fp16), weights drawn by the policy: "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in engine.module.parameters())} parameters")
    if not (cfg.head_dim == 256 and cfg.dtype == torch.float16
            and cfg.d_model == GPTJ_6B["n_embd"]
            and cfg.n_layers == GPTJ_FP16_SERVE_LAYERS):
        raise AssertionError("14c: not GPT-J-6B's widths in fp16")
    counts, readings, _ = serve_injected(engine, card, "14c")
    return counts, readings


def phase_fp16_serve(card, ckpt_dir=None):
    """Phase 14; ``ckpt_dir``: phase 11a's checkpoint (a full run), else a
    directory it is written to and deleted after 14a. Returns the launch
    counts of its runs and their readings."""
    import contextlib
    import tempfile
    t0 = time.perf_counter()
    with (contextlib.nullcontext(ckpt_dir) if ckpt_dir else
          tempfile.TemporaryDirectory()) as tmp:
        engine, counts_a, serve = phase_fp16_serve_pythia(card, tmp)
    t1 = time.perf_counter()
    counts_b, int8 = phase_fp16_serve_int8(engine, card)
    del engine
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    counts_c, gptj = phase_fp16_serve_gptj(card)
    torch.cuda.empty_cache()
    r = serve
    idle = 1 - r["decode_busy_ms"] / r["decode_wall_ms"]
    log(f"phase 14a: {r['tokens_per_s']:.1f} tokens/s, paged decode "
        f"{r['decode_wall_ms']:.3f} ms an iteration (device busy "
        f"{r['decode_busy_ms']:.4f} ms, {100 * idle:.1f}% idle), "
        f"{r['param_bytes']} bytes of parameters on the card, loaded in "
        f"{r['load_s']:.1f} s; 14b {int8['tokens_per_s']:.1f} tokens/s; 14c "
        f"{gptj['tokens_per_s']:.1f} tokens/s, paged decode "
        f"{gptj['decode_wall_ms']:.3f} ms an iteration [{card}]")
    log(f"  phase 14 wall: 14a {t1 - t0:.1f} s, 14b {t2 - t1:.1f} s, 14c "
        f"{time.perf_counter() - t2:.1f} s")
    return {"14a": counts_a, "14b": counts_b, "14c": counts_c,
            "serve": serve}


# --------------------------------------------------------------------------
# phase 15: sparse BERT pretrained at its published settings (fp16, every
# dropout at 0.1)
# --------------------------------------------------------------------------

# bing_bert's fp16 block (DeepSpeed's BERT pretraining configs: "fp16":
# {"enabled": true, "loss_scale": 0}), DeepSpeed's dynamic-scale defaults
# written out, so the host replay reads the same fields
PUBLISHED_FP16 = {"enabled": True, "loss_scale": 0, "initial_scale_power": 16,
                  "loss_scale_window": 1000, "hysteresis": 2,
                  "min_loss_scale": 1}
PUBLISHED_CONFIG = {**{k: v for k, v in BERT_TRAIN_CONFIG.items()
                       if k != "bf16"}, "fp16": PUBLISHED_FP16}
# BERT's bert_config.json (google-research/bert): hidden_dropout_prob and
# attention_probs_dropout_prob
PUBLISHED_DROPOUT = 0.1


def _sparse_entry_counter(bsa):
    """Wrap the block-sparse module's C entry lookup: counts launches by
    the entry point they reach (``_bf16``, ``_fp16`` or fp32). Returns
    (counts, restore)."""
    seen, real = {}, bsa._entry

    def counting(lib, name, code):
        fn = real(lib, name, code)
        key = name + ("", "_bf16", "_fp16")[code]
        seen[key] = seen.get(key, 0) + 1
        return fn
    bsa._entry = counting
    return seen, lambda: setattr(bsa, "_entry", real)


def phase_published_bert(card, steps=8):
    """15a: 7a's sparse BERT-base at 4096 tokens in fp16 on fp32 masters
    with dynamic loss scaling, attention, MLP and embedding dropout 0.1,
    FusedLamb, micro 2 x gas 2, ``steps`` train_batch calls on 7a's batch.
    Gates: exact launch counts through the fp16 block-sparse entries and
    the dropout kernel, finite losses that fall over whole periods, the
    loss-scale record replayed exactly on the host. Returns the launch
    counts and the step readings."""
    import dataclasses
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import BERT_PRESETS
    from deepspeed_tpu_torch.ops import (block_sparse_attention,
                                         dropout_apply, flash_attention,
                                         flash_attention_bwd, fused_adam,
                                         fused_lamb)
    bsa = sys.modules["deepspeed_tpu_torch.ops.block_sparse_attention"]
    f16 = PUBLISHED_FP16
    log(f"phase 15a: BERT-base with BigBird-64 block-sparse attention at "
        f"{SPARSE_SEQ} tokens at its published settings through "
        f"initialize() -> train_batch: fp16 on fp32 masters (dynamic loss "
        f"scale from 2**{f16['initial_scale_power']}), attention, MLP and "
        f"embedding dropout {PUBLISHED_DROPOUT}, FusedLamb, micro 2 x gas 2 "
        f"(GEMM flags {list(gemm_flags())})")
    base = dataclasses.replace(BERT_PRESETS["bert-base"], dtype=torch.float16,
                               attn_dropout_rate=PUBLISHED_DROPOUT,
                               dropout_rate=PUBLISHED_DROPOUT)
    model, cfg = sparse_bert(base, SPARSE_SEQ)
    engine, _, _, _ = initialize(model=model, config=PUBLISHED_CONFIG,
                                 loss_fn=bert_train_loss, seed=SEED)
    n = PUBLISHED_CONFIG["train_batch_size"]
    batch = bert_batch(n, SPARSE_SEQ, cfg.vocab_size, SEED + 8)
    counters = {**{k: v for k, v in _ds_counters().items() if k in (
        "block_sparse_attention_fwd", "block_sparse_attention_dq",
        "block_sparse_attention_dkv", "fused_lamb", "fused_lamb_apply",
        "flash_attention", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq", "fused_adam")},
        "dropout_fwd": (dropout_apply, "fwd_launches"),
        "dropout_bwd": (dropout_apply, "bwd_launches")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    entries, restore = _sparse_entry_counter(bsa)
    reset_counters(counters)
    rows, marks = [], [time.perf_counter()]
    try:
        for _ in range(steps):
            loss = engine.train_batch(batch)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            rows.append((loss, _scale_fields(engine), engine.skipped_steps,
                         (marks[-1] - marks[-2]) * 1e3))
    finally:
        restore()
    counts = read_counters(counters)
    peak = torch.cuda.max_memory_allocated()
    skipped = rows[-1][2]
    per_attn = cfg.n_layers * PUBLISHED_CONFIG["gradient_accumulation_steps"]
    sites = cfg.n_layers + 1                  # each layer's MLP, embeddings
    want = {name: 0 for name in counts}
    want.update({"block_sparse_attention_fwd": per_attn * steps,
                 "block_sparse_attention_dq": per_attn * steps,
                 "block_sparse_attention_dkv": per_attn * steps,
                 "dropout_fwd": sites * 2 * steps,
                 "dropout_bwd": sites * 2 * steps,
                 "fused_lamb": steps - skipped,
                 "fused_lamb_apply": steps - skipped})
    want_entries = {f"block_sparse_attention_{k}_fp16": per_attn * steps
                    for k in ("fwd", "dq", "dkv")}
    log(f"  launches over the {steps} steps: {counts} (want {want}: "
        f"{cfg.n_layers} layers x 2 microbatches x {steps} steps of each "
        f"block-sparse kernel, {sites} dropout sites x 2 microbatches x "
        f"{steps} steps each way, two LAMB launches a step taken, no flash "
        f"or Adam launch); block-sparse entry points {entries} (want "
        f"{want_entries})")
    if counts != want or entries != want_entries:
        raise AssertionError("15a: the published sparse BERT run did not go "
                             "through every kernel of its path the expected "
                             "number of times")
    losses = [float(r[0]) for r in rows]
    replay = replay_scale(rows, f16)
    log("  losses: " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"  (scale, growth, overflows, hysteresis) per step "
        f"{[r[1] for r in rows]}; skipped {skipped}; host replay {replay}")
    fall = np.mean(losses[:2]) - np.mean(losses[-2:])
    log(f"  mean of the first two losses - mean of the last two: "
        f"{fall:.4f} (gate >= {LOSS_FALL})")
    if not all(np.isfinite(losses)) or not fall >= LOSS_FALL:
        raise AssertionError("15a: losses not finite or did not fall over a "
                             "period on the repeated batch")
    if [r[1] for r in rows] != replay:
        raise AssertionError("15a: the loss-scale record differs from the "
                             "host replay")
    if skipped == steps:
        raise AssertionError("15a: every step overflowed")
    step_ms = (marks[-1] - marks[1]) / (steps - 1) * 1e3
    tokens = n * SPARSE_SEQ
    out = dict(step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               peak_bytes=peak, skipped=skipped)
    out["busy_ms"] = device_profile(
        "published sparse bert train step", lambda: engine.train_batch(batch),
        step_ms, card, iters=3, grad=True)
    log(f"  step wall {step_ms:.2f} ms (mean of steps 2-{steps}, each ending "
        f"in a synchronize), {out['tokens_per_s']:.0f} tokens/s, peak "
        f"device memory {peak} bytes ({peak / 2 ** 30:.2f} GiB), skipped "
        f"steps {skipped}, device busy {out['busy_ms']:.2f} ms a step "
        f"({100 * (1 - out['busy_ms'] / step_ms):.1f}% idle) [{card}]")
    del engine, model
    torch.cuda.empty_cache()
    # a control, logged only: the same run with the MLP and embedding
    # dropout off (attention dropout on), which splits the step's cost
    # between fp16 and the activation dropout sites
    model, _ = sparse_bert(dataclasses.replace(base, dropout_rate=0.0),
                           SPARSE_SEQ)
    engine, _, _, _ = initialize(model=model, config=PUBLISHED_CONFIG,
                                 loss_fn=bert_train_loss, seed=SEED)
    marks = []
    for _ in range(4):
        engine.train_batch(batch)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    ms = (marks[-1] - marks[0]) / 3 * 1e3
    busy = device_profile("published sparse bert, activation dropout off",
                          lambda: engine.train_batch(batch), ms, card,
                          iters=2, grad=True)
    out["control_step_ms"], out["control_busy_ms"] = ms, busy
    log(f"  control, MLP and embedding dropout off: step wall {ms:.2f} ms "
        f"(steps 2-4), device busy {busy:.2f} ms [{card}]")
    del engine, model
    torch.cuda.empty_cache()
    return counts, out


class DropoutRecorder:
    """Records every activation dropout map (``ops.dropout.dropout_map``:
    its words, and which elements it zeroed where its input was not 0) and
    the words each layer's forward takes (a forward pre-hook on every
    ``Block`` and ``DeepSpeedTransformerLayer``: its attention's words)."""

    def __init__(self, model):
        from deepspeed_tpu_torch.ops import dropout
        self.mod, self.real = dropout, dropout.dropout_map
        self.maps, self.layer_words = [], []
        self.hooks = [m.register_forward_pre_hook(self._hook,
                                                  with_kwargs=True)
                      for m in model.modules()
                      if type(m).__name__ in ("Block",
                                              "DeepSpeedTransformerLayer")]
        dropout.dropout_map = self._map

    def _hook(self, module, args, kwargs):
        self.layer_words.append(tuple(kwargs["dropout_seed"]))

    def _map(self, x, words, rate, backward=False):
        y = self.real(x, words, rate, backward)
        self.maps.append((tuple(words), backward,
                          ((y == 0) & (x != 0)).cpu()))
        return y

    def close(self):
        self.mod.dropout_map = self.real
        for h in self.hooks:
            h.remove()


def _fwd_bwd(model, run, dev):
    """One forward and backward of ``run(model)`` (a loss) under a
    recorder; returns (loss, outputs, grads by name, recorder)."""
    rec = DropoutRecorder(model)
    try:
        loss, outs = run(model, dev)
        loss.backward()
    finally:
        rec.close()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             .detach().cpu() for k, p in model.named_parameters()}
    return loss.item(), [o.detach().cpu() for o in outs], grads, rec


def phase_published_parity():
    """15b: fp32, card against CPU, every dropout on (0.1): sparse BERT
    (BigBird-64, d 128, 2 heads of 64, 2 layers, 512 tokens; attention,
    MLP and embedding dropout) and a stack of two
    ``DeepSpeedTransformerLayer``s at BERT-large's widths (attention and
    hidden dropout). Gates: every activation dropout map's zeros equal on
    both sides; outputs within 1e-5 and gradients within 1e-5 of the
    largest (the fp32 parity rule of the DS layer and BERT); on the card
    every activation site's words distinct and none of them a layer's
    (attention's) words."""
    import dataclasses
    from deepspeed_tpu_torch.models import BERT_PRESETS, bert_pretrain_loss
    from deepspeed_tpu_torch.ops.dropout import seed_words
    log("phase 15b: card against CPU, fp32, every dropout at 0.1: sparse "
        "BERT (BigBird-64, d 128, 2 layers, 512 tokens) and two "
        "DeepSpeedTransformerLayers at BERT-large's widths (hidden dropout)")
    seq, words = 512, seed_words(SEED + 15)
    base = dataclasses.replace(
        BERT_PRESETS["bert-base"], d_model=128, n_heads=2, n_layers=2,
        max_seq_len=seq // 2, dtype=torch.float32,
        attn_dropout_rate=PUBLISHED_DROPOUT, dropout_rate=PUBLISHED_DROPOUT)
    bt = bert_batch(2, seq, base.vocab_size, SEED + 15)

    def bert_run(model, dev):
        t = {k: torch.from_numpy(v).to(dev).long() for k, v in bt.items()}
        mlm, nsp = model(t["input_ids"], token_type_ids=t["token_type_ids"],
                         dropout_seed=words)
        return bert_pretrain_loss(mlm, nsp, t["mlm_labels"],
                                  t["nsp_labels"]), (mlm, nsp)
    ds_cfg = ds_bert_config(n_layers=2, dtype_fp16=False,
                            attn_dropout=PUBLISHED_DROPOUT,
                            hidden_dropout=PUBLISHED_DROPOUT)
    mb = mlm_batch(2, DS_SEQ, 30522, SEED + 15)

    def ds_run(model, dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in mb.items()}
        logits = model(t["input_ids"].long(), t["attention_mask"],
                       dropout_seed=words)
        return mlm_loss(logits, t["mlm_labels"]), (logits,)
    for name, make, run in (
            ("sparse BERT", lambda: sparse_bert(base, seq)[0], bert_run),
            ("DS layer stack", lambda: DSBertMLM(ds_cfg), ds_run)):
        res = {}
        for dev in ("cuda", "cpu"):
            model = make().to(dev).train()
            res[dev] = _fwd_bwd(model, run, dev)
            del model
        card, cpu = res["cuda"], res["cpu"]
        out_err = max((a - b).abs().max().item()
                      for a, b in zip(card[1], cpu[1]))
        top = max(g.abs().max().item() for g in cpu[2].values())
        grad_err = max((card[2][k] - g).abs().max().item()
                       for k, g in cpu[2].items()) / top
        rec, rec_cpu = card[3], cpu[3]
        same_masks = (len(rec.maps) == len(rec_cpu.maps) and all(
            a[:2] == b[:2] and torch.equal(a[2], b[2])
            for a, b in zip(rec.maps, rec_cpu.maps)))
        fwd_words = [w for w, backward, _ in rec.maps if not backward]
        distinct = (len(set(fwd_words)) == len(fwd_words)
                    and not set(fwd_words) & set(rec.layer_words))
        dropped = sum(int(m.sum()) for _, _, m in rec.maps)
        total = sum(m.numel() for _, _, m in rec.maps)
        ok = (out_err <= 1e-5 and grad_err <= 1e-5 and same_masks
              and distinct and len(fwd_words) > 0)
        log(f"  {name}: loss card {card[0]:.6f} cpu {cpu[0]:.6f}; outputs "
            f"max diff {out_err:.3e} (tol 1e-5); gradients max diff "
            f"{grad_err:.3e} of the largest (tol 1e-5); {len(rec.maps)} "
            f"dropout maps ({len(fwd_words)} forward), zeros equal on both "
            f"sides: {same_masks} ({dropped} of {total} elements dropped, "
            f"{dropped / max(total, 1):.4f}); site words distinct and no "
            f"layer's: {distinct} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"15b: {name}, card and CPU disagree or a "
                                 "dropout site reuses words")


def phase_published_remat():
    """15c: GPT-2 125M's widths at 2 layers (bf16, attention, MLP and
    embedding dropout 0.1) on the card: the loss and every gradient under
    remat ``full`` and ``attn_out`` bit-equal to ``none``."""
    import dataclasses
    from deepspeed_tpu_torch.models import GPT, GPT2_PRESETS, gpt_loss_fn
    from deepspeed_tpu_torch.ops.dropout import seed_words
    log("phase 15c: remat with dropout on the card: GPT-2 125M's widths at "
        "2 layers, bf16, attention, MLP and embedding dropout 0.1, 4 x 512 "
        "tokens; 'full' and 'attn_out' against 'none'")
    vocab = GPT2_PRESETS["gpt2-125m"].vocab_size
    ids = torch.from_numpy(np.random.RandomState(SEED + 16).randint(
        0, vocab, size=(4, 513))).cuda()
    words = seed_words(SEED + 16)
    runs = {}
    for policy in ("none", "full", "attn_out"):
        cfg = dataclasses.replace(
            GPT2_PRESETS["gpt2-125m"], n_layers=2,
            attn_dropout_rate=PUBLISHED_DROPOUT,
            dropout_rate=PUBLISHED_DROPOUT, remat=policy)
        model = GPT(cfg, seed=SEED).cuda().train()
        loss = gpt_loss_fn(model(ids[:, :-1], dropout_seed=words),
                           ids[:, 1:])
        loss.backward()
        runs[policy] = [loss.detach()] + [p.grad for p in model.parameters()]
        del model
    torch.cuda.synchronize()
    for policy in ("full", "attn_out"):
        same = _same_bits(runs[policy], runs["none"])
        log(f"  {policy}: loss {runs[policy][0].item():.6f} (none "
            f"{runs['none'][0].item():.6f}); loss and "
            f"{len(runs['none']) - 1} gradients bit-equal to none: {same}")
        if not same:
            raise AssertionError(f"15c: remat {policy!r} with dropout on "
                                 "differs from none")


def phase_published(card, defaults):
    """Phase 15: 15a under torch's default GEMM flags, 15b and 15c with
    them off. Returns 15a's launch counts and readings."""
    t0 = time.perf_counter()
    set_gemm_flags(defaults)
    try:
        counts, out = phase_published_bert(card)
    finally:
        set_gemm_flags(GEMM_OFF)
    t1 = time.perf_counter()
    phase_published_parity()
    t2 = time.perf_counter()
    phase_published_remat()
    log(f"  phase 15 wall: 15a {t1 - t0:.1f} s, 15b {t2 - t1:.1f} s, 15c "
        f"{time.perf_counter() - t2:.1f} s")
    return counts, out


# --------------------------------------------------------------------------
# planted faults: each edits a copy of the kernel sources and must fail
# ``--checks-only`` there
# --------------------------------------------------------------------------

PLANTED_FAULTS = (
    ("LayerNorm variance in the one-pass form E[x^2] - mean^2 (CTA-per-row "
     "forward)", "layernorm.cu",
     (("const float c = __fsub_rn(row[j], mean);", "const float c = row[j];"),
      ("const float var = __fdiv_rn(block_sum(ss), fd);",
       "const float var = __fsub_rn(__fdiv_rn(block_sum(ss), fd), "
       "__fmul_rn(mean, mean));")), "--checks-only"),
    ("LayerNorm variance in the one-pass form E[x^2] - mean^2 (warp-per-row "
     "forward)", "layernorm.cu",
     (("const float dev = __fsub_rn(xv[c][i], mean);",
       "const float dev = xv[c][i];"),
      ("const float var = __fdiv_rn(warp_sum(ss), fd);",
       "const float var = __fsub_rn(__fdiv_rn(warp_sum(ss), fd), "
       "__fmul_rn(mean, mean));")), "--checks-only"),
    ("the dgamma/dbeta reduction skips the last CTA's partial",
     "layernorm.cu",
     (("c < ctas; c += RED_WARPS", "c < ctas - 1; c += RED_WARPS"),),
     "--checks-only"),
    ("the warp-per-row backward's combine drops the last warp's dgamma/dbeta "
     "sums", "layernorm.cu",
     (("    if (w == k) {", "    if (w == k && k + 1 < BWD_WARPS) {"),),
     "--checks-only"),
    ("codes truncated instead of rounded half to even (rintf)",
     "quantizer.cu", (("rintf(", "truncf("),), "--checks-only"),
    ("the scale floor applied before the scaling",
     "quantizer.cu",
     (("fmaxf(__fmul_rn(range, inv_qmax), scale_floor)",
       "__fmul_rn(fmaxf(range, scale_floor), inv_qmax)"),), "--checks-only"),
    # phase 8c's own readings of faults in what its 1-D parameters go
    # through: each must fail ``--8c-only``
    # (the last CTA owns 8c's last row, a padding row with no gradient:
    # the first one's row is a token)
    ("8c: the dgamma/dbeta reduction skips the first CTA's partial",
     "layernorm.cu",
     (("for (int c = threadIdx.y; c < ctas; c += RED_WARPS)",
       "for (int c = threadIdx.y == 0 ? RED_WARPS : threadIdx.y; c < ctas; "
       "c += RED_WARPS)"),), "--8c-only"),
    ("8c: the LAMB trust ratio 2% low", "fused_lamb.cu",
     (("const float step = sc.neg_lr * trust;",
       "const float step = sc.neg_lr * trust * 0.98f;"),), "--8c-only"),
    # the bf16 tensor-core flash kernels
    ("bf16 flash forward: p' truncated to bf16 (round toward zero), not "
     "rounded to nearest, before PV", "flash_attention_fwd_bf16.cu",
     (("c_to_a16<T>(pa, s[2 * kc], s[2 * kc + 1]);  // p' rounded to T",
       "for (int e2 = 0; e2 < 4; ++e2) pa[e2] = __byte_perm("
       "__float_as_uint(s[2 * kc + (e2 >> 1)][(e2 & 1) * 2]), "
       "__float_as_uint(s[2 * kc + (e2 >> 1)][(e2 & 1) * 2 + 1]), "
       "0x7632);"),), "--checks-only"),
    ("bf16 flash forward: the causal mask skipped on the last (diagonal) "
     "key tile", "flash_attention_fwd_bf16.cu",
     (("(causal && k0 + BK - 1 > q0 + shift)",
       "(causal && kt + 1 < nkb && k0 + BK - 1 > q0 + shift)"),),
     "--checks-only"),
    ("bf16 flash dK/dV: the keep bit taken at the transposed fragment "
     "coordinate (key, q row)", "flash_attention_bwd_bf16.cu",
     (("hash_col(dr, key0", "hash_row(dr, key0"),
      ("hash_row(dr, q0 + qh * QC + c0", "hash_col(dr, q0 + qh * QC + c0")),
     "--checks-only"),
    ("bf16 flash dK/dV: dP rounded to bf16 before delta is subtracted "
     "(dS rounded twice)", "flash_attention_bwd_bf16.cu",
     (("dpT[j][e] = p * (dfac * dpT[j][e] - dlq) * a.scale;  // dS",
       "dpT[j][e] = p * (dfac * round_to<bf16>(dpT[j][e]) - dlq) * "
       "a.scale;  // dS"),), "--checks-only"),
    # the fp16 instances of the flash kernels and the bf16-gradient
    # optimizer instances
    ("fp16/bf16-gradient instance: fp16 flash forward and backward: p', "
     "O, dS, P o D and the outputs rounded toward zero, not to nearest",
     "mma.cuh",
     (('asm("cvt.rn.f16x2.f32 %0, %1, %2;\\n"',
       'asm("cvt.rz.f16x2.f32 %0, %1, %2;\\n"'),), "--checks-only"),
    ("fp16/bf16-gradient instance: fp16 flash dK/dV: dP rounded to fp16 "
     "before delta is subtracted (dS rounded twice)",
     "flash_attention_bwd_bf16.cu",
     (("dpT[j][e] = p * (dfac * dpT[j][e] - dlq) * a.scale;  // dS",
       "dpT[j][e] = p * (dfac * round_to<T>(dpT[j][e]) - dlq) * "
       "a.scale;  // dS"),), "--checks-only"),
    ("fp16/bf16-gradient instance: fused Adam, bf16 gradients: g scaled "
     "by 1.0039 after widening", "fused_adam.cu",
     (("float g = to_float(e.g[i]);  // exact for bf16",
       "float g = to_float(e.g[i]) * (sizeof(G) == 2 ? 1.0039f : 1.f);"),),
     "--checks-only"),
    ("fp16/bf16-gradient instance: fused LAMB phase 1, bf16 gradients: g "
     "scaled by 1.0039 after widening", "fused_lamb.cu",
     (("float g = to_float(e.g[i]);  // exact for bf16",
       "float g = to_float(e.g[i]) * (sizeof(G) == 2 ? 1.0039f : 1.f);"),),
     "--checks-only"),
    # the bf16 tensor-core block-sparse backward
    ("bf16 block-sparse dK/dV: the keep bit taken at the transposed "
     "fragment coordinate (key, q row)", "block_sparse_attention_bwd_bf16.cu",
     (("hash_col(dr, k0 + kl0", "hash_row(dr, k0 + kl0"),
      ("hash_row(dr, q0 + qh * QC + c0", "hash_col(dr, q0 + qh * QC + c0")),
     "--checks-only"),
    ("bf16 block-sparse dQ and dK/dV: a partial fine mask treated as all "
     "live", "block_sparse_attention_bwd_bf16.cu",
     (("const bool full = mask_full(lists, a, p_id);",
       "const bool full = true;"),), "--checks-only"),
    ("bf16 block-sparse dK/dV: P o D truncated to bf16 (round toward zero), "
     "not rounded to nearest, before dV", "block_sparse_attention_bwd_bf16.cu",
     (("c_to_a16<T>(pa, sT[2 * kc], sT[2 * kc + 1]);    // P o D rounded to T",
       "for (int e2 = 0; e2 < 4; ++e2) pa[e2] = __byte_perm("
       "__float_as_uint(sT[2 * kc + (e2 >> 1)][(e2 & 1) * 2]), "
       "__float_as_uint(sT[2 * kc + (e2 >> 1)][(e2 & 1) * 2 + 1]), "
       "0x7632);"),), "--checks-only"),
    ("bf16 block-sparse dK/dV: dP rounded to bf16 before delta is "
     "subtracted (dS rounded twice)", "block_sparse_attention_bwd_bf16.cu",
     (("float dfac = 1.f, d = dpT[jj][e];",
       "float dfac = 1.f, d = round_to<bf16>(dpT[jj][e]);"),),
     "--checks-only"),
    # the block-sparse forward: bf16 on the tensor cores, fp32 on 3xTF32
    ("bf16 block-sparse forward: p' truncated to bf16 (round toward zero), "
     "not rounded to nearest, before PV", "block_sparse_attention_fwd_bf16.cu",
     (("c_to_a16<T>(pa[kc], s[2 * kc], s[2 * kc + 1]);  // p' rounded to T",
       "for (int e2 = 0; e2 < 4; ++e2) pa[kc][e2] = __byte_perm("
       "__float_as_uint(s[2 * kc + (e2 >> 1)][(e2 & 1) * 2]), "
       "__float_as_uint(s[2 * kc + (e2 >> 1)][(e2 & 1) * 2 + 1]), "
       "0x7632);"),), "--checks-only"),
    ("bf16 block-sparse forward: the keep bit taken at the transposed "
     "coordinate (key, q row)", "block_sparse_attention_fwd_bf16.cu",
     (("hash_row(dr, q0 + rl0", "hash_col(dr, q0 + rl0"),
      ("hash_col(dr, k0 + jj * 8", "hash_row(dr, k0 + jj * 8")),
     "--checks-only"),
    ("bf16 block-sparse forward: a partial fine mask treated as all live",
     "block_sparse_attention_fwd_bf16.cu",
     (("const bool full = mask_full(lists, a, p_id);",
       "const bool full = true;"),), "--checks-only"),
    ("bf16 block-sparse forward: a row with no live tile left with l = 0",
     "block_sparse_attention_fwd_bf16.cu",
     (("const float safe_l = l[i] > 0.f ? l[i] : 1.f;",
       "const float safe_l = l[i];"),), "--checks-only"),
    ("fp32 block-sparse forward: the lo terms dropped (plain TF32 products, "
     "hi only)", "block_sparse_attention_fwd.cu",
     (("  mma_tf32(c, al, bh0, bh1);\n  mma_tf32(c, ah, bl0, bl1);\n", ""),),
     "--checks-only"),
    ("fp32 block-sparse forward: hi(A) lo(B), one of the three terms, "
     "dropped", "block_sparse_attention_fwd.cu",
     (("  mma_tf32(c, ah, bl0, bl1);\n", ""),), "--checks-only"),
    # the fp32 block-sparse backward on 3xTF32
    ("fp32 block-sparse dQ: the product dS K in plain TF32 (hi only)",
     "block_sparse_attention_bwd.cu",
     (("mma_3xtf32(tq[n], sh, sl, bh, bl);  // dQ",
       "mma_tf32(tq[n], sh, bh[0], bh[1]);  // dQ"),), "--checks-only"),
    ("fp32 block-sparse dK/dV: lo(A) hi(B), one of the three terms, dropped "
     "from dV and dK", "block_sparse_attention_bwd.cu",
     (("mma_3xtf32(tv[n], ph, pl, bh, bl);  // dV",
       "mma_tf32(tv[n], ph, bl[0], bl[1]); mma_tf32(tv[n], ph, bh[0], "
       "bh[1]);  // dV"),
      ("mma_3xtf32(tk[n], sh, sl, bh, bl);  // dK",
       "mma_tf32(tk[n], sh, bl[0], bl[1]); mma_tf32(tk[n], sh, bh[0], "
       "bh[1]);  // dK")), "--checks-only"),
    ("fp32 block-sparse dK/dV: the keep bit taken at the transposed "
     "fragment coordinate (key, q row)", "block_sparse_attention_bwd.cu",
     (("hash_col(dr, k0 + kl0", "hash_row(dr, k0 + kl0"),
      ("hash_row(dr, q0 + qh * QC + c0", "hash_col(dr, q0 + qh * QC + c0")),
     "--checks-only"),
    ("fp32 block-sparse dQ and dK/dV: a partial fine mask treated as all "
     "live", "block_sparse_attention_bwd.cu",
     (("const bool full = mask_full(lists, a, p_id);",
       "const bool full = true;"),), "--checks-only"),
    # the int8 matmul's summation order and the fp32 backward's products
    ("bf16 tiled int8: the mma accumulators carried across k segments (one "
     "chain over k), not fresh per segment", "wo_int8_matmul.cu",
     (("sum[i][j][e] = __fadd_rn(sum[i][j][e], acc[i][j][e]);\n"
       "          acc[i][j][e] = 0.f;",
       "sum[i][j][e] = acc[i][j][e];"),), "--checks-only"),
    ("fp32 flash backward: the lo terms dropped (plain TF32 products)",
     "mma.cuh",
     (("  mma_tf32(c, alo, bhi[0], bhi[1]);\n"
       "  mma_tf32(c, ahi, blo[0], blo[1]);\n", ""),), "--checks-only"),
    ("fp32 flash forward: the lo terms dropped (plain TF32 products, hi "
     "only)", "flash_attention_fwd.cu",
     (("  mma_tf32(c, al, bh0, bh1);\n  mma_tf32(c, ah, bl0, bl1);\n", ""),),
     "--checks-only"),
    ("fp32 flash forward: hi(A) lo(B), one of the three terms, dropped",
     "flash_attention_fwd.cu",
     (("  mma_tf32(c, ah, bl0, bl1);\n", ""),), "--checks-only"),
    # the split-KV decode and paged kernels (decode_split.cuh)
    ("split-KV merge: the last live chunk of a row left out of the sums",
     "decode_split.cuh",
     (("      if (k < nb) {", "      if (k < nb - (i0 + 32 >= live)) {"),),
     "--checks-only"),
    ("split-KV merge: the row's counter not reset after the merge (no "
     "later launch merges that row)", "decode_split.cuh",
     (("    if (last_s) a.counters[row] = 0;  // ready for the next launch\n",
       ""),),
     "--checks-only"),
    ("paged: the chunk boundaries one key short of the decode kernel's "
     "(127 keys a chunk; only _paged_is_decode's bit-equality sees it)",
     "paged_attention.cu",
     (('#include "decode_split.cuh"',
       '#define DS_SPLIT_CHUNK 127\n#include "decode_split.cuh"'),),
     "--checks-only"),
    # the head-dim-256 instances (phase 12's kernels)
    ("wgmma: bf16/fp16 flash forward at d-256: Q's descriptors of "
     "neighbouring 16-deep steps swapped (the shared-memory Q read)",
     "flash_attention_fwd_bf16.cu",
     (("desc_at(ql, c * WQ * 128 + kk * 32)",
       "desc_at(ql, c * WQ * 128 + (kk ^ 1) * 32)"),), "--checks-only"),
    ("wgmma: bf16/fp16 flash forward at d-256: S = Q K^T reads the other "
     "K stage, whose barrier the consumer did not wait on (the last "
     "tile's keys, or the next tile's before its phase flips)",
     "flash_attention_fwd_bf16.cu",
     (("    const uint32_t kl = fresh(k_lo) + st * (WTILE * 2 / 16);",
       "    const uint32_t kl = fresh(k_lo) + (st ^ 1) * (WTILE * 2 / 16);"),),
     "--checks-only"),
    # the fp32 d-256 kernels on tf32 wgmma (flash_tf32.cuh and the tf32
    # stagers of wgmma.cuh): ``--planted-faults tf32`` runs these six
    ("tf32: fp32 flash at d-256: the transposed stager writes no lo plane "
     "(V^T, K^T, Q^T and dO^T lose their lo halves)", "wgmma.cuh",
     (("      *reinterpret_cast<uint4*>(dl + sw128_f32(d, (vl % 32) >> 2)) = "
       "lo;\n", ""),), "--checks-only"),
    ("tf32: fp32 flash at d-256: the S-shaped products' hi(A) lo(B) term "
     "dropped (B's lo plane unread)", "flash_tf32.cuh",
     (("      wgmma_tf32<N>(c, h[x][i], desc_at(b, LO + off), 1);\n", ""),),
     "--checks-only"),
    ("tf32: fp32 flash at d-256: the transposed stager's rows out of "
     "c_to_a_tf32's order (position 4h + i of an 8-group holds row "
     "8j + 4h + 2i, not 8j + h + 2i)", "wgmma.cuh",
     (("  const int row = r0 + (c >> 1) * 8 + (c & 1);  // + 2i: rows of "
       "quad c",
       "  const int row = r0 + (c >> 1) * 8 + 4 * (c & 1);  // + 2i: rows "
       "of quad c"),), "--checks-only"),
    ("tf32: fp32 flash at d-256: S reads the next staged operand's slot, "
     "whose barrier the computing warpgroup did not wait on",
     "flash_tf32.cuh",
     (("    s_product<R>(s, frags + tid, desc_lo(slots, 16));",
       "    s_product<R>(s, frags + tid, desc_lo(slots + C::PAIR, 16));"),),
     "--checks-only"),
    ("split-KV fp32 at d-256: each lane's second 16-byte slice left out of "
     "the scores", "decode_split.cuh",
     (("      for (int i = 0; i < LPL; ++i) {\n"
       "        const int c = (t + i * TPK) * VEC;  // the slice's first",
       "      for (int i = 0; i < 1; ++i) {\n"
       "        const int c = (t + i * TPK) * VEC;  // the slice's first"),),
     "--checks-only"),
    ("split-KV merge at d-256: columns past the first 128 never merged",
     "decode_split.cuh",
     (("  for (int cb = 0; cb + warp * 32 < D; cb += THREADS) {",
       "  for (int cb = 0; cb + warp * 32 < D && cb < THREADS; "
       "cb += THREADS) {"),), "--checks-only"),
    ("paged at d-256: the grid one chunk short of the table's keys (a "
     "full row's last chunk never runs)", "paged_attention.cu",
     (("                                      split::CHUNK);",
       "                                      split::CHUNK) - (D == 256);"),),
     "--checks-only"),
    # the flash backward's head-dim-256 instances (phase 13's kernels):
    # ``--planted-faults bwd-d256`` runs these six; ``wgmma`` picks the
    # six faults of the bf16/fp16 d-256 kernels
    ("bwd-d256: wgmma: bf16/fp16 flash dK/dV at d-256: the epilogue "
     "writes the first 128 columns of dK and dV (the rest never written)",
     "flash_attention_bwd_bf16.cu",
     (("    for (int nb = 0; nb < 32; ++nb)\n"
       "      *reinterpret_cast<uint32_t*>(out + off",
       "    for (int nb = 0; nb < 16; ++nb)\n"
       "      *reinterpret_cast<uint32_t*>(out + off"),), "--checks-only"),
    ("bwd-d256: wgmma: bf16/fp16 flash dK/dV at d-256: the keep hash at "
     "the wrong fragment column (q rows 2t and 2t + 1 swapped; caught only "
     "with dropout on)", "flash_attention_bwd_bf16.cu",
     (("          hq[0] = hash_row(dr, q0 + c0);  // a q row is a row\n"
       "          hq[1] = hash_row(dr, q0 + c0 + 1);",
       "          hq[0] = hash_row(dr, q0 + c0 + 1);  // a q row is a row\n"
       "          hq[1] = hash_row(dr, q0 + c0);"),), "--checks-only"),
    ("bwd-d256: wgmma: bf16/fp16 flash dQ at d-256: each 32-key step's "
     "last 16 keys left out of dQ += dS K", "flash_attention_bwd_bf16.cu",
     (("    for (int kc = 0; kc < 2; ++kc)\n"
       "      wgmma_rs_n256<T>(acc, sa[kc],",
       "    for (int kc = 0; kc < 1; ++kc)\n"
       "      wgmma_rs_n256<T>(acc, sa[kc],"),), "--checks-only"),
    ("bwd-d256: wgmma: bf16/fp16 flash dQ at d-256: dS rounded at the "
     "wrong point (D o dP rounded to T before the delta subtraction)",
     "flash_attention_bwd_bf16.cu",
     (("        s[4 * jj + e] = p * (dfac * dp[4 * jj + e] - dlr[i]) * "
       "a.scale;",
       "        s[4 * jj + e] = p * (round_to<T>(dfac * dp[4 * jj + e]) - "
       "dlr[i]) * a.scale;"),), "--checks-only"),
    ("bwd-d256: tf32: fp32 flash dK at d-256: dK's second column half "
     "takes the first half's Q columns (Q^T's rows 128-255 staged from "
     "columns 0-127)", "flash_tf32.cuh",
     (("          load_rows_t<R, D, NT>(x, bt.p, bt.ss, c0, ncol, tid);\n",
       "          load_rows_t<R, D, NT>(x, bt.p, bt.ss, c0, ncol, tid);\n"
       "          if (M == DK)\n"
       "            for (int v = NV / 2; v < NV; ++v) "
       "x[v] = x[v - NV / 2];\n"),),
     "--checks-only"),
    ("bwd-d256: tf32: fp32 flash dQ at d-256: the last visible key step "
     "skipped", "flash_tf32.cuh",
     (("  for (int n = 0; n < steps; ++n) {\n    mbar_wait(&full[0], n & 1);",
       "  for (int n = 0; n < steps - (M == DQ); ++n) {\n"
       "    mbar_wait(&full[0], n & 1);"),),
     "--checks-only"),
    # the serving kernels' fp16 instances (phase 14's), each caught by
    # phase 3's fp16 checks: ``--planted-faults fp16-serving``
    ("fp16-serving: an fp16 pool read through the int8-page instance (the "
     "page code of int8 pages equal to fp16's)", "paged_attention.cu",
     (("  DS_PAGED_DIMS(f16, f16, 2, 2)\n",
       "  DS_PAGED_DIMS(f16, int8_t, 2, 2)\n"),), "--checks-only"),
    ("fp16-serving: int8 B fragments packed as bf16 for fp16 x",
     "wo_int8_matmul.cu",
     (("    b[j][0] = pack_rn<T>(f[0], f[1]);",
       "    b[j][0] = pack_bf16_rn(f[0], f[1]);"),
      ("    b[j][1] = pack_rn<T>(f[2], f[3]);",
       "    b[j][1] = pack_bf16_rn(f[2], f[3]);")), "--checks-only"),
    ("fp16-serving: a decode instance stores bf16 bits into its fp16 output",
     "decode_split.cuh",
     (("namespace split {\n",
       "namespace split {\n"
       "template <typename T>\n"
       "__device__ __forceinline__ T store_bf16_bits(float x) {\n"
       "  if constexpr (sizeof(T) == 2) {\n"
       "    const __nv_bfloat16 b = __float2bfloat16(x);\n"
       "    return *reinterpret_cast<const T*>(&b);\n"
       "  } else {\n"
       "    return from_float<T>(x);\n"
       "  }\n"
       "}\n"),
      ("out[c] = from_float<T>(at / lt);",
       "out[c] = store_bf16_bits<T>(at / lt);"),
      ("out[cc] = from_float<T>(asum / lsum);",
       "out[cc] = store_bf16_bits<T>(asum / lsum);")), "--checks-only"),
    # phase 12c's served-token gate: a fault that one decode step of one
    # prompt (slot 0, the logit rung's case) never sees
    ("12c: int8 pages at head dim 256 read the previous slot's page-table "
     "row in every slot but the first", "paged_attention.cu",
     (("    const long long page = ptab[static_cast<long long>(b) * "
       "max_pages +\n                                logical];",
       "    const long long page = ptab[static_cast<long long>(\n"
       "        b - (sizeof(P) == 1 && D == 256 && b > 0)) * max_pages + "
       "logical];"),), "--gptj-only"),
    # phase 11b's gates against faults in the injection path (Python
    # sources, named relative to the package)
    ("11b: K written to the cache before rotary", "models/layers.py",
     (("        q, k, v = self.project(x, positions, rope)\n",
       "        q, k, v = self.project(x, positions, rope)\n"
       "        if kv_cache is not None:\n"
       "            k = self.qkv(x).unflatten(-1, (3, self.n_heads, -1))"
       "[:, :, 1]\n"),), "--11b-only"),
    ("11b: the NeoX qkv regrouping skipped",
     "module_inject/replace_policy.py",
     (("            qkv_w = _headfirst_qkv_to_split(\n"
       "                _t(sd[lp + \"attention.query_key_value.weight\"]), "
       "nh)",
       "            qkv_w = _t(sd[lp + \"attention.query_key_value.weight\"])"),),
     "--11b-only"),
    ("11b: the paged decode step's rotary position off by one (idx_w + 1)",
     "serving/paging/manager.py",
     (("    positions = idx_w[:, None]\n",
       "    positions = (idx_w + 1)[:, None]\n"),), "--11b-only"),
    # the fp16 block-sparse instances and the dropout kernel (phase 3),
    # and phase 15b's site-words gate
    ("published: fp16 block-sparse forward: P' packed as bf16 before P V "
     "(the fp16 instance only)", "block_sparse_attention_fwd_bf16.cu",
     (("c_to_a16<T>(pa[kc], s[2 * kc], s[2 * kc + 1]);  // p' rounded to T",
       "c_to_a(pa[kc], s[2 * kc], s[2 * kc + 1]);  // p' rounded to T"),),
     "--checks-only"),
    ("published: dropout: a kept element divided by the fp32 1 - rate, not "
     "by dtype(1 - rate)", "dropout.cu",
     (("const float div = round_to<T>(keep);", "const float div = keep;"),),
     "--checks-only"),
    ("published: 15b: the MLP dropout site takes its layer's (attention's) "
     "words",
     "ops/dropout.py",
     (("    return _ActivationDropout.apply(x, site_words(words, site), "
       "float(rate))",
       "    return _ActivationDropout.apply(\n"
       "        x, words if site == MLP_SITE else site_words(words, site),\n"
       "        float(rate))"),), "--published-only"),
    # phase 7a's loss gate against a run whose parameters never move
    ("7a: the LAMB apply launch skipped (parameters unchanged)",
     "fused_lamb.cu",
     (("extern \"C\" int fused_lamb_apply(DS_LAMB_PARAMS) {\n"
       "  if (n_blocks <= 0) return 0;",
       "extern \"C\" int fused_lamb_apply(DS_LAMB_PARAMS) {\n"
       "  if (n_blocks <= 0 || true) return 0;"),), "--7a-only"),
)


def run_in_copy(name, src, edits, flag):
    """Copy chip_smoke.py and the package into a temporary directory, make
    ``edits`` to one source there (``src`` relative to ``ops/csrc``, or to
    the package when it names a directory; as ``sed`` would; each pattern
    must occur) and run ``chip_smoke.py flag`` in the copy; returns the
    finished process and its seconds."""
    import shutil
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp)
        shutil.copytree(os.path.join(REPO, "deepspeed_tpu_torch"),
                        os.path.join(tmp, "deepspeed_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(tmp, "deepspeed_tpu_torch",
                            *(() if "/" in src else ("ops", "csrc")), src)
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"{name!r}: {old!r} not found in {src}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "chip_smoke.py", flag],
                             cwd=tmp, capture_output=True, text=True,
                             timeout=900)
        return res, time.perf_counter() - t0


def run_planted_faults(only=None):
    """Each fault of ``PLANTED_FAULTS`` (those whose source file name or
    description contains ``only``, when given) made in a copy of the checkout
    (``run_in_copy``) with the fault's flag (``--checks-only``,
    ``--8c-only``, ``--7a-only``, ``--11b-only``, ``--gptj-only`` or
    ``--published-only``); each copy must fail.
    Logs each run's failing gate lines (and 8c's and 7a's readings)."""
    faults = [f for f in PLANTED_FAULTS
              if only is None or only in f[1] or only in f[0]]
    caught = 0
    for name, src, edits, flag in faults:
        res, secs = run_in_copy(f"planted fault {name}", src, edits, flag)
        lines = [ln for ln in (res.stdout + res.stderr).splitlines()
                 if "FAIL" in ln or "cases ok" in ln and (
                     "layernorm" in ln or "quantizer" in ln or "flash" in ln
                     or "block_sparse" in ln or "wo_int8" in ln
                     or "decode" in ln or "paged" in ln)
                 or "Error" in ln or "after step" in ln or "losses" in ln
                 or "11b" in ln or "max_abs_err" in ln or "deficit" in ln
                 or "dropout" in ln]
        # the gates' failing summaries first, then the failing cases
        worst = [ln for ln in lines
                 if (m := re.search(r"(\d+)/(\d+) cases ok", ln))
                 and m[1] != m[2]]
        lines = worst + [ln for ln in lines if ln not in worst]
        failed = res.returncode != 0
        caught += failed
        log(f"planted fault: {name} ({src}): {flag} exit "
            f"{res.returncode} in {secs:.1f} s, "
            f"{'caught' if failed else 'NOT CAUGHT'}")
        for ln in lines[:40]:
            log("    " + ln.strip()[:400])
    log(f"{caught} of {len(faults)} planted faults fail the kernel "
        "checks, phase 7a, 8c, 11b, 12c or 15")
    if not faults or caught != len(faults):
        raise AssertionError("a planted kernel fault passed the checks")


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
    timing = bool({"--serving-timing", "--decode-timing"}
                  & set(sys.argv[1:]))
    rest = [a for a in sys.argv[1:] if not a.startswith("--")]
    sys.path.insert(0, os.path.abspath(rest[0]) if timing and rest else REPO)
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
    with open("/proc/meminfo") as f:
        log(f"  host {f.readline().strip()}, {os.cpu_count()} CPUs")
    defaults = gemm_flags()
    set_gemm_flags(GEMM_OFF)
    log(f"  GEMM flags {[n for _, n in GEMM_FLAGS]}: torch's defaults "
        f"{list(defaults)}; off for every phase but 5a, 7a, 8a, 8b, 13a "
        f"and 15a (TF32 off for matmul and cuDNN, bf16 and fp16 GEMM "
        f"reductions in fp32)")

    if "--planted-faults" in sys.argv[1:]:
        run_planted_faults(rest[0] if rest else None)
        return 0
    if "--chunk-sweep" in sys.argv[1:]:
        chunk_sweep(card)
        return 0

    log("phase 2: build")
    t0 = time.perf_counter()
    op_builder.load(verbose=True)
    log(f"  built {len(op_builder.sources())} sources with nvcc for sm_90a "
        f"in {time.perf_counter() - t0:.1f} s")
    for line in op_builder.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())
    check_d256_spills(op_builder.build_log)

    if "--8c-only" in sys.argv[1:]:
        phase_ds_bert_parity()
        log("phase 8c passed (--8c-only: no other phase, no result)")
        return 0
    if "--loop-only" in sys.argv[1:]:
        phase_loop(card)
        log("phase 9 passed (--loop-only: no other phase, no result)")
        return 0
    if "--fp16-only" in sys.argv[1:]:
        phase_training_modes(card)
        log("phase 10 passed (--fp16-only: no other phase, no result)")
        return 0
    if "--inject-only" in sys.argv[1:]:
        log(f"phase 11: {PYTHIA_LAYERS}-layer Pythia-1.4B served from a "
            "HuggingFace-layout checkpoint through checkpoint injection")
        phase_inject(card, profile="--profile" in sys.argv[1:])
        log("phase 11 passed (--inject-only: no other phase, no result)")
        return 0
    if "--11b-only" in sys.argv[1:]:
        phase_inject_parity(card)
        log("phase 11b passed (--11b-only: no other phase, no result)")
        return 0
    if "--gptj-only" in sys.argv[1:]:
        log(f"phase 12: GPT-J-6B (head dim 256) served through checkpoint "
            "injection")
        phase_gptj(card, profile="--profile" in sys.argv[1:])
        log("phase 12 passed (--gptj-only: no other phase, no result)")
        return 0
    if "--fp16-serve-only" in sys.argv[1:]:
        log("phase 14: serving in fp16")
        phase_fp16_serve(card)
        log("phase 14 passed (--fp16-serve-only: no other phase, no result)")
        return 0
    if "--published-only" in sys.argv[1:]:
        log("phase 15: sparse BERT pretrained at its published settings")
        phase_published(card, defaults)
        log("phase 15 passed (--published-only: no other phase, no result)")
        return 0
    if "--gptj-train-only" in sys.argv[1:]:
        log("phase 13: GPT-J-6B's layout (head dim 256) trained")
        phase_gptj_train(card, defaults, profile="--profile" in sys.argv[1:])
        log("phase 13 passed (--gptj-train-only: no other phase, no result)")
        return 0
    if "--7a-only" in sys.argv[1:]:
        set_gemm_flags(defaults)
        phase_sparse_bert_bf16(card)
        log("phase 7a passed (--7a-only: no other phase, no result)")
        return 0
    if "--decode-timing" in sys.argv[1:]:
        decode_timing(card)
        return 0
    if "--serving-ab" in sys.argv[1:]:
        serving_ab(card, rest[0])
        return 0
    if "--d256-ab" in sys.argv[1:]:
        d256_ab(card, rest[0])
        return 0
    if timing:
        serving_timing(card)
        return 0
    if "--serving-only" in sys.argv[1:]:
        model_bf16 = GPT(GPT2_PRESETS["gpt2-125m"], seed=SEED)
        vocab = model_bf16.config.vocab_size
        phase_bf16(model_bf16, *traffic(vocab), SERVING_CONFIG, card)
        phase_paged_bf16(model_bf16, *paged_traffic(vocab), card)
        log("phases 4b and 6b passed (--serving-only: no other phase, no "
            "result)")
        return 0

    log("phase 3: kernels against their plain versions")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    check_flash(dev, gen)
    check_decode(dev, gen)
    check_flash_dropout(dev, gen)
    check_flash_bwd(dev, gen)
    check_flash_bwd_d256(dev, gen)
    check_flash_train_shapes(dev, gen)
    check_fused_adam(dev, gen)
    check_paged(dev, gen)
    check_repeat(dev, gen)
    check_int8(dev, gen)
    check_block_sparse(dev, gen)
    check_block_sparse(dev, gen, dtypes=(torch.float16,))
    check_dropout(dev, gen)
    check_fused_lamb(dev, gen)
    check_layernorm(dev, gen)
    check_quantizer(dev, gen)
    if "--checks-only" in sys.argv[1:]:
        log("every kernel agrees with its plain version (--checks-only: no "
            "timings, no end-to-end phases, no result)")
        return 0
    flash_t = time_flash(dev, gen)
    decode_t = time_decode(dev, gen)
    train_t = time_flash_train(dev, gen)
    train_t["fused_adam"] = time_fused_adam(dev, gen)
    # phase 10's instances: the fp16 flash kernels at 10a's shape (GPT-2's
    # micro batch), Adam and LAMB over bf16 gradient buffers at 10c's
    # models
    fp16_flash_t = time_flash_train(dev, gen, dtype=torch.float16)
    bf16g_t = {"fused_adam_bf16": time_fused_adam(dev, gen, torch.bfloat16),
               "fused_lamb_bf16": time_fused_lamb(dev, gen, torch.bfloat16)}
    # phase 8's shape (bf16) and the fp32 kernels at GPT-2's
    ds_flash_t = time_flash_train(dev, gen, b=DS_MICRO, h=16, s=DS_SEQ,
                                  padded=True)
    fp32_flash_t = time_flash_train(dev, gen, dtype=torch.float32)
    paged_t = {"paged_attention": time_paged(dev, gen, quant=False),
               "paged_attention_int8": time_paged(dev, gen, quant=True),
               "wo_int8_matmul_small_m": time_int8(dev, gen, 16),
               "wo_int8_matmul": time_int8(dev, gen, 256)}
    # bf16 at 7a's shape; fp32 (the parity mode) at 7b's, where its
    # launches are counted, and at 7a's (logged only)
    sparse_t = time_block_sparse(dev, gen)
    sparse_t.update({name + "_fp32": t for name, t in time_block_sparse(
        dev, gen, b=1, s=1024, dtype=torch.float32).items()})
    sparse_fp32_7a_t = time_block_sparse(dev, gen, dtype=torch.float32)
    sparse_t["fused_lamb"] = time_fused_lamb(dev, gen)
    # phase 15a's: the fp16 instances at 7a's shape, beside their bf16
    # twins' times of this run, and one dropout site at 15a's activation
    published_t = {name + "_fp16": t for name, t in time_block_sparse(
        dev, gen, dtype=torch.float16).items()}
    for name, t in published_t.items():
        t["bf16_ms"] = sparse_t[name[:-5]]["ms"]
    published_t["dropout"] = time_dropout(dev, gen)
    ds_t = {**time_layernorm(dev, gen), **time_quantizer(dev, gen)}
    # the decode and paged kernels at long rows (logged, and in the
    # kernels line beside their phase 3 times)
    long_t = time_long_rows(dev, gen)
    log(f"  decode_attention and paged_attention at long rows "
        f"[{long_t['shape']}]: decode {long_t['decode_ms']:.4f} ms (bound "
        f"{long_t['decode_bound_ms']:.4f}), paged {long_t['paged_ms']:.4f} "
        f"ms (bound {long_t['paged_bound_ms']:.4f}) [{card}]")
    decode_t["ms_long_rows"] = long_t["decode_ms"]
    paged_t["paged_attention"]["ms_long_rows"] = long_t["paged_ms"]
    # the fp32 kernels at head_dim 128, the widest (logged only: no main
    # path runs them)
    fp32_d128_t = time_flash_train(dev, gen, d=128, dtype=torch.float32)
    # phase 12's instances at head_dim 256 with GPT-J-6B's 16 heads: the
    # forward at a prefill bucket, decode and paged at 16 slots; bf16 and
    # int8 pages for 12a and 12c, fp32 for 12b
    d256_t = {
        "flash_attention_d256": time_flash(dev, gen, d=256, h=16),
        "flash_attention_d256_fp32": time_flash(dev, gen, d=256, h=16,
                                                dt=torch.float32),
        "decode_attention_d256": time_decode(dev, gen, d=256, H=16),
        "decode_attention_d256_fp32": time_decode(dev, gen, d=256, H=16,
                                                  dt=torch.float32),
        "paged_attention_d256": time_paged(dev, gen, False, d=256, H=16),
        "paged_attention_d256_int8": time_paged(dev, gen, True, d=256,
                                                H=16),
        "paged_attention_d256_fp32": time_paged(dev, gen, False, d=256,
                                                H=16, dt=torch.float32)}
    # phase 13's: the flash forward and both backward kernels at GPT-J-6B's
    # attention shape (dropout 0, as its config), bf16 (13a), fp16 (13b)
    # and fp32 (13c, which runs them at 4 heads and 256 tokens)
    gptj_t = {dt: time_flash_train(dev, gen, **GPTJ_ATTN, rate=0.0,
                                   dtype=dt)
              for dt in (torch.bfloat16, torch.float16, torch.float32)}
    # phase 14's fp16 instances at the bf16 rows' shapes: decode, paged
    # (fp16 and int8 pages) and the int8 matmuls at GPT-2's, the flash
    # forward at a prefill bucket; decode, paged and flash at GPT-J-6B's
    # d 256 (14c)
    fp16_t = {
        "flash_attention_prefill_fp16": time_flash(dev, gen,
                                                   dt=torch.float16),
        "decode_attention_fp16": time_decode(dev, gen, dt=torch.float16),
        "paged_attention_fp16": time_paged(dev, gen, False,
                                           dt=torch.float16),
        "paged_attention_int8_fp16": time_paged(dev, gen, True,
                                                dt=torch.float16),
        "wo_int8_matmul_small_m_fp16": time_int8(dev, gen, 16,
                                                 torch.float16),
        "wo_int8_matmul_fp16": time_int8(dev, gen, 256, torch.float16),
        "flash_attention_d256_fp16": time_flash(dev, gen, d=256, h=16,
                                                dt=torch.float16),
        "decode_attention_d256_fp16": time_decode(dev, gen, d=256, H=16,
                                                  dt=torch.float16),
        "paged_attention_d256_fp16": time_paged(dev, gen, False, d=256,
                                                H=16, dt=torch.float16)}
    for name, t in (("flash_attention (serving prefill)", flash_t),
                    ("decode_attention", decode_t), *train_t.items(),
                    *((f"{k} (fp16)", t) for k, t in fp16_flash_t.items()),
                    *bf16g_t.items(),
                    *ds_flash_t.items(), *fp32_flash_t.items(),
                    *((f"{k} (head_dim 128)", t)
                      for k, t in fp32_d128_t.items()),
                    *paged_t.items(), *sparse_t.items(),
                    *((f"{k}_fp32 (7a's shape)", t)
                      for k, t in sparse_fp32_7a_t.items()),
                    *ds_t.items(), *published_t.items(), *d256_t.items(),
                    *((f"{k} (d 256, {str(dt)[6:]})", t)
                      for dt, ts in gptj_t.items() for k, t in ts.items()),
                    *fp16_t.items()):
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        extra = (f" ({t['impl']}; rows in their own order: "
                 f"{t['ms_natural_order']:.4f} ms; the longest rows alone: "
                 f"{t['ms_heaviest_rows']:.4f} ms; bf16 twin "
                 f"{t['bf16_ms']:.4f} ms)" if "bf16_ms" in t else
                 f" ({t['impl']}; rate 0: {t['ms_rate0']:.4f} ms)"
                 if "ms_rate0" in t else
                 f" ({t['impl']}; rows in their own order: "
                 f"{t['ms_natural_order']:.4f} ms; the longest rows "
                 f"alone: {t['ms_heaviest_rows']:.4f} ms)"
                 if "ms_natural_order" in t else
                 f" ({t['impl']})" if "impl" in t else "")
        log(f"  {name} [{t['shape']}]: kernel {t['ms']:.4f} ms{extra}, "
            f"plain {t['plain_ms']:.4f} ms, library {lib}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) [{card}]")

    log("phase 4: GPT-2 125M served end to end")
    base = GPT2_PRESETS["gpt2-125m"]
    model_fp32 = GPT(dataclasses.replace(base, dtype=torch.float32),
                     seed=SEED)
    model_bf16 = GPT(base, seed=SEED)     # the same weights: same seed
    prompts, outs = traffic(base.vocab_size)
    phase_fp32(model_fp32, prompts, outs, SERVING_CONFIG)
    counts = phase_bf16(model_bf16, prompts, outs, SERVING_CONFIG, card,
                        profile="--profile" in sys.argv[1:])
    phase_cpu_parity(model_fp32)
    del model_fp32, model_bf16
    torch.cuda.empty_cache()
    phase_wide_heads()

    log("phase 5: GPT-2 125M trained end to end")
    set_gemm_flags(defaults)
    train_counts, _ = phase_train_bf16(card,
                                       profile="--profile" in sys.argv[1:])
    set_gemm_flags(GEMM_OFF)
    fp32_train_counts = phase_train_parity()

    log("phase 6: GPT-2 125M served from a paged pool (prefix cache, "
        "chunked prefill, int8 weights, int8 KV pages)")
    model_fp32 = GPT(dataclasses.replace(base, dtype=torch.float32),
                     seed=SEED)
    model_bf16 = GPT(base, seed=SEED)
    prompts, outs = paged_traffic(base.vocab_size)
    phase_paged_fp32(model_fp32, prompts, outs)
    del model_fp32
    paged_counts, _, _ = phase_paged_bf16(
        model_bf16, prompts, outs, card, profile="--profile" in sys.argv[1:])
    engine_int8, int8_tokens, int8_counts = phase_paged_int8_weights(
        model_bf16, prompts, outs, card, profile="--profile" in sys.argv[1:])
    kv_counts = phase_paged_int8_kv(engine_int8, int8_tokens, prompts, outs,
                                    card)
    del engine_int8, model_bf16
    torch.cuda.empty_cache()

    log("phase 7: BERT-base pretraining with block-sparse attention and "
        "FusedLamb")
    set_gemm_flags(defaults)
    sparse_counts, _ = phase_sparse_bert_bf16(
        card, profile="--profile" in sys.argv[1:])
    set_gemm_flags(GEMM_OFF)
    fp32_sparse_counts = phase_sparse_bert_parity()

    log("phase 8: a BERT-large stack of DeepSpeedTransformerLayers with "
        "8-bit compression-aware training and MoQ")
    set_gemm_flags(defaults)
    log("phase 8a: BERT-large DeepSpeedTransformerLayer stack trained "
        "through initialize() -> train_batch with 8-bit symmetric weight "
        f"quantization of {DS_MATRICES} from step 2 (bf16, attention "
        f"dropout 0.1, padding mask, FusedLamb, {DS_MICRO} x {DS_SEQ} "
        "tokens a step)")
    ds_counts, _, _ = phase_ds_bert(card, "compression",
                                    profile="--profile" in sys.argv[1:])
    torch.cuda.empty_cache()
    log("phase 8b: the same stack with MoQ (10 -> 8 bits, period 1, "
        "symmetric) on every matrix")
    phase_ds_bert(card, "moq")
    torch.cuda.empty_cache()
    set_gemm_flags(GEMM_OFF)
    phase_ds_bert_parity()

    log("phase 9: GPT-2 125M through the engine's own loop, checkpoints, "
        "the dataloader, Adagrad and SGD")
    loop_counts = phase_loop(card)

    log("phase 10: the one-card training modes (fp16 with dynamic loss "
        "scaling, activation checkpointing, the chunked loss, bf16 gradient "
        "accumulation, progressive layer drop)")
    mode_counts = phase_training_modes(card)

    log(f"phase 11: {PYTHIA_LAYERS}-layer Pythia-1.4B served from a "
        "HuggingFace-layout checkpoint through checkpoint injection "
        "(rotary attention, the GPT-NeoX policy)")
    import tempfile
    # 11a's fp16 checkpoint, kept on disk for phase 14a
    pythia_ckpt = tempfile.TemporaryDirectory()
    inject = phase_inject(card, profile="--profile" in sys.argv[1:],
                          ckpt_dir=pythia_ckpt.name)

    log("phase 12: GPT-J-6B (d 4096, 16 heads of 256) served through "
        "checkpoint injection: the serving kernels at head dim 256")
    gptj = phase_gptj(card, profile="--profile" in sys.argv[1:])

    log("phase 13: GPT-J-6B's layout (d 4096, 16 heads of 256) trained "
        "through initialize() -> train_batch: the flash backward at head "
        "dim 256")
    gptj_train = phase_gptj_train(card, defaults,
                                  profile="--profile" in sys.argv[1:])

    log("phase 14: serving in fp16 (Pythia-1.4B from its own fp16 "
        "checkpoint; int8 weights and KV pages; GPT-J-6B at head dim 256)")
    fp16_serve = phase_fp16_serve(card, ckpt_dir=pythia_ckpt.name)
    pythia_ckpt.cleanup()

    log("phase 15: sparse BERT-base pretrained at its published settings "
        "(fp16, attention, MLP and embedding dropout 0.1): the fp16 "
        "block-sparse instances and the dropout kernel")
    published_counts, published = phase_published(card, defaults)

    # flash_attention and decode_attention: the serving path's shapes and
    # launches; the other four: the training shape and phase 5a's launches
    flash_t["launches"] = counts["flash_attention"]
    decode_t["launches"] = counts["decode_attention"]
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq", "fused_adam"):
        train_t[name]["launches"] = train_counts[name]
        # and 9a's run A (forward/backward/step, micro 4 x gas 2)
        train_t[name]["loop_launches"] = loop_counts[name]
    # the flash kernels at phase 8's shape: 8a's launches; the fp32
    # kernels at GPT-2's training shape: 5b's (the card's fp32 run)
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        ds_flash_t[name]["launches"] = ds_counts[name]
        fp32_flash_t[name]["launches"] = fp32_train_counts[name]
    # the paged slice's kernels: phase 3's timings at phase 6's shapes;
    # launches of 6b (bf16 pages), 6d (int8 pages) and 6c (int8 weights)
    paged_t["paged_attention"]["launches"] = paged_counts["paged_attention"]
    paged_t["paged_attention_int8"]["launches"] = kv_counts["paged_attention"]
    for name in ("wo_int8_matmul_small_m", "wo_int8_matmul"):
        paged_t[name]["launches"] = int8_counts[name]
    # the sparse slice's kernels: phase 3's timings at phase 7's shapes;
    # launches of 7a (bf16) and, for the fp32 kernels, of 7b (the card's
    # fp32 run, whose shape the *_fp32 timings take)
    for name, t in sparse_t.items():
        t["launches"] = (fp32_sparse_counts[name[:-5]]
                         if name.endswith("_fp32") else sparse_counts[name])
    sparse_t["fused_lamb"]["apply_launches"] = sparse_counts[
        "fused_lamb_apply"]
    # the LayerNorm and quantizer kernels: phase 3's timings at phase 8's
    # shapes; launches of 8a
    for name, t in ds_t.items():
        t["launches"] = ds_counts[name]
    # phase 10's instances: 10a's launches (the run without remat) and
    # 10c's (GPT-2 for Adam, BERT for LAMB)
    for name, t in fp16_flash_t.items():
        t["launches"] = mode_counts[name]
    for name, t in bf16g_t.items():
        t["launches"] = mode_counts[name]
    bf16g_t["fused_lamb_bf16"]["apply_launches"] = mode_counts[
        "fused_lamb_apply"]
    # phase 11's runs, each with its counters set to 0 just before: 11a
    # (bf16 paged serving of the injected checkpoint), 11b (fp32, 2
    # layers: contiguous decode), 11c (int8 weights), 11e (the HF-named
    # sparse attention)
    flash_t["inject_launches"] = inject["11a"]["flash_attention"]
    decode_t["inject_launches"] = inject["11b"]["decode_attention"]
    paged_t["paged_attention"]["inject_launches"] = inject["11a"][
        "paged_attention"]
    for name in ("wo_int8_matmul_small_m", "wo_int8_matmul"):
        paged_t[name]["inject_launches"] = inject["11c"][name]
    sparse_t["block_sparse_attention_fwd"]["inject_launches"] = inject[
        "11e"]["block_sparse_attention_fwd"]
    # phase 12's, each with its counters set to 0 just before: 12a's bf16
    # paged serving (and the decode launches of its generate() references),
    # 12c's int8 KV pages, 12b's fp32 contiguous and paged serving
    for name, run, key in (
            ("flash_attention_d256", "12a", "flash_attention"),
            ("decode_attention_d256", "12a", "generate_decode_attention"),
            ("paged_attention_d256", "12a", "paged_attention"),
            ("paged_attention_d256_int8", "12c", "paged_attention"),
            ("flash_attention_d256_fp32", "12b", "flash_attention"),
            ("decode_attention_d256_fp32", "12b", "decode_attention"),
            ("paged_attention_d256_fp32", "12b", "paged_attention")):
        d256_t[name]["launches"] = gptj[run][key]
    # phase 13's, each with its counters set to 0 just before: 13a (bf16),
    # 13b (fp16), 13c (the card's fp32 run); fused Adam's 13a launches
    # beside its 5a ones
    gptj_train_t = {}
    for dt, run, suffix in ((torch.bfloat16, "13a", ""),
                            (torch.float16, "13b", "_fp16"),
                            (torch.float32, "13c", "_fp32")):
        for key, name in (("flash_attention", "flash_attention_d256_train"),
                          ("flash_attention_bwd_dkv",
                           "flash_attention_bwd_dkv_d256"),
                          ("flash_attention_bwd_dq",
                           "flash_attention_bwd_dq_d256")):
            gptj_t[dt][key]["launches"] = gptj_train[run][key]
            gptj_train_t[name + suffix] = gptj_t[dt][key]
    train_t["fused_adam"]["gptj_launches"] = gptj_train["13a"]["fused_adam"]
    # phase 14's, each with its counters set to 0 just before: 14a's fp16
    # paged serving (and the decode launches of its generate()
    # references), 14b's int8 weights and KV pages, 14c's GPT-J-6B
    for name, run, key in (
            ("flash_attention_prefill_fp16", "14a", "flash_attention"),
            ("decode_attention_fp16", "14a", "generate_decode_attention"),
            ("paged_attention_fp16", "14a", "paged_attention"),
            ("paged_attention_int8_fp16", "14b", "paged_attention"),
            ("wo_int8_matmul_small_m_fp16", "14b", "wo_int8_matmul_small_m"),
            ("wo_int8_matmul_fp16", "14b", "wo_int8_matmul"),
            ("flash_attention_d256_fp16", "14c", "flash_attention"),
            ("decode_attention_d256_fp16", "14c",
             "generate_decode_attention"),
            ("paged_attention_d256_fp16", "14c", "paged_attention")):
        fp16_t[name]["launches"] = fp16_serve[run][key]
    # phase 15a's, with its counters set to 0 just before: the fp16
    # block-sparse instances and both directions of the dropout kernel
    for name, t in published_t.items():
        if name == "dropout":
            t["launches"] = published_counts["dropout_fwd"]
            t["bwd_launches"] = published_counts["dropout_bwd"]
        else:
            t["launches"] = published_counts[name[:-5]]
    csrc, pallas = ("deepspeed_tpu_torch/ops/csrc/",
                    "deepspeed_tpu/ops/pallas/")
    sparse = "deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py"
    kernels = []
    for name, t, src, replaces in (
            ("flash_attention", flash_t, csrc + "flash_attention_fwd_bf16.cu",
             pallas + "flash_attention.py:662"),
            ("decode_attention", decode_t, csrc + "decode_attention.cu",
             pallas + "decode_attention.py:118"),
            ("flash_attention_train", train_t["flash_attention"],
             csrc + "flash_attention_fwd_bf16.cu",
             pallas + "flash_attention.py:662"),
            ("flash_attention_bwd_dkv", train_t["flash_attention_bwd_dkv"],
             csrc + "flash_attention_bwd_bf16.cu",
             pallas + "flash_attention.py:773"),
            ("flash_attention_bwd_dq", train_t["flash_attention_bwd_dq"],
             csrc + "flash_attention_bwd_bf16.cu",
             pallas + "flash_attention.py:773"),
            ("flash_attention_ds_bert", ds_flash_t["flash_attention"],
             csrc + "flash_attention_fwd_bf16.cu",
             pallas + "flash_attention.py:662"),
            ("flash_attention_bwd_dkv_ds_bert",
             ds_flash_t["flash_attention_bwd_dkv"],
             csrc + "flash_attention_bwd_bf16.cu",
             pallas + "flash_attention.py:773"),
            ("flash_attention_bwd_dq_ds_bert",
             ds_flash_t["flash_attention_bwd_dq"],
             csrc + "flash_attention_bwd_bf16.cu",
             pallas + "flash_attention.py:773"),
            ("flash_attention_fp32", fp32_flash_t["flash_attention"],
             csrc + "flash_attention_fwd.cu",
             pallas + "flash_attention.py:662"),
            ("flash_attention_bwd_dkv_fp32",
             fp32_flash_t["flash_attention_bwd_dkv"],
             csrc + "flash_attention_bwd.cu",
             pallas + "flash_attention.py:773"),
            ("flash_attention_bwd_dq_fp32",
             fp32_flash_t["flash_attention_bwd_dq"],
             csrc + "flash_attention_bwd.cu",
             pallas + "flash_attention.py:773"),
            ("fused_adam", train_t["fused_adam"], csrc + "fused_adam.cu",
             pallas + "fused_adam.py:46"),
            ("flash_attention_fp16", fp16_flash_t["flash_attention"],
             csrc + "flash_attention_fwd_bf16.cu",
             pallas + "flash_attention.py:662"),
            ("flash_attention_bwd_dkv_fp16",
             fp16_flash_t["flash_attention_bwd_dkv"],
             csrc + "flash_attention_bwd_bf16.cu",
             pallas + "flash_attention.py:773"),
            ("flash_attention_bwd_dq_fp16",
             fp16_flash_t["flash_attention_bwd_dq"],
             csrc + "flash_attention_bwd_bf16.cu",
             pallas + "flash_attention.py:773"),
            ("fused_adam_bf16", bf16g_t["fused_adam_bf16"],
             csrc + "fused_adam.cu", pallas + "fused_adam.py:46"),
            ("fused_lamb_bf16", bf16g_t["fused_lamb_bf16"],
             csrc + "fused_lamb.cu", pallas + "fused_lamb.py:49"),
            ("paged_attention", paged_t["paged_attention"],
             csrc + "paged_attention.cu", pallas + "paged_attention.py:169"),
            ("paged_attention_int8", paged_t["paged_attention_int8"],
             csrc + "paged_attention.cu", pallas + "paged_attention.py:169"),
            ("wo_int8_matmul_small_m", paged_t["wo_int8_matmul_small_m"],
             csrc + "wo_int8_matmul.cu", pallas + "wo_int8_matmul.py:138"),
            ("wo_int8_matmul", paged_t["wo_int8_matmul"],
             csrc + "wo_int8_matmul.cu", pallas + "wo_int8_matmul.py:167"),
            ("block_sparse_attention_fwd",
             sparse_t["block_sparse_attention_fwd"],
             csrc + "block_sparse_attention_fwd_bf16.cu", sparse + ":355"),
            ("block_sparse_attention_dq", sparse_t["block_sparse_attention_dq"],
             csrc + "block_sparse_attention_bwd_bf16.cu", sparse + ":379"),
            ("block_sparse_attention_dkv",
             sparse_t["block_sparse_attention_dkv"],
             csrc + "block_sparse_attention_bwd_bf16.cu", sparse + ":402"),
            ("block_sparse_attention_fwd_fp32",
             sparse_t["block_sparse_attention_fwd_fp32"],
             csrc + "block_sparse_attention_fwd.cu", sparse + ":355"),
            ("block_sparse_attention_dq_fp32",
             sparse_t["block_sparse_attention_dq_fp32"],
             csrc + "block_sparse_attention_bwd.cu", sparse + ":379"),
            ("block_sparse_attention_dkv_fp32",
             sparse_t["block_sparse_attention_dkv_fp32"],
             csrc + "block_sparse_attention_bwd.cu", sparse + ":402"),
            ("fused_lamb", sparse_t["fused_lamb"], csrc + "fused_lamb.cu",
             pallas + "fused_lamb.py:49"),
            ("layernorm_fwd", ds_t["layernorm_fwd"], csrc + "layernorm.cu",
             pallas + "layernorm.py:34"),
            ("layernorm_bwd", ds_t["layernorm_bwd"], csrc + "layernorm.cu",
             pallas + "layernorm.py:70"),
            ("quantize", ds_t["quantize"], csrc + "quantizer.cu",
             pallas + "quantizer.py:67"),
            ("dequantize", ds_t["dequantize"], csrc + "quantizer.cu",
             pallas + "quantizer.py:141"),
            ("block_sparse_attention_fwd_fp16",
             published_t["block_sparse_attention_fwd_fp16"],
             csrc + "block_sparse_attention_fwd_bf16.cu", sparse + ":355"),
            ("block_sparse_attention_dq_fp16",
             published_t["block_sparse_attention_dq_fp16"],
             csrc + "block_sparse_attention_bwd_bf16.cu", sparse + ":379"),
            ("block_sparse_attention_dkv_fp16",
             published_t["block_sparse_attention_dkv_fp16"],
             csrc + "block_sparse_attention_bwd_bf16.cu", sparse + ":402"),
            # no TPU kernel: flax's nn.Dropout (models/layers.py:618), which
            # XLA fuses
            ("dropout", published_t["dropout"], csrc + "dropout.cu",
             "deepspeed_tpu/models/layers.py:618"),
            *((name, d256_t[name], csrc + src, pallas + replaces)
              for name, src, replaces in (
                  ("flash_attention_d256", "flash_attention_fwd_bf16.cu",
                   "flash_attention.py:662"),
                  ("flash_attention_d256_fp32", "flash_tf32.cuh",
                   "flash_attention.py:662"),
                  ("decode_attention_d256", "decode_attention.cu",
                   "decode_attention.py:118"),
                  ("decode_attention_d256_fp32", "decode_attention.cu",
                   "decode_attention.py:118"),
                  ("paged_attention_d256", "paged_attention.cu",
                   "paged_attention.py:169"),
                  ("paged_attention_d256_int8", "paged_attention.cu",
                   "paged_attention.py:169"),
                  ("paged_attention_d256_fp32", "paged_attention.cu",
                   "paged_attention.py:169"))),
            *((name, t, csrc + ("flash_tf32.cuh" if name.endswith("_fp32")
                                else ("flash_attention_fwd" if "bwd" not in
                                      name else "flash_attention_bwd")
                                + "_bf16.cu"),
               pallas + ("flash_attention.py:773" if "bwd" in name
                         else "flash_attention.py:662"))
              for name, t in gptj_train_t.items()),
            *((name, fp16_t[name], csrc + src, pallas + replaces)
              for name, src, replaces in (
                  ("flash_attention_prefill_fp16",
                   "flash_attention_fwd_bf16.cu", "flash_attention.py:662"),
                  ("decode_attention_fp16", "decode_attention.cu",
                   "decode_attention.py:118"),
                  ("paged_attention_fp16", "paged_attention.cu",
                   "paged_attention.py:169"),
                  ("paged_attention_int8_fp16", "paged_attention.cu",
                   "paged_attention.py:169"),
                  ("wo_int8_matmul_small_m_fp16", "wo_int8_matmul.cu",
                   "wo_int8_matmul.py:138"),
                  ("wo_int8_matmul_fp16", "wo_int8_matmul.cu",
                   "wo_int8_matmul.py:167"),
                  ("flash_attention_d256_fp16", "flash_attention_fwd_bf16.cu",
                   "flash_attention.py:662"),
                  ("decode_attention_d256_fp16", "decode_attention.cu",
                   "decode_attention.py:118"),
                  ("paged_attention_d256_fp16", "paged_attention.cu",
                   "paged_attention.py:169")))):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": t["launches"],
            "max_abs_err": t["max_abs_err"], "max_err": t["max_abs_err"],
            "tol": (ADAM_TOL if name.startswith(("fused_adam", "fused_lamb"))
                    else 0.0 if name in ("quantize", "dequantize", "dropout")
                    else TOL[torch.float32] if name.endswith("_fp32")
                    else TOL[torch.float16] if name.endswith("_fp16")
                    else TOL[torch.bfloat16]),
            "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"],
            **{key: t[key] for key in ("impl", "ms_rate0", "ms_natural_order",
                                       "ms_heaviest_rows", "ms_long_rows",
                                       "bf16_ms", "bwd_launches")
               if key in t},
            **({"apply_launches": t["apply_launches"]}
               if "apply_launches" in t else {}),
            **({"loop_launches": t["loop_launches"]}
               if "loop_launches" in t else {}),
            **({"inject_launches": t["inject_launches"]}
               if "inject_launches" in t else {}),
            **({"gptj_launches": t["gptj_launches"]}
               if "gptj_launches" in t else {}),
            **({"fake_quantize_ms": t["fake_quantize_ms"]}
               if "fake_quantize_ms" in t else {})})
    r = published
    log(f"phase 15a: step wall {r['step_ms']:.2f} ms, "
        f"{r['tokens_per_s']:.0f} tokens/s, peak device memory "
        f"{r['peak_bytes']} bytes, device busy {r['busy_ms']:.2f} ms a step "
        f"({100 * (1 - r['busy_ms'] / r['step_ms']):.1f}% idle), skipped "
        f"steps {r['skipped']} [{card}]")
    r = gptj_train["train"]
    log(f"phase 13a: {r['params']} parameters, step wall "
        f"{r['step_ms']:.2f} ms, {r['tokens_per_s']:.0f} tokens/s, peak "
        f"device memory {r['peak_bytes']} bytes [{card}]")
    for phase, r in (("11a", inject["serve"]), ("12a", gptj["serve"]),
                     ("14a", fp16_serve["serve"])):
        log(f"phase {phase}: {r['tokens_per_s']:.1f} tokens/s, paged decode "
            f"{r['decode_wall_ms']:.3f} ms an iteration, {r['param_bytes']} "
            f"bytes of parameters on the card, loaded in {r['load_s']:.1f} "
            f"s, KV pool {r['pool_bytes']} bytes, host peak RSS "
            f"{r['host_peak_rss']} bytes [{card}]")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
