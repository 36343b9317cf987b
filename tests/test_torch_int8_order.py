"""What makes a token served in a batch equal ``generate()``'s: the
weight-only int8 matmul's summation order and its k split, and the tied
LM head's fixed GEMM shape when decoding.

Both CUDA kernels of ``csrc/wo_int8_matmul.cu`` sum in one canonical
order (segments of ``SEG`` k rows, each a chain from zero, the partials
added in segment order), so a row's result does not depend on m or on the
row's place in the batch; the wrapper routes m <= ``SMALL_M`` to the
small-m kernel and picks the bf16 tiled kernel's k split
(``tiled_splits``). The card holds the bits (``chip_smoke.py``
``check_int8``); here the wrapper's constants are held to the kernel
source's, as ``test_torch_head_dims.py`` holds ``HEAD_DIMS``, the split
rule to the kernel header's, and the plain version at a ragged k (neither
a whole segment nor a whole 16-row step) to JAX ``wo_int8_matmul`` (its
Pallas kernel in interpret mode; fp32 within 1e-5 of max(1, max |ref|),
bf16 within 2e-2: one bf16 rounding of the output). The tied head of a
cached forward (``models.gpt.tied_head_rows``) runs every GEMM at
``HEAD_ROWS`` rows, so a row's logits are the same bits alone, in a
batch, or anywhere in a prefill.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.wo_int8_matmul import \
    wo_int8_matmul as jax_wo_int8_matmul
from deepspeed_tpu_torch.models.gpt import HEAD_ROWS, tied_head_rows
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.wo_int8_matmul import (
    SEG, SMALL_M, SPLIT_TILES, TILE_M, TILE_N, tiled_splits, wo_int8_matmul)
from tests.torch_threads import share_cores

share_cores()

SOURCE = os.path.join(os.path.dirname(op_builder.__file__), "csrc",
                      "wo_int8_matmul.cu")


def _constant(name):
    with open(SOURCE) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert len(found) == 1, name
    return int(found[0])


@pytest.mark.parametrize("name,value", [("SEG", SEG), ("SMALL_M", SMALL_M)])
def test_constants_match_the_cuda_source(name, value):
    assert _constant(name) == value


def test_tile_matches_the_tiled_kernel():
    with open(SOURCE) as f:
        tiles = re.findall(r"constexpr int TM = (\d+), TN = (\d+)", f.read())
    assert tiles == [(str(TILE_M), str(TILE_N))]


SHAPES = [(m, k, n) for m in (17, 64, 256, 1000, 4096)
          for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768),
                       (200, 768), (128, 768), (4096, 64))]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tiled_splits_follow_the_rule(m, k, n):
    """One CTA a tile when the tiles alone fill half the card, else one
    CTA a k segment."""
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    want = 1 if tiles >= SPLIT_TILES else -(-k // SEG)
    assert tiled_splits(m, k, n) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_k_matches_jax(dtype):
    k, n = 200, 768
    r = np.random.RandomState(11)
    q = r.randint(-127, 128, size=(k, n)).astype(np.int8)
    scale = (r.rand(1, n) * 0.02).astype(np.float32)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for m in (1, SMALL_M, SMALL_M + 1):
        x = r.randn(m, k).astype(np.float32)
        ref = np.asarray(jax_wo_int8_matmul(
            jnp.asarray(x).astype(jd), jnp.asarray(q), jnp.asarray(scale)
        ).astype(jnp.float32))
        got = wo_int8_matmul(torch.from_numpy(x).to(dtype),
                             torch.from_numpy(q), torch.from_numpy(scale))
        assert got.dtype == dtype and got.shape == (m, n)
        err = np.abs(got.float().numpy() - ref).max() / max(
            1.0, np.abs(ref).max())
        assert err <= (1e-5 if dtype == torch.float32 else 2e-2), (m, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tied_head_rows_do_not_depend_on_the_batch(dtype):
    g = torch.Generator().manual_seed(5)
    w = torch.randn(1000, 64, generator=g).to(dtype)
    h = torch.randn(3, 2 * HEAD_ROWS + 7, 64, generator=g).to(dtype)
    full = tied_head_rows(h, w)
    assert full.shape == (3, 2 * HEAD_ROWS + 7, 1000)
    rows = full.reshape(-1, 1000)
    flat = h.reshape(-1, 64)
    for lo, hi in ((0, 1), (5, 6), (HEAD_ROWS - 1, HEAD_ROWS + 3),
                   (70, 87), (0, flat.shape[0])):
        assert torch.equal(tied_head_rows(flat[lo:hi], w), rows[lo:hi])
