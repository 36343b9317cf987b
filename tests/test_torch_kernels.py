"""The port's kernel modules against the JAX package's kernels.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX Pallas kernels run in interpret mode (as tests/unit/test_pallas_ops.py
runs them). Same numpy inputs into both. Tolerance: atol 1e-5 in fp32
(two fp32 evaluations of one function that sum in different orders) and
2e-2 in bf16 (one bf16 rounding of outputs of magnitude ~1, plus the
bf16 cast of the probabilities before the PV product in each).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.layers import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import decode_attention as jax_decode
from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu_torch.models.layers import alibi_slopes
from deepspeed_tpu_torch.ops import decode_attention, flash_attention
from deepspeed_tpu_torch.ops._common import NEG_INF
from deepspeed_tpu_torch.ops.transformer.attention import (
    _reference_attention, attention)
from tests.torch_threads import share_cores

share_cores()

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x, dtype):
    """The same numpy array as a JAX array and a torch CPU tensor."""
    return (jnp.asarray(x, _JNP[dtype]),
            torch.from_numpy(x).to(_TORCH[dtype]))


def _close(jax_out, torch_out, dtype):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=TOL[dtype], rtol=0)


def _bias(kind, b, h, sq, sk, rng):
    if kind is None:
        return None
    if kind == "cache_mask":     # [1, 1, sq, sk], as serving prefill builds
        cols = np.arange(sk)[None, :]
        rows = np.arange(sq)[:, None] + (sk - sq)
        return np.where(cols <= rows, 0.0, NEG_INF)[None, None].astype(
            np.float32)
    if kind == "padding":        # [b, 1, 1, sk]
        keep = np.ones((b, sk), bool)
        keep[0, sk - 40:] = False
        return np.where(keep, 0.0, NEG_INF)[:, None, None, :].astype(
            np.float32)
    return rng.standard_normal((b, h, sq, sk)).astype(np.float32)   # full


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sk,bias_kind", [
    (True, 128, None),
    (True, 128, "padding"),
    (False, 256, "cache_mask"),
    (False, 256, "full"),
])
def test_flash_attention_plain_matches_jax(dtype, causal, sk, bias_kind):
    b, sq, h, d = 2, 128, 2, 64
    rng = np.random.RandomState(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
    bias = _bias(bias_kind, b, h, sq, sk, rng)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    ref = jax_flash(jq, jk, jv, bias=jb, causal=causal, block_q=64)
    out = flash_attention(tq, tk, tv, bias=tb, causal=causal)
    assert out.dtype == _TORCH[dtype] and out.shape == (b, sq, h, d)
    _close(ref, out, dtype)


def test_attention_dispatch_matches_reference_attention():
    """The mask folds to NEG_INF and rides the flash path; on rows that
    keep at least one key it equals the dense reference (finfo.min)."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 48, 2, 64))
                                .astype(np.float32)) for _ in range(3))
    mask = torch.ones(2, 1, 1, 48, dtype=torch.bool)
    mask[1, ..., 30:] = False
    out = attention(q, k, v, mask=mask, causal=True)
    ref = _reference_attention(q, k, v, mask=mask, causal=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        attention(q, k, v, seq_parallel="ring")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alibi", [False, True])
def test_decode_attention_plain_matches_jax(dtype, alibi):
    B, H, S, d = 4, 2, 256, 64
    rng = np.random.RandomState(2)
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    k = rng.standard_normal((B, H, S, d)).astype(np.float32)
    v = rng.standard_normal((B, H, S, d)).astype(np.float32)
    lengths = np.asarray([0, 1, 77, S], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    # the JAX kernel reads the K^T layout [B, H, d, S]
    ref = jax_decode(jq, jnp.swapaxes(jk, 2, 3), jnp.swapaxes(jv, 2, 3),
                     jnp.asarray(lengths),
                     alibi_slopes=jax_alibi_slopes(H) if alibi else None,
                     block_k=128)
    out = decode_attention(tq, tk, tv, torch.from_numpy(lengths),
                           alibi_slopes=alibi_slopes(H) if alibi else None)
    assert out.shape == (B, 1, H, d) and out.dtype == _TORCH[dtype]
    _close(ref, out, dtype)
    assert not out[0].float().any()          # length 0 -> zeros


def test_decode_attention_never_reads_past_length():
    """Garbage (NaN) past each row's length must not reach the output."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 2, 64)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 100, 64)).astype(
        np.float32)) for _ in range(2))
    lengths = torch.tensor([5, 60], dtype=torch.int32)
    for b, n in enumerate(lengths.tolist()):
        k[b, :, n:] = float("nan")
        v[b, :, n:] = float("nan")
    out = decode_attention(q, k, v, lengths)
    assert torch.isfinite(out).all()


def test_alibi_slopes_match_jax():
    for h in (2, 12, 6):
        np.testing.assert_allclose(alibi_slopes(h).numpy(),
                                   np.asarray(jax_alibi_slopes(h)), rtol=0)
