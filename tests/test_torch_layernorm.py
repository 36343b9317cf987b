"""The port's fused LayerNorm against the JAX package's.

On the CPU ``fused_layer_norm`` runs the plain versions of its CUDA
kernels (forward and backward); the JAX ``fused_layer_norm`` runs its
Pallas forward in interpret mode and its jnp backward under ``jax.vjp``.
Same numpy inputs into both. Tolerances: fp32 atol 1e-5 (two fp32
evaluations of one function whose row sums run in different orders;
dgamma and dbeta sum up to 64 rows), bf16 atol 2e-2 (one bf16 rounding of
outputs of magnitude ~1-3).
"""

import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas.layernorm import \
    fused_layer_norm as jax_fused_layer_norm
from deepspeed_tpu_torch.ops import fused_layer_norm
from deepspeed_tpu_torch.ops.layernorm import (BWD_CTAS, BWD_WARPS,
                                               VEC_BYTES, bwd_ctas,
                                               layer_norm_bwd_reference,
                                               layer_norm_fwd_reference)
from tests.torch_threads import share_cores

share_cores()

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed, offset=0.0):
    rs = np.random.RandomState(seed)
    d = shape[-1]
    x = (rs.standard_normal(shape) + offset).astype(np.float32)
    gamma = (1.0 + 0.1 * rs.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rs.standard_normal(d)).astype(np.float32)
    dy = rs.standard_normal(shape).astype(np.float32)
    return x, gamma, beta, dy


def _jax(x, gamma, beta, dy, dtype, eps):
    xj = jnp.asarray(x, _JNP[dtype])
    y, vjp = jax.vjp(lambda a, g, b: jax_fused_layer_norm(a, g, b, eps),
                     xj, jnp.asarray(gamma), jnp.asarray(beta))
    return (y,) + vjp(jnp.asarray(dy, _JNP[dtype]))


def _port(x, gamma, beta, dy, dtype, eps):
    xt = torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_()
    g = torch.from_numpy(gamma).requires_grad_()
    b = torch.from_numpy(beta).requires_grad_()
    y = fused_layer_norm(xt, g, b, eps)
    y.backward(torch.from_numpy(dy).to(_TORCH[dtype]))
    return y, xt.grad, g.grad, b.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [
    ((4, 16, 64), 0.0), ((3, 96), 0.0), ((1, 256), 3.0), ((37, 200), 0.0)])
def test_forward_and_grads_match_jax(shape, offset, dtype):
    x, gamma, beta, dy = _inputs(shape, seed=sum(shape), offset=offset)
    ref = _jax(x, gamma, beta, dy, dtype, 1e-5)
    got = _port(x, gamma, beta, dy, dtype, 1e-5)
    assert got[0].dtype == got[1].dtype == _TORCH[dtype]
    assert got[2].dtype == got[3].dtype == torch.float32
    for name, r, p in zip(("y", "dx", "dgamma", "dbeta"), ref, got):
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(r, np.float32),
                                   atol=TOL[dtype], rtol=0, err_msg=name)


def test_constant_row_and_saved_statistics():
    """A constant row has variance 0: y is beta and dx is 0, with rstd
    1/sqrt(eps); mean and rstd come out fp32, one per row (JAX :34)."""
    x = np.full((2, 64), 3.0, np.float32)
    x[1] = np.linspace(-1, 1, 64)
    gamma, beta = np.ones(64, np.float32), np.arange(64, dtype=np.float32)
    y, mean, rstd = layer_norm_fwd_reference(
        torch.from_numpy(x), torch.from_numpy(gamma),
        torch.from_numpy(beta), 1e-12)
    assert mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == rstd.shape == (2,)
    assert torch.equal(y[0], torch.from_numpy(beta))
    assert rstd[0].item() == pytest.approx(1e6, rel=1e-6)
    dx, _, _ = layer_norm_bwd_reference(torch.ones(2, 64),
                                        torch.from_numpy(x),
                                        torch.from_numpy(gamma), mean, rstd)
    assert torch.equal(dx[0], torch.zeros(64))


def test_eps_and_bf16_dtypes_follow_jax():
    """Round trip through the autograd Function keeps shapes; bf16 x with
    fp32 gamma gives bf16 dx and fp32 dgamma, dbeta (JAX :84-85)."""
    x, gamma, beta, dy = _inputs((2, 5, 48), seed=3)
    for eps in (1e-5, 1e-12):
        ref = _jax(x, gamma, beta, dy, "float32", eps)
        got = _port(x, gamma, beta, dy, "float32", eps)
        np.testing.assert_allclose(got[0].detach().numpy(),
                                   np.asarray(ref[0]), atol=1e-5, rtol=0)
    got = _port(x, gamma, beta, dy, "bfloat16", 1e-5)
    assert got[0].shape == (2, 5, 48)
    assert (got[1].dtype, got[2].dtype, got[3].dtype) == (
        torch.bfloat16, torch.float32, torch.float32)


def test_backward_partition_covers_every_row():
    """The backward's first launch splits rows over ``bwd_ctas(n)`` CTAs
    as [c n / ctas, (c + 1) n / ctas): every CTA gets a row, and the runs
    tile [0, n) (the dgamma/dbeta partials miss no row)."""
    for n in (1, 2, 255, 256, 257, 8192, 8193):
        ctas = bwd_ctas(n)
        assert 1 <= ctas <= min(n, BWD_CTAS)
        bounds = [c * n // ctas for c in range(ctas + 1)]
        assert bounds[0] == 0 and bounds[-1] == n
        assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))


# ---------------------------------------------------------------------------
# the wrapper's width dispatch and row partition against csrc/layernorm.cu
# ---------------------------------------------------------------------------

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "deepspeed_tpu_torch", "ops", "csrc", "layernorm.cu")


def _source():
    with open(CSRC) as f:
        return f.read()


def _rows_of_warps(n, ctas):
    """The rows of each (CTA, warp) of the warp-per-row backward, as the
    kernel computes them: CTA c owns [c n / ctas, (c + 1) n / ctas), its
    warp w the w-th of BWD_WARPS equal cuts of that run."""
    out = []
    for c in range(ctas):
        c0, c1 = c * n // ctas, (c + 1) * n // ctas
        out.append([range(c0 + (c1 - c0) * w // BWD_WARPS,
                          c0 + (c1 - c0) * (w + 1) // BWD_WARPS)
                    for w in range(BWD_WARPS)])
    return out


def test_constants_match_the_kernels():
    src = _source()
    found = re.findall(r"constexpr int BWD_WARPS = (\d+);", src)
    assert found == [str(BWD_WARPS)]
    # a vector is 16 bytes of the row's dtype; whole vectors up to the
    # limit go to the warp-per-row kernels
    assert VEC_BYTES == 16
    assert "return 16 / static_cast<int>(sizeof(T));" in src
    assert "return d % vec_width<T>() == 0 && d <= WARP_ROW_MAX_D;" in src
    # the backward's first launch takes the wrapper's CTA count
    assert "(c1 - c0) * w / BWD_WARPS" in src


@pytest.mark.parametrize("d,dtype,kernel", [
    (8, torch.bfloat16, "warp"), (4, torch.float32, "warp"),
    (768, torch.bfloat16, "warp"), (1024, torch.bfloat16, "warp"),
    (1024, torch.float32, "warp"), (1020, torch.float32, "warp"),
    (1020, torch.bfloat16, "cta"), (1023, torch.bfloat16, "cta"),
    (1023, torch.float32, "cta"), (1032, torch.bfloat16, "cta"),
    (4096, torch.float32, "cta"), (12, torch.bfloat16, "cta")])
def test_width_dispatch(d, dtype, kernel):
    """The C entry points' rule, with layernorm.cu's WARP_ROW_MAX_D, sends
    rows of ``d`` elements of ``dtype`` to ``kernel``: the warp-per-row
    kernels for whole 16-byte vectors up to 1024 elements."""
    src = _source()
    assert "return d % vec_width<T>() == 0 && d <= WARP_ROW_MAX_D;" in src
    max_d = re.findall(r"constexpr int WARP_ROW_MAX_D = (\d+);", src)
    assert max_d == ["1024"]
    vec = VEC_BYTES // torch.empty((), dtype=dtype).element_size()
    warp = d % vec == 0 and d <= int(max_d[0])
    assert ("warp" if warp else "cta") == kernel


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 255, 1055, 1056, 1057, 8192,
                               8193])
def test_backward_rows_over_ctas_and_warps(n):
    """Each row belongs to exactly one warp of one CTA, in order; at most
    ``BWD_CTAS`` CTAs, and no CTA without a row."""
    ctas = bwd_ctas(n)
    assert ctas == min(BWD_CTAS, -(-n // BWD_WARPS))
    parts = _rows_of_warps(n, ctas)
    assert all(sum(len(r) for r in warps) > 0 for warps in parts)
    assert [i for warps in parts for r in warps for i in r] == list(range(n))


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    from deepspeed_tpu_torch.ops.layernorm import MAX_D, _check
    with pytest.raises(ValueError):
        _check(torch.zeros(2, MAX_D + 1), torch.ones(MAX_D + 1),
               torch.zeros(MAX_D + 1))
    with pytest.raises(ValueError):
        _check(torch.zeros(2, 8), torch.ones(8, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        _check(torch.zeros(2, 8, dtype=torch.float16), torch.ones(8))
