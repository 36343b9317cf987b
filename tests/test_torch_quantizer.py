"""The port's group-wise quantizer and ``fake_quantize`` against the JAX
package's.

On the CPU ``quantize`` / ``dequantize`` run the plain versions of their
CUDA kernels; the JAX ``quantize`` runs its Pallas kernels in interpret
mode. The JAX functions are compiled with ``jax.jit``, as the JAX package
runs them (the interpreted Pallas kernels, the Compressor and MoQ
projections): XLA folds a division by the constant qmax into a product
with its fp32 reciprocal and contracts ``q * scale + zp`` into one FMA,
and the port computes the same. Deterministic codes, scales, zero points
and dequantized values are bit-equal (tolerance 0). Stochastic rounding
draws its uniforms from the TPU PRNG (``jax.random`` in interpret mode)
in JAX and from the port's counter hash, so it is held by distribution:
codes within one grid step of x, and the mean error over 64 seeds within
3 standard errors of 0, for both packages.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.compression.compress import fake_quantize as jax_fq
from deepspeed_tpu.ops.pallas import quantizer as jq
from deepspeed_tpu_torch.compression.compress import fake_quantize
from deepspeed_tpu_torch.ops import dequantize, quantize
from deepspeed_tpu_torch.ops.quantizer import uniform24
from tests.torch_threads import share_cores

share_cores()

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _x(shape, seed, zero_group=None):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal(shape) * rs.uniform(0.1, 3.0, (shape[0], 1))
         ).astype(np.float32)
    if zero_group is not None:
        x[zero_group] = 0.0            # the scale floor
    return x


def _equal(port, ref):
    ref = np.asarray(ref)
    port = port.numpy() if port.dtype != torch.bfloat16 else \
        port.float().numpy()
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port, ref.astype(port.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("asymmetric", [False, True])
@pytest.mark.parametrize("groups", [1, 16, 64])
def test_codes_scales_and_values_equal_jax(groups, asymmetric, dtype):
    x = _x((64, 96), seed=groups, zero_group=5)
    xj = jnp.asarray(x, _JNP[dtype])
    ref = jax.jit(lambda v: jq.quantize(v, groups,
                                        asymmetric=asymmetric))(xj)
    got = quantize(torch.from_numpy(x).to(_TORCH[dtype]), groups,
                   asymmetric=asymmetric)
    assert len(got) == len(ref) == (3 if asymmetric else 2)
    assert got[0].dtype == (torch.uint8 if asymmetric else torch.int8)
    for g, r in zip(got, ref):
        _equal(g, r)
    deq = jax.jit(jq.dequantize)(*ref)
    _equal(dequantize(*got), deq)


@pytest.mark.parametrize("bits", [4, 8, 12])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("shape", [(48, 40), (3, 8, 24), (200,)])
def test_fake_quantize_equals_jax(shape, symmetric, bits):
    """Per channel along the last axis (a 1-D leaf is one group), with an
    all-zero column where the 1e-8 scale floor applies."""
    rs = np.random.RandomState(bits + len(shape))
    w = rs.standard_normal(shape).astype(np.float32)
    if len(shape) > 1:
        w[..., 5] = 0.0
    ref = jax.jit(lambda v: jax_fq(v, bits, symmetric))(jnp.asarray(w))
    got = fake_quantize(torch.from_numpy(w), bits, symmetric)
    assert got.dtype == torch.float32
    _equal(got, ref)
    # the grid: at most 2^bits distinct values per column
    cols = got.reshape(-1, shape[-1]) if len(shape) > 1 \
        else got.reshape(-1, 1)
    assert max(len(torch.unique(cols[:, j]))
               for j in range(cols.shape[1])) <= 2 ** bits


def test_code_types_and_bit_range():
    x = torch.from_numpy(_x((4, 32), seed=1))
    q, s = quantize(x, 4, bits=12)
    assert q.dtype == torch.int16 and int(q.abs().max()) == 2 ** 11 - 1
    q, s, z = quantize(x, 4, asymmetric=True, bits=12)
    assert q.dtype == torch.int16 and int(q.max()) == 2 ** 12 - 1
    assert int(q.min()) == 0
    for bad in (1, 16):
        with pytest.raises(ValueError):
            quantize(x, 4, bits=bad)
    with pytest.raises(ValueError):
        quantize(x, 5)


def test_stochastic_rounding_bounds_and_reproducibility():
    x = torch.from_numpy(_x((16, 256), seed=2))
    q1, s1 = quantize(x, 16, stochastic=True, seed=7)
    q2, s2 = quantize(x, 16, stochastic=True, seed=7)
    q3, _ = quantize(x, 16, stochastic=True, seed=8)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    assert not torch.equal(q1, q3)
    assert q1.dtype == torch.int8 and int(q1.abs().max()) <= 127
    scaled = x / s1[:, None]
    # every code is floor or ceil of x / scale
    assert bool(((q1.float() - torch.floor(scaled)) >= 0).all())
    assert bool(((q1.float() - torch.floor(scaled)) <= 1).all())
    # the deterministic scale is the stochastic one
    assert torch.equal(quantize(x, 16)[1], s1)
    # the uniforms: 24 bits, in [0, 1), distinct per element
    u = uniform24((0, 7), torch.arange(4096, dtype=torch.int64))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02


def _sr_mean_error(run, x, seeds=64):
    errs = torch.stack([run(x, s) - x for s in range(seeds)])
    mean = errs.mean().item()
    stderr = errs.std().item() / np.sqrt(errs.numel())
    return mean, stderr


def test_stochastic_rounding_is_unbiased_in_both_packages():
    x = torch.from_numpy(_x((8, 512), seed=3))

    def port(v, seed):
        return dequantize(*quantize(v, 8, stochastic=True, seed=seed))

    def jax_sr(v, seed):
        q, s = jq.quantize(jnp.asarray(v.numpy()), 8, stochastic=True,
                           seed=seed)
        return torch.from_numpy(np.array(jq.dequantize(q, s)))

    for run in (port, jax_sr):
        mean, stderr = _sr_mean_error(run, x)
        assert abs(mean) <= 3 * stderr, (run.__name__, mean, stderr)
    # the two packages' per-element error spreads agree (same grid)
    pe = torch.stack([port(x, s) - x for s in range(16)]).std().item()
    je = torch.stack([jax_sr(x, s) - x for s in range(16)]).std().item()
    assert abs(pe - je) / je < 0.05
