"""The rounding points of the bf16 block-sparse backward, held against the
JAX package.

The port's bf16 dQ and dK/dV kernels (``csrc/block_sparse_attention_bwd_
bf16.cu``) round where their plain versions round: P∘D to bf16 before
dV, dS to bf16 before dK and dQ, fp32 sums, and the stores. On the CPU
the kernel route runs those plain versions; here their bf16 gradients are
held against ``jax.grad`` through the JAX package's Pallas block-sparse
kernels in bf16 (interpret mode), on the same numpy inputs, with dropout
off and at 0.2 (seed words ``seed_words(n)`` against ``PRNGKey(n)``, which
give the same keep bits). Tolerances, per tensor:

- atol = 2e-2 × max|ref|: the two sides walk different tiles (the port
  64, JAX 128 or 256), so the forward's P is rounded against different
  running maxima and the fp32 sums go in other orders; one bf16 ulp
  (2^-8 relative) of a gradient of size max|ref| is 4e-3 of it.
- rms(err) / rms(ref) <= 5e-4 for dV and 2.5e-3 for dQ and dK: this is
  what pins the rounding points. dV sees the same rounded P∘D on both
  sides and reads <= 4.2e-5; dQ and dK carry delta = rowsum(dO∘O), whose
  O differs with the tiles, and read <= 1.6e-3. P∘D left unrounded reads
  2.6e-3 on dV, and dP rounded before delta is subtracted 3.4e-3 on dK.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.sparse_attention import sparse_attention as jax_sparse
from deepspeed_tpu_torch.ops.dropout import seed_words
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import \
    device_plan
from tests.test_torch_sparse_attention import pair, qkv, to_t
from tests.torch_threads import share_cores

share_cores()

ATOL = 2e-2          # of max|ref|, per tensor
RMS = {"dq": 2.5e-3, "dk": 2.5e-3, "dv": 5e-4}   # rms(err) / rms(ref)
H, D = 2, 64

# (name, config class, kwargs, seq): BigBird with the kernel tile's block
# (every fine mask all live) and two block-16 layouts (partial masks; the
# causal diagonal for the unidirectional one)
CASES = [
    ("bigbird-64", "BigBirdSparsityConfig", dict(block=64,
                                                 num_random_blocks=1), 256),
    ("fixed-uni-16", "FixedSparsityConfig",
     dict(block=16, attention="unidirectional"), 128),
    ("longformer-16", "BSLongformerSparsityConfig", dict(block=16), 256),
]


def _grads(jcfg, pcfg, s, rate, seed):
    arrays = qkv((1, s, H, D), seed=seed)
    w = qkv((1, s, H, D), seed=seed + 1, n=1)[0]
    drop = dict(dropout_rate=rate, deterministic=rate == 0.0)
    fn = lambda q, k, v: jnp.sum(jax_sparse(
        q, k, v, jcfg, backend="pallas",
        dropout_rng=jax.random.PRNGKey(seed) if rate else None,
        **drop).astype(jnp.float32) * w)
    ref = jax.grad(fn, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays))
    q, k, v = to_t(arrays, torch.bfloat16, grad=True)
    out = sparse_attention(q, k, v, pcfg, backend="kernel",
                           dropout_seed=seed_words(seed) if rate else None,
                           **drop)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad for t in (q, k, v)], [np.asarray(r, np.float32)
                                         for r in ref]


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["rate0", "rate0.2"])
@pytest.mark.parametrize("name,cls,kw,s", CASES, ids=[c[0] for c in CASES])
def test_bf16_gradients_match_jax_pallas(name, cls, kw, s, rate):
    kw = dict(kw)
    jcfg, pcfg = pair(cls, heads=H, block=kw.pop("block"), **kw)
    assert device_plan(pcfg, s, "cpu") is not None
    got, ref = _grads(jcfg, pcfg, s, rate, seed=11)
    for g, r, what in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16, what
        g = g.float().numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL * np.abs(r).max(),
                                   err_msg=f"{name} rate={rate} {what}")
        rms = np.sqrt(np.mean((g - r) ** 2) / np.mean(r ** 2))
        assert rms <= RMS[what], (name, rate, what, rms)


def test_bf16_dropout_changes_the_gradients():
    """The rate-0.2 case draws keep bits: its gradients differ from rate 0
    by far more than the tolerance, so the comparison above sees them."""
    jcfg, pcfg = pair("BigBirdSparsityConfig", heads=H, block=64,
                      num_random_blocks=1)
    got0, _ = _grads(jcfg, pcfg, 256, 0.0, seed=11)
    got2, ref2 = _grads(jcfg, pcfg, 256, 0.2, seed=11)
    for g0, g2, r in zip(got0, got2, ref2):
        gap = (g0.float() - g2.float()).abs().max().item()
        assert gap > 5 * ATOL * np.abs(r).max()
