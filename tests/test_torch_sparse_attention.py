"""The port's block-sparse attention against the JAX package's.

Layouts come from numpy on both sides (BigBird's and Variable's random
blocks from ``default_rng(0)``) and must be bit-equal; the plans of
``compile_layout`` at the JAX package's tiles (128, 256) must equal JAX's
array for array. The plain versions of the kernels (what a CPU tensor
runs) are held against JAX ``sparse_attention`` in Pallas interpret mode
(``backend="pallas"``) and its dense-mask route, on the same numpy inputs.
Tolerances:

- forward: fp32 atol 2e-5 (one function, softmax sums in two orders);
  bf16 atol 2e-2 (outputs of size ~1 at bf16's 8 bits);
- gradients: atol 2e-5 of the largest gradient (fp32; dS is a difference
  of products, so its error is relative to the whole gradient's scale).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu.ops.sparse_attention import sparse_attention as jax_sparse
from deepspeed_tpu.ops.sparse_attention.block_sparse_kernel import \
    compile_layout as jax_compile_layout
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.dropout import seed_words
from deepspeed_tpu_torch.ops.sparse_attention import (
    SparseSelfAttention, layout_to_dense_mask, sparse_attention)
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as psc
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import (
    KERNEL_TILE, compile_layout, device_plan)
from deepspeed_tpu_torch.ops.transformer.attention import \
    _reference_attention
from tests.torch_threads import share_cores

share_cores()

FWD_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRAD_ATOL = 2e-5
H, D = 4, 64

# (name, class name, kwargs) of the five config families; "attention" is
# added for the ones that take it
CONFIGS = [
    ("dense", "DenseSparsityConfig", {}),
    ("fixed", "FixedSparsityConfig", dict(num_local_blocks=4)),
    ("variable", "VariableSparsityConfig",
     dict(num_random_blocks=2, local_window_blocks=[2, 4],
          global_block_indices=[0, 5])),
    ("bigbird", "BigBirdSparsityConfig", dict(num_random_blocks=2)),
    ("longformer", "BSLongformerSparsityConfig",
     dict(global_block_indices=[0, 3])),
]


def make(pkg, cls, heads=H, block=16, **kw):
    return getattr(pkg, cls)(num_heads=heads, block=block, **kw)


def pair(cls, heads=H, block=16, **kw):
    """The same config in both packages."""
    return make(jsc, cls, heads, block, **kw), make(psc, cls, heads, block,
                                                    **kw)


def qkv(shape, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def to_t(arrays, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad)
            for a in arrays]


# --------------------------------------------------------------------------
# layouts and plans
# --------------------------------------------------------------------------

LAYOUT_CASES = [(name, cls, kw, attn, s) for name, cls, kw in CONFIGS
                for attn in ((None,) if name == "dense"
                             else ("bidirectional", "unidirectional"))
                for s in (256, 1024)]


@pytest.mark.parametrize("name,cls,kw,attn,s", LAYOUT_CASES,
                         ids=[f"{c[0]}-{c[3]}-{c[4]}" for c in LAYOUT_CASES])
def test_layouts_bit_equal_to_jax(name, cls, kw, attn, s):
    extra = {} if attn is None else {"attention": attn}
    jcfg, pcfg = pair(cls, different_layout_per_head=True, **kw, **extra)
    np.testing.assert_array_equal(pcfg.make_layout(s), jcfg.make_layout(s))
    assert pcfg.prefix_stable == jcfg.prefix_stable
    assert pcfg.cache_key() == jcfg.cache_key()


# (name, config class, kwargs, seq, the tile JAX picks)
PLAN_CASES = [
    ("dense16", "DenseSparsityConfig", {}, 512, 256),
    ("bigbird16", "BigBirdSparsityConfig", {}, 1024, 256),
    ("fixed-uni16", "FixedSparsityConfig", dict(attention="unidirectional"),
     512, 256),
    ("longformer16", "BSLongformerSparsityConfig", {}, 1024, 128),
    ("variable16", "VariableSparsityConfig",
     dict(num_random_blocks=2, local_window_blocks=[2, 4]), 512, 128),
    ("fixed256", "FixedSparsityConfig", dict(block=256, num_local_blocks=2),
     1024, 256),
]


@pytest.mark.parametrize("name,cls,kw,s,tile", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plans_equal_jax_at_its_tiles(name, cls, kw, s, tile):
    kw = dict(kw)
    block = kw.pop("block", 16)
    jcfg, pcfg = pair(cls, block=block, **kw)
    ref = jax_compile_layout(jcfg, s)
    assert ref.tile == tile
    plan = compile_layout(pcfg, s, tile=tile)
    for f in ("kv_idx", "kv_pid", "kv_cnt", "qt_idx", "qt_pid", "qt_cnt",
              "masks"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(ref, f),
                                      err_msg=f)
    assert (plan.tile, plan.n_heads, plan.nq, plan.active_tiles,
            plan.total_tiles) == (ref.tile, ref.n_heads, ref.nq,
                                  ref.active_tiles, ref.total_tiles)


class _EmptyRow(psc.DenseSparsityConfig):
    def make_layout(self, seq_len):
        layout = super().make_layout(seq_len)
        layout[:, 1] = 0
        return layout


class _JaxEmptyRow(jsc.DenseSparsityConfig):
    def make_layout(self, seq_len):
        layout = super().make_layout(seq_len)
        layout[:, 1] = 0
        return layout


def test_plan_refusals_match_jax():
    """seq % tile, a block that does not divide the tile and an all-empty
    fine row each give None on both sides; the kernel tile's plan of the
    BigBird-64 pattern covers only its own blocks."""
    assert compile_layout(psc.FixedSparsityConfig(H, block=16), 96) is None
    assert jax_compile_layout(jsc.FixedSparsityConfig(H, block=16),
                              96) is None
    assert compile_layout(psc.FixedSparsityConfig(H, block=48), 192) is None
    assert jax_compile_layout(jsc.FixedSparsityConfig(H, block=48),
                              384) is None
    assert compile_layout(_EmptyRow(H), 256) is None
    assert jax_compile_layout(_JaxEmptyRow(H), 256) is None
    bb = psc.BigBirdSparsityConfig(12, block=64, num_random_blocks=3)
    plan = compile_layout(bb, 4096)
    assert plan.tile == KERNEL_TILE and len(plan.masks) == 1
    assert plan.live_pairs == int(bb.make_layout(4096).sum()) * 64 * 64
    coarse = compile_layout(bb, 4096, tile=128)
    assert coarse.active_tiles * 128 ** 2 > 2 * plan.live_pairs


def test_device_plan_is_cached_by_value():
    a = device_plan(psc.BigBirdSparsityConfig(H, block=16), 256, "cpu")
    b = device_plan(psc.BigBirdSparsityConfig(H, block=16), 256, "cpu")
    assert a is b and a.kv_idx.dtype == torch.int32
    assert a.masks.dtype == torch.int8 and a.seq_len == 256


# --------------------------------------------------------------------------
# the plain kernels against JAX
# --------------------------------------------------------------------------

KERNEL_CONFIGS = [
    ("bigbird", "BigBirdSparsityConfig", {}),
    ("fixed-uni", "FixedSparsityConfig", dict(attention="unidirectional")),
    ("longformer", "BSLongformerSparsityConfig", {}),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name,cls,kw", KERNEL_CONFIGS,
                         ids=[c[0] for c in KERNEL_CONFIGS])
def test_forward_matches_jax_pallas(name, cls, kw, dtype):
    """S 256, H 4, D 64: the port's kernel route (plain versions on the
    CPU) against the JAX Pallas kernel in interpret mode."""
    jcfg, pcfg = pair(cls, **kw)
    arrays = qkv((2, 256, H, D), seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_sparse(*(jnp.asarray(a, jdt) for a in arrays), jcfg,
                     backend="pallas")
    out = sparse_attention(*to_t(arrays, dtype), pcfg, backend="kernel")
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=FWD_ATOL[dtype], rtol=0)


def _grads_jax(jcfg, arrays, w, backend, s_dtype=jnp.float32):
    q, k, v = (jnp.asarray(a, s_dtype) for a in arrays)
    fn = lambda q, k, v: jnp.sum(jax_sparse(q, k, v, jcfg,
                                            backend=backend) * w)
    return [np.asarray(g) for g in jax.grad(fn, argnums=(0, 1, 2))(q, k, v)]


def _grads_port(pcfg, arrays, w, backend="kernel"):
    q, k, v = to_t(arrays, grad=True)
    out = sparse_attention(q, k, v, pcfg, backend=backend)
    (out * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


def _close_grads(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=GRAD_ATOL * np.abs(r).max())


GRAD_CASES = [(name, cls, kw, attn) for name, cls, kw in CONFIGS
              for attn in ((None,) if name == "dense"
                           else ("bidirectional", "unidirectional"))]


@pytest.mark.parametrize("name,cls,kw,attn", GRAD_CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in GRAD_CASES])
def test_gradients_match_jax_dense_route(name, cls, kw, attn):
    """dQ, dK, dV of the port's kernel route (the plain dQ and dK/dV
    versions) against jax.grad of the JAX package's dense-mask route."""
    extra = {} if attn is None else {"attention": attn}
    jcfg, pcfg = pair(cls, **kw, **extra)
    arrays = qkv((2, 256, H, D), seed=2)
    w = qkv((2, 256, H, D), seed=3, n=1)[0]
    assert device_plan(pcfg, 256, "cpu") is not None
    _close_grads(_grads_port(pcfg, arrays, w),
                 _grads_jax(jcfg, arrays, w, "dense"))


def test_gradients_match_jax_pallas_kernels():
    """One small case against jax.grad through the JAX Pallas backward
    kernels (interpret mode): BigBird, S 128, 2 heads."""
    jcfg, pcfg = pair("BigBirdSparsityConfig", heads=2)
    arrays = qkv((1, 128, 2, D), seed=4)
    w = qkv((1, 128, 2, D), seed=5, n=1)[0]
    _close_grads(_grads_port(pcfg, arrays, w),
                 _grads_jax(jcfg, arrays, w, "pallas"))


def test_dropout_keep_bits_equal_the_dense_mask_hash():
    """With dropout on, the kernel route draws the keep bits of
    ``ops.dropout.attention_dropout_keep`` (the dense reference with the
    dense mask gives the same output), and the same bits as the JAX
    package (Pallas interpret) from PRNGKey(n) against seed_words(n)."""
    jcfg, pcfg = pair("BigBirdSparsityConfig")
    arrays = qkv((2, 256, H, D), seed=6)
    words = seed_words(7)
    out = sparse_attention(*to_t(arrays), pcfg, backend="kernel",
                           dropout_rate=0.2, dropout_seed=words,
                           deterministic=False)
    mask = layout_to_dense_mask(pcfg, 256)
    ref = _reference_attention(*to_t(arrays), mask=mask, dropout_rate=0.2,
                               dropout_seed=words, deterministic=False)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    dense = sparse_attention(*to_t(arrays), pcfg, backend="dense",
                             dropout_rate=0.2, dropout_seed=words,
                             deterministic=False)
    np.testing.assert_allclose(dense.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    jref = jax_sparse(*(jnp.asarray(a) for a in arrays), jcfg,
                      backend="pallas", dropout_rate=0.2,
                      dropout_rng=jax.random.PRNGKey(7), deterministic=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), atol=2e-5,
                               rtol=0)
    no_drop = sparse_attention(*to_t(arrays), pcfg, backend="kernel")
    assert not torch.allclose(out, no_drop, atol=1e-2)


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of the kernel route (``block_sparse_attention``)."""
    import sys
    mod = sys.modules["deepspeed_tpu_torch.ops.block_sparse_attention"]
    calls = []
    real = mod.block_sparse_attention

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(mod, "block_sparse_attention", spy)
    return calls


def test_extra_masks_take_the_dense_route(kernel_calls):
    jcfg, pcfg = pair("BSLongformerSparsityConfig")
    arrays = qkv((2, 256, H, D), seed=8)
    keep = np.ones((2, 256), bool)
    keep[1, 200:] = False
    ref = jax_sparse(*(jnp.asarray(a) for a in arrays), jcfg,
                     key_padding_mask=jnp.asarray(keep))
    out = sparse_attention(*to_t(arrays), pcfg,
                           key_padding_mask=torch.from_numpy(keep))
    assert not kernel_calls
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)
    amask = torch.from_numpy(keep)[:, None, None, :]
    out2 = SparseSelfAttention(pcfg)(*to_t(arrays), attn_mask=amask)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)
    assert not kernel_calls
    with pytest.raises(ValueError, match="key_padding_mask"):
        sparse_attention(*to_t(arrays), pcfg, attn_mask=amask,
                         backend="kernel")


def test_untileable_layout_is_dense_under_auto_and_raises_for_kernel(
        kernel_calls):
    """S = 96 is no multiple of the 64-token tile: auto takes the dense
    route (equal to JAX's), backend="kernel" raises; a tileable layout in
    auto mode takes the kernel route."""
    jcfg, pcfg = pair("FixedSparsityConfig")
    arrays = qkv((1, 96, H, D), seed=9)
    ref = jax_sparse(*(jnp.asarray(a) for a in arrays), jcfg)
    out = sparse_attention(*to_t(arrays), pcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)
    assert len(kernel_calls) == 1     # asked, and it declined
    with pytest.raises(ValueError, match="cannot be tiled"):
        sparse_attention(*to_t(arrays), pcfg, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        sparse_attention(*to_t(arrays), pcfg, backend="pallas")
    sparse_attention(*to_t(qkv((1, 128, H, D))), pcfg)
    assert len(kernel_calls) == 3


def test_pinned_pattern_at_another_length_goes_dense(kernel_calls):
    """BigBird is not prefix-stable: a layer trained at 512 attends at 256
    through the TRAINED pattern's slice on the dense route, never a new
    random layout (layers.py:529-553)."""
    from deepspeed_tpu_torch.models.layers import SelfAttention
    from deepspeed_tpu_torch.ops.transformer.attention import attention
    cfg = psc.BigBirdSparsityConfig(H, block=16)
    layer = SelfAttention(H, H * D, torch.float32, causal=False,
                          sparsity_config=cfg, sparsity_pattern_len=512)
    q, k, v = to_t(qkv((1, 256, H, D), seed=10))
    out = layer._attend_sparse(q, k, v, None, None, None, False)
    assert not kernel_calls
    pinned = layout_to_dense_mask(cfg, 512)[:, :, :256, :256]
    np.testing.assert_array_equal(
        out.numpy(), attention(q, k, v, mask=pinned).numpy())
    fresh = sparse_attention(q, k, v, cfg)
    assert not np.allclose(out.numpy(), fresh.numpy(), atol=1e-3)
    layer.sparsity_pattern_len = 256
    layer._attend_sparse(q, k, v, None, None, None, False)
    assert len(kernel_calls) == 2
    with pytest.raises(ValueError, match="unidirectional"):
        SelfAttention(H, H * D, torch.float32, sparsity_config=cfg)(
            torch.zeros(1, 64, H * D))


def test_cpu_tensors_never_need_nvcc(monkeypatch):
    from deepspeed_tpu_torch.ops import block_sparse_attention as fn
    monkeypatch.setattr(op_builder, "load", lambda *a, **k: pytest.fail(
        "a CPU tensor asked for the CUDA kernels"))
    before = (fn.fwd_launches, fn.dq_launches, fn.dkv_launches)
    q, k, v = to_t(qkv((1, 128, H, D)), grad=True)
    sparse_attention(q, k, v, psc.BigBirdSparsityConfig(H)).sum().backward()
    assert (fn.fwd_launches, fn.dq_launches, fn.dkv_launches) == before
    assert q.grad is not None and k.grad is not None
