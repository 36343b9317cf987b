"""Head dim 256 (GPT-J-6B's) in the port's serving kernels, on the CPU.

The plain versions that the CUDA kernels are held to on the card, against
the JAX package at head_dim 256: the flash forward with dropout and its
LSE (the JAX side runs its Pallas kernel in interpret mode, as
tests/unit/test_pallas_ops.py runs it), and the split-KV design of the
decode and paged kernels (``tests/test_torch_decode_split.py``'s fp32
emulation: chunks of ``CHUNK`` keys merged in chunk order) against JAX
decode attention (Pallas interpret) and paged attention (dense, bf16 and
int8 pages). Tolerances as at the other head dims: flash fp32 atol 1e-5,
bf16 2e-2 (one bf16 rounding of outputs ~1); split-KV 2e-6 x max(1,
max |ref|) (one function in two fp32 summation orders).

A 2-layer GPT-J at d_model 512 with 2 heads of 256 (rotary over 64 of
each head's dims) built from ``transformers``' ``GPTJConfig`` with seeded
weights, injected by both packages: fp32 logits within 1e-4, greedy
``generate()`` and paged serving token for token.

The wrappers' head dims against the CUDA sources' dispatch (256 in every
one, the flash backward's too), and the refusal that remains on CUDA: a
flash forward at a head dim no kernel takes, with or without a gradient,
named before any launch.
"""

import functools
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu.module_inject as jmi
from deepspeed_tpu.inference.generation import generate as jax_generate
from deepspeed_tpu.models.layers import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu.ops.pallas.decode_attention import \
    decode_attention as jax_decode_attention
from deepspeed_tpu.ops.pallas.flash_attention import (
    _flash_fwd as jax_flash_fwd, pack_dropout_seeds)
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_attention as jax_paged_attention
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.engine import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.paging import PagingConfig as JaxPagingConfig
import deepspeed_tpu_torch.module_inject as pmi
from deepspeed_tpu_torch.inference import engine as engine_mod
from deepspeed_tpu_torch.inference.generation import generate
from deepspeed_tpu_torch.models.layers import alibi_slopes
from deepspeed_tpu_torch.ops import (decode_attention, op_builder,
                                     paged_attention)
from deepspeed_tpu_torch.ops.decode_attention import \
    HEAD_DIMS as DECODE_HEAD_DIMS
from deepspeed_tpu_torch.ops.flash_attention import (BWD_HEAD_DIMS,
                                                     FWD_HEAD_DIMS,
                                                     flash_attention)
from deepspeed_tpu_torch.ops.paged_attention import \
    HEAD_DIMS as PAGED_HEAD_DIMS
from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine
from tests.test_torch_decode_split import (HEADS, _close as _split_close,
                                           _decode_case, _paged_case, _t,
                                           emulate_decode, emulate_paged)
from tests.test_torch_flash_bwd import _bias, _inputs, _words
from tests.test_torch_head_dims import _dispatched_dims
from tests.torch_threads import share_cores

share_cores()

T = pytest.importorskip("transformers")

D = 256
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")


# ---------------------------------------------------------------------------
# the flash forward's plain version against JAX's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate,bias_kind", [(0.0, None), (0.1, "padding")])
def test_flash_forward_matches_jax(dtype, rate, bias_kind):
    b, h, sq, sk = 1, 2, 128, 128
    q, k, v, _, rng = _inputs(b, sq, sk, h, D, 0)
    bias = _bias(bias_kind, b, h, sq, sk, rng)
    key = jax.random.PRNGKey(3)
    jq, jk, jv = (jnp.asarray(x, _JNP[dtype]) for x in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    ref, ref_lse = jax_flash_fwd(
        *(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)), jb,
        pack_dropout_seeds(key) if rate else None, D ** -0.5, True, rate,
        h, 64)
    tq, tk, tv = (torch.from_numpy(x).to(_TORCH[dtype]) for x in (q, k, v))
    out, lse = flash_attention(
        tq, tk, tv, bias=None if bias is None else torch.from_numpy(bias),
        causal=True, dropout_rate=rate, dropout_seed=_words(3),
        return_lse=True)
    assert out.shape == (b, sq, h, D) and out.dtype == _TORCH[dtype]
    np.testing.assert_allclose(
        out.float().numpy(),
        np.asarray(jnp.swapaxes(ref, 1, 2), np.float32), atol=TOL[dtype],
        rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=TOL["float32"], rtol=1e-6)


def test_flash_forward_matches_jax_public_entry():
    """The same through JAX's public ``flash_attention`` (its custom_vjp
    wrapper, BSHD layout), bf16, dropout and ALiBi rows."""
    b, h, sq, sk = 1, 2, 64, 128
    q, k, v, _, rng = _inputs(b, sq, sk, h, D, 4)
    bias = _bias("alibi", b, h, sq, sk, rng)
    key = jax.random.PRNGKey(6)
    ref = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                    bias=jnp.asarray(bias), causal=True, dropout_rate=0.5,
                    dropout_rng=key, block_q=64)
    out = flash_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        bias=torch.from_numpy(bias), causal=True, dropout_rate=0.5,
        dropout_seed=_words(6))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TOL["bfloat16"], rtol=0)


# ---------------------------------------------------------------------------
# the split-KV emulation against JAX decode and paged attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
def test_decode_emulation_matches_jax_decode_attention(alibi):
    q, k, v, lengths = _decode_case(D, D)
    ref = jax_decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k.swapaxes(2, 3)),
        jnp.asarray(v.swapaxes(2, 3)), jnp.asarray(lengths),
        alibi_slopes=jax_alibi_slopes(HEADS) if alibi else None,
        block_k=128)
    got = emulate_decode(_t(q), _t(k), _t(v), lengths,
                         alibi_slopes(HEADS) if alibi else None)
    _split_close(got.numpy(), ref[:, 0])
    assert not got[0].any()            # length 0: zeros
    # and the wrapper's plain version on the CPU, within the same bound
    plain = decode_attention(_t(q)[:, None], _t(k), _t(v), _t(lengths),
                             alibi_slopes=alibi_slopes(HEADS)
                             if alibi else None)
    _split_close(plain[:, 0].numpy(), ref[:, 0])


@pytest.mark.parametrize("page_len,alibi,quant", [
    (16, True, False), (16, False, True), (128, False, False),
    (128, True, True)])
def test_paged_emulation_matches_jax_paged_dense(page_len, alibi, quant):
    q, kn, vn, k, v, ks, vs, table, lengths = _paged_case(
        page_len + D, D, page_len, quant)
    pool = lambda x: jnp.asarray(x.transpose(0, 1, 3, 2))
    slopes = alibi_slopes(HEADS) if alibi else None
    ref = jax_paged_attention(
        jnp.asarray(q)[:, None], pool(k), pool(v), jnp.asarray(table),
        jnp.asarray(lengths), jnp.asarray(kn), jnp.asarray(vn),
        alibi_slopes=jax_alibi_slopes(HEADS) if alibi else None,
        k_scale=None if ks is None else jnp.asarray(ks[:, :, None, :]),
        v_scale=None if vs is None else jnp.asarray(vs[:, :, None, :]),
        impl="dense")
    got = emulate_paged(_t(q), _t(k), _t(v), _t(table), lengths, _t(kn),
                        _t(vn), slopes, _t(ks), _t(vs))
    assert np.isfinite(got.numpy()).all()
    _split_close(got.numpy(), ref[:, 0])
    np.testing.assert_array_equal(got[0].numpy(), vn[0])
    plain = paged_attention(_t(q), _t(k), _t(v), _t(table), _t(lengths),
                            _t(kn), _t(vn), alibi_slopes=slopes,
                            k_scale=_t(ks), v_scale=_t(vs))
    _split_close(plain.numpy(), ref[:, 0])


# ---------------------------------------------------------------------------
# a 2-layer GPT-J at head dim 256, injected by both packages
# ---------------------------------------------------------------------------

VOCAB = 97
PROMPTS = [np.concatenate([np.arange(1, 17), np.arange(20, 20 + n)])
           .astype(np.int32) for n in (3, 11, 16)] + [
    (np.arange(25) * 7 % (VOCAB - 1) + 1).astype(np.int32)]
OUTS = [5, 3, 6, 4]
KNOBS = dict(num_slots=2, max_len=128, prefill_bucket=32, seed=0)
PAGING = dict(page_len=16, prefill_chunk=16, num_pages=17,
              max_chunks_per_iter=2)


@functools.lru_cache(maxsize=None)
def gptj_256():
    """(JAX module, JAX params, the port's model) of a seeded 2-layer
    GPT-J with d_model 512 and 2 heads of 256 (rotary_dim 64)."""
    torch.manual_seed(0)
    hf = T.GPTJForCausalLM(T.GPTJConfig(
        vocab_size=VOCAB, n_positions=128, n_embd=512, n_layer=2, n_head=2,
        rotary_dim=64)).eval()
    with torch.no_grad():
        for p in hf.parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn_like(p))
    jm, jp = jmi.replace_transformer_layer(hf, dtype=jnp.float32)
    pm, _ = pmi.replace_transformer_layer(hf, dtype=torch.float32)
    return jm, jp, pm.eval().requires_grad_(False)


def _serve(eng):
    reqs = [eng.submit(p, max_new_tokens=o) for p, o in zip(PROMPTS, OUTS)]
    eng.run()
    return [list(r.output_tokens) for r in reqs]


def _jax_ragged_generate(jm, jp):
    """Each prompt's tokens from one ragged JAX ``generate()`` (one
    compiled program for the four prompts)."""
    lens = [len(p) for p in PROMPTS]
    ids = np.zeros((len(lens), max(lens)), np.int32)
    for row, p in enumerate(PROMPTS):
        ids[row, :len(p)] = p
    out = np.asarray(jax_generate(jm, jp, jnp.asarray(ids),
                                  max_new_tokens=max(OUTS),
                                  prompt_lengths=lens))
    return [out[row, n:n + o].tolist()
            for row, (n, o) in enumerate(zip(lens, OUTS))]


def test_injected_gptj_256_logits_match_jax():
    jm, jp, pm = gptj_256()
    assert (pm.config.head_dim, pm.config.rotary_dim) == (D, 64)
    ids = np.random.RandomState(1).randint(1, VOCAB, size=(2, 40))
    with torch.no_grad():
        got = pm(torch.tensor(ids)).numpy()
    ref = np.asarray(jm.apply({"params": jp}, jnp.asarray(ids)))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_injected_gptj_256_generates_and_serves_jaxs_tokens():
    jm, jp, pm = gptj_256()
    ref = _jax_ragged_generate(jm, jp)
    got = [generate(pm, p[None], max_new_tokens=o)[0, len(p):].tolist()
           for p, o in zip(PROMPTS, OUTS)]
    assert got == ref
    paged = ServingEngine(pm, ServingConfig(**KNOBS, paging=PAGING))
    served = _serve(paged)
    jax_paged = _serve(JaxServingEngine(jm, jp, JaxServingConfig(
        **KNOBS, paging=JaxPagingConfig(**PAGING))))
    assert served == jax_paged == ref
    assert paged.metrics.snapshot()["prefix_hits"] >= 1
    paged._paged.allocator.check()


# ---------------------------------------------------------------------------
# the wrappers' head dims and the refusal that remains on CUDA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dims", [
    ("flash_attention_fwd.cu", FWD_HEAD_DIMS),
    ("flash_attention_fwd_bf16.cu", FWD_HEAD_DIMS),
    ("flash_attention_bwd.cu", BWD_HEAD_DIMS),
    ("flash_attention_bwd_bf16.cu", BWD_HEAD_DIMS),
    ("decode_attention.cu", DECODE_HEAD_DIMS),
    ("paged_attention.cu", PAGED_HEAD_DIMS)])
def test_wrapper_dims_are_the_cuda_dispatch(name, dims):
    """256 in every flash, decode and paged kernel's dims and dispatch:
    the serving kernels' (what ``init_inference`` checks) and, since the
    flash backward's d-256 instances, the backward's."""
    assert _dispatched_dims(name) == dims
    assert D in dims
    assert D in engine_mod.SERVING_HEAD_DIMS
    assert FWD_HEAD_DIMS == BWD_HEAD_DIMS


def test_flash_forward_with_grad_at_d256_is_refused_on_cuda(monkeypatch):
    """The refusal of a forward that needs a gradient now holds only at a
    head dim no kernel takes (160): it raises on the kernel route, naming
    the kernels' dims, before any launch or build. At d 256 the same
    call runs the forward kernel and, on ``backward()``, the backward
    kernels, once each."""
    monkeypatch.setattr(FLASH, "use_kernel", lambda t: True)
    monkeypatch.setattr(op_builder, "load", lambda *a, **k: pytest.fail(
        "built the kernels for an untaken head dim"))
    launches = flash_attention.launches
    q, k, v = (torch.zeros(1, 64, 2, 160) for _ in range(3))
    for t in (q, v):        # a gradient to q, or to v alone
        t.requires_grad_()
        with pytest.raises(ValueError, match=r"take head_dim in "
                           r"\(64, 80, 96, 128, 256\), got 160"):
            flash_attention(q, k, v, causal=True)
        t.requires_grad_(False)
    assert flash_attention.launches == launches
    fwd, bwd = [], []
    monkeypatch.setattr(FLASH, "_launch", lambda q, *a: fwd.append(q.shape)
                        or (torch.zeros_like(q),
                            torch.zeros(q.shape[0], q.shape[2], q.shape[1])))
    monkeypatch.setattr(FLASH, "_launch_bwd", lambda q, k, v, *a: bwd.append(
        q.shape) or (torch.zeros_like(q), torch.zeros_like(k),
                     torch.zeros_like(v)))
    q, k, v = (torch.zeros(1, 64, 2, D, requires_grad=True)
               for _ in range(3))
    flash_attention(q, k, v, causal=True).sum().backward()
    assert fwd == bwd == [(1, 64, 2, D)]
    assert all(t.grad is not None for t in (q, k, v))


def test_flash_forward_with_grad_at_an_untaken_dim_names_the_forwards(
        monkeypatch):
    """A head dim no flash kernel takes (192), with a gradient, meets the
    forward's refusal, not the backward's: the forward does not run at
    192 either."""
    monkeypatch.setattr(FLASH, "use_kernel", lambda t: True)
    monkeypatch.setattr(op_builder, "load", lambda *a, **k: pytest.fail(
        "built the kernels for an untaken head dim"))
    q, k, v = (torch.zeros(1, 64, 2, 192) for _ in range(3))
    q.requires_grad_()
    with pytest.raises(ValueError, match=r"take head_dim in "
                       r"\(64, 80, 96, 128, 256\), got 192"):
        flash_attention(q, k, v, causal=True)
