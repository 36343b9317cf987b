"""fp16 serving in the port against the JAX package, on the CPU.

The serving kernels' plain versions (split-KV decode, paged attention
with fp16 pages and with int8 pages under fp16 compute, the weight-only
int8 matmul) in fp16 against JAX's Pallas kernels in fp16 (interpret
mode), at head dims 64 and 256, within ``FP16_ATOL`` (PERF.md's fp16
tolerance row: a few fp16 ulps, 2^-10, at outputs ~1). A tiny GPT-NeoX
(the ``transformers`` config class: 2 layers, d_model 128, two heads of
64, rotary) injected in fp16 through both packages'
``replace_transformer_layer`` and served paged by both engines: its
first forward within ``LOGIT_ATOL`` of JAX's, its tokens JAX's up to a
step whose JAX top-2 logit gap is at most ``TIE_ULPS`` fp16 ulps of the
top logit; the same with int8 weights against JAX's int8 engine; int8 KV
pages by the JAX package's rungs (greedy agreement >= 0.9, one decode
step's logits within 0.2). An fp16 HuggingFace checkpoint (torch shards
and safetensors) loads into an fp16 model bit for bit, and on CUDA a
compute dtype that no serving kernel takes is refused by name before any
weight is built.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.core import meta, unfreeze

import deepspeed_tpu.module_inject as jmi
from deepspeed_tpu.models.layers import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import decode_attention as jax_decode
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_attention as jax_paged_attention
from deepspeed_tpu.ops.pallas.wo_int8_matmul import \
    wo_int8_matmul as jax_wo_int8_matmul
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.config import QuantizeConfig as JaxQuantizeConfig
from deepspeed_tpu.serving.engine import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.paging import PagingConfig as JaxPagingConfig
import deepspeed_tpu_torch.module_inject as pmi
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import engine as engine_mod
from deepspeed_tpu_torch.inference.cache import (gather_pages,
                                                 init_page_pool,
                                                 scatter_chunk_pages)
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.layers import alibi_slopes
from deepspeed_tpu_torch.module_inject.module_quantize import is_quantized
from deepspeed_tpu_torch.ops import (decode_attention, paged_attention,
                                     wo_int8_matmul)
from deepspeed_tpu_torch.ops.wo_int8_matmul import wo_int8_matmul_reference
from deepspeed_tpu_torch.serving import ServingEngine
from tests.torch_threads import share_cores

share_cores()

T = pytest.importorskip("transformers")

FP16_ATOL = 2e-3        # kernels' plain versions vs JAX's Pallas kernels
LOGIT_ATOL = 2e-2       # first forward, 2 fp16 layers: logits up to ~4
TIE_ULPS = 2            # a JAX top-2 gap this many fp16 ulps is a tie
INT8_KV_AGREE = 0.9     # the JAX package's rungs
INT8_KV_LOGIT_ERR = 0.2
HEAD_DIMS = (64, 256)
VOCAB = 97


def fp16_ulp(x):
    """The fp16 spacing at |x| (11 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -14)))
                   - 10)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype is not None else t


def _j16(x):
    """A numpy array as JAX fp16, rounded as torch's ``.half()`` rounds
    it (fp32 -> fp16 round-to-nearest-even on both sides)."""
    return jnp.asarray(x, jnp.float32).astype(jnp.float16)


def _close(got, ref, atol=FP16_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# the kernels' plain versions against JAX's Pallas kernels, fp16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", HEAD_DIMS)
def test_decode_fp16_matches_jax(d):
    B, H, S = 4, 2, 256
    rng = np.random.RandomState(d)
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, S, d)).astype(np.float32)
            for _ in range(2))
    lengths = np.asarray([0, 1, 129, S], np.int32)
    ref = jax_decode(_j16(q), jnp.swapaxes(_j16(k), 2, 3),
                     jnp.swapaxes(_j16(v), 2, 3), jnp.asarray(lengths),
                     alibi_slopes=jax_alibi_slopes(H), block_k=128)
    assert ref.dtype == jnp.float16
    before = decode_attention.launches
    out = decode_attention(*(_t(x, torch.float16) for x in (q, k, v)),
                           _t(lengths), alibi_slopes=alibi_slopes(H))
    assert decode_attention.launches == before       # the plain version
    assert out.shape == (B, 1, H, d) and out.dtype == torch.float16
    _close(out.float().numpy(), ref)
    assert not out[0].float().any()          # length 0 -> zeros


def _paged_case(d, quant, page=16, heads=2, max_pages=4):
    """Port-layout operands: each slot owns ceil(length / page) pages of
    a shuffled pool, the null page 0 holds NaN (int8: NaN scales)."""
    lengths = np.array([0, 1, 23, 47, 16], np.int32)
    r = np.random.RandomState(d + quant)
    owned = [-(-int(n) // page) for n in lengths]
    num_pages = sum(owned) + 1
    perm = r.permutation(np.arange(1, num_pages))
    table = np.zeros((len(lengths), max_pages), np.int32)
    at = 0
    for b, own in enumerate(owned):
        table[b, :own] = perm[at:at + own]
        at += own
    shape = (num_pages, heads, page, d)
    q, kn, vn = (r.randn(len(lengths), heads, d).astype(np.float32)
                 for _ in range(3))
    if quant:
        k, v = (r.randint(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (r.rand(*shape[:3]).astype(np.float32) * 0.05
                  for _ in range(2))
        ks[0] = vs[0] = np.nan
    else:
        k, v = (r.randn(*shape).astype(np.float32) for _ in range(2))
        k[0] = v[0] = np.nan
        ks = vs = None
    return q, kn, vn, k, v, ks, vs, table, lengths


@pytest.mark.parametrize("pages", ["fp16", "int8"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_fp16_matches_jax_kernel(d, pages):
    """fp16 compute over fp16 pages, and over int8 pages with fp32
    scales; pools in each package's layout, NaN on the null page."""
    quant = pages == "int8"
    q, kn, vn, k, v, ks, vs, table, lengths = _paged_case(d, quant)
    heads = q.shape[1]
    pool = lambda x: (jnp.asarray(x.transpose(0, 1, 3, 2)) if quant  # noqa
                      else _j16(x.transpose(0, 1, 3, 2)))
    ref = jax_paged_attention(
        _j16(q)[:, None], pool(k), pool(v), jnp.asarray(table),
        jnp.asarray(lengths), _j16(kn), _j16(vn),
        alibi_slopes=jax_alibi_slopes(heads),
        k_scale=None if ks is None else jnp.asarray(ks[:, :, None, :]),
        v_scale=None if vs is None else jnp.asarray(vs[:, :, None, :]),
        impl="kernel")
    assert ref.dtype == jnp.float16
    f16 = torch.float16
    before = paged_attention.launches
    out = paged_attention(
        _t(q, f16), _t(k) if quant else _t(k, f16),
        _t(v) if quant else _t(v, f16), _t(table), _t(lengths),
        _t(kn, f16), _t(vn, f16), alibi_slopes=alibi_slopes(heads),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    assert paged_attention.launches == before
    assert out.shape == (len(lengths), heads, d) and out.dtype == f16
    assert np.isfinite(out.float().numpy()).all()
    _close(out.float().numpy(), ref[:, 0])
    # a slot of length 0 attends only itself
    np.testing.assert_array_equal(out[0].numpy(), _t(vn, f16)[0].numpy())


@pytest.mark.parametrize("k,n", [(128, 384), (512, 128), (200, 256)])
def test_wo_int8_matmul_fp16_matches_jax(k, n):
    r = np.random.RandomState(k + n)
    q = r.randint(-127, 128, size=(k, n)).astype(np.int8)
    scale = (r.rand(1, n) * 0.002).astype(np.float32)
    for m in (1, 5, 40):
        x = r.randn(m, k).astype(np.float32)
        ref = jax_wo_int8_matmul(_j16(x), jnp.asarray(q), jnp.asarray(scale))
        assert ref.dtype == jnp.float16
        before = (wo_int8_matmul.small_m_launches,
                  wo_int8_matmul.tiled_launches)
        got = wo_int8_matmul(_t(x, torch.float16), _t(q), _t(scale))
        assert (wo_int8_matmul.small_m_launches,
                wo_int8_matmul.tiled_launches) == before
        assert got.dtype == torch.float16 and got.shape == (m, n)
        assert torch.equal(got, wo_int8_matmul_reference(
            _t(x, torch.float16), _t(q), _t(scale)))
        _close(got.float().numpy(), ref)


# ---------------------------------------------------------------------------
# a tiny GPT-NeoX injected in fp16 through both packages, served paged
# ---------------------------------------------------------------------------

PROMPTS = [np.random.RandomState(20 + n).randint(1, VOCAB, size=n)
           .astype(np.int32) for n in (19, 27, 32, 25)]
OUTS = [6, 4, 7, 5]
KNOBS = dict(num_slots=2, max_len=128, prefill_bucket=32, seed=0)
PAGING = dict(page_len=16, prefill_chunk=16, num_pages=17,
              max_chunks_per_iter=2)


def neox_config():
    return T.GPTNeoXConfig(vocab_size=VOCAB, max_position_embeddings=128,
                           hidden_size=128, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=256,
                           rotary_pct=0.25)


@functools.lru_cache(maxsize=None)
def hf_neox():
    """The tiny HF GPT-NeoX, weights from torch seed 3 (LayerNorms and
    biases with seeded noise too)."""
    torch.manual_seed(3)
    model = T.GPTNeoXForCausalLM(neox_config()).eval()
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn_like(p))
    return model


@pytest.fixture(scope="module")
def injected():
    """(JAX module, JAX params, the port's model), both injected in fp16."""
    jm, jp = jmi.replace_transformer_layer(hf_neox(), dtype=jnp.float16)
    pm, _ = pmi.replace_transformer_layer(hf_neox(), dtype=torch.float16)
    return jm, jp, pm.eval().requires_grad_(False)


def _jax_serve(jm, jp, quantize=None):
    eng = JaxServingEngine(jm, jp, JaxServingConfig(
        **KNOBS, paging=JaxPagingConfig(**PAGING), quantize=quantize))
    reqs = [eng.submit(p, max_new_tokens=o) for p, o in zip(PROMPTS, OUTS)]
    eng.run()
    return [list(r.output_tokens) for r in reqs]


def _serve(module, quantize=None):
    srv = ServingEngine(module, {**KNOBS, "paging": PAGING,
                                 **({"quantize": quantize} if quantize
                                    else {})})
    reqs = [srv.submit(p, max_new_tokens=o) for p, o in zip(PROMPTS, OUTS)]
    srv.run()
    srv._paged.allocator.check()
    return [list(r.output_tokens) for r in reqs], srv


def _jax_gaps(jm, params, ref):
    """JAX's top-2 logit gap and the fp16 tie threshold at every
    generated position of each request, from one cache-free causal
    forward over every history at once (rows padded on the right)."""
    seqs = [np.concatenate([p, np.asarray(r, np.int32)])
            for p, r in zip(PROMPTS, ref)]
    ids = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for row, s in enumerate(seqs):
        ids[row, :len(s)] = s
    logits = np.asarray(jm.apply({"params": params}, jnp.asarray(ids))
                        .astype(jnp.float32))
    out = []
    for row, (p, r) in enumerate(zip(PROMPTS, ref)):
        top = np.sort(logits[row, len(p) - 1:len(p) - 1 + len(r)],
                      axis=-1)[:, ::-1]
        out.append((top[:, 0] - top[:, 1], TIE_ULPS * fp16_ulp(top[:, 0])))
    return out


def _agree_up_to_ties(got, ref, jm, params):
    """Each request's tokens equal JAX's up to its first step whose JAX
    top-2 gap is within ``TIE_ULPS`` fp16 ulps of the top logit; returns
    the tokens compared."""
    compared = 0
    for g, r, (gap, tie) in zip(got, ref, _jax_gaps(jm, params, ref)):
        near = np.nonzero(gap <= tie)[0]
        upto = int(near[0]) if near.size else len(r)
        assert len(g) == len(r)
        assert g[:upto] == r[:upto], (g, r, upto)
        compared += upto
    return compared


@pytest.fixture(scope="module")
def jax_fp16_run(injected):
    jm, jp, _ = injected
    return _jax_serve(jm, jp)


@pytest.fixture(scope="module")
def jax_int8_run(injected):
    jm, jp, _ = injected
    return _jax_serve(jm, jp, JaxQuantizeConfig(weights="int8"))


@pytest.fixture(scope="module")
def jax_int8_kv_run(injected):
    jm, jp, _ = injected
    return _jax_serve(jm, jp, JaxQuantizeConfig(kv="int8"))


def test_injected_fp16_state_and_first_forward(injected):
    """The port's model holds JAX's tree rounded once to fp16
    (LayerNorms in fp32, as JAX's), and its first forward is within
    ``LOGIT_ATOL`` of JAX's fp16 forward."""
    jm, jp, pm = injected
    assert pm.config.dtype == torch.float16
    assert pm.config.param_dtype == torch.float16
    tree = jax.tree.map(np.asarray, unfreeze(meta.unbox(jp)))
    want = params_from_jax(tree, pm.config)
    for name, t in pm.state_dict().items():
        ln = ".ln_" in name or name.startswith("ln_f")
        assert t.dtype == (torch.float32 if ln else torch.float16), name
        np.testing.assert_array_equal(
            t.numpy(), want[name].to(t.dtype).numpy(), err_msg=name)
    ids = np.random.RandomState(4).randint(1, VOCAB, size=(2, 24))
    ref = jm.apply({"params": jp}, jnp.asarray(ids, jnp.int32))
    assert ref.dtype == jnp.float16
    with torch.no_grad():
        out = pm(torch.from_numpy(ids).long())
    assert out.dtype == torch.float16
    _close(out.float().numpy(), ref, LOGIT_ATOL)


def test_fp16_paged_serving_matches_jax(injected, jax_fp16_run):
    jm, jp, pm = injected
    got, srv = _serve(pm)
    assert srv._paged.pool.k.dtype == torch.float16
    rep = srv.memory_report()
    assert rep["kv_page_dtype"] == "float16" and rep["paged_kernel"]
    assert _agree_up_to_ties(got, jax_fp16_run, jm, jp) >= sum(OUTS) // 2


def test_int8_weights_fp16_matches_jax(injected, jax_int8_run):
    jm, jp, pm = injected
    eng = init_inference(pm, quantize_weights=True, quantize_min_size=4096,
                         device="cpu")
    assert is_quantized(eng.module) and not is_quantized(pm)
    assert eng.module.config.dtype == torch.float16
    got, srv = _serve(eng.module, {"weights": "int8"})
    assert srv.module is eng.module
    jq, transform = jmi.module_quantize.quantize_for_serving(
        jm, jp, min_size=4096)
    assert transform is None
    assert _agree_up_to_ties(got, jax_int8_run, jm, jq) >= sum(OUTS) // 2


def test_int8_kv_fp16_rungs(injected, jax_int8_kv_run):
    """int8 KV pages under fp16 compute: greedy agreement with the fp16
    pool and with JAX's int8-KV engine >= 0.9; one decode step's logits
    over an int8 pool within 0.2 of those over an fp16 pool."""
    _, _, pm = injected
    dense, _ = _serve(pm)
    got, srv = _serve(pm, {"kv": "int8"})
    assert srv._paged.pool.k.dtype == torch.int8
    assert srv.memory_report()["kv_page_dtype"] == "int8"
    flat = lambda toks: [t for r in toks for t in r]  # noqa: E731
    for ref in (dense, jax_int8_kv_run):
        agree = np.mean([a == b for a, b in zip(flat(got), flat(ref))])
        assert agree >= INT8_KV_AGREE, agree
    ids = torch.from_numpy(PROMPTS[2][None]).long()         # 32 tokens
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    logits = []
    with torch.no_grad():
        for kv_int8 in (False, True):
            pool = init_page_pool(pm, 5, 16, kv_int8=kv_int8)
            row = gather_pages(pool, table, dequant_dtype=torch.float16)
            row.index = 0
            pm(ids, positions=torch.arange(32), cache=row)
            scatter_chunk_pages(pool, row.k[:, 0], row.v[:, 0], table[0])
            view = gather_pages(pool, table, dequant_dtype=torch.float16)
            view.index = torch.tensor([32], dtype=torch.int32)
            logits.append(pm(torch.tensor([[7]]),
                             positions=torch.tensor([[32]]),
                             cache=view).float())
    err = (logits[0] - logits[1]).abs().max().item()
    assert 0 < err < INT8_KV_LOGIT_ERR, err


# ---------------------------------------------------------------------------
# an fp16 checkpoint, and the dtype refusal on CUDA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("safe", [False, True], ids=["bin", "safetensors"])
def test_fp16_checkpoint_loads_bit_equal(tmp_path, safe):
    """HF ``save_pretrained`` of the fp16 model, injected with
    ``dtype=torch.float16``: every served weight is the checkpoint's
    fp16 tensor bit for bit (the LayerNorms widened to fp32, exactly)."""
    hf = T.GPTNeoXForCausalLM(neox_config()).eval()
    hf.load_state_dict(hf_neox().state_dict())
    hf.half().save_pretrained(tmp_path, safe_serialization=safe)
    eng = init_inference(pmi.read_hf_config(str(tmp_path)),
                         checkpoint=str(tmp_path),
                         replace_with_kernel_inject=True,
                         dtype=torch.float16, device="cpu")
    assert eng.injected and eng.module.config.dtype == torch.float16
    back = pmi.export_hf_state_dict("gpt_neox", eng.module,
                                    eng.module.config)
    ckpt = {k: v for k, v in hf.state_dict().items() if k in back}
    assert set(ckpt) == set(back)
    for name, t in ckpt.items():
        assert t.dtype == torch.float16
        held = np.asarray(back[name])              # exported as fp32
        narrow = held.astype(np.float16)
        np.testing.assert_array_equal(narrow.astype(held.dtype), held,
                                      err_msg=name)
        np.testing.assert_array_equal(narrow.view(np.uint16),
                                      t.numpy().view(np.uint16),
                                      err_msg=name)
    for name, p in eng.module.named_parameters():
        assert p.dtype == (torch.float32 if ".ln_" in name
                           or name.startswith("ln_f") else torch.float16)


class _Built(Exception):
    """Raised by a stand-in ``build_model``: the engine got past its
    checks."""


@pytest.mark.parametrize("dtype,refused", [
    (torch.float16, False), (torch.float64, True)],
    ids=["float16", "float64"])
def test_serving_dtype_checked_on_cuda_before_building(monkeypatch, dtype,
                                                       refused):
    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device: torch.device("cuda"))

    def no_build(*a, **k):
        raise _Built
    monkeypatch.setattr(pmi.replace_module, "build_model", no_build)
    if refused:
        with pytest.raises(TypeError, match=r"compute dtype torch\.float64"
                           r".*'float16'"):
            init_inference(neox_config(), replace_with_kernel_inject=True,
                           dtype=dtype)
    else:
        with pytest.raises(_Built):
            init_inference(neox_config(), replace_with_kernel_inject=True,
                           dtype=dtype)
