"""Checkpoint injection in the port against the JAX package, on the CPU.

Tiny HuggingFace models (2 layers, d_model 128, 2 heads of 64, rotary
dim 16) built from the ``transformers`` config classes with seeded
weights go through JAX's ``replace_transformer_layer`` and the port's:
for each of the seven policies the port's state equals
``params_from_jax`` of JAX's tree bit for bit and the fp32 outputs agree
within 1e-5; ``export_hf_state_dict`` of both packages is bit-equal on
the same weights; Megatron merge and split are bit-equal to JAX's for
checkpoint versions 0, 1.0 and 2.0. An injected GPT-NeoX and GPT-J are
token-exact against JAX's in greedy ``generate()``, contiguous serving
and paged serving (prefix cache, chunked prefill), fp32. Weight-only
int8 on an injected BERT (direct mode, and the transform mode of a
module without QDense kernels) within 1e-5 of JAX's: both quantize to
the same int8 bytes. ``init_inference`` takes ``checkpoint=``,
``replace_with_kernel_inject=`` and ``injection_policy=``; on CUDA it
takes GPT-J-6B's head dim 256 and refuses one no serving kernel takes
(192) before building anything.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.core import meta, unfreeze

import deepspeed_tpu.module_inject as jmi
from deepspeed_tpu.inference.generation import generate as jax_generate
from deepspeed_tpu.module_inject.module_quantize import \
    quantize_for_serving as jax_quantize_for_serving
from deepspeed_tpu.models.bert import BertEncoder as JaxBertEncoder
from deepspeed_tpu.ops.sparse_attention import (
    BertSparseSelfAttention as JaxBertSparse, BigBirdSparsityConfig as
    JaxBigBird)
from deepspeed_tpu.runtime.state_dict_factory import \
    MegatronSDLoader as JaxMegatronSDLoader
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.engine import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.paging import PagingConfig as JaxPagingConfig
import deepspeed_tpu_torch.module_inject as pmi
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import engine as engine_mod
from deepspeed_tpu_torch.inference.generation import generate
from deepspeed_tpu_torch.models import BertEncoder
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.module_inject.module_quantize import (
    is_quantized, quantize_for_serving, quantized_nbytes)
from deepspeed_tpu_torch.ops.sparse_attention import (
    BertSparseSelfAttention, BigBirdSparsityConfig)
from deepspeed_tpu_torch.runtime.state_dict_factory import MegatronSDLoader
from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine
from tests.torch_threads import share_cores

share_cores()

T = pytest.importorskip("transformers")

VOCAB = 97
ATOL = 1e-5
FAMILIES = ("gpt2", "gpt_neo", "gptj", "gpt_neox", "bloom", "bert")


def hf_config(model_type):
    """The tiny HF config of a family (2 layers, d_model 128, 2 heads)."""
    if model_type == "gpt2":
        return T.GPT2Config(vocab_size=VOCAB, n_positions=128, n_embd=128,
                            n_layer=2, n_head=2)
    if model_type == "gpt_neo":
        return T.GPTNeoConfig(vocab_size=VOCAB, max_position_embeddings=128,
                              hidden_size=128, num_layers=2, num_heads=2,
                              attention_types=[[["global", "local"], 1]],
                              intermediate_size=256)
    if model_type == "gptj":
        return T.GPTJConfig(vocab_size=VOCAB, n_positions=128, n_embd=128,
                            n_layer=2, n_head=2, rotary_dim=16)
    if model_type == "gpt_neox":
        return T.GPTNeoXConfig(vocab_size=VOCAB, max_position_embeddings=128,
                               hidden_size=128, num_hidden_layers=2,
                               num_attention_heads=2, intermediate_size=256,
                               rotary_pct=0.25)
    if model_type == "bloom":
        return T.BloomConfig(vocab_size=VOCAB, hidden_size=128, n_layer=2,
                             n_head=2)
    return T.BertConfig(vocab_size=VOCAB, hidden_size=128,
                        num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=256, max_position_embeddings=128)


_CLASSES = {"gpt2": "GPT2LMHeadModel", "gpt_neo": "GPTNeoForCausalLM",
            "gptj": "GPTJForCausalLM", "gpt_neox": "GPTNeoXForCausalLM",
            "bloom": "BloomForCausalLM", "bert": "BertModel"}


@functools.lru_cache(maxsize=None)
def hf_model(model_type):
    """The tiny HF model of a family, weights from torch seed 0; its
    LayerNorms and biases get seeded noise too, so that a mapping that
    swapped two of them would show."""
    torch.manual_seed(0)
    model = getattr(T, _CLASSES[model_type])(hf_config(model_type)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn_like(p))
    return model


@functools.lru_cache(maxsize=None)
def injected(model_type):
    """(JAX module, JAX params, the port's model) of the HF model."""
    jm, jp = jmi.replace_transformer_layer(hf_model(model_type),
                                           dtype=jnp.float32)
    pm, _ = pmi.replace_transformer_layer(hf_model(model_type),
                                          dtype=torch.float32)
    return jm, jp, pm.eval().requires_grad_(False)


def _tree(params):
    return jax.tree.map(np.asarray, unfreeze(meta.unbox(params)))


def _ids(shape, seed=0):
    return np.random.RandomState(seed).randint(1, VOCAB, size=shape)


def _outputs(out):
    return [np.asarray(o, np.float32) for o in
            (out if isinstance(out, tuple) else (out,))]


def _megatron_shards(n, version, seed=0):
    """``n`` mp shards of a 2-layer Megatron GPT (d 128, d_ff 256), qkv
    rows laid out as ``version`` stores them."""
    r = np.random.RandomState(seed)
    d, f, v = 128, 256, VOCAB - 1

    def rnd(*shape):
        return r.standard_normal(shape).astype(np.float32) * 0.05

    shards = [{} for _ in range(n)]
    for key, full in (("word_embeddings.weight", rnd(v, d)),):
        for i, part in enumerate(np.split(full, n, 0)):
            shards[i][key] = part
    for s in shards:
        s["position_embeddings.weight"] = rnd(128, d)
        s["transformer.final_layernorm.weight"] = 1 + rnd(d)
        s["transformer.final_layernorm.bias"] = rnd(d)
    for i in range(2):
        lp = f"transformer.layers.{i}."
        qkv_w, qkv_b = rnd(3 * d, d), rnd(3 * d)
        col = {"mlp.dense_h_to_4h.weight": rnd(f, d),
               "mlp.dense_h_to_4h.bias": rnd(f)}
        row = {"attention.dense.weight": rnd(d, d),
               "mlp.dense_4h_to_h.weight": rnd(d, f)}
        rep = {"input_layernorm.weight": 1 + rnd(d),
               "input_layernorm.bias": rnd(d),
               "post_attention_layernorm.weight": 1 + rnd(d),
               "post_attention_layernorm.bias": rnd(d),
               "attention.dense.bias": rnd(d),
               "mlp.dense_4h_to_h.bias": rnd(d)}
        for r_ in range(n):
            s = shards[r_]
            for name, full in (("attention.query_key_value.weight", qkv_w),
                               ("attention.query_key_value.bias", qkv_b)):
                if version >= 2.0:
                    s[lp + name] = np.split(full, n, 0)[r_]
                else:
                    s[lp + name] = np.concatenate(
                        [np.split(t, n, 0)[r_] for t in np.split(full, 3, 0)])
            for name, full in col.items():
                s[lp + name] = np.split(full, n, 0)[r_]
            for name, full in row.items():
                s[lp + name] = np.split(full, n, 1)[r_]
            for name, full in rep.items():
                s[lp + name] = full
    return shards


# ---------------------------------------------------------------------------
# the seven policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", FAMILIES)
def test_policy_matches_jax(model_type):
    jm, jp, pm = injected(model_type)
    ref = params_from_jax(_tree(jp), pm.config)
    state = pm.state_dict()
    assert set(state) == set(ref)
    for name, t in ref.items():
        assert torch.equal(state[name], t), name
    ids = _ids((2, 24))
    jout = _outputs(jm.apply({"params": jp}, jnp.asarray(ids)))
    pout = _outputs(tuple(o.numpy() for o in pm(torch.tensor(ids)))
                    if model_type == "bert"
                    else pm(torch.tensor(ids)).numpy())
    assert len(jout) == len(pout)
    for a, b in zip(pout, jout):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("version", [0, 1.0, 2.0])
def test_megatron_policy_matches_jax(version):
    shards = _megatron_shards(2, version)
    jm, jp = jmi.load_megatron_checkpoint(
        {"type": "Megatron", "checkpoints": shards, "version": version},
        n_heads=2, dtype=jnp.float32)
    pm, state = pmi.load_megatron_checkpoint(
        {"type": "Megatron", "checkpoints": shards, "version": version},
        n_heads=2, dtype=torch.float32)
    ref = params_from_jax(_tree(jp), pm.config)
    assert set(state) == set(ref)
    assert all(torch.equal(state[k], ref[k]) for k in ref)
    ids = _ids((1, 16), seed=1)
    np.testing.assert_allclose(
        pm.eval()(torch.tensor(ids)).detach().numpy(),
        np.asarray(jm.apply({"params": jp}, jnp.asarray(ids))),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("version", [0, 1.0, 2.0])
def test_megatron_merge_and_split_are_bit_equal_to_jax(version):
    shards = _megatron_shards(4, version, seed=3)
    jl, pl = JaxMegatronSDLoader(shards, version), MegatronSDLoader(
        shards, version)
    jfull, pfull = jl.load(mp_world_size=1), pl.load(mp_world_size=1)
    assert set(jfull) == set(pfull)
    for key in jfull:
        np.testing.assert_array_equal(pfull[key], jfull[key], err_msg=key)
    for n, rank in ((2, 1), (4, 3)):
        js, ps = jl.split_state_dict(jfull, n, rank), \
            pl.split_state_dict(pfull, n, rank)
        for key in js:
            np.testing.assert_array_equal(ps[key], js[key], err_msg=key)
    # a split then merged again is the full state dict
    parts = [pl.split_state_dict(pfull, 4, r) for r in range(4)]
    again = pl.merge_state_dict(parts)
    assert all(np.array_equal(again[k], pfull[k]) for k in pfull)


@pytest.mark.parametrize("model_type", FAMILIES)
def test_export_is_bit_equal_to_jax(model_type):
    jm, jp, pm = injected(model_type)
    jsd = jmi.export_hf_state_dict(model_type, jp, jm.config)
    psd = pmi.export_hf_state_dict(model_type, pm, pm.config)
    assert set(psd) == set(jsd)
    for key in jsd:
        assert psd[key].dtype == np.float32
        np.testing.assert_array_equal(psd[key], jsd[key], err_msg=key)
    # and the export of the port's state dict converts back to it
    again, _ = pmi.replace_transformer_layer(
        hf_config(model_type), checkpoint=dict(psd), dtype=torch.float32)
    for name, t in pm.state_dict().items():
        assert torch.equal(again.state_dict()[name], t), name


def test_unknown_model_type_and_policy_override():
    cfg = hf_config("gpt_neox")
    cfg.model_type = "my_neox"
    with pytest.raises(ValueError, match="no injection policy"):
        pmi.replace_transformer_layer(cfg)
    pm, _ = pmi.replace_transformer_layer(
        cfg, policy=pmi.GPTNEOXLayerPolicy, dtype=torch.float32)
    assert pm.config.rotary and pm.config.rotary_dim == 16
    # the engine's injection_policy= reaches the same override
    eng = init_inference(cfg, replace_with_kernel_inject=True,
                         injection_policy=pmi.GPTNEOXLayerPolicy,
                         dtype=torch.float32, device="cpu")
    assert eng.injected and eng.module.config.activation == "gelu_exact"


# ---------------------------------------------------------------------------
# serving an injected rotary model, token for token against JAX
# ---------------------------------------------------------------------------

# three requests share a one-page prefix; every prompt fits one prefill
# bucket and spans two prefill chunks (each JAX program compiles once)
SERVE_PROMPTS = [np.concatenate([_ids(16, seed=9), _ids(n, seed=10 + n)])
                 .astype(np.int32) for n in (3, 11, 16)] + [
    _ids(25, seed=13).astype(np.int32)]
SERVE_OUTS = [5, 3, 6, 4]
KNOBS = dict(num_slots=2, max_len=128, prefill_bucket=32, seed=0)
PAGING = dict(page_len=16, prefill_chunk=16, num_pages=17,
              max_chunks_per_iter=2)


def _serve(eng):
    reqs = [eng.submit(p, max_new_tokens=o)
            for p, o in zip(SERVE_PROMPTS, SERVE_OUTS)]
    eng.run()
    return [list(r.output_tokens) for r in reqs]


def _ragged_generate(gen, *args):
    """Each request's tokens from one ragged ``generate()`` call over
    every prompt (each row decodes from its own length)."""
    lens = [len(p) for p in SERVE_PROMPTS]
    ids = np.zeros((len(lens), max(lens)), np.int32)
    for row, p in enumerate(SERVE_PROMPTS):
        ids[row, :len(p)] = p
    out = np.asarray(gen(*args, ids, max_new_tokens=max(SERVE_OUTS),
                         prompt_lengths=lens))
    return [out[row, n:n + o].tolist()
            for row, (n, o) in enumerate(zip(lens, SERVE_OUTS))]


@functools.lru_cache(maxsize=None)
def jax_serving(model_type):
    """JAX's tokens for the trace: ragged generate(), the contiguous
    engine and the paged engine."""
    jm, jp, _ = injected(model_type)
    gen = _ragged_generate(
        lambda m, p, ids, **kw: jax_generate(m, p, jnp.asarray(ids), **kw),
        jm, jp)
    contiguous = _serve(JaxServingEngine(jm, jp, JaxServingConfig(**KNOBS)))
    paged_eng = JaxServingEngine(jm, jp, JaxServingConfig(
        **KNOBS, paging=JaxPagingConfig(**PAGING)))
    paged = _serve(paged_eng)
    return {"generate": gen, "contiguous": contiguous, "paged": paged,
            "prefix_hits": paged_eng.metrics.snapshot()["prefix_hits"]}


@pytest.mark.parametrize("model_type", ["gpt_neox", "gptj"])
@pytest.mark.parametrize("path", ["generate", "contiguous", "paged"])
def test_injected_rotary_model_serves_jaxs_tokens(model_type, path):
    ref = jax_serving(model_type)
    pm = injected(model_type)[2]
    if path == "generate":
        got = [generate(pm, p[None], max_new_tokens=o)[0, len(p):].tolist()
               for p, o in zip(SERVE_PROMPTS, SERVE_OUTS)]
        assert _ragged_generate(generate, pm) == got
    else:
        eng = ServingEngine(pm, ServingConfig(
            **KNOBS, **({"paging": PAGING} if path == "paged" else {})))
        got = _serve(eng)
        if path == "paged":
            snap = eng.metrics.snapshot()
            assert snap["prefix_hits"] == ref["prefix_hits"] >= 1
            assert snap["prefill_chunks"] > len(SERVE_PROMPTS)
            eng._paged.allocator.check()
    assert got == ref[path]
    assert got == ref["generate"]


# ---------------------------------------------------------------------------
# int8 weights on an injected BERT
# ---------------------------------------------------------------------------

class _PlainJaxBert(JaxBertEncoder):
    supports_quantized_kernels = False


class _PlainBert(BertEncoder):
    supports_quantized_kernels = False


@pytest.mark.parametrize("mode", ["direct", "transform"])
def test_int8_bert_matches_jax(mode):
    jm, jp, pm = injected("bert")
    if mode == "transform":
        jm = _PlainJaxBert(jm.config)
        plain = _PlainBert(pm.config, seed=None)
        plain.load_state_dict(pm.state_dict())
        pm = plain
    jq, transform = jax_quantize_for_serving(jm, jp, min_size=4096)
    assert (transform is None) == (mode == "direct")
    qm = quantize_for_serving(pm, min_size=4096)
    assert is_quantized(qm) and not is_quantized(pm)
    assert quantize_for_serving(qm) is qm
    ids = _ids((2, 24), seed=4)
    jout = jm.apply({"params": transform(jq) if transform else jq},
                    jnp.asarray(ids))
    with torch.no_grad():
        pout = qm.eval()(torch.tensor(ids))
    for a, b in zip(pout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)
    # the same weights quantized (JAX's layers stacked, the port's not):
    # the embeddings too in transform mode only
    leaves = jax.tree_util.tree_leaves(
        jq, is_leaf=lambda x: isinstance(x, dict) and set(x) == {"q",
                                                                 "scale"})
    jax_int8 = sum(x["q"].size for x in leaves if isinstance(x, dict))
    port_int8 = sum(b.numel() for name, b in qm.named_buffers()
                    if b.dtype == torch.int8)
    assert port_int8 == jax_int8 > 0
    if mode == "transform":
        np.testing.assert_array_equal(
            qm.word_embeddings_q.numpy(),
            np.asarray(jq["word_embeddings"]["q"]))
        nb = quantized_nbytes(qm)
        assert nb["quantized"] < nb["dense_equivalent"]
        pmi.dequantize_param_tree(qm)
        assert not is_quantized(qm) and qm.word_embeddings.dtype == \
            torch.float32


def test_quantize_weights_after_a_checkpoint_load(tmp_path):
    jm, jp, pm = injected("gpt_neox")
    sd = pmi.export_hf_state_dict("gpt_neox", pm, pm.config)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "pytorch_model.bin")
    eng = init_inference(hf_config("gpt_neox"), checkpoint=str(tmp_path),
                         replace_with_kernel_inject=True, dtype=torch.float32,
                         quantize_weights=True, quantize_min_size=4096,
                         device="cpu")
    assert is_quantized(eng.module)
    jq, _ = jax_quantize_for_serving(jm, jp, min_size=4096)
    ids = _ids((1, 20), seed=5)
    np.testing.assert_allclose(
        eng(torch.tensor(ids)).numpy(),
        np.asarray(jm.apply({"params": jq}, jnp.asarray(ids))),
        atol=ATOL, rtol=0)


class _Built(Exception):
    """Raised by a stand-in ``build_model``: the engine got past its
    head-dim check."""


def _on_cuda_without_building(monkeypatch):
    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device: torch.device("cuda"))

    def no_build(*a, **k):
        raise _Built
    monkeypatch.setattr(pmi.replace_module, "build_model", no_build)


def test_gptj_6b_passes_the_head_dim_check_on_cuda(monkeypatch):
    """GPT-J-6B's widths (16 heads of 256): every serving kernel takes
    head dim 256, so the engine goes on to build the model."""
    _on_cuda_without_building(monkeypatch)
    cfg = T.GPTJConfig()
    assert cfg.n_embd // cfg.n_head == 256
    with pytest.raises(_Built):
        init_inference(cfg, replace_with_kernel_inject=True,
                       dtype=torch.bfloat16)


def test_untaken_head_dim_is_refused_on_cuda_before_building(monkeypatch):
    """Head dim 192, which no serving kernel takes: the engine names the
    head dim and the kernels' head dims before it converts or builds
    anything."""
    _on_cuda_without_building(monkeypatch)
    with pytest.raises(ValueError,
                       match=r"head_dim 192.*\(64, 80, 96, 128, 256\)"):
        init_inference(T.GPTJConfig(n_embd=3072, n_head=16),
                       replace_with_kernel_inject=True,
                       dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# BertSparseSelfAttention: an HF BERT's attention weights by name
# ---------------------------------------------------------------------------

def test_bert_sparse_self_attention_loads_hf_names_and_matches_jax():
    hf = hf_model("bert")
    prefix = "encoder.layer.1.attention.self."
    sd = {k[len(prefix):]: v for k, v in hf.state_dict().items()
          if k.startswith(prefix)}
    layer = BertSparseSelfAttention.from_bert_config(
        hf.config, BigBirdSparsityConfig(2, block=64, num_random_blocks=1))
    layer.load_state_dict(sd)
    jl = JaxBertSparse.from_bert_config(
        hf.config, JaxBigBird(2, block=64, num_random_blocks=1))
    jp = {name: {"kernel": sd[name + ".weight"].numpy().T,
                 "bias": sd[name + ".bias"].numpy()}
          for name in ("query", "key", "value")}
    x = np.random.RandomState(6).standard_normal((2, 256, 128)).astype(
        np.float32)
    mask = np.ones((2, 256), np.int32)
    mask[1, 200:] = 0
    for m in (None, mask):
        ref = jl.apply({"params": jp}, jnp.asarray(x),
                       None if m is None else jnp.asarray(m))
        with torch.no_grad():
            out = layer(torch.from_numpy(x),
                        None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
