"""The port's int8 serving against the JAX package's: the weight-only
int8 matmul's plain version against JAX ``wo_int8_matmul`` (its Pallas
kernel in interpret mode), the weight quantizer bit for bit, the serving
engine with int8 weights token for token (near-tie rule), and the int8
KV pool's bounded-error rungs (``tests/unit/test_quantized_serving.py``).

Tolerances: the int8 matmul in fp32 within 1e-5 of max(1, max |ref|)
(one function, two fp32 summation orders; bf16 x times int8 is exact in
fp32), bf16 within 2e-2 (one bf16 rounding of the output). Serving with
int8 weights compares tokens up to the first step where the reference's
top-2 logit gap is under 1e-3 (fp32 logits of two implementations that
sum in other orders); int8 KV pages are held to the JAX package's rungs:
greedy token agreement >= 0.9 with the fp pool, one decode step's logits
within 0.2.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.core import meta, unfreeze

from deepspeed_tpu.module_inject.module_quantize import (
    _quantize_array as jax_quantize_array)
from deepspeed_tpu.module_inject.module_quantize import (
    quantize_for_serving as jax_quantize_for_serving)
from deepspeed_tpu.module_inject.module_quantize import (
    quantize_param_tree as jax_quantize_param_tree)
from deepspeed_tpu.ops.pallas.wo_int8_matmul import \
    wo_int8_matmul as jax_wo_int8_matmul
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.config import QuantizeConfig as JaxQuantizeConfig
from deepspeed_tpu.serving.engine import ServingEngine as JaxServingEngine
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference.cache import (gather_pages,
                                                 init_page_pool,
                                                 scatter_chunk_pages)
from deepspeed_tpu_torch.inference.generation import generate
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.module_inject.module_quantize import (
    _quantize_array, adopt_int8_layout, is_quantized, quantize_for_serving,
    quantized_nbytes)
from deepspeed_tpu_torch.ops import wo_int8_matmul
from deepspeed_tpu_torch.ops.wo_int8_matmul import wo_int8_matmul_reference
from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine
from deepspeed_tpu_torch.serving.config import QuantizeConfig
from tests.test_torch_model import TINY, jax_gpt, port_gpt
from tests.torch_threads import share_cores

share_cores()

VOCAB = TINY["vocab_size"]
GAP_STOP = 1e-3
# the tiny model's four matrices: qkv, out, fc_in, fc_out
SHAPES = ((128, 384), (128, 128), (128, 512), (512, 128))


@pytest.fixture(scope="module")
def models():
    jm, params = jax_gpt(seed=7)
    return jm, params, port_gpt(jm, params)


def _rel(out, ref):
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", SHAPES)
def test_reference_matches_jax_wo_int8_matmul(dtype, k, n):
    r = np.random.RandomState(k + n)
    q = r.randint(-127, 128, size=(k, n)).astype(np.int8)
    scale = (r.rand(1, n) * 0.02).astype(np.float32)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for m in (1, 5, 40):
        x = r.randn(m, k).astype(np.float32)
        ref = np.asarray(jax_wo_int8_matmul(
            jnp.asarray(x).astype(jd), jnp.asarray(q), jnp.asarray(scale)
        ).astype(jnp.float32))
        xt = torch.from_numpy(x).to(dtype)
        got = wo_int8_matmul_reference(xt, torch.from_numpy(q),
                                       torch.from_numpy(scale))
        assert got.dtype == dtype and got.shape == (m, n)
        assert _rel(got.float().numpy(), ref) <= (
            1e-5 if dtype == torch.float32 else 2e-2), m
        # the wrapper on a CPU tensor is the plain version: no launch
        launches = (wo_int8_matmul.small_m_launches,
                    wo_int8_matmul.tiled_launches)
        wrapped = wo_int8_matmul(xt[None], torch.from_numpy(q),
                                 torch.from_numpy(scale))
        assert (wo_int8_matmul.small_m_launches,
                wo_int8_matmul.tiled_launches) == launches
        np.testing.assert_array_equal(wrapped[0].float().numpy(),
                                      got.float().numpy())


def _tree(params):
    return jax.tree.map(np.asarray, unfreeze(meta.unbox(params)))


def test_quantize_array_bit_equal_to_jax():
    r = np.random.RandomState(3)
    w = (r.randn(2, 96, 40) * np.exp(r.randn(2, 1, 40))).astype(np.float32)
    w[0, :, 0] = 0.0                                # an all-zero channel
    w[1, :3, 1] = [127.0, 0.5, -0.5]               # round-half-even ties
    ref = jax_quantize_array(jnp.asarray(w), axis=2)
    q, scale = _quantize_array(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref["scale"]))


def test_quantized_model_matches_jax_quantized_tree(models):
    """JAX ``quantize_param_tree`` (direct mode: kernels only) against the
    port's ``quantize_for_serving``, bit for bit, through
    ``params_from_jax`` of the JAX int8 tree, which loads into the port
    and gives the same logits. JAX's own serving step jits the quantizer,
    and XLA then multiplies by 1/127 instead of dividing by 127: its
    scales lie within one ulp of the rule's, its q within one step."""
    jm, params, model = models
    jq = jax_quantize_param_tree(meta.unbox(params), dtype=None,
                                 only_kernels=True)
    jit_q, transform = jax_quantize_for_serving(jm, params)
    assert transform is None
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(_tree(t))[0]}
    eager, jitted = flat(jq), flat(jit_q)
    assert sorted(eager) == sorted(jitted)
    for key, a in eager.items():
        b = jitted[key]
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b).max() <= 1
        else:
            np.testing.assert_allclose(a, b, rtol=2.5e-7, atol=0)
    qmodel = quantize_for_serving(model)
    assert is_quantized(qmodel) and not is_quantized(model)
    assert quantize_for_serving(qmodel) is qmodel      # no double rounding
    mine = qmodel.state_dict()
    theirs = params_from_jax(_tree(jq), model.config)
    assert sorted(mine) == sorted(theirs)
    for name, val in theirs.items():
        assert mine[name].dtype == val.dtype, name
        np.testing.assert_array_equal(mine[name].numpy(), val.numpy(),
                                      err_msg=name)
    assert mine["h.0.attn.qkv.q"].dtype == torch.int8
    assert mine["h.0.attn.qkv.scale"].shape == (1, 3 * TINY["d_model"])
    assert "wte" in mine                               # embeddings stay
    fresh = port_gpt(jm, params)
    adopt_int8_layout(fresh, theirs)
    fresh.load_state_dict(theirs)
    ids = torch.from_numpy(np.arange(1, 20)[None])
    np.testing.assert_array_equal(fresh(ids).numpy(), qmodel(ids).numpy())
    nb = quantized_nbytes(qmodel)
    assert nb["quantized"] < nb["dense_equivalent"]


def _gaps(model, prompt, toks):
    seq = torch.tensor(np.concatenate([prompt, toks])[None]).long()
    with torch.no_grad():
        logits = model(seq)[0, len(prompt) - 1:-1].float()
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).numpy()


def _prompts(seed, n, lo=3, hi=40):
    r = np.random.RandomState(seed)
    return [r.randint(1, VOCAB, size=int(r.randint(lo, hi))).astype(np.int32)
            for _ in range(n)]


def test_int8_weight_serving_matches_jax_and_generate(models):
    jm, params, model = models
    prompts = _prompts(5, 4)
    outs = [5, 3, 6, 4]
    jeng = JaxServingEngine(jm, params, JaxServingConfig(
        num_slots=2, max_len=128, prefill_bucket=16, seed=0,
        quantize=JaxQuantizeConfig(weights="int8")))
    jreqs = [jeng.submit(p, max_new_tokens=o) for p, o in zip(prompts, outs)]
    jeng.run()
    eng = init_inference(model, quantize_weights=True, device="cpu")
    assert is_quantized(eng.module) and not is_quantized(model)
    srv = eng.serve({"num_slots": 2, "max_len": 128, "prefill_bucket": 16,
                     "paging": {"page_len": 16, "prefill_chunk": 32},
                     "quantize": {"weights": "int8"}})
    assert srv.module is eng.module                  # already int8
    reqs = [srv.submit(p, max_new_tokens=o) for p, o in zip(prompts, outs)]
    srv.run()
    compared = 0
    for req, jreq, p, o in zip(reqs, jreqs, prompts, outs):
        ref = eng.generate(p[None], max_new_tokens=o)[0, len(p):].tolist()
        assert req.output_tokens == ref
        near = np.nonzero(_gaps(eng.module, p, np.array(ref)) < GAP_STOP)[0]
        upto = int(near[0]) if near.size else o
        assert req.output_tokens[:upto] == list(jreq.output_tokens)[:upto]
        compared += upto
    assert compared >= sum(outs) - 4
    rep = srv.memory_report()
    assert rep["params_bytes"]["quantized"] < \
        rep["params_bytes"]["dense_equivalent"]
    assert rep["kv_page_dtype"] == "float32" and rep["paged_kernel"]


def test_int8_kv_bounded_error(models):
    _, _, model = models
    prompts = _prompts(7, 5)
    outs = [5] * 5
    toks = {}
    for kv in (None, "int8"):
        eng = ServingEngine(model, ServingConfig(
            num_slots=3, max_len=128, prefill_bucket=16,
            paging={"page_len": 16, "prefill_chunk": 16},
            quantize={"kv": kv} if kv else None))
        reqs = [eng.submit(p, max_new_tokens=o) for p, o in zip(prompts, outs)]
        eng.run()
        toks[kv] = [t for r in reqs for t in r.output_tokens]
        if kv:
            assert eng._paged.pool.k.dtype == torch.int8
            assert eng.memory_report()["kv_page_dtype"] == "int8"
    agree = np.mean([a == b for a, b in zip(toks[None], toks["int8"])])
    assert agree >= 0.9, agree

    # one decode step's logits over an fp pool and an int8 pool holding
    # the same 32-token chunk, written through the chunk scatter
    ids = torch.from_numpy(_prompts(9, 1, 32, 33)[0][None]).long()
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    logits = []
    for kv_int8 in (False, True):
        pool = init_page_pool(model, 5, 16, kv_int8=kv_int8)
        row = gather_pages(pool, table)
        row.index = 0
        model(ids, positions=torch.arange(32), cache=row)
        scatter_chunk_pages(pool, row.k[:, 0], row.v[:, 0], table[0])
        view = gather_pages(pool, table)
        view.index = torch.tensor([32], dtype=torch.int32)
        logits.append(model(torch.tensor([[7]]),
                            positions=torch.tensor([[32]]), cache=view))
    err = (logits[0] - logits[1]).abs().max().item()
    assert 0 < err < 0.2, err


def test_quantize_config_validation(models):
    _, _, model = models
    with pytest.raises(ValueError, match="weights"):
        QuantizeConfig(weights="int4").validate(paged=True)
    with pytest.raises(ValueError, match="kv requires"):
        ServingConfig(num_slots=2, max_len=128,
                      quantize={"kv": "int8"}).validate()
    with pytest.raises(ValueError, match="min_size"):
        QuantizeConfig(min_size=0).validate(paged=True)
    cfg = ServingConfig(num_slots=2, max_len=128, paging={"page_len": 16},
                        quantize={"weights": "int8", "kv": "int8"}).validate()
    assert cfg.weights_int8 and cfg.kv_int8
    # min_size above every kernel: nothing quantizes
    assert not is_quantized(quantize_for_serving(model, min_size=10 ** 9))
