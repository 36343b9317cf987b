"""The port's compression-aware training and MoQ against the JAX package's.

- ``Compressor`` and ``MoQQuantizer`` project one seeded tree in both
  packages: the port's projection, on the plain versions of the quantize
  and dequantize kernels, is bit-equal to the jitted JAX projection
  (tolerance 0), masks included; module patterns match the same leaves
  (``keystr`` paths, brackets and separators included).
- ``initialize()`` with ``compression_training`` or ``quantize_training``
  trains a 2-layer ``DeepSpeedTransformerLayer`` stack (the twin of
  ``chip_smoke.DSBertMLM``) for 3 steps beside the JAX engine on the same
  weights and batches: each step's loss within 1e-4 (two fp32 evaluations
  of a 2-layer model), and each parameter under the flip rule (``_flips``).
- The blocks of a later slice raise.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as nn
import torch
from flax.core import meta, unfreeze

import chip_smoke
import deepspeed_tpu as jds
from deepspeed_tpu.compression.compress import Compressor as JaxCompressor
from deepspeed_tpu.compression.config import \
    CompressionConfig as JaxCompressionConfig
from deepspeed_tpu.ops.pallas.layernorm import \
    fused_layer_norm as jax_fused_layer_norm
from deepspeed_tpu.ops.transformer.transformer import (
    DeepSpeedTransformerConfig as JaxLayerConfig,
    DeepSpeedTransformerLayer as JaxLayer)
from deepspeed_tpu.runtime.quantize import MoQConfig as JaxMoQConfig
from deepspeed_tpu.runtime.quantize import MoQQuantizer as JaxMoQ
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.compression import (CompressionConfig, Compressor,
                                             init_compression, keystr,
                                             param_paths, redundancy_clean)
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.quantizer import inv_qmax
from deepspeed_tpu_torch.ops.transformer import DeepSpeedTransformerConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.quantize import MoQConfig, MoQQuantizer
from tests.torch_threads import share_cores

share_cores()

MATRICES = ["attn_qkvw", "attn_ow", "inter_w", "output_w"]


def _tree(seed=0):
    """A flax-shaped params tree: two unrolled DS layers and embeddings,
    with one all-zero column."""
    rs = np.random.RandomState(seed)
    f = lambda *s: (rs.standard_normal(s) * 0.05).astype(np.float32)
    layer = {"attn_qkvw": f(48, 16), "attn_qkvb": f(48), "attn_ow": f(16, 16),
             "attn_ob": f(16), "attn_nw": 1 + f(16), "attn_nb": f(16),
             "inter_w": f(64, 16), "inter_b": f(64), "output_w": f(16, 64),
             "output_b": f(16), "norm_w": 1 + f(16), "norm_b": f(16)}
    tree = {"word_embeddings": f(50, 16), "position_embeddings": f(12, 16),
            "layers_0": layer,
            "layers_1": {k: v * 2 for k, v in layer.items()},
            "ln_f_scale": 1 + f(16), "ln_f_bias": f(16)}
    tree["layers_1"]["inter_w"][:, 3] = 0.0
    return {"params": tree}


def _flat(tree, prefix=""):
    """(keystr path, torch tensor) pairs of a nested dict of arrays."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out += _flat(v, path)
        else:
            out.append((path, torch.from_numpy(np.array(v))))
    return out


def _check_equal(port_pairs, jax_tree):
    ref = dict(_flat(jax.tree.map(np.asarray, jax_tree)))
    assert sorted(p for p, _ in port_pairs) == sorted(ref)
    for path, t in port_pairs:
        np.testing.assert_array_equal(t.numpy(), ref[path].numpy(),
                                      err_msg=path)


COMPRESSION_BLOCKS = {
    "sym8": {"weight_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": 1},
        "different_groups": {"g": {"params": {"start_bits": 8},
                                   "modules": MATRICES}}}},
    "asym4_brackets": {"weight_quantization": {
        "shared_parameters": {"enabled": True},
        "different_groups": {"g": {
            "params": {"bits": 4, "quantization_type": "asymmetric"},
            "modules": ["['layers_1']['inter", "embeddings']"]}}}},
    "pruning": {
        "sparse_pruning": {"shared_parameters": {"enabled": True},
                           "different_groups": {"g": {
                               "params": {"dense_ratio": 0.6},
                               "modules": ["attn_ow"]}}},
        "row_pruning": {"shared_parameters": {"enabled": True},
                        "different_groups": {"g": {
                            "params": {"dense_ratio": 0.5},
                            "modules": ["inter_w"]}}},
        "channel_pruning": {"shared_parameters": {"enabled": True},
                            "different_groups": {"g": {
                                "params": {"dense_ratio": 0.75},
                                "modules": ["output_w"]}}},
        "head_pruning": {"shared_parameters": {"enabled": True},
                         "different_groups": {"g": {
                             "params": {"dense_ratio": 0.5, "num_heads": 4},
                             "modules": ["attn_qkvw"]}}},
        "weight_quantization": {"shared_parameters": {"enabled": True},
                                "different_groups": {"g": {
                                    "params": {"start_bits": 6},
                                    "modules": ["layers_0"]}}}},
}


@pytest.mark.parametrize("name", list(COMPRESSION_BLOCKS))
def test_compressor_projection_equals_jax(name):
    block = COMPRESSION_BLOCKS[name]
    tree = _tree(1)
    ref = JaxCompressor(JaxCompressionConfig.from_dict(block)).apply(
        jax.tree.map(jnp.asarray, tree), step=3)
    pairs = _flat(tree)
    comp = init_compression(block)
    assert isinstance(comp, Compressor)
    assert comp.apply(pairs, 3) is pairs
    _check_equal(pairs, ref)


@pytest.mark.parametrize("step,sym", [(1, True), (2, True), (5, True),
                                      (3, False)])
def test_moq_projection_equals_jax(step, sym):
    """10 -> 8 bits with period 1 snaps at 9, 9, 8 ... bits (int16 codes,
    then int8); 1-D leaves stay; the ratio table stretches a layer."""
    kw = dict(enabled=True, quantize_bits_start=10, quantize_bits_target=8,
              quantize_period=1,
              quantize_type="symmetric" if sym else "asymmetric")
    ratios = {"layers_1": 0.5}
    tree = _tree(2)
    jq = JaxMoQ(JaxMoQConfig(**kw), ratios)
    ref = jq.quantize(jax.tree.map(jnp.asarray, tree), step)
    q = MoQQuantizer(MoQConfig(**kw), ratios)
    assert [q.bits_at(s) for s in range(5)] == [10, 9, 9, 8, 8]
    assert all(q.bits_at(s, 0.5) == jq.bits_at(s, 0.5) for s in range(9))
    pairs = _flat(tree)
    q.quantize(pairs, step)
    _check_equal(pairs, ref)
    flat = dict(pairs)
    assert torch.equal(flat["['params']['layers_0']['attn_qkvb']"],
                       torch.from_numpy(tree["params"]["layers_0"]
                                        ["attn_qkvb"]))


def test_keystr_paths_select_the_same_leaves():
    """The port's parameter names become JAX's keystr paths, so patterns
    with brackets and separators select the same leaves."""
    assert keystr("layers.0.inter_w") == "['params']['layers_0']['inter_w']"
    assert keystr("bert.layer.11.attn.c_attn.kernel") == \
        "['params']['bert']['layer_11']['attn']['c_attn']['kernel']"
    cfg = DeepSpeedTransformerConfig(hidden_size=16, heads=2,
                                     intermediate_size=64,
                                     num_hidden_layers=2, training=False)
    model = chip_smoke.DSBertMLM(cfg, vocab_size=50, max_positions=12)
    port = [p for p, _ in param_paths(model)]
    jax_paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(_tree())[0]]
    assert sorted(port) == sorted(jax_paths)
    for pattern in ("['layers_1']['inter", "embeddings']", "_0']['attn_o",
                    "ln_f"):
        sel = lambda paths: sorted(p for p in paths if pattern in p)
        assert sel(port) == sel(jax_paths) != []


def test_redundancy_clean_and_the_blocks_that_raise():
    pairs = _flat(_tree(3))
    redundancy_clean(pairs, COMPRESSION_BLOCKS["sym8"])
    w = dict(pairs)["['params']['layers_0']['inter_w']"]
    assert max(len(torch.unique(w[:, j])) for j in range(16)) <= 255
    assert init_compression({}) is None
    assert CompressionConfig.from_dict(None).any_enabled() is False
    base = {"train_batch_size": 1}
    for block in (
            {"compression_training": {"activation_quantization": {
                "shared_parameters": {"enabled": True}}}},
            {"compression_training": {"layer_reduction": {
                "enabled": True, "keep_number_layers": 1}}},
            {"eigenvalue": {"enabled": True}}):
        with pytest.raises(NotImplementedError):
            DeepSpeedConfig.from_dict({**base, **block})
    with pytest.raises(NotImplementedError):
        init_compression({"activation_quantization": {
            "shared_parameters": {"enabled": True}}})
    # eigenvalue MoQ: refused by the quantizer, which initialize() builds
    with pytest.raises(NotImplementedError, match="eigenvalue"):
        MoQQuantizer(MoQConfig(enabled=True, eigenvalue_enabled=True))
    kw = dict(hidden_size=64, heads=1, intermediate_size=128,
              num_hidden_layers=1, training=True)
    with pytest.raises(NotImplementedError, match="eigenvalue"):
        ds.initialize(model=chip_smoke.DSBertMLM(
            DeepSpeedTransformerConfig(**kw), VOCAB, MAXPOS),
            config={**_config(8, {}), "quantize_training": {
                "enabled": True, "eigenvalue_enabled": True}},
            loss_fn=chip_smoke.ds_bert_loss, device="cpu")
    cfg = DeepSpeedConfig.from_dict({
        **base, "compression_training": COMPRESSION_BLOCKS["sym8"],
        "quantize_training": {"enabled": True}})
    assert cfg.quantize_training == {"enabled": True}


# --------------------------------------------------------------------------
# the engine against the JAX engine on a 2-layer DeepSpeedTransformerLayer
# stack
# --------------------------------------------------------------------------

H, HEADS, FF, VOCAB, SEQ, MAXPOS = 128, 2, 512, 2048, 64, 64


class JaxDSBertMLM(nn.Module):
    """The JAX twin of ``chip_smoke.DSBertMLM``: embeddings, unrolled
    ``DeepSpeedTransformerLayer``s named ``layers_<i>``, the Pallas
    ``fused_layer_norm`` and the tied decoder."""
    config: JaxLayerConfig
    vocab_size: int
    max_positions: int

    @nn.compact
    def __call__(self, input_ids, attention_mask=None, deterministic=True):
        cfg = self.config
        normal = nn.initializers.normal(0.02)
        word = self.param("word_embeddings", normal,
                          (self.vocab_size, cfg.hidden_size), jnp.float32)
        pos = self.param("position_embeddings", normal,
                         (self.max_positions, cfg.hidden_size), jnp.float32)
        h = word[input_ids] + pos[:input_ids.shape[1]][None]
        for i in range(cfg.num_hidden_layers):
            h = JaxLayer(cfg, name=f"layers_{i}")(
                h, attention_mask, deterministic=deterministic)
        h = jax_fused_layer_norm(
            h, self.param("ln_f_scale", nn.initializers.ones,
                          (cfg.hidden_size,), jnp.float32),
            self.param("ln_f_bias", nn.initializers.zeros,
                       (cfg.hidden_size,), jnp.float32), cfg.layer_norm_eps)
        return h @ word.astype(h.dtype).T


def _jax_loss(model, params, batch, rng, train):
    logits = model.apply(params, batch["input_ids"], batch["attention_mask"],
                         deterministic=not train).astype(jnp.float32)
    labels = batch["mlm_labels"]
    keep = labels != -1
    safe = jnp.where(keep, labels, 0)
    nll = jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
        logits, safe[..., None], -1)[..., 0]
    return jnp.sum(nll * keep) / jnp.maximum(jnp.sum(keep), 1)


def _config(micro, block):
    return {"train_batch_size": 16, "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "FusedLamb",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "steps_per_print": 10_000, **block}


def _flips(port, ref, bits, asymmetric):
    """(elements more than 1e-6 apart that are one grid step of their
    column apart, other elements more than 1e-6 apart): a snapped element
    whose x / scale sat at an fp32 tie in one package may land on the
    neighbouring grid point; the grid step is the column's scale at the
    last snap's width."""
    d = (port - ref).abs()
    far = d > 1e-6
    if ref.dim() < 2:
        return 0, int(far.sum())
    cols = ref.reshape(-1, ref.shape[-1])
    if asymmetric:
        rng_ = cols.amax(0) - cols.amin(0)
    else:
        rng_ = cols.abs().amax(0)
    step = torch.clamp_min(rng_ * inv_qmax(bits, asymmetric), 1e-8)
    one = (d.reshape(-1, ref.shape[-1]) - step).abs() <= 1e-6
    far = far.reshape(-1, ref.shape[-1])
    return int((far & one).sum()), int((far & ~one).sum())


ENGINE_BLOCKS = {
    "compression": ({"compression_training":
                     COMPRESSION_BLOCKS["sym8"]}, MATRICES, 8, False),
    "moq": ({"quantize_training": {
        "enabled": True, "quantize_bits_start": 10,
        "quantize_bits_target": 8, "quantize_period": 1}}, None, 8, False),
}


@pytest.mark.parametrize("name", list(ENGINE_BLOCKS))
def test_engine_with_projections_matches_the_jax_engine(name):
    """FusedLamb, clip 1.0, gas 2, fp32, dropout off, a padding mask. The
    JAX engine shards each microbatch over the 8-device test mesh: its
    global micro batch (1 x 8) is the port's micro batch."""
    block, matrices, bits, asym = ENGINE_BLOCKS[name]
    kw = dict(hidden_size=H, heads=HEADS, intermediate_size=FF,
              num_hidden_layers=2, initializer_range=0.02,
              layer_norm_eps=1e-12, pre_layer_norm=True, training=True)
    jmodel = JaxDSBertMLM(JaxLayerConfig(**kw), VOCAB, MAXPOS)
    batch = chip_smoke.mlm_batch(16, SEQ, VOCAB, seed=4)
    jeng, *_ = jds.initialize(
        model=jmodel, config=_config(1, block), loss_fn=_jax_loss,
        sample_batch={"input_ids": np.zeros((1, SEQ), np.int32)},
        rng=jax.random.PRNGKey(0))
    pcfg = DeepSpeedTransformerConfig(**kw)
    tree = lambda: jax.tree.map(
        np.asarray, unfreeze(meta.unbox(jeng.params)))["params"]
    eng, *_ = ds.initialize(
        model=chip_smoke.DSBertMLM(pcfg, VOCAB, MAXPOS),
        model_parameters=params_from_jax(tree(), pcfg),
        config=_config(8, block), loss_fn=chip_smoke.ds_bert_loss,
        device="cpu")
    for step in range(3):
        ref = float(jeng.train_batch(batch))
        loss = float(eng.train_batch(batch))
        assert abs(loss - ref) <= 1e-4, (step, loss, ref)
    final = params_from_jax(tree(), pcfg)
    total = flips = bad = 0
    for k, v in eng.module.state_dict().items():
        snapped = v.dim() >= 2 and (matrices is None
                                    or any(m in k for m in matrices))
        f, b = _flips(v, final[k], bits, asym) if snapped else \
            (0, int(((v - final[k]).abs() > 1e-6).sum()))
        total, flips, bad = total + v.numel(), flips + f, bad + b
        assert b == 0, (k, (v - final[k]).abs().max().item())
    assert flips <= 1e-4 * total


def test_the_slice_runs_on_the_card_by_default_and_cpu_launches_nothing():
    """initialize() with both blocks raises without a card unless asked
    for the CPU; on the CPU the path runs the plain versions and leaves
    the LayerNorm and quantizer launch counters at 0."""
    from deepspeed_tpu_torch.ops import (dequantize, fused_layer_norm,
                                         quantize)
    kw = dict(hidden_size=64, heads=1, intermediate_size=128,
              num_hidden_layers=1, training=True)
    config = _config(4, {"compression_training": COMPRESSION_BLOCKS["sym8"],
                         "quantize_training": ENGINE_BLOCKS["moq"][0][
                             "quantize_training"]})
    config.update(train_batch_size=8)
    model = lambda: chip_smoke.DSBertMLM(DeepSpeedTransformerConfig(**kw),
                                         VOCAB, MAXPOS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ds.initialize(model=model(), config=config,
                          loss_fn=chip_smoke.ds_bert_loss)
    fused_layer_norm.fwd_launches = fused_layer_norm.bwd_launches = 0
    quantize.launches = dequantize.launches = 0
    eng, *_ = ds.initialize(model=model(), config=config,
                            loss_fn=chip_smoke.ds_bert_loss, device="cpu")
    batch = chip_smoke.mlm_batch(8, 16, VOCAB, seed=5)
    losses = [float(eng.train_batch(batch)) for _ in range(2)]
    assert all(np.isfinite(losses))
    assert (fused_layer_norm.fwd_launches, fused_layer_norm.bwd_launches,
            quantize.launches, dequantize.launches) == (0, 0, 0, 0)
    w = eng.module.layers[0].inter_w
    assert max(len(torch.unique(w[:, j])) for j in range(64)) <= 511
