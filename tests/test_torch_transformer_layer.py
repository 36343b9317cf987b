"""The port's ``DeepSpeedTransformerLayer`` against the JAX package's.

The JAX layer's parameters (flax init from a seed) load into the port's
layer by name, as the reference's state dict does; the same numpy hidden
states and masks go through both, in fp32 with dropout off. On the CPU
the port's LayerNorms run the plain versions of the LayerNorm kernels and
its attention the plain flash versions; the JAX layer runs jnp
LayerNorms and its attention op. Tolerances: outputs within 1e-5, and
gradients (of sum(out * r)) within 1e-5 of the largest gradient: two fp32
evaluations of a 2-layer-deep function at widths 64-128. The loss is
sum(out * r) with a fixed random r (sum(out^2) of a post-LN layer is
nearly constant, its gradients rounding noise).
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.transformer.transformer import (
    DeepSpeedTransformerConfig as JaxConfig,
    DeepSpeedTransformerLayer as JaxLayer)
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.ops import fused_layer_norm
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)
from tests.torch_threads import share_cores

share_cores()

B, S = 2, 32
KW = dict(hidden_size=128, heads=2, num_hidden_layers=2,
          initializer_range=0.02, training=False)


def _jax_layer(cfg_kw, seed=0):
    cfg = JaxConfig(**cfg_kw)
    layer = JaxLayer(cfg)
    x = np.random.RandomState(seed + 1).standard_normal(
        (B, S, cfg.hidden_size)).astype(np.float32)
    params = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return layer, jax.tree.map(np.asarray, dict(params)), x


def _port_layer(cfg_kw, params):
    layer = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**cfg_kw))
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
    return layer


def _masks():
    keep = np.ones((B, S), np.float32)
    keep[0, S - 11:] = 0.0
    keep[1, S - 3:] = 0.0
    return {"none": None, "2d": keep,
            "bool4d": (keep > 0.5)[:, None, None, :],
            "additive": ((1.0 - keep) * -1e4)[:, None, None, :]}


R = np.random.RandomState(9).standard_normal((B, S, 128)).astype(np.float32)


def _run_jax(layer, params, x, mask):
    def loss(p, xx):
        out = layer.apply({"params": p}, xx,
                          None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * R), out
    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        params, jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, \
        np.asarray(gx)


def _run_port(layer, x, mask):
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt, None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(R)).sum().backward()
    return out.detach().numpy(), {k: p.grad.numpy() for k, p in
                                  layer.named_parameters()}, xt.grad.numpy()


def _close_grads(got, ref):
    top = max(np.abs(v).max() for v in ref.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5 * top, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("mask_kind", ["none", "2d", "bool4d", "additive"])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_forward_and_grads_match_jax(pre_ln, mask_kind):
    kw = dict(KW, pre_layer_norm=pre_ln)
    jlayer, params, x = _jax_layer(kw, seed=int(pre_ln))
    mask = _masks()[mask_kind]
    ref_out, ref_gp, ref_gx = _run_jax(jlayer, params, x, mask)
    out, gp, gx = _run_port(_port_layer(kw, params), x, mask)
    np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=0)
    _close_grads(gp, ref_gp)
    _close_grads({"x": gx}, {"x": ref_gx})


@pytest.mark.parametrize("knob", ["normalize_invertible", "gelu_checkpoint",
                                  "attn_dropout_checkpoint"])
def test_checkpoint_knobs_leave_values_and_grads_equal(knob):
    """The three memory knobs recompute in the backward
    (torch.utils.checkpoint): values and grads equal the plain layer's
    exactly, and JAX's within the tolerance (JAX
    tests/unit/test_transformer_layer.py:108)."""
    jlayer, params, x = _jax_layer(KW)
    mask = _masks()["2d"]
    ref_out, ref_gp, _ = _run_jax(jlayer, params, x, mask)
    plain = _run_port(_port_layer(KW, params), x, mask)
    knobbed = _run_port(_port_layer(dict(KW, **{knob: True}), params), x,
                        mask)
    np.testing.assert_array_equal(knobbed[0], plain[0])
    for k in plain[1]:
        np.testing.assert_array_equal(knobbed[1][k], plain[1][k], err_msg=k)
    np.testing.assert_allclose(knobbed[0], ref_out, atol=1e-5, rtol=0)
    _close_grads(knobbed[1], ref_gp)


def test_state_dict_names_shapes_and_initialisers():
    """The reference's parameter surface (JAX :137-150, torch [out, in]),
    the JAX initialisers: N(0, std) and N(0, std / sqrt(2 L)) weights,
    zero biases, unit LayerNorm weights."""
    cfg = DeepSpeedTransformerConfig(hidden_size=32, heads=2,
                                     num_hidden_layers=8,
                                     initializer_range=0.05, training=False)
    layer = DeepSpeedTransformerLayer(cfg, seed=3)
    assert {k: tuple(v.shape) for k, v in layer.state_dict().items()} == {
        "attn_qkvw": (96, 32), "attn_qkvb": (96,), "attn_ow": (32, 32),
        "attn_ob": (32,), "attn_nw": (32,), "attn_nb": (32,),
        "inter_w": (128, 32), "inter_b": (128,), "output_w": (32, 128),
        "output_b": (32,), "norm_w": (32,), "norm_b": (32,)}
    sd = layer.state_dict()
    assert abs(sd["inter_w"].std().item() - 0.05) < 0.005
    assert abs(sd["output_w"].std().item() - 0.05 / 4.0) < 0.0015
    assert torch.equal(sd["attn_nw"], torch.ones(32))
    assert torch.equal(sd["inter_b"], torch.zeros(128))
    assert not layer.training
    _, params, _ = _jax_layer(dict(KW, hidden_size=32, num_hidden_layers=8))
    assert set(params) == set(sd)


def test_from_dict_and_json_file(tmp_path):
    cfg = DeepSpeedTransformerConfig.from_dict(
        {"hidden_size": 128, "heads": 8, "fp16": True, "unknown": 1})
    assert cfg.intermediate_size == 512 and cfg.dtype == torch.bfloat16
    assert cfg.attn_dropout_ratio == 0.0 and cfg.hidden_dropout_ratio == 0.0
    cfg2 = DeepSpeedTransformerConfig(hidden_size=128, heads=8,
                                      intermediate_size=256)
    assert cfg2.intermediate_size == 256 and cfg2.dtype == torch.float32
    path = tmp_path / "layer.json"
    path.write_text(json.dumps({"hidden_size": 64, "heads": 4,
                                "pre_layer_norm": False}))
    cfg3 = DeepSpeedTransformerConfig.from_json_file(str(path))
    assert (cfg3.hidden_size, cfg3.intermediate_size,
            cfg3.pre_layer_norm) == (64, 256, False)
    assert ds.DeepSpeedTransformerLayer is DeepSpeedTransformerLayer
    assert ds.DeepSpeedTransformerConfig is DeepSpeedTransformerConfig


def test_bf16_compute_and_dropout_rules():
    """fp16=True computes in bf16 on fp32 parameters; attention dropout
    is drawn from the seed words in training mode (the same words drop
    the same elements); hidden dropout in training mode needs the words,
    draws from them, and is off in deterministic mode."""
    kw = dict(KW, attn_dropout_ratio=0.2, training=True)
    layer = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**kw))
    x = torch.randn(B, S, 128, generator=torch.Generator().manual_seed(0))
    a = layer(x, dropout_seed=(1, 2))
    assert torch.equal(a, layer(x, dropout_seed=(1, 2)))
    assert not torch.equal(a, layer(x, dropout_seed=(1, 3)))
    assert torch.equal(layer(x, deterministic=True),
                       layer.eval()(x))
    with pytest.raises(ValueError):
        layer.train()(x)
    bf = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(
        **dict(KW, fp16=True)))
    out = bf(x)
    assert out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    hid = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(
        **dict(KW, hidden_dropout_ratio=0.1, training=True)))
    with pytest.raises(ValueError):
        hid(x)
    h = hid(x, dropout_seed=(1, 2))
    assert torch.equal(h, hid(x, dropout_seed=(1, 2)))
    assert not torch.equal(h, hid(x, dropout_seed=(1, 3)))
    assert torch.equal(hid(x, deterministic=True), hid.eval()(x))


def test_layer_norms_go_through_fused_layer_norm(monkeypatch):
    """Both LayerNorms of a layer call ops.layernorm.fused_layer_norm (on
    a card: the LayerNorm kernels), once each in the forward."""
    from deepspeed_tpu_torch.ops.transformer import transformer
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return fused_layer_norm(*args)
    monkeypatch.setattr(transformer, "fused_layer_norm", counting)
    for pre_ln in (True, False):
        calls.clear()
        layer = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(
            **dict(KW, pre_layer_norm=pre_ln)))
        layer(torch.zeros(B, S, 128))
        assert calls == [(B, S, 128)] * 2


def test_params_from_jax_loads_unrolled_and_stacked_layer_trees():
    """A JAX tree of DeepSpeedTransformerLayers, unrolled (``layers_<i>``)
    or stacked (``layers`` with [L, ...] leaves, as ``nn.scan`` builds it),
    converts to the same state dict of ``layers.<i>`` entries, which loads
    into the port's stack (``chip_smoke.DSBertMLM``) as it is."""
    import chip_smoke
    from deepspeed_tpu_torch.models.convert import params_from_jax
    kw = dict(KW, hidden_size=64, heads=2)
    layers = [_jax_layer(kw, seed=s)[1] for s in (0, 5)]
    rs = np.random.RandomState(0)
    rest = {"word_embeddings": rs.standard_normal((40, 64)),
            "position_embeddings": rs.standard_normal((16, 64)),
            "ln_f_scale": np.ones(64), "ln_f_bias": np.zeros(64)}
    unrolled = {**rest, "layers_0": layers[0], "layers_1": layers[1]}
    stacked = {**rest, "layers": {k: np.stack([p[k] for p in layers])
                                  for k in layers[0]}}
    cfg = DeepSpeedTransformerConfig(**kw)
    a, b = params_from_jax(unrolled, cfg), params_from_jax(stacked, cfg)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["layers.1.inter_w"],
                       torch.from_numpy(np.array(layers[1]["inter_w"])))
    model = chip_smoke.DSBertMLM(cfg, vocab_size=40, max_positions=16)
    model.load_state_dict(b)            # strict: every name, every shape
