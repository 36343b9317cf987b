"""Activation dropout (the residual, MLP and embedding sites) against its
definition and against the JAX package fed the port's masks.

The port draws these masks from the counter hash of attention dropout
(``ops.dropout.keep_from_coords``); JAX draws flax Bernoulli bits, which
no port reproduces. So the model-level comparisons hand JAX the port's
masks, test-side only: ``flax.linen.intercept_methods`` replaces every
``nn.Dropout.__call__`` of the JAX GPT and BERT with flax's own formula
``where(keep, x / (1.0 - rate), 0)`` over the port's keep mask of that
site, and ``monkeypatch`` replaces ``_dropout`` of JAX's
``DeepSpeedTransformerLayer`` the same way. Attention dropout stays off in
those comparisons (its parity is the flash and block-sparse tests').

Tolerances: the plain dropout and the division are bit-equal (JAX
divides by the weakly typed ``1.0 - rate`` in the activation's dtype; the
port divides in fp32 by ``dtype(1 - rate)`` and rounds once, which is the
same value for fp32, bf16 and fp16); fp32 logits within 1e-5 and
gradients within 1e-5 of the largest gradient (two fp32 evaluations of a
2-layer model, as ``test_torch_bert.py``); the keep share within 3
standard errors of 1 - rate over 2**20 elements; the agreement of two
sites' masks within 3 standard errors of (1 - p)**2 + p**2, which two
independent masks give. Eval mode, rate 0 and the remat policies are bit
for bit.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.transformer.transformer as jax_transformer
from deepspeed_tpu.models.bert import BertConfig as JaxBertConfig
from deepspeed_tpu.models.bert import BertForPreTraining as JaxBert
from deepspeed_tpu.models.gpt import GPT as JaxGPT
from deepspeed_tpu.models.gpt import GPTConfig as JaxGPTConfig
from deepspeed_tpu_torch.models import (GPT, BertConfig, BertForPreTraining,
                                        GPTConfig)
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops import dropout as pdrop
from deepspeed_tpu_torch.ops.dropout import (EMBED_SITE, HIDDEN1_SITE,
                                             HIDDEN2_SITE, MLP_SITE,
                                             activation_keep, dropout_apply,
                                             dropout_reference, fold_seed,
                                             keep_from_coords, seed_words,
                                             site_words)
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)

from tests.test_torch_bert import tree_np
from tests.torch_threads import share_cores

share_cores()

RATE = 0.1
WORDS = (0x1234ABCD, 0x9E3779B9)       # a forward's seed words
TINY = dict(vocab_size=97, max_seq_len=64, d_model=128, n_layers=2,
            n_heads=2)
B, S = 2, 16
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}


def _ids(seed=0, vocab=TINY["vocab_size"]):
    return np.random.RandomState(seed).randint(1, vocab, (B, S)).astype(
        np.int32)


def _close_grads(got, ref):
    top = max(np.abs(v).max() for v in ref.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5 * top, rtol=0,
                                   err_msg=k)


# --------------------------------------------------------------------------
# the map itself
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_dropout_is_the_hash_and_jaxs_division(dtype):
    """Dropped exactly where ``keep_from_coords`` says, and every kept
    element bit-equal to JAX's ``jnp.where(keep, x / (1.0 - rate), 0.0)``
    over the same keep array, in fp32, bf16 and fp16."""
    tdt, jdt = DTYPES[dtype]
    x = np.random.RandomState(1).uniform(-3, 3, (3, 40, 64)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(tdt)
    ar = lambda n: torch.arange(n, dtype=torch.int64)  # noqa: E731
    keep = keep_from_coords(WORDS[0], WORDS[1], ar(3)[:, None, None],
                            ar(40)[None, :, None], ar(64)[None, None, :],
                            RATE)
    assert torch.equal(keep, activation_keep(WORDS, RATE, x.shape))
    got = dropout_reference(xt, WORDS, RATE)
    assert got.dtype == tdt
    xj = jnp.asarray(x).astype(jdt)
    ref = jnp.where(jnp.asarray(keep.numpy()), xj / (1.0 - RATE), 0.0)
    assert ref.dtype == jdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert bool((got[~keep] == 0).all())


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_within_three_standard_errors(rate):
    keep = activation_keep(WORDS, rate, (4, 256, 1024))
    n = keep.numel()
    assert n == 2 ** 20
    se = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) <= 3 * se


def _forward_words(seed, step, micro):
    """The words of one microbatch's forward, as ``train_batch`` derives
    them (``runtime/engine.py``)."""
    return fold_seed(fold_seed(seed_words(seed), step), micro)


PAIRS = {   # two sites whose masks must be unrelated
    "two sites": (site_words(fold_seed(_forward_words(7, 1, 0), 0),
                             HIDDEN1_SITE),
                  site_words(fold_seed(_forward_words(7, 1, 0), 0),
                             HIDDEN2_SITE)),
    "two layers": (site_words(fold_seed(_forward_words(7, 1, 0), 0),
                              MLP_SITE),
                   site_words(fold_seed(_forward_words(7, 1, 0), 1),
                              MLP_SITE)),
    "two microbatches": (site_words(_forward_words(7, 1, 0), EMBED_SITE),
                         site_words(_forward_words(7, 1, 1), EMBED_SITE)),
    "two steps": (site_words(fold_seed(_forward_words(7, 1, 0), 3),
                             MLP_SITE),
                  site_words(fold_seed(_forward_words(7, 2, 0), 3),
                             MLP_SITE)),
}


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_masks_of_distinct_sites_are_unrelated(pair, rate):
    a, b = PAIRS[pair]
    assert a != b
    shape = (2, 512, 1024)
    ka, kb = (activation_keep(w, rate, shape) for w in (a, b))
    agree = (ka == kb).float().mean().item()
    p = (1 - rate) ** 2 + rate ** 2
    se = (p * (1 - p) / ka.numel()) ** 0.5
    assert abs(agree - p) <= 3 * se, (agree, p, se)


def test_site_words_are_never_a_layers_or_the_embeddings():
    """The words of every activation site differ from the words any
    layer's attention dropout takes (``fold_seed(words, i)``) and from
    each other, over 64 layers; the embedding site is no layer's."""
    layers = [fold_seed(WORDS, i) for i in range(64)]
    sites = [site_words(w, s) for w in layers
             for s in (MLP_SITE, HIDDEN1_SITE, HIDDEN2_SITE)]
    sites.append(site_words(WORDS, EMBED_SITE))
    assert len(set(sites)) == len(sites)
    assert not set(sites) & set(layers)
    assert WORDS not in sites


@pytest.mark.parametrize("model", ["gpt", "bert", "ds-layer"])
def test_each_site_draws_its_own_words_in_the_model(model, monkeypatch):
    """What the models really pass: every dropout map of one forward gets
    words that no layer's attention takes, and no two maps share words
    (GPT and BERT: the embeddings and one MLP a layer; the fused layer:
    hidden1 and hidden2 a layer)."""
    seen, layer_words = [], []
    real = pdrop.dropout_map

    def recording(x, words, rate, backward=False):
        if not backward:
            seen.append(tuple(words))
        return real(x, words, rate, backward)
    monkeypatch.setattr(pdrop, "dropout_map", recording)

    def hook(module, args, kwargs):
        layer_words.append(tuple(kwargs["dropout_seed"]))
    net, run = _dropout_model(model)
    for m in net.modules():
        if type(m).__name__ in ("Block", "DeepSpeedTransformerLayer"):
            m.register_forward_pre_hook(hook, with_kwargs=True)
    run(WORDS)
    assert len(layer_words) == 2
    assert len(seen) == (4 if model == "ds-layer" else 3)
    assert len(set(seen)) == len(seen)
    assert not set(seen) & set(layer_words)


class _DSStack(torch.nn.Module):
    """Two fused layers, layer ``i`` on ``fold_seed(words, i)``."""

    def __init__(self, cfg, params=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            DeepSpeedTransformerLayer(cfg, seed=i) for i in range(2))
        if params is not None:
            for layer, p in zip(self.layers, params):
                layer.load_state_dict({k: torch.from_numpy(np.array(v))
                                       for k, v in p.items()})

    def forward(self, x, dropout_seed=None):
        for i, layer in enumerate(self.layers):
            x = layer(x, dropout_seed=(None if dropout_seed is None
                                       else fold_seed(dropout_seed, i)))
        return x


DS_KW = dict(hidden_size=128, heads=2, num_hidden_layers=2,
             initializer_range=0.02, attn_dropout_ratio=0.0,
             hidden_dropout_ratio=RATE, training=True)


def _dropout_model(model, rate=RATE, **kw):
    """(module, run(words) -> output) of a tiny fp32 model with every
    activation dropout at ``rate`` and attention dropout off."""
    if model == "gpt":
        net = GPT(GPTConfig(**TINY, dtype=torch.float32, dropout_rate=rate,
                            **kw), seed=3)
        ids = torch.from_numpy(_ids()).long()
        return net, lambda w: net(ids, dropout_seed=w)
    if model == "bert":
        net = BertForPreTraining(BertConfig(**TINY, dtype=torch.float32,
                                            dropout_rate=rate, **kw), seed=3)
        ids = torch.from_numpy(_ids()).long()
        return net, lambda w: net(ids, dropout_seed=w)[0]
    net = _DSStack(DeepSpeedTransformerConfig(
        **dict(DS_KW, hidden_dropout_ratio=rate, **kw)))
    x = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (B, S, 128)).astype(np.float32))
    return net, lambda w: net(x, dropout_seed=w)


# --------------------------------------------------------------------------
# the models against the JAX package fed the port's masks
# --------------------------------------------------------------------------

def _site_of(path, n_layers):
    """The port's (site, layer) of a JAX nn.Dropout path (BERT's under
    'bert'): ('Dropout_0',) the embeddings, ('h_i' | 'layer_i', 'mlp',
    'Dropout_0') layer i's MLP."""
    path = path[1:] if path[0] == "bert" else path
    if path == ("Dropout_0",):
        return EMBED_SITE, None
    assert path[1:] == ("mlp", "Dropout_0"), path
    i = int(path[0].rsplit("_", 1)[1])
    assert 0 <= i < n_layers
    return MLP_SITE, i


def _fed_masks(words, rate):
    """An interceptor that replaces each JAX nn.Dropout call with flax's
    formula over the port's keep mask of that site."""
    def interceptor(next_fun, args, kwargs, ctx):
        if not (isinstance(ctx.module, nn.Dropout)
                and ctx.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        site, layer = _site_of(ctx.module.path, TINY["n_layers"])
        w = words if layer is None else fold_seed(words, layer)
        keep = activation_keep(site_words(w, site), rate, x.shape)
        return jnp.where(jnp.asarray(keep.numpy()), x / (1.0 - rate), 0.0)
    return interceptor


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_model_matches_jax_fed_the_ports_masks(model):
    """Logits within 1e-5 and every gradient within 1e-5 of the largest,
    with the MLP and embedding dropout of both layers at 0.1: the JAX
    model (unrolled layers) drops the port's elements."""
    ids = _ids()
    if model == "gpt":
        jcfg = JaxGPTConfig(**TINY, dtype=jnp.float32, scan_layers=False,
                            dropout_rate=RATE)
        jm = JaxGPT(jcfg)
        pcfg = GPTConfig(**TINY, dtype=torch.float32, dropout_rate=RATE)
        net = GPT(pcfg, seed=None)
    else:
        jcfg = JaxBertConfig(**TINY, dtype=jnp.float32, scan_layers=False,
                             dropout_rate=RATE)
        jm = JaxBert(jcfg)
        pcfg = BertConfig(**TINY, dtype=torch.float32, dropout_rate=RATE)
        net = BertForPreTraining(pcfg, seed=None)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))[
        "params"]
    net.load_state_dict(params_from_jax(tree_np(params), pcfg))
    r = np.random.RandomState(4).standard_normal(
        (B, S, TINY["vocab_size"])).astype(np.float32)

    def jloss(p):
        with nn.intercept_methods(_fed_masks(WORDS, RATE)):
            out = jm.apply({"params": p}, jnp.asarray(ids),
                           deterministic=False)
        logits = out[0] if model == "bert" else out
        return jnp.sum(logits * r), logits
    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    out = net(torch.from_numpy(ids).long(), dropout_seed=WORDS)
    logits = out[0] if model == "bert" else out
    (logits * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    ref_g = params_from_jax(tree_np(jgrads), pcfg)
    got_g = {k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                 else p.grad.numpy())     # BERT's NSP head: no gradient
             for k, p in net.named_parameters()}
    _close_grads(got_g, {k: v.numpy() for k, v in ref_g.items()})
    # the port dropped something: without dropout the logits move
    plain = dataclasses.replace(pcfg, dropout_rate=0.0)
    twin = type(net)(plain, seed=None)
    twin.load_state_dict(net.state_dict())
    out0 = twin(torch.from_numpy(ids).long())
    assert (out0[0] if model == "bert" else out0).sub(logits).abs().max() \
        > 1e-3


def test_ds_layer_stack_matches_jax_fed_the_ports_masks(monkeypatch):
    """Two fused layers (pre-LN, hidden dropout 0.1 after the attention
    output and after the FFN): JAX's ``_dropout`` fed the port's masks in
    call order (layer 0 hidden1, hidden2, layer 1 ...); outputs within
    1e-5, gradients within 1e-5 of the largest."""
    jcfg = jax_transformer.DeepSpeedTransformerConfig(**DS_KW)
    jlayer = jax_transformer.DeepSpeedTransformerLayer(jcfg)
    x = np.random.RandomState(2).standard_normal((B, S, 128)).astype(
        np.float32)
    params = [jax.tree.map(np.asarray, dict(jlayer.init(
        jax.random.PRNGKey(i), jnp.asarray(x))["params"])) for i in range(2)]
    calls = []

    def fed(y, rate, rng, deterministic):
        if rate <= 0.0 or deterministic or rng is None:
            return y
        layer, half = divmod(len(calls), 2)
        calls.append(layer)
        site = (HIDDEN1_SITE, HIDDEN2_SITE)[half]
        keep = activation_keep(site_words(fold_seed(WORDS, layer), site),
                               rate, y.shape)
        return jnp.where(jnp.asarray(keep.numpy()), y / (1.0 - rate), 0.0)
    monkeypatch.setattr(jax_transformer, "_dropout", fed)
    r = np.random.RandomState(9).standard_normal((B, S, 128)).astype(
        np.float32)

    def jloss(ps, xx):
        for i, p in enumerate(ps):
            xx = jlayer.apply({"params": p}, xx, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(i)})
        return jnp.sum(xx * r), xx
    (_, ref), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    assert calls == [0, 0, 1, 1]
    net = _DSStack(DeepSpeedTransformerConfig(**DS_KW), params)
    xt = torch.from_numpy(x).requires_grad_()
    out = net(xt, dropout_seed=WORDS)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    got = {f"{i}.{k}": p.grad.numpy() for i, layer in enumerate(net.layers)
           for k, p in layer.named_parameters()}
    want = {f"{i}.{k}": np.asarray(v) for i, g in enumerate(jg)
            for k, v in g.items()}
    _close_grads({**got, "x": xt.grad.numpy()}, {**want, "x": np.asarray(
        jgx)})


# --------------------------------------------------------------------------
# bit-for-bit rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["gpt", "bert", "ds-layer"])
def test_eval_mode_and_rate_0_are_the_model_without_dropout(model):
    net, run = _dropout_model(model)
    plain, run0 = _dropout_model(model, rate=0.0)
    plain.load_state_dict(net.state_dict())
    with torch.no_grad():
        ref = run0(WORDS)
        net.eval()
        assert torch.equal(run(WORDS), ref)
        net.train()
        assert not torch.equal(run(WORDS), ref)


@pytest.mark.parametrize("model", ["gpt", "bert", "ds-layer"])
def test_the_former_refusals_train(model):
    """``GPTConfig(dropout_rate=0.1)``, ``BertConfig(dropout_rate=0.1)``
    and ``DeepSpeedTransformerConfig(hidden_dropout_ratio=0.1)`` build
    and take a gradient in training mode (they raised before); the same
    words drop the same elements, other words others."""
    net, run = _dropout_model(model)
    out = run(WORDS)
    out.float().square().mean().backward()
    grads = [p.grad for p in net.parameters() if p.grad is not None]
    assert len(grads) >= len(list(net.parameters())) - 4   # BERT's NSP head
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        assert torch.equal(run(WORDS), out)
        assert not torch.equal(run((WORDS[0], WORDS[1] ^ 1)), out)


def test_backward_redraws_the_mask_and_saves_none():
    """The gradient of a dropout site is the same map of the incoming
    gradient, and the graph keeps no bool mask tensor."""
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = dropout_apply(x, WORDS, 0.3, MLP_SITE)
    assert y.grad_fn.saved_tensors == ()
    g = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(1))
    y.backward(g)
    assert torch.equal(x.grad, dropout_reference(
        g, site_words(WORDS, MLP_SITE), 0.3))


@pytest.mark.parametrize("policy", ["full", "attn_out"])
def test_remat_with_dropout_is_bit_equal_to_none(policy):
    """GPT with MLP, embedding and attention dropout at 0.1: the loss and
    every gradient under ``full`` and ``attn_out`` equal ``none``'s bit
    for bit (the recompute redraws the same bits)."""
    grads = {}
    ids = torch.from_numpy(_ids()).long()
    for name in ("none", policy):
        net = GPT(GPTConfig(**TINY, dtype=torch.float32, dropout_rate=RATE,
                            attn_dropout_rate=RATE, remat=name), seed=3)
        loss = net(ids, dropout_seed=WORDS).float().square().mean()
        loss.backward()
        grads[name] = (loss.detach(), {k: p.grad for k, p in
                                       net.named_parameters()})
    assert torch.equal(grads["none"][0], grads[policy][0])
    for k, g in grads["none"][1].items():
        assert torch.equal(g, grads[policy][1][k]), k
