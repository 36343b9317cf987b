"""The port's greedy ``generate()`` against the JAX package's, token for
token, in fp32 on the same weights (equal-length, ragged and eos)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.generation import generate as jax_generate
from deepspeed_tpu_torch.inference.generation import (
    _sample_impl, _sampling_mode, generate)
from tests.test_torch_model import jax_gpt, port_gpt, tokens


@pytest.fixture(scope="module")
def models():
    jm, params = jax_gpt(seed=3)
    return jm, params, port_gpt(jm, params)


def test_equal_length_batch_and_eos_match_jax(models):
    jm, params, model = models
    ids = tokens((3, 12), seed=4)
    ref = np.asarray(jax_generate(jm, params, jnp.asarray(ids),
                                  max_new_tokens=6))
    out = generate(model, ids, max_new_tokens=6)
    np.testing.assert_array_equal(out.numpy(), ref)

    # an eos that occurs: row 0's second generated token
    eos = int(ref[0, 13])
    ref = np.asarray(jax_generate(jm, params, jnp.asarray(ids),
                                  max_new_tokens=6, eos_token_id=eos))
    out = generate(model, ids, max_new_tokens=6, eos_token_id=eos)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[0, 13:] == eos).all()


def test_ragged_batch_matches_jax(models):
    jm, params, model = models
    ids = tokens((3, 12), seed=5)
    lens = [12, 5, 9]
    ref = np.asarray(jax_generate(jm, params, jnp.asarray(ids),
                                  max_new_tokens=6, prompt_lengths=lens))
    out = generate(model, ids, max_new_tokens=6, prompt_lengths=lens)
    np.testing.assert_array_equal(out.numpy(), ref)
    # each ragged row equals that prompt generated alone
    for row, n in enumerate(lens):
        alone = generate(model, ids[row, :n], max_new_tokens=6)
        np.testing.assert_array_equal(out[row, :n + 6].numpy(),
                                      alone[0].numpy())


def test_sampling_by_distribution():
    """temperature > 0 cannot match jax.random bit for bit: check the
    distribution, the top-k / top-p supports and generator replay."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]])).repeat(
        4000, 1)

    def draw(**kw):
        mode = _sampling_mode(kw.pop("temperature", 1.0), kw.pop("top_k",
                              None), kw.pop("top_p", None))
        return _sample_impl(logits, torch.Generator().manual_seed(0), mode)

    freq = torch.bincount(draw(), minlength=4).float() / 4000
    np.testing.assert_allclose(freq.numpy(), [0.5, 0.3, 0.15, 0.05],
                               atol=0.03)
    assert set(draw(top_k=2).tolist()) == {0, 1}
    assert set(draw(top_p=0.7).tolist()) == {0, 1}
    assert set(draw(temperature=0.0).tolist()) == {0}         # greedy
    assert torch.equal(draw(), draw())                        # replay


def test_generate_validates_lengths_and_ids(models):
    _, _, model = models
    with pytest.raises(ValueError, match="max_seq_len"):
        generate(model, tokens((1, 120)), max_new_tokens=9)
    with pytest.raises(ValueError, match="token ids"):
        generate(model, np.array([[1, 2, 97]]), max_new_tokens=2)
