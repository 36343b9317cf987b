"""``init_inference`` takes the JAX package's call forms.

The port's ``InferenceEngine.__init__`` has the JAX engine's positional
parameters in the JAX engine's order (read here through ``inspect``), so
every call that names them, by keyword or by position, means the same
thing in both packages; ``device`` is the port's own keyword-only
argument. At their defaults the parameters the port does not implement
yet do nothing; other values raise ``NotImplementedError`` naming the
slice of the port that brings them. ``checkpoint`` (by keyword or by
position), ``replace_with_kernel_inject`` and ``injection_policy`` work
since the checkpoint-injection slice (``test_torch_injection.py``).
Extra keyword arguments are ignored, as the JAX engine ignores them.
"""

import inspect
import json

import pytest
import torch

from deepspeed_tpu.comm.mesh import MeshSpec
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import GPT, GPTConfig
from tests.torch_threads import share_cores

share_cores()


def _params(cls):
    return [p for p in inspect.signature(cls.__init__).parameters.values()
            if p.kind is p.POSITIONAL_OR_KEYWORD][2:]   # self, model


JAX_NAMES = [p.name for p in _params(JaxEngine)]
# the port's defaults (JAX's dtype default is a jnp dtype)
DEFAULTS = {p.name: p.default for p in _params(InferenceEngine)}


@pytest.fixture(scope="module")
def model():
    return GPT(GPTConfig(vocab_size=64, max_seq_len=32, d_model=32,
                         n_layers=1, n_heads=2, dtype=torch.float32))


def test_the_positional_parameters_are_jaxs_in_jaxs_order():
    assert [p.name for p in _params(InferenceEngine)] == JAX_NAMES
    sig = inspect.signature(InferenceEngine.__init__).parameters
    assert sig["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert any(p.kind is inspect.Parameter.VAR_KEYWORD for p in
               inspect.signature(JaxEngine.__init__).parameters.values())
    assert any(p.kind is inspect.Parameter.VAR_KEYWORD for p in
               sig.values())


@pytest.mark.parametrize("name", JAX_NAMES)
def test_each_jax_keyword_at_its_default_constructs(model, name):
    eng = init_inference(model, **{name: DEFAULTS[name]}, device="cpu")
    assert eng.device == torch.device("cpu")


def test_every_jax_keyword_at_once_and_by_position(model):
    init_inference(model, **DEFAULTS, device="cpu")
    eng = InferenceEngine(model, *(DEFAULTS[n] for n in JAX_NAMES),
                          device="cpu")
    assert eng.max_tokens == DEFAULTS["max_tokens"]
    # the three new keywords at once
    init_inference(model, checkpoint=None, injection_policy=None,
                   mesh=None, device="cpu")


@pytest.mark.parametrize("mesh", [{"model": 1, "data": 1},
                                  MeshSpec(model=1)])
def test_a_mesh_with_a_model_axis_of_one_constructs(model, mesh):
    init_inference(model, mesh=mesh, device="cpu")


def test_extra_keywords_are_ignored_as_jax_ignores_them(model):
    init_inference(model, enable_cuda_graph=False, device="cpu")


@pytest.mark.parametrize("kwargs,slice_name", [
    ({"offload_params": True}, "offload and tiering slice"),
    ({"mp_size": 8}, "multi-GPU slice"),
    ({"mesh": {"model": 2}}, "multi-GPU slice"),
    ({"mesh": MeshSpec(model=4)}, "multi-GPU slice"),
    ({"mp_size": 2}, "multi-GPU slice"),
])
def test_each_non_default_value_names_its_slice(model, kwargs, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        init_inference(model, **kwargs, device="cpu")


def test_a_checkpoint_by_position_names_its_slice(model, tmp_path):
    """The fifth positional parameter is the checkpoint in both packages:
    a HF directory (GPT-2 names, ``config.json`` beside them) given by
    position loads into the model."""
    from deepspeed_tpu_torch.module_inject import export_hf_state_dict
    source = GPT(model.config, seed=5)
    sd = export_hf_state_dict("gpt2", source, model.config)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "pytorch_model.bin")
    cfg = model.config
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": cfg.vocab_size,
                   "n_positions": cfg.max_seq_len, "n_embd": cfg.d_model,
                   "n_layer": cfg.n_layers, "n_head": cfg.n_heads}, f)
    eng = InferenceEngine(model, 1, None, None, str(tmp_path), device="cpu")
    for name, t in source.state_dict().items():
        assert torch.equal(eng.module.state_dict()[name], t), name
