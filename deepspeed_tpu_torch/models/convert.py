"""JAX model parameters -> the port's state dict (``GPT``,
``BertForPreTraining``, stacks of ``DeepSpeedTransformerLayer``), and
back (``params_to_jax``: the scan-stacked flax layout the injection
policies' ``export`` reads).

The port's module and parameter names are the flax ones, so the map is
structural: nested dict keys join with ".", and a block tree becomes the
port's ``nn.ModuleList`` entries: the scan-stacked ``h`` / ``layer`` trees
([L, ...] leaves, ``scan_layers=True``) and the unrolled ``h_<i>`` /
``layer_<i>`` trees become ``h.<i>`` / ``layer.<i>``, at any depth (BERT's
sit under ``bert``); a stack of ``DeepSpeedTransformerLayer``s named
``layers`` (scanned, or unrolled ``layers_<i>``) becomes ``layers.<i>``,
whose parameters already carry torch's names and ``[out, in]`` layout. Dense kernels keep their ``[in, out]`` orientation,
and the fused qkv kernel keeps its column order (thirds of 3*d_model, then
heads), which the port splits the same way.
"""

import re

import numpy as np
import torch

# GPT's, BERT's and a DeepSpeedTransformerLayer stack's block trees
_STACKED = ("h", "layer", "layers")
_UNROLLED = re.compile(r"(h|layer|layers)_(\d+)")


def _flatten(tree, prefix, out, n_layers=None):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if key == "kernel" and isinstance(val, dict) \
                and set(val) == {"q", "scale"}:
            # a weight-only int8 kernel (module_quantize's {"q", "scale"}
            # node) is the port's QDense buffers q and scale
            out[f"{prefix}q"], out[f"{prefix}scale"] = val["q"], val["scale"]
        elif key in _STACKED and isinstance(val, dict) \
                and n_layers is not None:
            stacked = _flatten(val, "", {})     # every leaf [n_layers, ...]
            for i in range(n_layers):
                for sub, leaf in stacked.items():
                    out[f"{name}.{i}.{sub}"] = leaf[i]
        elif isinstance(val, dict):
            m = _UNROLLED.fullmatch(key)
            _flatten(val, f"{prefix}{m[1]}.{int(m[2])}." if m else name + ".",
                     out, n_layers)
        else:
            out[name] = val
    return out


def params_from_jax(tree, config) -> dict:
    """``tree``: the flax ``params`` of a JAX ``GPT``,
    ``BertForPreTraining`` or ``DeepSpeedTransformerLayer`` stack as nested
    dicts of numpy arrays (unboxed), int8 ``{"q", "scale"}`` kernels
    included; bf16 leaves (a ``param_dtype`` bf16 model) are widened.
    ``config``: the model's config; its ``n_layers`` (or
    ``num_hidden_layers``) splits a scanned stack. Returns a state dict for
    the port's model: fp32, except int8 ``q`` buffers (load it into a
    quantized model, or after
    ``module_inject.module_quantize.adopt_int8_layout``)."""
    n_layers = getattr(config, "n_layers", None)
    if n_layers is None:
        n_layers = getattr(config, "num_hidden_layers", None)
    flat = _flatten(tree, "", {}, n_layers)
    return {name: torch.from_numpy(np.array(
        leaf, np.int8 if name.endswith(".q") else np.float32))
        for name, leaf in flat.items()}


def params_to_jax(state_dict) -> dict:
    """The inverse of ``params_from_jax`` into the scan layout: a port
    state dict (or a module's) as nested dicts of fp32 numpy arrays, each
    ``h.<i>`` / ``layer.<i>`` / ``layers.<i>`` run stacked on a leading
    layer axis, int8 ``q`` / ``scale`` buffers as a ``{"q", "scale"}``
    kernel node."""
    if isinstance(state_dict, torch.nn.Module):
        state_dict = state_dict.state_dict()
    stacks = {}
    tree = {}
    int8 = {name[:-2] for name in state_dict if name.endswith(".q")}
    for name, t in state_dict.items():
        if t is None:
            continue
        arr = t.detach().cpu()
        arr = (arr.numpy() if arr.dtype == torch.int8
               else arr.float().numpy())
        parts = name.split(".")
        if ".".join(parts[:-1]) in int8:
            parts = parts[:-1] + ["kernel", parts[-1]]
        for j in range(len(parts) - 1):
            if parts[j] in _STACKED and parts[j + 1].isdigit():
                head = tuple(parts[:j + 1])
                stacks.setdefault(head, {}).setdefault(
                    tuple(parts[j + 2:]), {})[int(parts[j + 1])] = arr
                break
        else:
            _put(tree, parts, arr)
    for head, leaves in stacks.items():
        for rest, by_layer in leaves.items():
            _put(tree, list(head) + list(rest),
                 np.stack([by_layer[i] for i in sorted(by_layer)]))
    return tree


def _put(tree, parts, leaf):
    for key in parts[:-1]:
        tree = tree.setdefault(key, {})
    tree[parts[-1]] = leaf
