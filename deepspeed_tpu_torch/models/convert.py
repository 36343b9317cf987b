"""JAX ``GPT`` parameters -> the port's ``GPT`` state dict.

The port's module and parameter names are the flax ones, so the map is
structural: nested dict keys join with "." and the scan-stacked block tree
``h`` ([L, ...] leaves, ``scan_layers=True``) or the unrolled ``h_<i>``
trees become ``h.<i>``. Dense kernels keep their ``[in, out]``
orientation, and the fused qkv kernel keeps its column order (thirds of
3*d_model, then heads), which the port splits the same way.
"""

import numpy as np
import torch


def _flatten(tree, prefix, out):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if key == "kernel" and isinstance(val, dict) \
                and set(val) == {"q", "scale"}:
            # a weight-only int8 kernel (module_quantize's {"q", "scale"}
            # node) is the port's QDense buffers q and scale
            out[f"{prefix}q"], out[f"{prefix}scale"] = val["q"], val["scale"]
        elif isinstance(val, dict):
            _flatten(val, name + ".", out)
        else:
            out[name] = val
    return out


def params_from_jax(tree, config) -> dict:
    """``tree``: the flax ``params`` of a JAX ``GPT`` as nested dicts of
    numpy arrays (unboxed), int8 ``{"q", "scale"}`` kernels included.
    Returns a state dict for ``deepspeed_tpu_torch.models.gpt.GPT(config)``:
    fp32, except int8 ``q`` buffers (load it into a quantized model, or
    after ``module_inject.module_quantize.adopt_int8_layout``)."""
    flat = {}
    for key, val in tree.items():
        if key == "h":   # scan-stacked: every leaf is [n_layers, ...]
            stacked = _flatten(val, "", {})
            for i in range(config.n_layers):
                for name, leaf in stacked.items():
                    flat[f"h.{i}.{name}"] = leaf[i]
        elif key.startswith("h_"):
            _flatten(val, f"h.{int(key[2:])}.", flat)
        elif isinstance(val, dict):
            _flatten(val, f"{key}.", flat)
        else:
            flat[key] = val
    return {name: torch.from_numpy(np.array(
        leaf, np.int8 if name.endswith(".q") else np.float32))
        for name, leaf in flat.items()}
