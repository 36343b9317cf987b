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
        if isinstance(val, dict):
            _flatten(val, name + ".", out)
        else:
            out[name] = val
    return out


def params_from_jax(tree, config) -> dict:
    """``tree``: the flax ``params`` of a JAX ``GPT`` as nested dicts of
    numpy arrays (unboxed). Returns an fp32 state dict for
    ``deepspeed_tpu_torch.models.gpt.GPT(config)``."""
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
    return {name: torch.from_numpy(np.array(leaf, np.float32))
            for name, leaf in flat.items()}
