"""Versioned Megatron checkpoint loading with tensor-parallel merge and
split (counterpart of ``deepspeed_tpu/runtime/state_dict_factory.py``).

Serving a Megatron-trained GPT at another model-parallel degree than it
was saved at needs qkv-aware merging (ckpt_mp > target_mp) or splitting
(ckpt_mp < target_mp) of the column- and row-parallel weights. One card
only ever merges to a full state dict; ``split`` writes Megatron-format
shards back out.

Category rules (substring-matched, as the reference's merge loop):
- column-parallel (cat dim 0 of the [out, in] torch layout):
  ``mlp.dense_h_to_4h``, ``word_embeddings``, ``lm_head``
- row-parallel (cat dim 1): ``attention.dense.weight``,
  ``mlp.dense_4h_to_h.weight`` (their biases are replicated)
- qkv (version-aware): ``attention.query_key_value``. Versions below 2.0
  (0 and 1.0) store each rank's shard as [q_r; k_r; v_r], so a naive
  concat interleaves wrongly and the merge regroups per category;
  version >= 2.0 is a plain dim-0 concat.
- everything else is replicated: rank 0 wins.
"""

import json
import os
from typing import Dict, List

import numpy as np


COL_PARALLEL = ("mlp.dense_h_to_4h", "word_embeddings.weight", "lm_head")
ROW_PARALLEL = ("attention.dense.weight", "mlp.dense_4h_to_h.weight",
                "self_attention.dense.weight")
QKV = ("attention.query_key_value", "self_attention.query_key_value")


class SDLoaderFactory:
    @staticmethod
    def get_sd_loader_json(json_file, checkpoint_engine=None):
        """Resolve a ds_inference checkpoint descriptor (reference:
        SDLoaderFactory.get_sd_loader_json): a path to a json file or an
        already-parsed dict with {type, checkpoints, version, mp_size}."""
        if isinstance(json_file, str):
            with open(json_file) as f:
                data = json.load(f)
            base = os.path.dirname(os.path.abspath(json_file))
        else:
            data = dict(json_file)
            base = data.get("base_dir", "")
        ckpt_list = [os.path.join(base, c) if base and not os.path.isabs(c)
                     else c for c in data["checkpoints"]]
        return SDLoaderFactory.get_sd_loader(
            ckpt_list, sd_type=data.get("type", "Megatron"),
            version=data.get("version", 1.0))

    @staticmethod
    def get_sd_loader(ckpt_list: List[str], sd_type: str = "Megatron",
                      version=1.0):
        if sd_type.lower() != "megatron":
            raise ValueError(f"unsupported checkpoint type {sd_type!r} "
                             "(only 'Megatron' has a versioned loader; HF "
                             "checkpoints load via module_inject)")
        return MegatronSDLoader(ckpt_list, version=version)


class MegatronSDLoader:
    """Merge/split Megatron mp-sharded state dicts (numpy level)."""

    def __init__(self, ckpt_list, version=1.0):
        self.ckpt_list = list(ckpt_list)
        self.version = float(version)

    # -- loading -------------------------------------------------------
    def _load_shard(self, path_or_sd) -> Dict[str, np.ndarray]:
        if isinstance(path_or_sd, dict):
            return path_or_sd
        from ..module_inject.load_checkpoint import _load_torch_file
        return _load_torch_file(path_or_sd)

    def load(self, mp_world_size: int = 1, mp_rank: int = 0):
        """Reference MegatronSDLoader.load: return the state dict for
        (mp_world_size, mp_rank), merging or splitting as needed."""
        n = len(self.ckpt_list)
        shards = [self._load_shard(c) for c in self.ckpt_list]
        if n == mp_world_size:
            return shards[mp_rank]
        full = self.merge_state_dict(shards)
        if mp_world_size == 1:
            return full
        return self.split_state_dict(full, mp_world_size, mp_rank)

    # -- qkv handling (version-aware) ---------------------------------
    def merge_query_key_value(self, parts: List[np.ndarray]) -> np.ndarray:
        if self.version >= 2.0:
            return np.concatenate(parts, axis=0)
        # v1.0: each rank holds [q_r; k_r; v_r] stacked on dim 0 — regroup
        cats = [[], [], []]
        for p in parts:
            if p.shape[0] % 3 != 0:
                raise ValueError(f"qkv dim {p.shape[0]} not divisible by 3")
            for c, chunk in enumerate(np.split(p, 3, axis=0)):
                cats[c].append(chunk)
        return np.concatenate([np.concatenate(c, axis=0) for c in cats],
                              axis=0)

    def split_query_key_value(self, full: np.ndarray, n: int,
                              rank: int) -> np.ndarray:
        if self.version >= 2.0:
            return np.split(full, n, axis=0)[rank]
        q, k, v = np.split(full, 3, axis=0)
        return np.concatenate([np.split(t, n, axis=0)[rank]
                               for t in (q, k, v)], axis=0)

    # -- merge / split ------------------------------------------------
    def merge_state_dict(self, shards: List[Dict[str, np.ndarray]]):
        full = {}
        for key in shards[0]:
            parts = [np.asarray(s[key]) for s in shards]
            if any(t in key for t in QKV):
                full[key] = self.merge_query_key_value(parts)
            elif any(t in key for t in ROW_PARALLEL):
                full[key] = np.concatenate(parts, axis=1)
            elif any(t in key for t in COL_PARALLEL):
                # matches both .weight and .bias of column-parallel layers
                full[key] = np.concatenate(parts, axis=0)
            else:
                full[key] = parts[0]
        return full

    def split_state_dict(self, full: Dict[str, np.ndarray], n: int,
                         rank: int):
        out = {}
        for key, val in full.items():
            val = np.asarray(val)
            if any(t in key for t in QKV):
                out[key] = self.split_query_key_value(val, n, rank)
            elif any(t in key for t in ROW_PARALLEL):
                out[key] = np.split(val, n, axis=1)[rank]
            elif any(t in key for t in COL_PARALLEL):
                out[key] = np.split(val, n, axis=0)[rank]
            else:
                out[key] = val
        return out
