"""Utilities for adapting models to sparse self-attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``;
reference: ``SparseAttentionUtils``, sparse_attention_utils.py:13).

Models here are (config, state dict) pairs as in the JAX package's
(config, params): "replacing a layer" rewrites the config (the model built
from it routes every attention through the sparse path) and the state
dict (the position table extended). Both return new values; the inputs
are untouched.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .sparsity_config import FixedSparsityConfig, SparsityConfig


class SparseAttentionUtils:
    """Static helpers (reference: sparse_attention_utils.py:13)."""

    @staticmethod
    def extend_position_embedding(state, max_position,
                                  key="position_embeddings",
                                  reserved_rows=0):
        """Tile every 2-D ``key`` table of a state dict (names ending in
        ``.key``) up to ``max_position`` rows: the pretrained table
        repeated whole (RoBERTa's 2 reserved rows: ``reserved_rows=2``).
        Returns a NEW dict sharing the other tensors."""
        out, hits = {}, 0
        for name, val in state.items():
            if name.rsplit(".", 1)[-1] == key and val.dim() == 2:
                head, body = val[:reserved_rows], val[reserved_rows:]
                orig = body.shape[0]
                if max_position <= orig:
                    raise ValueError(
                        f"new max position {max_position} must exceed the "
                        f"original {orig}")
                reps = -(-max_position // orig)   # ceil: never short
                ext = torch.cat([body] * reps, dim=0)[:max_position]
                out[name] = torch.cat([head, ext], dim=0)
                hits += 1
            else:
                out[name] = val
        if not hits:
            raise ValueError(
                f"no 2-D '{key}' table found in the state dict: pass the "
                "embedding's name via key=")
        return out

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position):
        """Reference: sparse_attention_utils.py:69; any HF tokenizer."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            config, state, max_position,
            sparsity_config: Optional[SparsityConfig] = None):
        """Reference: sparse_attention_utils.py:85. Returns
        ``(new_config, new_state)``: the config (``BertConfig`` or any
        dataclass config with a ``sparsity_config`` field) carries the
        pattern and ``max_seq_len = max_position``; the state dict has its
        position table extended to ``max_position``. The q/k/v/output
        weights are untouched: sparsity only changes which score blocks
        are computed."""
        if sparsity_config is None:
            sparsity_config = FixedSparsityConfig(num_heads=config.n_heads)
        field_names = {f.name for f in dataclasses.fields(config)}
        if "sparsity_config" not in field_names:
            raise ValueError(
                f"{type(config).__name__} does not support sparse attention")
        updates = {"sparsity_config": sparsity_config}
        if "max_seq_len" in field_names:
            updates["max_seq_len"] = max_position
        new_config = dataclasses.replace(config, **updates)
        new_state = SparseAttentionUtils.extend_position_embedding(
            state, max_position)
        return new_config, new_state

    @staticmethod
    def pad_to_block_size(block_size, input_ids, attention_mask,
                          token_type_ids, position_ids, inputs_embeds,
                          pad_token_id, model_embeddings=None):
        """Pad the seq dim of every given input to a multiple of
        ``block_size`` (reference: sparse_attention_utils.py:154). Returns
        ``(pad_len, input_ids, attention_mask, token_type_ids,
        position_ids, inputs_embeds)`` with None passed through."""
        seq_len = (input_ids if input_ids is not None
                   else inputs_embeds).shape[1]
        pad_len = (block_size - seq_len % block_size) % block_size
        if pad_len == 0:
            return (0, input_ids, attention_mask, token_type_ids,
                    position_ids, inputs_embeds)

        def pad2d(x, value):
            return None if x is None else F.pad(x, (0, pad_len), value=value)

        if inputs_embeds is not None:
            if model_embeddings is not None:
                pad_ids = torch.full((inputs_embeds.shape[0], pad_len),
                                     pad_token_id, dtype=torch.long,
                                     device=inputs_embeds.device)
                pad_embeds = model_embeddings(pad_ids)
            else:
                pad_embeds = inputs_embeds.new_zeros(
                    (inputs_embeds.shape[0], pad_len,
                     *inputs_embeds.shape[2:]))
            inputs_embeds = torch.cat([inputs_embeds, pad_embeds], dim=1)
        return (pad_len, pad2d(input_ids, pad_token_id),
                pad2d(attention_mask, 0), pad2d(token_type_ids, 0),
                pad2d(position_ids, pad_token_id), inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Reference: sparse_attention_utils.py:214."""
        if pad_len > 0:
            sequence_output = sequence_output[:, :-pad_len]
        return sequence_output
