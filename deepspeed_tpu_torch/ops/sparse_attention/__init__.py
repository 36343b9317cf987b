"""Block-sparse attention (counterpart of
``deepspeed_tpu/ops/sparse_attention``), with ``BertSparseSelfAttention``
taking HF BERT checkpoint names."""

from .sparsity_config import (SparsityConfig, DenseSparsityConfig,  # noqa: F401
                              FixedSparsityConfig, VariableSparsityConfig,
                              BigBirdSparsityConfig,
                              BSLongformerSparsityConfig)
from .sparse_self_attention import (SparseSelfAttention,  # noqa: F401
                                    layout_to_dense_mask, sparse_attention)
from .sparse_attention_utils import SparseAttentionUtils  # noqa: F401
from .bert_sparse_self_attention import BertSparseSelfAttention  # noqa: F401

__all__ = ["SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
           "VariableSparsityConfig", "BigBirdSparsityConfig",
           "BSLongformerSparsityConfig", "SparseSelfAttention",
           "sparse_attention", "layout_to_dense_mask",
           "SparseAttentionUtils", "BertSparseSelfAttention"]
