"""BERT-family encoder (counterpart of ``deepspeed_tpu/models/bert.py``).

Post-LN (the reference default) or pre-LN blocks, exact GELU in the
encoder MLP, bidirectional attention, optionally block-sparse
(``sparsity_config``, set by ``ops.sparse_attention.SparseAttentionUtils.
replace_model_self_attention_with_sparse_self_attention``). The layers are
an unrolled ``nn.ModuleList`` named ``layer``; parameter names are the
flax ones, so ``models.convert.params_from_jax`` maps a JAX BERT tree
(scanned or unrolled) onto this module.

Attention dropout (``attn_dropout_rate``) is live in training mode with
the forward's seed words, layer ``i`` taking
``ops.dropout.fold_seed(dropout_seed, i)`` as GPT does. ``remat``
checkpoints every layer under a ``models.layers.REMAT_POLICIES`` policy and
``layer_keep_prob`` is progressive layer drop's gate, as in the JAX
encoder (bert.py:63-119); ``BertForPreTraining.forward`` also takes
``layer_keep_prob`` and hands it to the encoder (the JAX pretraining
module does not take it, so PLD there reaches only a loss that calls the
encoder itself). Embedding and MLP dropout (``dropout_rate``, JAX
bert.py:83-84 and layers.py:618-619) are live in training mode on the
same counter hash (``ops.dropout.dropout_apply``): the embeddings after
``embeddings_ln`` at ``EMBED_SITE`` of the forward's words, each layer's
MLP output at ``MLP_SITE`` of the layer's.
"""

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import EMBED_SITE, dropout_apply, fold_seed
from .layers import Block, LayerNorm, QDense, remat_policy


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_seq_len: int = 512
    type_vocab_size: int = 2
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: Optional[int] = None
    dropout_rate: float = 0.0            # MLP output and embeddings
    attn_dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16  # compute dtype (params are fp32)
    ln_epsilon: float = 1e-12
    pre_ln: bool = False                 # reference default: post-LN BERT
    remat: str = "none"                  # key into REMAT_POLICIES
    activation: str = "gelu_exact"       # HF BERT uses exact GELU
    # block-sparse attention pattern (set via SparseAttentionUtils.
    # replace_model_self_attention_with_sparse_self_attention)
    sparsity_config: Any = None

    @property
    def ffn_dim(self):
        return self.d_ff or 4 * self.d_model

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


BERT_PRESETS = {
    "bert-base": BertConfig(d_model=768, n_layers=12, n_heads=12),
    "bert-large": BertConfig(d_model=1024, n_layers=24, n_heads=16),
}


def init_params(module: nn.Module, seed: int):
    """Embeddings ~ N(0, 0.02), dense kernels ~ N(0, 1/fan_in), biases 0,
    LayerNorm scale 1 — drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("embeddings"):
                val = torch.randn(p.shape, generator=gen) * 0.02
            elif leaf == "kernel":
                val = torch.randn(p.shape, generator=gen) / p.shape[0] ** 0.5
            elif leaf == "scale":
                val = torch.ones(p.shape)
            else:
                val = torch.zeros(p.shape)
            p.copy_(val)


class BertEncoder(nn.Module):
    """Token + position + type embeddings -> N encoder blocks; returns
    (sequence_output [b, s, d], pooled_output [b, d]) in the compute
    dtype. Weights drawn from ``seed`` (``init_params``; None leaves them
    unset, for a caller that loads every weight)."""

    # every dense layer is a QDense (module_quantize's direct mode)
    supports_quantized_kernels = True

    def __init__(self, config: BertConfig, seed: Optional[int] = 0):
        super().__init__()
        remat_policy(config.remat)
        self.config = cfg = config
        d = cfg.d_model
        self.word_embeddings = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.position_embeddings = nn.Parameter(torch.empty(cfg.max_seq_len,
                                                            d))
        self.token_type_embeddings = nn.Parameter(
            torch.empty(cfg.type_vocab_size, d))
        self.embeddings_ln = LayerNorm(d, cfg.ln_epsilon)
        self.layer = nn.ModuleList(
            Block(cfg.n_heads, d, cfg.ffn_dim, dtype=cfg.dtype,
                  ln_epsilon=cfg.ln_epsilon,
                  attn_dropout_rate=cfg.attn_dropout_rate,
                  dropout_rate=cfg.dropout_rate, causal=False,
                  pre_ln=cfg.pre_ln, activation=cfg.activation,
                  sparsity_config=cfg.sparsity_config,
                  sparsity_pattern_len=cfg.max_seq_len)
            for _ in range(cfg.n_layers))
        self.pooler = QDense(d, d, True, cfg.dtype)
        if seed is not None:
            init_params(self, seed)

    def forward(self, input_ids, *, token_type_ids=None, attention_mask=None,
                dropout_seed=None, layer_keep_prob=None):
        cfg = self.config
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(s, device=input_ids.device)
        h = (self.word_embeddings[input_ids]
             + self.position_embeddings[pos][None]
             + self.token_type_embeddings[token_type_ids]).to(cfg.dtype)
        h = self.embeddings_ln(h)
        if cfg.dropout_rate > 0.0 and self.training:
            h = dropout_apply(h, dropout_seed, cfg.dropout_rate, EMBED_SITE)
        mask = (attention_mask[:, None, None, :].bool()
                if attention_mask is not None else None)
        for i, block in enumerate(self.layer):
            h = block(h, mask=mask,
                      dropout_seed=(None if dropout_seed is None
                                    else fold_seed(dropout_seed, i)),
                      layer_keep_prob=layer_keep_prob, remat=cfg.remat)
        return h, torch.tanh(self.pooler(h[:, 0]))


class BertForPreTraining(nn.Module):
    """MLM + NSP heads (JAX ``BertForPreTraining``; reference:
    BertForPreTraining in tests/unit/modeling.py). ``forward`` returns
    (mlm_logits [b, s, vocab], nsp_logits [b, 2]) in the compute dtype.
    Built on the CPU with weights drawn from ``seed``."""

    supports_quantized_kernels = True

    def __init__(self, config: BertConfig, seed: Optional[int] = 0):
        super().__init__()
        self.config = cfg = config
        self.bert = BertEncoder(cfg, seed=None)
        self.mlm_transform = QDense(cfg.d_model, cfg.d_model, True, cfg.dtype)
        self.mlm_ln = LayerNorm(cfg.d_model, cfg.ln_epsilon)
        self.nsp_head = QDense(cfg.d_model, 2, True, cfg.dtype)
        if seed is not None:
            self.reset_parameters(seed)

    def reset_parameters(self, seed: int = 0):
        """``init_params`` over every weight, the encoder's included."""
        init_params(self, seed)

    def forward(self, input_ids, *, token_type_ids=None, attention_mask=None,
                dropout_seed=None, layer_keep_prob=None):
        cfg = self.config
        seq_out, pooled = self.bert(input_ids, token_type_ids=token_type_ids,
                                    attention_mask=attention_mask,
                                    dropout_seed=dropout_seed,
                                    layer_keep_prob=layer_keep_prob)
        # MLM head: transform, tanh-GELU (bert.py:148), LN, and the decoder
        # tied to the word embeddings in the compute dtype, no bias
        h = F.gelu(self.mlm_transform(seq_out), approximate="tanh")
        h = self.mlm_ln(h)
        mlm_logits = h @ self.bert.word_embeddings.to(cfg.dtype).t()
        return mlm_logits, self.nsp_head(pooled)


def bert_pretrain_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                       ignore_index=-1):
    """Masked-LM + next-sentence loss in fp32 (bert.py:159): the MLM
    cross entropy averaged over the labelled positions (at least one),
    plus the mean NSP cross entropy."""
    mlm_logits = mlm_logits.float()
    nsp_logits = nsp_logits.float()
    mlm_labels, nsp_labels = mlm_labels.long(), nsp_labels.long()
    mask = mlm_labels != ignore_index
    safe = torch.where(mask, mlm_labels, 0)
    logz = torch.logsumexp(mlm_logits, dim=-1)
    ll = mlm_logits.gather(-1, safe[..., None])[..., 0]
    mlm_nll = ((logz - ll) * mask).sum() / mask.sum().clamp_min(1)
    nsp_logz = torch.logsumexp(nsp_logits, dim=-1)
    nsp_ll = nsp_logits.gather(-1, nsp_labels[..., None])[..., 0]
    return mlm_nll + (nsp_logz - nsp_ll).mean()
