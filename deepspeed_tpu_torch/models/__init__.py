from .gpt import GPT, GPT2_PRESETS, GPTConfig, gpt_loss_fn  # noqa: F401
from .bert import (BERT_PRESETS, BertConfig, BertEncoder,  # noqa: F401,I001
                   BertForPreTraining, bert_pretrain_loss)
