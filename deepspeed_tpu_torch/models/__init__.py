from .gpt import (GPT, GPT2_PRESETS, REMAT_POLICIES, GPTConfig,  # noqa: F401
                  gpt_chunked_loss_fn, gpt_loss_fn)
from .bert import (BERT_PRESETS, BertConfig, BertEncoder,  # noqa: F401,I001
                   BertForPreTraining, bert_pretrain_loss)
