"""Model transformations for serving (counterpart of
``deepspeed_tpu/module_inject``): kernel injection of HuggingFace models
and checkpoints into the port's models, and weight-only int8
quantization."""

from .replace_module import replace_transformer_layer  # noqa: F401
from .replace_policy import (  # noqa: F401
    InjectionPolicy, HFGPT2LayerPolicy, HFGPTNEOLayerPolicy,
    HFGPTJLayerPolicy, GPTNEOXLayerPolicy, BLOOMLayerPolicy,
    HFBertLayerPolicy, MegatronLayerPolicy, replace_policies,
    POLICY_REGISTRY, export_hf_state_dict)
from .load_checkpoint import (load_model_checkpoint,  # noqa: F401
                              load_megatron_checkpoint, read_hf_config,
                              read_safetensors)
from .module_quantize import (quantize_param_tree,  # noqa: F401
                              dequantize_param_tree)
