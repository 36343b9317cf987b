from .attention import attention  # noqa: F401
from .transformer import (DeepSpeedTransformerConfig,  # noqa: F401
                          DeepSpeedTransformerLayer, TransformerConfig)
