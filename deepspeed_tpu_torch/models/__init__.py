from .gpt import GPT, GPT2_PRESETS, GPTConfig  # noqa: F401
