from .gpt import GPT, GPT2_PRESETS, GPTConfig, gpt_loss_fn  # noqa: F401
