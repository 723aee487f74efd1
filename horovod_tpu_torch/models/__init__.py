"""Models of horovod_tpu_torch."""

from .convert import params_from_jax
from .transformer import GPT, GPT_CONFIGS, TransformerConfig, gpt

__all__ = ["GPT", "GPT_CONFIGS", "TransformerConfig", "gpt",
           "params_from_jax"]
