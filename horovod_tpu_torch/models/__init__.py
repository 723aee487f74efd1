"""Models of horovod_tpu_torch."""

from .convert import params_from_jax, tree_from_jax, variables_from_jax
from .decode import (assign_slot, decode_step, generate, init_cache, prefill,
                     prefill_scan, reset_slot)
from .inception import InceptionV3
from .resnet import (ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
                     ResNet152)
from .simple import MLP, ConvNet
from .transformer import GPT, GPT_CONFIGS, TransformerConfig, gpt
from .vgg import VGG, VGG16, VGG19

__all__ = ["GPT", "GPT_CONFIGS", "TransformerConfig", "gpt",
           "params_from_jax", "tree_from_jax", "variables_from_jax",
           "ResNet", "ResNet18",
           "ResNet34", "ResNet50", "ResNet101", "ResNet152", "VGG", "VGG16",
           "VGG19", "InceptionV3", "MLP", "ConvNet", "assign_slot",
           "decode_step", "generate", "init_cache", "prefill", "prefill_scan",
           "reset_slot"]
