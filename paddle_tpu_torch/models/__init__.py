from .convert import load_paddle_params, load_stacked_params
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    apply_rotary_emb, llama_config)
from .llama_functional import build_loss_fn, build_train_step

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_config",
           "apply_rotary_emb", "load_paddle_params", "load_stacked_params",
           "build_loss_fn", "build_train_step"]
