from .convert import load_paddle_params
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    apply_rotary_emb, llama_config)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_config",
           "apply_rotary_emb", "load_paddle_params"]
