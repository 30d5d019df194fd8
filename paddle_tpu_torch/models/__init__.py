from .gpt import GPTConfig, GPTForCausalLM
from .llama import LlamaConfig, LlamaForCausalLM, llama_preset

__all__ = ["GPTConfig", "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM",
           "llama_preset"]
