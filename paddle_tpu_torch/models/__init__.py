from .bert import (BertConfig, BertEmbeddings, BertEncoderLayer,
                   BertForPretraining, BertModel, bert_base, bert_large)
from .gpt import (GPTConfig, GPTForCausalLM, GPTForCausalLMMoE,
                  GPTForCausalLMPipe, convert_decoder_state_dict,
                  decoder_state_layout, restore_decoder_any_layout)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaForCausalLMPipe,
                    LlamaModel, llama_preset)

__all__ = ["BertConfig", "BertEmbeddings", "BertEncoderLayer",
           "BertForPretraining", "BertModel", "bert_base", "bert_large",
           "GPTConfig", "GPTForCausalLM", "GPTForCausalLMMoE",
           "GPTForCausalLMPipe", "LlamaConfig", "LlamaForCausalLM",
           "LlamaForCausalLMPipe", "LlamaModel", "convert_decoder_state_dict",
           "decoder_state_layout", "llama_preset",
           "restore_decoder_any_layout"]
