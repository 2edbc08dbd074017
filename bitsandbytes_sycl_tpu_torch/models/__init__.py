"""Model families of the port: the Llama substrate (Llama, Mistral, Qwen2,
Gemma, Gemma-2, Mixtral's mixture of experts), the GPT-J substrate (GPT-J,
Phi, GPT-NeoX, Falcon) and the OPT substrate (OPT, GPT-2, BLOOM with
ALiBi), with QLoRA adapters. Each family's ``load_*_from_hf`` reads a
HuggingFace checkpoint directory (``checkpoints.read_safetensors`` or
``.bin``) and quantizes it on load, on the card unless given
``device="cpu"``."""

from . import (bloom, falcon, gemma, gpt2, gptj, llama, lora, mistral, mixtral, neox, opt, phi,
               qwen2)
from .bloom import BloomConfig, bloom_forward, load_bloom_from_hf
from .falcon import FalconConfig, falcon_forward, load_falcon_from_hf
from .gemma import (Gemma2Config, GemmaConfig, gemma2_forward, gemma_forward, load_gemma2_from_hf,
                    load_gemma_from_hf)
from .gpt2 import GPT2Config, gpt2_forward, load_gpt2_from_hf
from .gptj import GPTJConfig, gptj_forward, init_gptj_kv_cache, init_gptj_params
from .llama import LlamaConfig, init_kv_cache, init_params, llama_forward, quantize_params
from .lora import init_lora, lora_leaves, merge_lora, qlora_loss_fn, stack_lora
from .mistral import MistralConfig, load_mistral_from_hf, mistral_forward
from .mixtral import MixtralConfig, load_mixtral_from_hf, mixtral_forward
from .neox import NeoXConfig, load_neox_from_hf, neox_forward
from .opt import OPTConfig, init_opt_kv_cache, init_opt_params, load_opt_from_hf, opt_forward
from .phi import PhiConfig, load_phi_from_hf, phi_forward
from .qwen2 import Qwen2Config, load_qwen2_from_hf, qwen2_forward

__all__ = [
    "llama", "gptj", "lora", "mistral", "mixtral", "qwen2", "gemma", "phi", "neox",
    "falcon", "FalconConfig", "falcon_forward", "load_falcon_from_hf",
    "opt", "OPTConfig", "opt_forward", "init_opt_params", "init_opt_kv_cache", "load_opt_from_hf",
    "gpt2", "GPT2Config", "gpt2_forward", "load_gpt2_from_hf",
    "bloom", "BloomConfig", "bloom_forward", "load_bloom_from_hf",
    "LlamaConfig", "init_params", "llama_forward", "quantize_params", "init_kv_cache",
    "GPTJConfig", "gptj_forward", "init_gptj_kv_cache", "init_gptj_params",
    "MistralConfig", "mistral_forward", "load_mistral_from_hf",
    "MixtralConfig", "mixtral_forward", "load_mixtral_from_hf",
    "Qwen2Config", "qwen2_forward", "load_qwen2_from_hf",
    "GemmaConfig", "gemma_forward", "load_gemma_from_hf",
    "Gemma2Config", "gemma2_forward", "load_gemma2_from_hf",
    "PhiConfig", "phi_forward", "load_phi_from_hf",
    "NeoXConfig", "neox_forward", "load_neox_from_hf",
    "init_lora", "merge_lora", "qlora_loss_fn", "lora_leaves", "stack_lora",
]
