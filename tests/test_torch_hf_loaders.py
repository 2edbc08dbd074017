"""Every HuggingFace loader of the port against the JAX package's on the
CPU.

One tiny HuggingFace checkpoint per family (hidden 128, 2 layers, random
weights from a seed; the smallest width whose projections hold whole
pairs of 64-blocks), saved by ``transformers`` as safetensors. For each of
the 13 loaders (``load_llama_from_hf``, ``load_gptj_from_hf`` and the
eleven families'), the JAX loader and the port's (``device="cpu"``) read
the same directory with the config from its config.json: the configs
agree field for field and every leaf (packed NF4 bytes, bf16 scales, the
bf16 embeddings, the f32 norms and biases) is equal bit for bit. Falcon
runs in both fused-qkv layouts. Llama and GPT-J with ``quant="none"`` in
f32 match ``transformers``' logits within the JAX tests' 2e-2 relative L2;
a bf16 Llama checkpoint loads bit-equal to the JAX loader and within their
5e-2.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bitsandbytes_sycl_tpu.checkpoints as JC
import bitsandbytes_sycl_tpu.models as JM
import bitsandbytes_sycl_tpu_torch.checkpoints as TC
import bitsandbytes_sycl_tpu_torch.models as TM
from bitsandbytes_sycl_tpu_torch.convert import params_from_jax
from bitsandbytes_sycl_tpu_torch.ops.common import QLinearWeight

transformers = pytest.importorskip("transformers")

V, H = 256, 128
_COMMON = dict(attn_implementation="eager")
# family -> (transformers config class, model class, config fields, loader module)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(
        vocab_size=V, hidden_size=H, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64,
        tie_word_embeddings=False), None),
    "gptj": ("GPTJConfig", "GPTJForCausalLM", dict(
        vocab_size=V, n_embd=H, n_layer=2, n_head=2, rotary_dim=32, n_positions=64), None),
    "mistral": ("MistralConfig", "MistralForCausalLM", dict(
        vocab_size=V, hidden_size=H, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64,
        sliding_window=8, tie_word_embeddings=False), "mistral"),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(
        vocab_size=V, hidden_size=H, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64,
        rope_theta=10000.0, tie_word_embeddings=False), "qwen2"),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(
        vocab_size=V, hidden_size=H, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=32, max_position_embeddings=64,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True), "gemma"),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM", dict(
        vocab_size=V, hidden_size=H, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=32, max_position_embeddings=64,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
        query_pre_attn_scalar=32, sliding_window=8), "gemma"),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM", dict(
        vocab_size=V, hidden_size=H, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64,
        num_local_experts=4, num_experts_per_tok=2, tie_word_embeddings=False), "mixtral"),
    "phi": ("PhiConfig", "PhiForCausalLM", dict(
        vocab_size=V, hidden_size=H, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=64, partial_rotary_factor=0.5,
        tie_word_embeddings=False), "phi"),
    "neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM", dict(
        vocab_size=V, hidden_size=H, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=64, rotary_pct=0.25,
        use_parallel_residual=True, hidden_act="gelu", tie_word_embeddings=False), "neox"),
    "falcon": ("FalconConfig", "FalconForCausalLM", dict(
        vocab_size=V, hidden_size=H, num_hidden_layers=2, num_attention_heads=4, num_kv_heads=2,
        multi_query=False, new_decoder_architecture=True, parallel_attn=True, bias=False,
        alibi=False, max_position_embeddings=64, tie_word_embeddings=False), "falcon"),
    "falcon_mq": ("FalconConfig", "FalconForCausalLM", dict(
        vocab_size=V, hidden_size=H, num_hidden_layers=2, num_attention_heads=4,
        multi_query=True, new_decoder_architecture=False, parallel_attn=True, bias=False,
        alibi=False, max_position_embeddings=64, tie_word_embeddings=True), "falcon"),
    "opt": ("OPTConfig", "OPTForCausalLM", dict(
        vocab_size=V, hidden_size=H, num_hidden_layers=2, ffn_dim=256, num_attention_heads=2,
        max_position_embeddings=64, word_embed_proj_dim=H, do_layer_norm_before=True,
        tie_word_embeddings=True), "opt"),
    "gpt2": ("GPT2Config", "GPT2LMHeadModel", dict(
        vocab_size=V, n_embd=H, n_layer=2, n_head=2, n_positions=64, n_inner=256,
        activation_function="gelu_new"), "gpt2"),
    "bloom": ("BloomConfig", "BloomForCausalLM", dict(
        vocab_size=V, hidden_size=H, n_layer=2, n_head=2, tie_word_embeddings=True), "bloom"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side on one thread (six test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nonzero_biases(model):
    """transformers zero-initialises biases: give them values so that a
    dropped or misplaced bias shows."""
    g = torch.Generator().manual_seed(99)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias") and "norm" not in name and "ln" not in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)


def _save(tmp_path_factory, family, dtype=torch.float32, seed=0):
    cfg_cls, model_cls, fields, _ = FAMILIES[family]
    cfg = getattr(transformers, cfg_cls)(**fields, **_COMMON)
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(cfg).eval()
    _nonzero_biases(model)
    d = tmp_path_factory.mktemp(f"hf_{family}")
    toks = torch.randint(0, V, (2, 12), generator=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        ref = model(toks).logits.float().numpy()
    model.to(dtype).save_pretrained(d, safe_serialization=True)
    return str(d), toks, ref


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return {f: _save(tmp_path_factory, f, seed=i) for i, f in enumerate(FAMILIES)}


def _loaders(family):
    mod = FAMILIES[family][3]
    if mod is None:
        name = f"load_{family}_from_hf"
        return getattr(JC, name), getattr(TC, name)
    name = f"load_{family.split('_')[0]}_from_hf"
    return getattr(getattr(JM, mod), name), getattr(getattr(TM, mod), name)


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, QLinearWeight):
        return [(f"{path}.{f}", getattr(tree, f)) for f in ("packed", "absmax")] + [
            (f"{path}.meta", (tree.shape, tree.blocksize, tree.quant_type))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]


def _same_tree(jax_params, port_params, cfg):
    want = params_from_jax(jax.tree.map(np.asarray, jax_params), cfg, device="cpu")
    lw, lg = _leaves(want), _leaves(port_params)
    assert [p for p, _ in lw] == [p for p, _ in lg]
    for (p, w), (_, g) in zip(lw, lg):
        if isinstance(w, tuple):
            assert tuple(w[0]) == tuple(g[0]) and w[1:] == g[1:], p
        else:
            assert w.dtype == g.dtype and w.shape == g.shape and torch.equal(w, g), p
    return len(lw)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loader_bytes_equal_the_jax_loader(checkpoints, family):
    d, _, _ = checkpoints[family]
    jload, tload = _loaders(family)
    jcfg, jparams = jload(d)
    tcfg, tparams = tload(d, device="cpu")
    assert type(tcfg).__name__ == type(jcfg).__name__
    assert _fields(tcfg) == _fields(jcfg)
    assert _same_tree(jparams, tparams, tcfg) > 10


@pytest.mark.parametrize("family,forward", [("llama", "llama_forward"),
                                            ("gptj", "gptj_forward")])
def test_unquantized_logits_match_transformers(checkpoints, family, forward):
    d, toks, ref = checkpoints[family]
    _, tload = _loaders(family)
    cfg, _ = tload(d, device="cpu")
    cfg = dataclasses.replace(cfg, quant="none", dtype=torch.float32)
    _, params = tload(d, cfg=cfg, device="cpu")
    logits, _ = getattr(TM, forward)(params, cfg, toks)
    rel = np.linalg.norm(logits.numpy() - ref) / np.linalg.norm(ref)
    assert rel < 2e-2, rel


def test_bf16_checkpoint(tmp_path_factory):
    d, toks, ref = _save(tmp_path_factory, "llama", dtype=torch.bfloat16, seed=7)
    jcfg, jparams = JC.load_llama_from_hf(d)
    tcfg, tparams = TC.load_llama_from_hf(d, device="cpu")
    _same_tree(jparams, tparams, tcfg)
    cfg = dataclasses.replace(tcfg, quant="none", dtype=torch.float32)
    _, params = TC.load_llama_from_hf(d, cfg=cfg, device="cpu")
    logits, _ = TM.llama_forward(params, cfg, toks)
    rel = np.linalg.norm(logits.numpy() - ref) / np.linalg.norm(ref)
    assert rel < 5e-2, rel


def test_loaders_run_on_the_card_unless_given_cpu(checkpoints, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for family in ("llama", "gptj", "mixtral", "bloom"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _loaders(family)[1](checkpoints[family][0])
