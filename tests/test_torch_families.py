"""The port's model families against the JAX package on the CPU: every
family's tiny config (Mistral, Qwen2, Gemma, Gemma-2, Mixtral, GPT-J, Phi,
NeoX, Falcon with one kv head, OPT, GPT-2, BLOOM), the same weights
(``convert.params_from_jax``) and the same seeded tokens through both
packages.

The JAX side runs eagerly (no jit: one call per shape, where a compile
would cost more than the call) and takes its XLA routes on the CPU; the
port attends through its kernels' plain versions where the JAX kernels
take the shapes (head_dim 128) and through the same dequantize-then-attend
routes elsewhere. Tolerances are the engine tests' (test_torch_contiguous.py):
logits within 5% of the largest and 4% relative L2, since the port attends
over f32-dequantized K/V where the JAX CPU route dequantizes to bf16, and
W4A8 requantizes each activation row after that. ``alibi_slopes``, the
stacked experts' bytes and the configs are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu import models as JM
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu_torch import models as TM
from bitsandbytes_sycl_tpu_torch.convert import params_from_jax
from bitsandbytes_sycl_tpu_torch.models import llama as TL

LOGIT_TOL = 5e-2  # of the largest |logit|
LOGIT_REL_L2 = 4e-2
B, T, DECODE_STEPS = 2, 8, 3

# family -> (config class name, init function names in the JAX and port
# packages, forward name); the tiny configs are the JAX package's
FAMILIES = {
    "mistral": ("MistralConfig", "init_params", "mistral_forward"),
    "qwen2": ("Qwen2Config", "init_params", "qwen2_forward"),
    "gemma": ("GemmaConfig", "init_params", "gemma_forward"),
    "gemma2": ("Gemma2Config", "init_params", "gemma2_forward"),
    "mixtral": ("MixtralConfig", "init_params", "mixtral_forward"),
    "gptj": ("GPTJConfig", "init_gptj_params", "gptj_forward"),
    "phi": ("PhiConfig", "init_gptj_params", "phi_forward"),
    "neox": ("NeoXConfig", "init_gptj_params", "neox_forward"),
    "falcon": ("FalconConfig", "init_gptj_params", "falcon_forward"),
    "opt": ("OPTConfig", "init_opt_params", "opt_forward"),
    "gpt2": ("GPT2Config", "init_opt_params", "gpt2_forward"),
    "bloom": ("BloomConfig", "init_opt_params", "bloom_forward"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side runs on one thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale, (np.abs(got - want).max(), scale)
    assert np.linalg.norm(got - want) <= LOGIT_REL_L2 * np.linalg.norm(want)


def _jax_init(name, jc, key):
    cls_name, init_name, _ = FAMILIES[name]
    if init_name == "init_params":
        return JL.init_params(jc, key)
    mod = JM.gptj if init_name == "init_gptj_params" else JM.opt
    return getattr(mod, init_name)(jc, key)


_PARAMS = {}  # family -> (JAX params, port params): the weights do not depend on kw below


def family(name, **kw):
    """(JAX config, port config, JAX params, port params, JAX forward, port
    forward) of a family's tiny config with ``kw`` (options that leave the
    weights alone); with a NeoX layer's second LayerNorm, as its
    checkpoints carry."""
    cls_name, _, fwd_name = FAMILIES[name]
    jc, tc = getattr(JM, cls_name).tiny(**kw), getattr(TM, cls_name).tiny(**kw)
    if name not in _PARAMS:
        _PARAMS[name] = _init_pair(name, jc, tc)
    jp, tp = _PARAMS[name]
    return jc, tc, jp, tp, getattr(JM, fwd_name), getattr(TM, fwd_name)


def _init_pair(name, jc, tc):
    jp = _jax_init(name, jc, jax.random.PRNGKey(11))
    if name == "neox":
        rng = np.random.default_rng(2)
        for layer in jp["layers"]:
            ln2 = 1.0 + 0.1 * rng.normal(size=(jc.hidden_size,))
            layer["ln2_w"] = jnp.asarray(ln2, jnp.float32)
            layer["ln2_b"] = jnp.asarray(0.1 * rng.normal(size=(jc.hidden_size,)), jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _jax_cache(name, jc, batch):
    if FAMILIES[name][1] == "init_opt_params":
        return JM.opt.init_opt_kv_cache(jc, batch)
    return JL.init_kv_cache(jc, batch)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_forward_matches_jax(name):
    """No-cache logits, then a prefill of T tokens and DECODE_STEPS cached
    decode steps on the int8 cache, teacher-forced with the same tokens."""
    jc, tc, jp, tp, jfwd, tfwd = family(name)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab_size, (B, T + DECODE_STEPS)).astype(np.int32)
    want, _ = jfwd(jp, jc, jnp.asarray(toks[:, :T]))
    got, _ = tfwd(tp, tc, torch.from_numpy(toks[:, :T]))
    _close_logits(got.numpy(), want)
    jcache, tcache = _jax_cache(name, jc, B), TL.init_kv_cache(tc, B, device="cpu")
    pos = np.broadcast_to(np.arange(T), (B, T))
    want, jcache = jfwd(jp, jc, jnp.asarray(toks[:, :T]), jcache, jnp.asarray(pos))
    got, tcache = tfwd(tp, tc, torch.from_numpy(toks[:, :T]), tcache,
                       torch.from_numpy(pos.astype(np.int64)))
    _close_logits(got[:, -1].numpy(), want[:, -1])
    for step in range(DECODE_STEPS):
        p = np.full((B, 1), T + step)
        tok = toks[:, T + step:T + step + 1]
        want, jcache = jfwd(jp, jc, jnp.asarray(tok), jcache, jnp.asarray(p))
        got, tcache = tfwd(tp, tc, torch.from_numpy(tok), tcache,
                           torch.from_numpy(p.astype(np.int64)))
        _close_logits(got[:, 0].numpy(), want[:, 0])


@pytest.mark.parametrize("min_tokens", [0, 1], ids=["dense", "dispatch"])
def test_moe_combine_and_dispatch_match_jax(min_tokens):
    """The MoE block alone on 64 tokens: dense combine, and dispatch at
    capacity factor 0.5, where each expert keeps 16 slots and the tokens
    past them drop; the same tokens drop in both packages (JAX
    tests/test_mixtral.py's MoE checks)."""
    kw = dict(moe_dispatch_min_tokens=min_tokens, moe_capacity_factor=0.5)
    jc, tc, jp, tp, _, _ = family("mixtral", **kw)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, 32, jc.hidden_size)).astype(np.float32)
    want = JL._moe_ffn(jnp.asarray(h, jc.dtype), jp["layers"][0], jc, None)
    got = TL._moe_ffn(torch.from_numpy(h).to(tc.dtype), tp["layers"][0], tc)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2 * float(jnp.abs(want.astype(jnp.float32)).max()))
    if min_tokens:  # capacity binds: dispatch differs from the dense combine
        dense = TL._moe_ffn(torch.from_numpy(h).to(tc.dtype), tp["layers"][0],
                            dataclasses.replace(tc, moe_dispatch_min_tokens=0))
        assert not torch.equal(dense, got)


def test_stacked_experts_quantize_bit_for_bit():
    """quantize_params on stacked f32 experts: the codes and scales equal
    the JAX package's byte for byte, and an expert's slice is a view."""
    jc, tc = JM.MixtralConfig.tiny(), TM.MixtralConfig.tiny()
    rng = np.random.default_rng(6)
    E, h, i = jc.num_experts, jc.hidden_size, jc.intermediate_size
    fp = {"embed": rng.normal(size=(jc.vocab_size, h)).astype(np.float32),
          "final_norm": np.ones((h,), np.float32),
          "layers": [{"router": rng.normal(size=(E, h)).astype(np.float32),
                      "experts": {"gate_proj": rng.normal(size=(E, i, h)).astype(np.float32),
                                  "up_proj": rng.normal(size=(E, i, h)).astype(np.float32),
                                  "down_proj": rng.normal(size=(E, h, i)).astype(np.float32)}}]}
    want = JL.quantize_params(jax.tree.map(jnp.asarray, fp), jc)["layers"][0]["experts"]
    got = TL.quantize_params(jax.tree.map(torch.from_numpy, fp), tc)["layers"][0]["experts"]
    for n in ("gate_proj", "up_proj", "down_proj"):
        w, g = want[n], got[n]
        assert g.shape == tuple(w.shape) and g.packed.shape[0] == E
        np.testing.assert_array_equal(g.packed.numpy(), np.asarray(w.packed))
        np.testing.assert_array_equal(g.absmax.float().numpy(), np.asarray(w.absmax, np.float32))
        one = TL._expert_slice(got, 1)[n]
        assert one.packed.data_ptr() == g.packed[1].data_ptr() and one.packed.is_contiguous()


@pytest.mark.parametrize("n", [1, 4, 12, 30, 32, 112])
def test_alibi_slopes_bit_for_bit(n):
    np.testing.assert_array_equal(TL.alibi_slopes(n), JL.alibi_slopes(n))


# literal config.json dicts of public checkpoints (the fields the config makers read)
HF_CONFIGS = {
    "mistral": ("mistral", "_config_from_hf", dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, max_position_embeddings=32768,
        rope_theta=10000.0, rms_norm_eps=1e-5, sliding_window=4096, tie_word_embeddings=False)),
    "qwen2": ("qwen2", "_config_from_hf", dict(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
        num_attention_heads=28, num_key_value_heads=4, max_position_embeddings=131072,
        rope_theta=1000000.0, rms_norm_eps=1e-6, tie_word_embeddings=False)),
    "gemma": ("gemma", "_config_from_hf", dict(
        vocab_size=256000, hidden_size=3072, intermediate_size=24576, num_hidden_layers=28,
        num_attention_heads=16, num_key_value_heads=16, head_dim=256,
        max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-6)),
    "gemma2": ("gemma", "_config_from_hf2", dict(
        vocab_size=256000, hidden_size=3584, intermediate_size=14336, num_hidden_layers=42,
        num_attention_heads=16, num_key_value_heads=8, head_dim=256,
        max_position_embeddings=8192, rms_norm_eps=1e-6, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, query_pre_attn_scalar=256, sliding_window=4096)),
}
# families whose JAX config is built inside the loader: the fields it sets
LOADER_CONFIGS = {
    "mixtral": ("MixtralConfig", dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, max_position_embeddings=32768,
        rope_theta=1000000.0, rms_norm_eps=1e-5, num_local_experts=8, num_experts_per_tok=2),
        lambda h: dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                       num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=4096,
                       rope_theta=1e6, rms_eps=1e-5, num_experts=8, num_experts_per_tok=2,
                       tie_embeddings=False)),
    "phi": ("PhiConfig", dict(
        vocab_size=51200, hidden_size=2560, num_hidden_layers=32, num_attention_heads=32,
        partial_rotary_factor=0.4, max_position_embeddings=2048, layer_norm_eps=1e-5,
        rope_theta=10000.0),
        lambda h: dict(vocab_size=51200, hidden_size=2560, num_layers=32, num_heads=32,
                       rotary_dim=32, max_seq_len=2048, ln_eps=1e-5, rope_theta=10000.0)),
    "neox": ("NeoXConfig", dict(
        vocab_size=50432, hidden_size=4096, num_hidden_layers=32, num_attention_heads=32,
        rotary_pct=0.25, max_position_embeddings=2048, layer_norm_eps=1e-5,
        rotary_emb_base=10000),
        lambda h: dict(vocab_size=50432, hidden_size=4096, num_layers=32, num_heads=32,
                       rotary_dim=32, max_seq_len=2048, ln_eps=1e-5, rope_theta=10000)),
    "falcon": ("FalconConfig", dict(
        vocab_size=65024, hidden_size=4544, num_hidden_layers=32, num_attention_heads=71,
        multi_query=True, parallel_attn=True, bias=False, alibi=False,
        layer_norm_epsilon=1e-5, max_position_embeddings=2048),
        lambda h: dict(vocab_size=65024, hidden_size=4544, num_layers=32, num_heads=71,
                       kv_heads=1, rotary_dim=64, max_seq_len=2048, ln_eps=1e-5,
                       rope_theta=10000.0)),
    "opt": ("OPTConfig", dict(
        vocab_size=50272, hidden_size=4096, num_hidden_layers=32, num_attention_heads=32,
        ffn_dim=16384, word_embed_proj_dim=4096, max_position_embeddings=2048,
        do_layer_norm_before=True, activation_function="relu"),
        lambda h: dict(vocab_size=50272, hidden_size=4096, num_layers=32, num_heads=32,
                       ffn_dim=16384, word_embed_proj_dim=4096, max_seq_len=2048, ln_eps=1e-5)),
    "gpt2": ("GPT2Config", dict(
        vocab_size=50257, n_embd=768, n_layer=12, n_head=12, n_inner=None, n_positions=1024,
        layer_norm_epsilon=1e-5, activation_function="gelu_new"),
        lambda h: dict(vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12,
                       ffn_dim=3072, max_seq_len=1024, ln_eps=1e-5, act="gelu_tanh")),
    "bloom": ("BloomConfig", dict(
        vocab_size=250880, hidden_size=4096, n_layer=30, n_head=32, layer_norm_epsilon=1e-5,
        apply_residual_connection_post_layernorm=False),
        lambda h: dict(vocab_size=250880, hidden_size=4096, num_layers=30, num_heads=32,
                       ln_eps=1e-5)),
}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


@pytest.mark.parametrize("name", list(HF_CONFIGS) + list(LOADER_CONFIGS))
def test_config_from_hf_gives_the_jax_fields(name):
    """_config_from_hf on a literal config.json: the JAX config maker's
    (its own where it has one, else the one its loader builds), field for
    field, of the same family class."""
    if name in HF_CONFIGS:
        mod, fn, hf = HF_CONFIGS[name]
        want = getattr(getattr(JM, mod), fn)(hf)
        got = getattr(getattr(TM, mod), fn)(hf)
        if isinstance(want, tuple):
            (want, _), (got, _) = want, got
    else:
        cls_name, hf, fields = LOADER_CONFIGS[name]
        want = getattr(JM, cls_name)(**fields(hf))
        got = getattr(TM, name)._config_from_hf(hf)
    assert type(got).__name__ == type(want).__name__
    assert _fields(got) == _fields(want)
    # a replaced config keeps its class and the fields given
    again = dataclasses.replace(got, num_layers=2)
    assert type(again) is type(got) and again.num_layers == 2 and again.vocab_size == got.vocab_size


def test_models_export_the_jax_names():
    assert set(JM.__all__) <= set(TM.__all__)
    for n in JM.__all__:
        assert hasattr(TM, n), n
