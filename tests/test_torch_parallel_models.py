"""The port's tensor, expert, pipeline and sequence parallelism on the CPU,
in a gloo world of four processes, against the JAX package's
single-device forwards (and the port's single-device engine).

One world serves the file: a module-scoped fixture starts the four ranks
(``tests/torch_parallel_cases.py``, one thread each, ``init_method=file://``
under the test's temporary directory) and, while they run, builds the same
weights (the port's seeded init, carried to the JAX package leaf for leaf)
and the references. Each check is its own test. The meshes over the four
ranks: {"data": 2, "model": 2} for Llama, LLM.int8 and Mixtral at TP (EP)
= 2, the pipeline (2 stages on "data", TP inside a stage on "model") and
the engine; {"model": 4} for GPT-J, Phi, OPT and BLOOM at TP = 4 and for
ring attention over 4 chunks.

Tolerances are the matching JAX tests' (tests/test_parallel.py,
tests/test_engine.py, tests/test_paged.py): f32 logits within rtol = atol
= 2e-2 of the single device's (5e-2 for LLM.int8, whose row-parallel
shards quantize their own activation slices; a mean relative 5% for W4A8
decode, where they do the same), ring attention within 2e-5 of a plain
causal attention, and the engine's greedy tokens equal to the port's
single-device engine's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as C
from bitsandbytes_sycl_tpu.models import gptj as JG
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu.models import opt as JO
from bitsandbytes_sycl_tpu.models.bloom import BloomConfig as JBloom
from bitsandbytes_sycl_tpu.models.mixtral import MixtralConfig as JMixtral
from bitsandbytes_sycl_tpu.models.phi import PhiConfig as JPhi
from bitsandbytes_sycl_tpu_torch.models import llama as TL

WORLD = 4
TOL = dict(rtol=2e-2, atol=2e-2)


def _jcfg(cls, tcfg):
    """The JAX package's config with the port config's fields (f32)."""
    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    kw["dtype"] = jnp.float32
    return cls(**{k: v for k, v in kw.items() if k in {f.name for f in dataclasses.fields(cls)}})


def _jax_llama_refs(ref):
    B, T = C.B, C.T
    toks = C.tokens(0, t=T + 1).numpy().astype(np.int32)
    pos = np.broadcast_to(np.arange(T), (B, T))
    cfg = C.llama_cfg()
    jc, jp = _jcfg(JL.LlamaConfig, cfg), C.to_jax(TL.init_params(cfg, seed=0, device="cpu"))
    cache = JL.init_kv_cache(jc, B)
    lp, cache = JL.llama_forward(jp, jc, jnp.asarray(toks[:, :T]), cache, jnp.asarray(pos))
    ld, _ = JL.llama_forward(jp, jc, jnp.asarray(toks[:, T:]), cache, jnp.full((B, 1), T))
    ref["llama"] = (np.asarray(lp), np.asarray(ld))
    ref["llama_nocache"] = np.asarray(JL.llama_forward(jp, jc, jnp.asarray(toks[:, :T]))[0])
    c8 = C.llama_cfg(**C.A8_CFG)
    j8 = _jcfg(JL.LlamaConfig, c8)
    ref["llama_a8"] = np.asarray(JL.llama_forward(
        C.to_jax(TL.init_params(c8, seed=6, device="cpu")), j8, jnp.asarray(toks[:, :1]),
        JL.init_kv_cache(j8, B), jnp.zeros((B, 1), jnp.int32))[0])
    ci = C.llama_cfg(**C.INT8_CFG)
    ref["llama_int8"] = np.asarray(JL.llama_forward(
        C.to_jax(TL.init_params(ci, seed=7, device="cpu")), _jcfg(JL.LlamaConfig, ci),
        jnp.asarray(toks[:, :T]))[0])
    cm = C.mixtral_cfg()
    ref["mixtral"] = np.asarray(JL.llama_forward(
        C.to_jax(TL.init_params(cm, seed=2, device="cpu")), _jcfg(JMixtral, cm),
        jnp.asarray(toks[:, :T]))[0])


def _jax_family_refs(ref):
    B, T = C.B, C.FAMILY_T
    toks = C.tokens(2, t=T + 1).numpy().astype(np.int32)
    pos = jnp.asarray(np.broadcast_to(np.arange(T), (B, T)))
    classes = {"gptj": (JG.GPTJConfig, JG.gptj_forward), "phi": (JPhi, JG.gptj_forward),
               "opt": (JO.OPTConfig, JO.opt_forward), "bloom": (JBloom, JO.opt_forward)}
    for name, (tcfg, _, _) in C.family_cfgs().items():
        cls, fwd = classes[name]
        jc, jp = _jcfg(cls, tcfg), C.to_jax(C.family_params(name))
        lp, cache = fwd(jp, jc, jnp.asarray(toks[:, :T]), JL.init_kv_cache(jc, B), pos)
        ref[name] = [np.asarray(lp)]
        if name in C.FAMILY_DECODED:
            ld, _ = fwd(jp, jc, jnp.asarray(toks[:, T:]), cache, jnp.full((B, 1), T))
            ref[name].append(np.asarray(ld))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs on one thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory, _one_thread):
    tmp = tmp_path_factory.mktemp("tp_models")
    procs = C.start_world("models", WORLD, tmp)
    ref = {}
    _jax_llama_refs(ref)
    _jax_family_refs(ref)
    with torch.no_grad():
        cfg = C.engine_cfg()
        ref["engine"] = C.run_engines(cfg, TL.init_params(cfg, seed=0, device="cpu"))
    return C.finish_world(procs, tmp), ref


def _np(t):
    return t.detach().float().numpy()


def _replicated(outs, key, i=None):
    """The output every rank returned: the same bits on each rank."""
    vals = [o[key] if i is None else o[key][i] for o in outs]
    assert all(torch.equal(v, vals[0]) for v in vals[1:]), key
    return _np(vals[0])


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_llama_tp_matches_jax(world, step):
    outs, ref = world
    i = ["prefill", "decode"].index(step)
    np.testing.assert_allclose(_replicated(outs, "llama", i), ref["llama"][i], **TOL)


def test_llama_tp_a8_decode_within_int8_noise_of_jax(world):
    outs, ref = world
    got, want = _replicated(outs, "llama_a8"), ref["llama_a8"]
    assert np.abs(got - want).mean() / (np.abs(want).mean() + 1e-9) < 0.05


def test_llama_tp_int8_matches_jax(world):
    outs, ref = world
    np.testing.assert_allclose(_replicated(outs, "llama_int8"), ref["llama_int8"], rtol=5e-2,
                               atol=5e-2)


def test_mixtral_expert_parallel_matches_jax(world):
    outs, ref = world
    np.testing.assert_allclose(_replicated(outs, "mixtral"), ref["mixtral"], **TOL)


@pytest.mark.parametrize("name, step", [(n, "prefill") for n in ("gptj", "phi", "opt", "bloom")]
                         + [(n, "decode") for n in C.FAMILY_DECODED])
def test_family_tp4_matches_jax(world, name, step):
    outs, ref = world
    i = ["prefill", "decode"].index(step)
    np.testing.assert_allclose(_replicated(outs, name, i), ref[name][i], **TOL)


def test_pipeline_prefill_matches_jax(world):
    outs, ref = world
    np.testing.assert_allclose(_replicated(outs, "pp"), ref["llama_nocache"], **TOL)


@pytest.mark.parametrize("key", ["pp_decode", "pp_decode_tp"])
def test_pipeline_decode_matches_jax_and_its_tokens(world, key):
    outs, ref = world
    for i in range(2):
        got = _replicated(outs, key, i)
        np.testing.assert_allclose(got, ref["llama"][i], **TOL)
        assert (got.argmax(-1) == ref["llama"][i].argmax(-1)).all()


def test_ring_attention_matches_plain_causal_attention(world):
    outs, _ = world
    q, k, v = C.ring_inputs()
    S = q.shape[1]
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool))[None].expand(q.shape[0], S, S)
    want = TL._attention(q, k, v, mask, torch.float32).numpy()
    got = np.concatenate([_np(o["ring"]) for o in outs], axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["contiguous", "paged", "lora", "speculative"])
def test_engine_with_mesh_token_identical(world, mode):
    outs, ref = world
    want = ref["engine"][mode]
    assert all(o["engine"][mode] == want for o in outs), ([o["engine"][mode] for o in outs], want)
    if mode == "lora":
        assert want[0] != want[1]  # the two adapters differ


@pytest.mark.parametrize("key", ["guard_kv4", "guard_w8a8"])
def test_engine_mesh_guards_raise_as_jax(world, key):
    outs, _ = world
    phrase = {"guard_kv4": "kv_bits=4", "guard_w8a8": "w8a8_prefill"}[key]
    for o in outs:
        assert o[key].startswith("NotImplementedError: ")
        assert f"{phrase} does not compose with a TP mesh yet" in o[key], o[key]
