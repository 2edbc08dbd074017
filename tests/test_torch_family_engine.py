"""The port's engine serving other families through ``forward_fn`` against
the JAX engine on the CPU: GPT-J, Falcon (one kv head, head_dim 64), OPT,
BLOOM (ALiBi) and Mixtral (MoE), each served contiguous and paged by the
port; adapters through ``forward_fn`` on GPT-J and OPT; speculative
decoding on GPT-J; the paged gather route where kernel D's JAX counterpart
declines head_dim 64.

One JAX engine per family (contiguous; its model calls run eagerly, no jit,
and log their logits), serving stacked adapters on GPT-J and OPT, whose
adapter 0 is zero (B = 0) and so the base model. Tolerances are
test_torch_engine_serving.py's: the first tokens' logits within 5% of the
largest and 4% relative L2; greedy tokens equal until a step where the
port's top-2 logit gap is within 5% of its largest logit (paged and
contiguous run different kernels' plain versions, and speculative decoding
verifies through the prefill route, so a near tie may part them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu import models as JM
from bitsandbytes_sycl_tpu.engine import EngineConfig as JEngineConfig
from bitsandbytes_sycl_tpu.engine import InferenceEngine as JEngine
from bitsandbytes_sycl_tpu_torch import models as TM
from bitsandbytes_sycl_tpu_torch.convert import lora_from_jax, params_from_jax
from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
from bitsandbytes_sycl_tpu_torch.models import llama as TL
from bitsandbytes_sycl_tpu_torch.ops import paged_attention

LOGIT_TOL = 5e-2
LOGIT_REL_L2 = 4e-2
STEPS = 4
# 2 prompts padded to 8 tokens: the shapes of test_torch_families.py's
# forwards, whose compiled JAX ops the persistent compile cache then shares
ECFG = dict(max_batch=2, max_new_tokens=STEPS, prefill_buckets=(8,))
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3, 2]]
ADAPTERS = 3
# family -> (config, JAX init, forward, cache maker, adapter targets)
FAMILIES = {
    "gptj": ("GPTJConfig", "gptj.init_gptj_params", "gptj_forward", "gptj.init_gptj_kv_cache",
             ("q_proj", "k_proj", "v_proj", "out_proj", "fc_in", "fc_out")),
    "falcon": ("FalconConfig", "gptj.init_gptj_params", "falcon_forward",
               "gptj.init_gptj_kv_cache", ()),
    "opt": ("OPTConfig", "opt.init_opt_params", "opt_forward", "opt.init_opt_kv_cache",
            ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")),
    "bloom": ("BloomConfig", "opt.init_opt_params", "bloom_forward", "opt.init_opt_kv_cache", ()),
    "mixtral": ("MixtralConfig", "llama.init_params", "mixtral_forward", "llama.init_kv_cache",
                ()),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attr(mod, path):
    for part in path.split("."):
        mod = getattr(mod, part)
    return mod


def _adapters(shapes, targets, num_layers, rank=4, seed=5):
    """A stack_lora tree in numpy: adapter 0 zero (B = 0), the others seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_layers):
        layer = {}
        for t in targets:
            N, K = shapes[t]
            B = rng.normal(size=(ADAPTERS, N, rank)).astype(np.float32) * 0.05
            B[0] = 0.0
            A = rng.normal(size=(ADAPTERS, rank, K)) / np.sqrt(rank)
            layer[t] = {"A": A.astype(np.float32), "B": B,
                        "scale": np.full((ADAPTERS,), 16.0 / rank, np.float32)}
        out.append(layer)
    return out


def _target_shapes(jp):
    layer = jp["layers"][0]
    return {k: tuple(v.shape) for k, v in layer.items() if hasattr(v, "packed")}


def _jax_engine(jc, jp, fwd, init_cache, lora, log):
    """The JAX engine with its prefill and decode as eager calls of the
    same forward that also log their logits."""
    je = JEngine(jc, jp, JEngineConfig(**ECFG), forward_fn=fwd, init_cache_fn=init_cache,
                 lora=lora)

    def call(params, tokens, cache, positions, ids):
        if lora is None:
            return fwd(params, jc, tokens, cache, positions)
        return fwd(params, jc, tokens, cache, positions, lora=lora, lora_ids=ids)

    def prefill(params, tokens, true_len, key, ids):
        K, T = tokens.shape
        pos = jnp.broadcast_to(jnp.arange(T), (K, T))
        logits, cacheK = call(params, tokens, init_cache(jc, K), pos, ids)
        last = jnp.take_along_axis(logits, (true_len - 1).reshape(K, 1, 1), axis=1)[:, 0]
        log.append(np.asarray(last))
        return jnp.argmax(last, -1).astype(jnp.int32), cacheK

    def decode(params, cache, tokens, positions, key, ids):
        logits, cache = call(params, tokens, cache, positions, ids)
        log.append(np.asarray(logits[:, 0]))
        return jnp.argmax(logits[:, 0], -1).astype(jnp.int32), cache

    je._prefill, je._decode = prefill, decode
    return je


@pytest.fixture(scope="module")
def served():
    """Per family, built once: the configs, params, adapters, the JAX
    engine's greedy tokens and logits per adapter-id pair."""
    memo = {}

    def get(name):
        if name in memo:
            return memo[name]
        cls, init, fwd, cache, targets = FAMILIES[name]
        jc, tc = getattr(JM, cls).tiny(), getattr(TM, cls).tiny()
        jp = _attr(JM, init)(jc, jax.random.PRNGKey(7))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
        lora_np = _adapters(_target_shapes(jp), targets, jc.num_layers) if targets else None
        jlora = None if lora_np is None else jax.tree.map(jnp.asarray, lora_np)
        log = []
        je = _jax_engine(jc, jp, getattr(JM, fwd), _attr(JM, cache), jlora, log)
        runs = {}

        def run(ids):
            if ids not in runs:
                del log[:]
                kw = {} if jlora is None else dict(adapter_ids=list(ids))
                runs[ids] = (je.generate(PROMPTS, **kw), [a.copy() for a in log])
            return runs[ids]

        memo[name] = dict(jc=jc, tc=tc, tp=tp, lora_np=lora_np, run=run,
                          fwd=getattr(TM, fwd), cache=_attr(TM, cache))
        return memo[name]

    return get


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale, (np.abs(got - want).max(), scale)
    assert np.linalg.norm(got - want) <= LOGIT_REL_L2 * np.linalg.norm(want)


def _recording(eng):
    log = []
    sample = eng._sample
    eng._sample = lambda logits: (log.append(logits.numpy().copy()), sample(logits))[1]
    return log


def _gap_rule(want, got, log):
    """Tokens equal until a step where the port's top-2 logit gap is within
    LOGIT_TOL of its largest logit; returns the tokens compared."""
    compared = 0
    for r, (a, b) in enumerate(zip(want, got)):
        assert len(a) == len(b)
        for i, (ta, tb) in enumerate(zip(a, b)):
            if ta != tb:
                lg = log[i][r]
                top2 = np.sort(lg)[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(lg).max(), (r, i)
                break
            compared += 1
    return compared


def _port_engine(s, paged, lora=False):
    return InferenceEngine(
        s["tc"], s["tp"], EngineConfig(**ECFG, paged=paged), device="cpu", forward_fn=s["fwd"],
        init_cache_fn=s["cache"],
        lora=lora_from_jax(s["lora_np"], device="cpu") if lora else None)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_engine_matches_jax(served, name, paged):
    """Greedy generation through forward_fn against the JAX engine; paged,
    a head_dim of 64 (Falcon, OPT, BLOOM, Mixtral's tiny configs) takes the
    gather route and 128 (GPT-J) kernel D, chosen by shape and counted."""
    s = served(name)
    want, jlog = s["run"]((0, 0))
    te = _port_engine(s, paged)
    log = _recording(te)
    d0 = TL.write_and_attend.paged_dequant_calls
    got = te.generate(PROMPTS)
    _close_logits(log[0], jlog[0])
    assert _gap_rule(want, got, log) >= STEPS
    steps = len(log) - 1  # decode steps
    gather = TL.write_and_attend.paged_dequant_calls - d0
    takes = paged_attention.paged_attention_ok(1, s["tc"].hd, s["tc"].num_heads,
                                               s["tc"].num_kv_heads, 128, 128)
    assert takes == (s["tc"].hd % 128 == 0)
    assert gather == (steps * s["tc"].num_layers if paged and not takes else 0)


@pytest.mark.parametrize("name", ["gptj", "opt"])
def test_family_lora_matches_jax(served, name):
    """Stacked adapters through forward_fn: requests on adapters 1 and 2
    against the JAX engine's, and the adapters change the tokens."""
    s = served(name)
    want, jlog = s["run"]((1, 2))
    te = _port_engine(s, paged=False, lora=True)
    log = _recording(te)
    got = te.generate(PROMPTS, adapter_ids=[1, 2])
    _close_logits(log[0], jlog[0])
    assert _gap_rule(want, got, log) >= STEPS
    assert got != s["run"]((0, 0))[0]


def test_forward_fn_without_adapter_kwargs_refuses_lora(served):
    s = served("gptj")

    def bare(params, cfg, tokens, cache, positions):
        return s["fwd"](params, cfg, tokens, cache, positions)

    with pytest.raises(NotImplementedError, match="lora"):
        InferenceEngine(s["tc"], s["tp"], EngineConfig(**ECFG), device="cpu", forward_fn=bare,
                        lora=lora_from_jax(s["lora_np"], device="cpu"))


def test_speculative_gptj_through_forward_fn(served):
    """generate_speculative with the engine's forward_fn as target and draft
    (the same GPT-J): the JAX engine's greedy tokens under the gap rule."""
    s = served("gptj")
    want, _ = s["run"]((0, 0))
    te = _port_engine(s, paged=False)
    log = _recording(te)
    greedy = te.generate(PROMPTS)
    out = te.generate_speculative(PROMPTS, STEPS, s["tp"], s["tc"], gamma=2)
    assert _gap_rule(want, out, log) >= STEPS
    assert _gap_rule(greedy, out, log) >= STEPS
    assert te.last_speculative_stats is not None
