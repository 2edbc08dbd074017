"""The port's speculative decoding (engine/speculative.py) against its own
target-only greedy decode and against the JAX package.

The target is the tiny config with head_dim = 128 (its kernels' plain
versions here): the draft's single-token steps attend on kernel H's, the
verify step (gamma + 1 rows) and the draft's two-token ingest through the
dequantize-then-attend route. Greedy speculative tokens equal the target's
own greedy tokens until a step where the target's top-2 logit gap is within
5% of its largest logit (the verify step rounds unlike a decode step); the
host loop and the loop variant give equal tokens on the CPU. Against the
JAX package's loop variant, the same rule. The numpy acceptance rule is the
JAX package's, bit for bit; the torch one is checked statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu.engine.speculative import _accept_and_correct as j_accept
from bitsandbytes_sycl_tpu.engine.speculative import speculative_generate_jit as j_spec_jit
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu_torch.convert import lora_from_jax, params_from_jax
from bitsandbytes_sycl_tpu_torch.engine import (
    EngineConfig,
    InferenceEngine,
    speculative_generate,
    speculative_generate_jit,
)
from bitsandbytes_sycl_tpu_torch.engine.speculative import (
    _accept_and_correct,
    _accept_and_correct_torch,
)
from bitsandbytes_sycl_tpu_torch.models import llama as TL

GAP = 5e-2  # of the largest |logit|
SHAPE = dict(hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=128)
RAGGED = [[5, 17, 3], [9, 2, 6, 5, 3, 8, 1], [44], [7, 7, 1, 2, 9]]
UNIFORM = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]]
NEW = 6


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side runs on one thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The target and an unrelated draft (the port's own seeded weights)."""
    tc = TL.LlamaConfig.tiny(**SHAPE)
    return tc, TL.init_params(tc, seed=0, device="cpu"), TL.init_params(tc, seed=99, device="cpu")


@pytest.fixture(scope="module")
def greedy(models):
    """The target's own greedy tokens and logits for UNIFORM and RAGGED."""
    tc, tp, _ = models
    return {name: _greedy(tc, tp, prompts, NEW)
            for name, prompts in (("uniform", UNIFORM), ("ragged", RAGGED))}


def _greedy(tc, tp, prompts, n_new):
    """The target's own greedy tokens (the engine's generate) and, per
    request, the logits each token came from."""
    eng = InferenceEngine(tc, tp, EngineConfig(max_batch=len(prompts), max_new_tokens=n_new,
                                               prefill_buckets=(8,)), device="cpu")
    log = []
    sample = eng._sample
    eng._sample = lambda logits: (log.append(logits.numpy().copy()), sample(logits))[1]
    return eng.generate(prompts), log


def _gap_rule(want, log, got):
    compared = 0
    for r, (a, b) in enumerate(zip(want, got)):
        for i, (ta, tb) in enumerate(zip(a, b)):
            if ta != tb:
                top2 = np.sort(log[i][r])[-2:]
                assert top2[1] - top2[0] <= GAP * np.abs(log[i][r]).max(), (r, i)
                break
            compared += 1
    return compared


def _padded(prompts):
    toks = np.zeros((len(prompts), max(map(len, prompts))), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    return toks, [len(p) for p in prompts]


@pytest.mark.parametrize("draft", ["self", "unrelated"])
def test_greedy_speculative_is_the_targets_greedy(models, greedy, draft):
    tc, tp, td = models
    dp = tp if draft == "self" else td
    want, log = greedy["uniform"]
    host, st_host = speculative_generate(tp, tc, dp, tc, torch.tensor(UNIFORM), NEW, gamma=3)
    loop, st_loop = speculative_generate_jit(tp, tc, dp, tc, torch.tensor(UNIFORM), NEW, gamma=3)
    assert loop.device.type == "cpu" and loop.shape == (2, NEW)
    assert host.tolist() == loop.tolist()  # the two variants on the CPU
    assert _gap_rule(want, log, host.tolist()) >= NEW
    assert st_host["target_calls"] == st_loop["target_calls"] == st_loop["rounds"] + 1
    if draft == "self":
        assert st_loop["accept_rate"] > 0.9 and st_loop["rounds"] <= (NEW - 1 + 3) // 4 + 1
        # ragged prompts, right-padded with per-row cursors (the unrelated
        # draft's: test_engine_generate_speculative)
        want, log = greedy["ragged"]
        toks, lens = _padded(RAGGED)
        out, _ = speculative_generate_jit(tp, tc, dp, tc, torch.from_numpy(toks), NEW, gamma=4,
                                          lengths=torch.tensor(lens))
        assert _gap_rule(want, log, out.tolist()) >= 2 * NEW


def test_loop_variant_matches_jax():
    """One layer and gamma = 2 keep the JAX loop's compile short."""
    jc, tc = (L.LlamaConfig.tiny(**dict(SHAPE, num_layers=1)) for L in (JL, TL))
    jp, jd = JL.init_params(jc, jax.random.PRNGKey(0)), JL.init_params(jc, jax.random.PRNGKey(99))
    tp, td = (params_from_jax(jax.tree.map(np.asarray, p), tc, device="cpu") for p in (jp, jd))
    toks, lens = _padded(RAGGED)
    want, _ = j_spec_jit(jp, jc, jd, jc, jnp.asarray(toks, jnp.int32), NEW, gamma=2,
                         lengths=jnp.asarray(lens, jnp.int32))
    got, _ = speculative_generate_jit(tp, tc, td, tc, torch.from_numpy(toks), NEW, gamma=2,
                                      lengths=torch.tensor(lens))
    _, log = _greedy(tc, tp, RAGGED, NEW)
    assert _gap_rule(np.asarray(want).tolist(), log, got.tolist()) >= 2 * NEW


def test_need_checks(models):
    tc, tp, td = models
    prompts = torch.ones((1, 100), dtype=torch.long)
    # host loop: T + max_new_tokens + gamma + 1; loop variant: + 2
    speculative_generate(tp, tc, tp, tc, prompts[:, :95], 28, gamma=4)
    with pytest.raises(ValueError, match="required 129"):
        speculative_generate(tp, tc, tp, tc, prompts[:, :96], 28, gamma=4)
    with pytest.raises(ValueError, match="required 129"):
        speculative_generate_jit(tp, tc, tp, tc, prompts[:, :95], 28, gamma=4)


def test_numpy_acceptance_is_the_jax_packages():
    rng = np.random.default_rng(4)
    B, g, V = 6, 3, 7
    q = rng.dirichlet(np.ones(V), size=(B, g))
    p = rng.dirichlet(np.ones(V), size=(B, g + 1))
    d = rng.integers(0, V, (B, g))
    for seed in range(3):
        want = j_accept(d, q, p, np.random.default_rng(seed))
        got = _accept_and_correct(d, q, p, np.random.default_rng(seed))
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_torch_acceptance_preserves_the_target_distribution():
    """A gamma = 1 round (d ~ q, accepted with p/q, else corrected from
    norm(relu(p - q))) emits tokens distributed as p."""
    rng = np.random.default_rng(0)
    V, N = 8, 200_000
    q = torch.from_numpy(rng.dirichlet(np.ones(V))).float()
    p = torch.from_numpy(rng.dirichlet(np.ones(V))).float()
    gen = torch.Generator().manual_seed(0)
    d = torch.multinomial(q, N, replacement=True, generator=gen)
    acc, fix = _accept_and_correct_torch(d[:, None], q.expand(N, 1, V), p.expand(N, 2, V), gen)
    emitted = torch.where(acc == 1, d, fix)
    emp = torch.bincount(emitted, minlength=V).double().numpy() / N
    # the multinomial's std is ~sqrt(p/N) ~ 1e-3: allow 5 of them
    assert np.abs(emp - p.double().numpy()).max() < 5 * np.sqrt(float(p.max()) / N) + 1e-3


def test_sampling_mode_runs(models):
    tc, tp, td = models
    prompts = torch.tensor([[1, 2, 3, 4]])
    out, st = speculative_generate(tp, tc, tp, tc, prompts, NEW, gamma=3, temperature=0.8,
                                   seed=1)
    assert out.shape == (1, NEW) and ((0 <= out) & (out < 256)).all()
    assert 0.5 < st["accept_rate"] <= 1.0  # a self-draft accepts most proposals
    toks, lens = _padded(RAGGED)
    out, st = speculative_generate_jit(tp, tc, td, tc, torch.from_numpy(toks), NEW, gamma=3,
                                       temperature=0.8, seed=1, lengths=torch.tensor(lens))
    again, _ = speculative_generate_jit(tp, tc, td, tc, torch.from_numpy(toks), NEW, gamma=3,
                                        temperature=0.8, seed=1, lengths=torch.tensor(lens))
    assert out.shape == (4, NEW) and ((0 <= out) & (out < 256)).all()
    assert torch.equal(out, again)  # one seed, one stream
    assert 0.0 <= st["accept_rate"] <= 1.0


def test_engine_generate_speculative(models, greedy):
    tc, tp, td = models
    eng = InferenceEngine(tc, tp, EngineConfig(max_batch=4, max_new_tokens=NEW,
                                               prefill_buckets=(8,)), device="cpu")
    out = eng.generate_speculative(RAGGED, NEW, td, tc, gamma=4)
    want, log = greedy["ragged"]
    assert _gap_rule(want, log, out) >= 2 * NEW
    assert eng.last_speculative_stats["target_calls"] >= 2
    assert not eng.active.any()  # the slot pool is left alone
    # EOS truncation (with the self-draft, a few rounds): the EOS token is
    # kept, nothing after it
    out = eng.generate_speculative(RAGGED, NEW, tp, tc, gamma=4)
    eos = out[1][2]
    e2 = InferenceEngine(tc, tp, EngineConfig(max_batch=4, max_new_tokens=NEW, eos_token=eos),
                         device="cpu")
    trunc = e2.generate_speculative(RAGGED, NEW, tp, tc, gamma=4)
    for full, cut in zip(out, trunc):
        assert cut == (full[: full.index(eos) + 1] if eos in full else full)
    with pytest.raises(ValueError, match="non-empty"):
        eng.generate_speculative([[1], []], NEW, td, tc)
    # an engine serving adapters refuses: the draft loop would serve the base model
    one = [{t: {"A": np.zeros((1, 2, 256), np.float32), "B": np.zeros((1, 256, 2), np.float32),
                "scale": np.ones((1,), np.float32)} for t in ("q_proj",)} for _ in range(2)]
    e3 = InferenceEngine(tc, tp, EngineConfig(max_batch=4), device="cpu",
                         lora=lora_from_jax(one, device="cpu"))
    with pytest.raises(NotImplementedError, match="lora"):
        e3.generate_speculative(RAGGED, NEW, td, tc)
