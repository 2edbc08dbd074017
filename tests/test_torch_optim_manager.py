"""The port's GlobalOptimManager and AnalysisAdam on the CPU.

- ``GlobalOptimManager.build`` routes an "embedding" leaf to 32-bit states
  and a dense leaf to 8-bit ones (the JAX package's
  tests/test_optim.py::test_global_optim_manager_overrides), from a dict
  tree or an nn.Module, and three steps leave every parameter and state
  bit for bit where two separately built optimizers (one per
  configuration) leave them; its 8-bit groups step in one grouped update
  per configuration.
- ``analysis_adam`` over 3 steps against the JAX package's in its three
  modes: parameters within f32 tolerance, ``abserr`` and ``relerr`` within
  1e-5 relative, ``counts`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bitsandbytes_sycl_tpu import optim as jopt
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch import optim as topt


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"emb": {"embedding": torch.tensor(rng.normal(size=(128, 64)).astype(np.float32))},
            "dense": {"w": torch.tensor(rng.normal(size=(128, 64)).astype(np.float32))}}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return [torch.tensor((rng.normal(size=(128, 64)) * 0.01).astype(np.float32)) for _ in range(2)]


def test_manager_routes_overrides_like_two_optimizers():
    mgr = topt.GlobalOptimManager()
    mgr.register_module_override("embedding", optim_bits=32)
    tree = _tree()
    opt = mgr.build("adam", tree, optim_bits=8, min_8bit_size=64, learning_rate=1e-3)
    emb, dense = tree["emb"]["embedding"], tree["dense"]["w"]
    # two optimizers over copies, one per configuration
    e2, d2 = emb.clone(), dense.clone()
    o32 = topt.adam([e2], 1e-3, optim_bits=32, min_8bit_size=64)
    o8 = topt.adam([d2], 1e-3, optim_bits=8, min_8bit_size=64)
    for step in range(3):
        ge, gd = _grads(step)
        emb.grad, dense.grad, e2.grad, d2.grad = ge, gd, ge.clone(), gd.clone()
        opt.step()
        o32.step()
        o8.step()
    assert opt.state[emb]["state1"].dtype == torch.float32
    assert opt.state[dense]["state1"].dtype == torch.uint8
    for a, b, sa, sb in ((emb, e2, opt.state[emb], o32.state[e2]),
                         (dense, d2, opt.state[dense], o8.state[d2])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert opt.route_leaves == {"grouped": 3, "batched": 3, "per_leaf": 0}


def test_manager_builds_from_a_module_and_a_predicate():
    """nn.Module paths (named_parameters, "/" for "."); a predicate
    override; the last matching override wins; get_instance is one
    manager."""
    assert topt.GlobalOptimManager.get_instance() is topt.GlobalOptimManager.get_instance()
    mgr = topt.GlobalOptimManager()
    model = torch.nn.Sequential(torch.nn.Embedding(128, 64), torch.nn.Linear(64, 128))
    mgr.register_module_override(lambda path: path.startswith("1/"), optim_bits=32)
    mgr.override_config("1/bias", optim_bits=8, min_8bit_size=1, learning_rate=5e-4)
    opt = mgr.build("adam", model, optim_bits=8, min_8bit_size=64)
    groups = {id(p): g for g in opt.param_groups for p in g["params"]}
    emb, w, b = model[0].weight, model[1].weight, model[1].bias
    assert groups[id(emb)]["optim_bits"] == 8 and groups[id(w)]["optim_bits"] == 32
    assert groups[id(b)]["optim_bits"] == 8 and groups[id(b)]["lr"] == 5e-4
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.01)
    opt.step()
    dtypes = [opt.state[p]["state1"].dtype for p in (emb, w, b)]
    assert dtypes == [torch.uint8, torch.float32, torch.uint8]


def test_grouped_step_splits_by_group_configuration(monkeypatch):
    """8-bit groups of one configuration share one grouped update (their lr
    as scalar rows); a group that differs in another setting (stochastic
    rounding) takes its own."""
    calls = []
    real = TF.optimizer_update_8bit_grouped
    monkeypatch.setattr(TF, "optimizer_update_8bit_grouped",
                        lambda name, items, *a, **k: (calls.append(len(items)),
                                                      real(name, items, *a, **k))[1])
    ps = [torch.zeros((4096,)) for _ in range(3)]
    opt = topt.adam([{"params": [ps[0]]}, {"params": [ps[1]], "lr": 5e-4},
                     {"params": [ps[2]], "stochastic_rounding": True}], 1e-3, optim_bits=8)
    for p in ps:
        p.grad = torch.full_like(p, 0.01)
    opt.step()
    assert sorted(calls) == [1, 2]


@pytest.mark.parametrize("analysis", ["dynamic-blockwise", "linear", "quantile"])
def test_analysis_adam_matches_jax(analysis):
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4096,)).astype(np.float32)
    jp = {"w": jnp.asarray(w0)}
    jtx = jopt.analysis_adam(1e-3, analysis=analysis)
    st = jtx.init(jp)
    tw = torch.tensor(w0)
    topt_ = topt.analysis_adam([tw], 1e-3, analysis=analysis)
    for _ in range(3):
        g = np.sin(np.asarray(jp["w"]))  # one gradient for both (sin differs in the last bit)
        up, st = jtx.update({"w": jnp.asarray(g)}, st, jp)
        jp = optax.apply_updates(jp, up)
        tw.grad = torch.tensor(g)
        topt_.step()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-6)
    js, ts = st.inner["w"], topt_.state[tw]
    assert int(ts["counts"]) == int(js["counts"]) == 3 * 4096
    for k in ("abserr", "relerr"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-5)
    view = topt_.analysis_state()
    assert view.count == 3 and view.inner[0]["counts"] is ts["counts"]
    assert jax.tree.structure(js) == jax.tree.structure({k: 0 for k in ts})
