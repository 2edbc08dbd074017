"""The grouped route of the port's 8-bit optimizers on the CPU: one leaf table
per step (kernels J and K; here their plain version, ``_grouped_plain``),
the batched 32-bit update and the launch plan ``leaf_plan``.

Every comparison is bit for bit (f32 compared as int32 bits): the grouped
route must leave p, the codes, the absmax and the 32-bit states exactly
where the per-leaf route (``BnbOptimizer._step_leaf`` for every leaf) puts
them, and the leaf-table plain version exactly where the JAX entry's rows
version (``_kernel2_plain`` / ``_kernel1_plain`` on padded rows) puts a
leaf. Inputs are numpy arrays from a seed.
"""

import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu_torch import codebooks as TC
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch import optim as topt
from bitsandbytes_sycl_tpu_torch.ops import dynamic8 as TD
from bitsandbytes_sycl_tpu_torch.ops import optim8 as O

NAMES = ["adam", "momentum", "rmsprop", "adagrad", "lion"]
CTORS = {"adam": "adamw", "lamb": "lamb", "momentum": "sgd", "rmsprop": "rmsprop",
         "adagrad": "adagrad", "lion": "lion"}
# two 2048-multiple leaves, the ragged 47 x 97 leaf, one at the 8-bit boundary,
# one just under it (32-bit) and three scalars
SHAPES = {"w1": (8, 1024), "w2": (6144,), "rag": (47, 97), "b": (64, 64), "c": (4095,),
          "s1": (), "s2": (), "s3": ()}
GROUPS = (("w1", "rag", "c", "s1"), ("w2", "b", "s2", "s3"))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bits_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), (what, int((_bits(a) != _bits(b)).sum()))


def _make(name, seed=0, **kw):
    """The leaf mix in two param groups (lr and lr / 2) as two optimizers
    over equal copies."""
    rng = np.random.default_rng(seed)
    init = {k: (rng.normal(size=s) * 0.05).astype(np.float32) for k, s in SHAPES.items()}
    opts = []
    for _ in range(2):
        params = {k: torch.tensor(v) for k, v in init.items()}
        groups = [{"params": [params[k] for k in GROUPS[0]]},
                  {"params": [params[k] for k in GROUPS[1]], "lr": 5e-4}]
        ctor = getattr(topt, CTORS[name] + "8bit")
        extra = {"max_unorm": 0.0} if name == "lamb" else {}
        opts.append((params, ctor(groups, 1e-3, weight_decay=0.01, **extra, **kw)))
    return opts


def _per_leaf_step(opt):
    """One step with every leaf on the per-leaf route."""
    opt.count += 1
    for group in opt.param_groups:
        beta1, beta2 = group["betas"]
        for p in group["params"]:
            if p.grad is None:
                continue
            s = opt.state[p]
            if not s:
                s.update(opt.init_state(p))
            opt._step_leaf(p, p.grad, s, opt.count, group["lr"], beta1, beta2, group["eps"],
                           group["weight_decay"])


def _run_both(name, steps=3, **kw):
    (pg, og), (pl, ol) = _make(name, **kw)
    rng = np.random.default_rng(1)
    for step in range(steps):
        for k, s in SHAPES.items():
            g = (rng.normal(size=s) * 0.01).astype(np.float32)
            if k == "rag" and step == 1:
                g.reshape(-1)[5] = np.nan  # a non-finite entry keeps p and the states
            pg[k].grad, pl[k].grad = torch.tensor(g), torch.tensor(g)
        og.step()
        _per_leaf_step(ol)
    return (pg, og), (pl, ol)


def _compare(pg, og, pl, ol):
    for k in SHAPES:
        _assert_bits_equal(pg[k], pl[k], f"p {k}")
        sg, sl = og.state[pg[k]], ol.state[pl[k]]
        assert set(sg) == set(sl)
        for name in sg:
            _assert_bits_equal(sg[name], sl[name], f"{name} of {k}")


@pytest.mark.parametrize("clip", [100, 5], ids=["noclip", "clip5"])
@pytest.mark.parametrize("name", NAMES + ["lamb"])
def test_grouped_route_equals_per_leaf_route(name, clip):
    """3 steps over the leaf mix in two param groups (different lr), with
    and without percentile clipping: p, codes, absmax, 32-bit states and
    the clipping history bit for bit."""
    (pg, og), (pl, ol) = _run_both(name, percentile_clipping=clip)
    routes = {k: og._route(pg[k], og.state[pg[k]]) for k in SHAPES}
    assert routes["w1"] == routes["rag"] == routes["b"] == "grouped"
    assert routes["c"] == routes["s1"] == ("batched" if clip == 100 else "per_leaf")
    # 3 steps of 4 leaves on the grouped route and 4 on the 32-bit one
    small = {"batched": 12, "per_leaf": 0} if clip == 100 else {"batched": 0, "per_leaf": 12}
    assert og.route_leaves == {"grouped": 12, **small}
    assert og.state[pg["rag"]]["state1"].dtype == torch.uint8
    _compare(pg, og, pl, ol)


@pytest.mark.parametrize("name", NAMES)
def test_grouped_route_stochastic_rounding(name):
    """Stochastic rounding rides the leaf table (each leaf's uniforms, those
    of the per-leaf route): bit for bit, and the noise moved codes."""
    (pg, og), (pl, ol) = _run_both(name, stochastic_rounding=True)
    _compare(pg, og, pl, ol)
    (pd, od), _ = _run_both(name)
    assert not torch.equal(od.state[pd["w1"]]["state1"], og.state[pg["w1"]]["state1"])


def test_grouped_route_updates_in_place():
    (pg, og), _ = _make("adam")
    for k, s in SHAPES.items():
        pg[k].grad = torch.full(s, 0.01)
    og.step()
    held = {k: dict(og.state[pg[k]]) for k in ("w1", "rag")}
    ptrs = {k: pg[k].data_ptr() for k in SHAPES}
    og.step()
    for k, st in held.items():
        for name, t in st.items():
            assert og.state[pg[k]][name] is t  # written in place, not replaced
    assert all(pg[k].data_ptr() == ptrs[k] for k in SHAPES)


def test_routes():
    """lamb8bit and lars8bit (max_unorm) stay per leaf; views, bf16 and
    non-contiguous leaves too; percentile clipping sends 32-bit leaves per
    leaf."""
    base = torch.zeros(64, 128)
    leaves = {"a": torch.zeros(64, 128), "view": base[:32], "bf16": torch.zeros(4096).bfloat16(),
              "t": torch.zeros(128, 64).t(), "small": torch.zeros(10)}
    for t in leaves.values():
        t.grad = torch.ones_like(t)
    want = {"a": "grouped", "view": "per_leaf", "bf16": "per_leaf", "t": "per_leaf",
            "small": "batched"}
    for ctor, kw, expect in (
        (topt.adam8bit, {}, want),
        (topt.adam8bit, {"percentile_clipping": 5}, {**want, "small": "per_leaf"}),
        (topt.lamb8bit, {}, dict.fromkeys(want, "per_leaf")),
        (topt.lars8bit, {}, dict.fromkeys(want, "per_leaf")),
    ):
        opt = ctor(list(leaves.values()), 1e-3, **kw)
        for k, t in leaves.items():
            assert opt._route(t, opt.init_state(t)) == expect[k], (ctor, kw, k)
    # the per-leaf leaves still step (and match their own route)
    opt = topt.adam8bit(list(leaves.values()), 1e-3)
    opt.step()
    assert opt.route_leaves == {"grouped": 1, "batched": 1, "per_leaf": 3}
    assert float(leaves["view"].abs().max()) > 0 and float(leaves["t"].float().abs().max()) > 0


# ------------------------------------------------ the leaf-table plain body


def _table(name, sizes, seed, nonfinite_absmax=False):
    rng = np.random.default_rng(seed)
    two = name in O.TWO_STATE
    leaves = []
    for n in sizes:
        nb = -(-n // 2048)
        g = (rng.normal(size=n) * 0.01).astype(np.float32)
        g[:2] = [np.inf, np.nan][: min(2, n)]
        lo = 127 if name in ("rmsprop", "adagrad") else 0
        s1 = rng.integers(lo, 256, n).astype(np.uint8)
        am1 = (rng.uniform(size=nb) * 1e-3).astype(np.float32)
        s2 = rng.integers(0, 256, n).astype(np.uint8) if two else None
        am2 = (rng.uniform(size=nb) * 1e-5).astype(np.float32) if two else None
        if nonfinite_absmax and n % 2048:
            am1[-1] = np.nan if len(leaves) % 2 else np.inf  # the ragged block's padding x absmax
        t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
        leaves.append(O.Optim8Leaf(t(g), t((rng.normal(size=n) * 0.02).astype(np.float32)),
                                   t(s1), t(am1), t(s2), t(am2)))
    return leaves


def _rows_of(leaf, fill):
    n = leaf.p.numel()
    nb = -(-n // 2048)
    flat = [torch.cat([getattr(leaf, a), torch.full((nb * 2048 - n,), f, dtype=getattr(leaf, a).dtype)])
            .reshape(nb, 2048) if getattr(leaf, a) is not None else None for a, f in fill]
    return flat


@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "nan_inf_absmax"])
@pytest.mark.parametrize("name", O.TWO_STATE + O.ONE_STATE)
def test_leaf_table_plain_equals_rows_plain(name, nonfinite):
    """The leaf-table plain version (offsets, per-leaf scalars rows, ragged
    tails read up to n, in-place writes) against the JAX entry's rows
    version on each leaf padded as the dispatcher used to pad it, with
    Python-float scalars: bit for bit, also where a ragged block's absmax
    is NaN or Inf (its padding then decodes to NaN and enters the max)."""
    sizes = [4096, 4559, 1, 2048, 5000]
    leaves = _table(name, sizes, seed=3, nonfinite_absmax=nonfinite)
    rows_sc = [TF._optim8_scalars(name, 0.9, 0.99, 1e-8, 3, lr, 0.01, 1.0, "cpu")
               for lr in (1e-3, 5e-4)]
    rows = [i % 2 for i in range(len(leaves))]
    want = []
    for lf, r in zip(leaves, rows):
        g, p, s1, s2 = _rows_of(lf, (("g", 0.0), ("p", 0.0), ("state1", 127), ("state2", 0)))
        want.append(O.optim8_blockwise_fused(name, g, p, s1, lf.absmax1, s2, lf.absmax2,
                                             rows_sc[r]))
    p0 = [lf.p.clone() for lf in leaves]
    O.optim8_update(name, leaves, torch.stack(rows_sc), rows)
    for lf, w, n in zip(leaves, want, sizes):
        _assert_bits_equal(lf.p, w[0].reshape(-1)[:n], "p")
        _assert_bits_equal(lf.state1, w[1].reshape(-1)[:n], "state1")
        _assert_bits_equal(lf.absmax1, w[2], "absmax1")
        if lf.state2 is not None:
            _assert_bits_equal(lf.state2, w[3].reshape(-1)[:n], "state2")
            _assert_bits_equal(lf.absmax2, w[4], "absmax2")
    if nonfinite:
        assert torch.isnan(leaves[1].absmax1[-1]) or torch.isnan(leaves[4].absmax1[-1])
    # apply_delta: p + (new_p - p) from the same start
    again = _table(name, sizes, seed=3, nonfinite_absmax=nonfinite)
    O.optim8_update(name, again, torch.stack(rows_sc), rows, apply_delta=True)
    for lf, q0, w, n in zip(again, p0, want, sizes):
        _assert_bits_equal(lf.p, q0 + (w[0].reshape(-1)[:n] - q0), "p + (new_p - p)")


def test_single_leaf_api_runs_the_table():
    """optimizer_update_8bit_blockwise (one-leaf table over copies) leaves
    its inputs alone and equals the rows version of the padded leaf."""
    lf = _table("adam", [4559], seed=5)[0]
    keep = [t.clone() for t in lf if t is not None]
    out = TF.optimizer_update_8bit_blockwise("adam", lf.g.reshape(47, 97), lf.p.reshape(47, 97),
                                             lf.state1.reshape(47, 97), lf.absmax1,
                                             lf.state2.reshape(47, 97), lf.absmax2, step=3,
                                             weight_decay=0.01)
    for a, b in zip([t for t in lf if t is not None], keep):
        _assert_bits_equal(a, b, "input")
    g, p, s1, s2 = _rows_of(lf, (("g", 0.0), ("p", 0.0), ("state1", 127), ("state2", 0)))
    sc = TF._optim8_scalars("adam", 0.9, 0.999, 1e-8, 3, 1e-3, 0.01, 1.0, "cpu")
    want = O.optim8_blockwise_fused("adam", g, p, s1, lf.absmax1, s2, lf.absmax2, sc)
    for got, w in zip(out, want):
        _assert_bits_equal(got.reshape(-1), w.reshape(-1)[:got.numel()], "output")


def test_leaf_table_rejects():
    leaves = _table("lion", [4096, 100], seed=1)
    sc = TF._optim8_scalars("lion", 0.9, 0.99, 1e-8, 1, 1e-4, 0.0, 1.0, "cpu").reshape(1, 8)
    shared = [leaves[0], leaves[1]._replace(p=leaves[0].p[:100])]  # p overlaps leaf 0's
    with pytest.raises(ValueError, match="share memory"):
        O.optim8_update("lion", shared, sc)
    with pytest.raises(ValueError, match="contiguous"):
        O.optim8_update("lion", [leaves[0]._replace(state1=leaves[0].state1[:10])], sc)
    with pytest.raises(ValueError, match="every leaf or for none"):
        O.optim8_update("lion", [leaves[0]._replace(u=torch.rand(4096)), leaves[1]], sc)
    with pytest.raises(ValueError, match="state2"):
        O.optim8_update("lion", [leaves[0]._replace(state2=leaves[0].state1)], sc)
    with pytest.raises(ValueError, match="scalars row"):
        O.optim8_update("lion", leaves, sc, rows=[0, 1])
    assert O.optim8_1state.launches == 0  # the CPU runs no kernel


def test_launch_count_only_where_the_kernel_launches(monkeypatch):
    """On CUDA tensors the count goes up by one with each launch (two for
    a block past 2048: the two-pass body), and a table of no block (every
    leaf empty) launches nothing and counts nothing; the branch counters
    count the LUT codec's and the two-pass body's launches. The CPU stands
    in for the card: the table's checks report CUDA tensors and the launch
    is recorded instead of run."""
    check, launched = O._check_leaves, []
    monkeypatch.setattr(O, "_check_leaves", lambda *a: check(*a)[:3] + (True,))
    monkeypatch.setattr(O, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(O, "_launch", lambda kname, name, table, scalars, rows, plan, bs, *a:
                        launched.append(kname) or (2 if bs > O.ONE_PASS_MAX else 1))
    for fn in (O.optim8_2state, O.optim8_1state):
        for attr in ("launches", "launches_lut", "launches_two_pass"):
            monkeypatch.setattr(fn, attr, 0)
    sc = TF._optim8_scalars("adam", 0.9, 0.999, 1e-8, 1, 1e-3, 0.0, 1.0, "cpu").reshape(1, 8)
    empty = _table("adam", [0, 0], seed=2)
    O.optim8_update("adam", empty, sc, apply_delta=True)
    assert launched == [] and O.optim8_2state.launches == 0
    O.optim8_update("adam", _table("adam", [4096, 0, 100], seed=2), sc, apply_delta=True)
    assert launched == ["optim8_2state"] and O.optim8_2state.launches == 1
    O.optim8_update("adam", _table("adam", [2048, 2048], seed=2), sc, blocksize=4096,
                    qmaps=(TC.create_linear_map(True), TC.create_linear_map(False)))
    assert O.optim8_2state.launches == 3 and O.optim8_2state.launches_two_pass == 2
    assert O.optim8_2state.launches_lut == 2
    assert O.optim8_1state.launches == 0


# ------------------------------------------------------------- leaf_plan

QLORA = (262144,) * 352 + (704512,) * 96  # the 7B QLoRA step's 448 8-bit leaves


@pytest.mark.parametrize("numels,blocks,first,grid", [
    ((4096, 4559, 1, 2048, 5000), (2, 3, 1, 1, 3), (0, 2, 5, 6, 7), 10),
    ((2048,), (1,), (0,), 1),                        # one leaf of one block
    ((1,), (1,), (0,), 1),                           # a leaf of one element
    ((16777216,), (8192,), (0,), 396),               # one leaf, the grid capped at 3 a SM
    ((0, 3000, 0, 10), (0, 2, 0, 1), (0, 0, 2, 2), 3),  # empty leaves take no block
    ((), (), (), 0),
])
def test_leaf_plan(numels, blocks, first, grid):
    plan = O.leaf_plan(numels, 2048, 132)
    assert plan.blocks == blocks and plan.first == first
    assert plan.total == sum(blocks) and plan.grid == grid


def test_leaf_plan_qlora_table():
    plan = O.leaf_plan(QLORA, 2048, 132)
    assert sum(QLORA) == 159_907_840
    assert plan.total == 352 * 128 + 96 * 344
    assert plan.grid == 132 * O.CTAS_PER_SM
    assert plan.first[352] == 352 * 128 and plan.first[-1] == plan.total - 344
    # the first blocks are the prefix sums: every block belongs to one leaf
    assert all(f + b == nf for f, b, nf in zip(plan.first, plan.blocks, plan.first[1:]))
    small = O.leaf_plan(QLORA[:3], 256, 8)
    assert small.blocks == (1024,) * 3 and small.first == (0, 1024, 2048) and small.grid == 24


@pytest.mark.parametrize("bs", [0, -4096])
def test_leaf_plan_rejects_blocksize(bs):
    """Any blocksize >= 1 is taken (past 2048 by the two-pass body)."""
    with pytest.raises(ValueError, match="blocksize"):
        O.leaf_plan((10,), bs, 132)


# ------------------------------------------------------- the codec table


@pytest.mark.parametrize("signed", [True, False])
def test_edge_count_by_exponent_bits(signed):
    """The kernels' decade search (one binade_table row by the exponent
    field, one compare) counts the edges below a as the 7 compares do: on
    every binade's ends and neighbours, each edge and its neighbours, NaN,
    0, 1 and a strided sweep of [0, 1]."""
    edges = TD._consts(signed)[0]
    lows = (np.arange(1, 128, dtype=np.uint32) << 23).view(np.float32)
    pts = np.concatenate([lows, np.nextafter(lows, np.float32(0)), np.nextafter(lows, np.float32(2)),
                          edges, np.nextafter(edges, np.float32(0)), np.nextafter(edges, np.float32(2)),
                          np.float32([np.nan, 0.0, 1.0, 1e-45]),
                          np.arange(0, 0x3F800001, 4099, dtype=np.uint32).view(np.float32)])
    pts = pts[(pts <= 1.0) | np.isnan(pts)].astype(np.float32)
    want = sum((e < pts).astype(np.int32) for e in edges)
    np.testing.assert_array_equal(TD.edge_count(pts, signed), want)


def test_kernel_table_layout():
    t = TD.kernel_table("cpu").numpy()
    parts = TD.KERNEL_TABLE_PARTS
    assert t.size == parts["words"]
    np.testing.assert_array_equal(t[:512].view(np.uint32), TD.decode_table("cpu").numpy().view(np.uint32))
    for s, sfx in ((True, "s"), (False, "u")):
        bins = t[parts[f"bin_{sfx}"]:][:258].reshape(129, 2)
        np.testing.assert_array_equal(bins[:, 0].view(np.int32), TD.binade_table(s)[:, 0])
        np.testing.assert_array_equal(bins[:, 1], TD.binade_table(s)[:, 1])
        dec = t[parts[f"decade_{sfx}"]:][:14].reshape(7, 2)
        # n / 0.9 rounded once, as the plain encode's tensor division rounds it
        n = torch.tensor([2.0 ** (i if s else i + 1) for i in range(7)])
        np.testing.assert_array_equal(dec[:, 1], (n / torch.tensor(0.9)).numpy())
        assert t[parts[f"top_{sfx}"]] == TD._consts(s)[1]
