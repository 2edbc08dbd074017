"""The LUT codec of kernels J and K (any 256-entry state table), their
blocks past 2048 (the global-max update, ``block_wise=False``) and the
codebook makers, against the JAX package on the CPU. Inputs are numpy
arrays from a seed, handed to both packages.

Tolerances, and why:
- the codebook makers, the codec's encode and decode: bit for bit;
- ``estimate_quantiles``: within 2 f32 ulps of numpy's float64 quantiles
  (the port interpolates in float64); against jnp.quantile, which rounds
  each position q * (n - 1) to f32, within n * 2^-23 of the largest gap
  between neighbouring sorted values (positions that far apart);
- the 8-bit updates: the envelope of tests/test_torch_optim.py (XLA on the
  CPU contracts a*b + c into FMAs, the port rounds every operation): p
  within rtol 1e-6 and 1e-6 of the learning rate, absmax within rtol 1e-6,
  codes >= 99.9% equal and never more than one step apart. Each step both
  packages start from the JAX package's state. Against the JAX package's
  CPU route, which applies Adam's bias corrections apart where its kernel
  route (and the port) folds them into the step size, the JAX package's
  own kernel-against-CPU-route bar (tests/test_optim.py): p and absmax
  within rtol 1e-4 (p atol 1e-7), the same codes bar.
The JAX side of a table update runs its kernel route (interpret mode)
wherever that route takes the table, as the port follows it in a ragged
last block (state1's codes padded with 127, state2's with 0); an unsorted
table, which only JAX's CPU route takes, runs on whole blocks.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu import codebooks as JC
from bitsandbytes_sycl_tpu import functional as JF
from bitsandbytes_sycl_tpu import optim as jopt
from bitsandbytes_sycl_tpu.ops import optim8 as JO
from bitsandbytes_sycl_tpu.ops.lut8 import searchsorted_tree, take_tree
from bitsandbytes_sycl_tpu_torch import codebooks as TC
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch import optim as topt
from bitsandbytes_sycl_tpu_torch.convert import optim_state_from_jax
from bitsandbytes_sycl_tpu_torch.ops import optim8 as TO


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """The JAX package's 8-bit updates through its Pallas kernel
    (interpret mode) instead of its CPU route."""
    import bitsandbytes_sycl_tpu.ops.common as jcommon

    monkeypatch.setattr(jcommon, "on_tpu", lambda: True)
    monkeypatch.setattr(JO, "interpret_mode", lambda: True)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np(a):
    return None if a is None else (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a))


def _bits_equal(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _close_p(got, want, lr, cpu_route=False):
    tol = dict(rtol=1e-4, atol=1e-7) if cpu_route else dict(rtol=1e-6, atol=1e-6 * lr)
    np.testing.assert_allclose(_np(got).astype(np.float64), _np(want).astype(np.float64), **tol)


def _codes_close(got, want):
    got, want = _np(got).astype(np.int64), _np(want).astype(np.int64)
    assert np.abs(got - want).max() <= 1
    assert np.mean(got == want) >= 0.999, np.mean(got == want)


def _quantile_maps(seed=3):
    """tests/test_optim.py's maps: distinct tanh-normal values, signed for
    state1 and unsigned for state2."""
    rng = np.random.default_rng(seed)
    q1 = np.sort(np.unique(np.tanh(rng.normal(size=400)))).astype(np.float32)[:256]
    q2 = np.sort(np.unique(np.abs(np.tanh(rng.normal(size=500)))))[:256].astype(np.float32)
    return q1, q2


def _tables():
    """The tables of the codec tests: name -> (256,) f32."""
    rng = np.random.default_rng(17)
    sub7 = np.sort(np.tanh(np.linspace(-2.0, 2.0, 129))).astype(np.float32)
    return {
        "quantile": TC.create_quantile_map(rng.normal(size=20000).astype(np.float32)),
        "linear_signed": TC.create_linear_map(True),
        "linear_unsigned": TC.create_linear_map(False),
        "fp8": TC.create_fp8_map(True),
        "normal": TC.create_normal_map(),  # 241 duplicate zeros
        "padded_7bit": TC._pad_sorted_to_256(list(sub7)),
        "dynamic": TC.create_dynamic_map(True),
        "unsorted": rng.permutation(TC.create_linear_map(True)).astype(np.float32),
        "constant": np.full(256, 0.25, np.float32),
    }


# ------------------------------------------------------------- codebooks


@pytest.mark.parametrize("maker,args", [
    ("create_linear_map", (True, 8, True)), ("create_linear_map", (False, 8, True)),
    ("create_linear_map", (True, 4, False)), ("create_linear_map", (True, 8, False)),
    ("create_normal_map", (0.9677083, True)), ("create_normal_map", (0.99, False)),
    ("create_fp8_map", (True, 5, 2, 8)), ("create_fp8_map", (True, 4, 3, 8)),
    ("create_fp8_map", (False, 4, 4, 8)), ("create_fp8_map", (True, 2, 1, 4)),
    ("create_dynamic_map", (True, 4, 8)),
])
def test_codebook_makers_bit_identical(maker, args):
    _bits_equal(getattr(TC, maker)(*args), getattr(JC, maker)(*args))


@pytest.mark.parametrize("n", [1, 100, 5000])
def test_quantile_map_and_padding_bit_identical(n):
    x = np.random.default_rng(n).standard_t(3, size=n).astype(np.float32)
    _bits_equal(TC.create_quantile_map(x), JC.create_quantile_map(x))
    _bits_equal(TC.create_quantile_map(torch.from_numpy(x), 4), JC.create_quantile_map(x, 4))
    sub = np.sort(np.tanh(x[:200])).tolist()
    _bits_equal(TC._pad_sorted_to_256(sub), JC._pad_sorted_to_256(sub))


@pytest.mark.parametrize("n,num_quantiles,offset", [
    (1, 256, None), (7, 256, None), (1000, 100, None), (100003, 256, 0.01), (20000, 16, 0.0),
])
def test_estimate_quantiles(n, num_quantiles, offset):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = TF.estimate_quantiles(torch.from_numpy(x), offset, num_quantiles).numpy()
    want = np.asarray(JF.estimate_quantiles(jnp.asarray(x), offset, num_quantiles))
    off = 1.0 / (2 * num_quantiles) if offset is None else offset
    ref = np.quantile(x.astype(np.float64), np.linspace(off, 1 - off, num_quantiles))
    assert got.shape == want.shape == (256,) and got.dtype == np.float32
    assert np.all(got[num_quantiles:] == 0)
    np.testing.assert_allclose(got[:num_quantiles], ref, rtol=0,
                               atol=2 * np.spacing(np.float32(np.abs(ref).max())))
    gap = np.diff(np.sort(x)).max() if n > 1 else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=max(n, 1) * 2.0 ** -23 * gap + 1e-30)
    nan = x.copy()
    nan[n // 2] = np.nan
    assert np.isnan(TF.estimate_quantiles(torch.from_numpy(nan), offset,
                                          num_quantiles).numpy()[:num_quantiles]).all()


# ---------------------------------------------------------------- codec


def _encode_jax(table, normed, sign_fix):
    """JAX's encode of each table form: _LutCodec (the kernel's, sorted
    tables) or functional._codec_xla's unsorted branch."""
    if np.all(np.diff(table) >= 0):
        return np.asarray(JO._LutCodec(table, sign_fix=sign_fix).encode(jnp.asarray(normed)))
    order = np.argsort(table, kind="stable").astype(np.int32)
    sc = table[order]
    mids = ((sc[1:] + sc[:-1]) / 2.0).astype(np.float32)
    rank = searchsorted_tree(jnp.asarray(normed), mids, side="left")
    if sign_fix:
        rank = JO._apply_sign_fix(rank, jnp.asarray(normed), int(np.signbit(sc).sum()), 255)
    return np.asarray(take_tree(rank, order)).astype(np.uint8)


@pytest.mark.parametrize("sign_fix", [True, False])
@pytest.mark.parametrize("table", list(_tables()))
def test_lut_codec_matches_jax_select_trees(table, sign_fix):
    """Encode (rank over the midpoints, NaN at rank 0, the sign fix, the
    first index of a duplicate run) and decode, bit for bit, over values,
    their midpoints and neighbours, +-0.0, NaN and +-inf."""
    q = _tables()[table]
    codec = TO.LutCodec(q, sign_fix=sign_fix)
    u = np.unique(q)
    mids = ((u[1:] + u[:-1]) / 2.0).astype(np.float32)
    x = np.concatenate([
        np.linspace(-1.2, 1.2, 4001, dtype=np.float32), q, -q, mids,
        np.nextafter(mids, np.float32(2)), np.nextafter(mids, np.float32(-2)),
        np.float32([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-30, -1e-30]),
    ]).astype(np.float32)
    if table == "constant":
        x = x[np.isfinite(x) | np.isnan(x)]  # JAX's tree over no midpoint: a Python int
    got = codec.encode(torch.from_numpy(x)).numpy()
    want = np.broadcast_to(_encode_jax(q, x, sign_fix), x.shape)
    np.testing.assert_array_equal(got, want)
    codes = np.arange(256, dtype=np.uint8)
    _bits_equal(codec.decode(torch.from_numpy(codes)),
                np.asarray(take_tree(jnp.asarray(codes.astype(np.int32)), q)).astype(np.float32))


def _rank_jax(table, x):
    """JAX's rank of x among a table's midpoints: the select tree over
    _LutCodec's midpoints (sorted tables) or over those of the stably
    argsorted table (functional._codec_xla's unsorted branch)."""
    if np.all(np.diff(table) >= 0):
        mids = JO._LutCodec(table).mids
    else:
        sc = table[np.argsort(table, kind="stable")]
        mids = ((sc[1:] + sc[:-1]) / 2.0).astype(np.float32)
    return np.broadcast_to(np.asarray(searchsorted_tree(jnp.asarray(x), mids, side="left")),
                           x.shape)


@pytest.mark.parametrize("table", list(_tables()))
def test_bucketed_rank_matches_searchsorted_and_jax(table):
    """The kernels' bucketed rank (``lut_bucket_rank``, the index of
    ``lut_parts``) equals LutCodec.rank and JAX's select tree, bit for bit,
    over each midpoint and its neighbours one ulp away, the table's values,
    +-0.0, subnormals, +-inf, NaN of both signs and seeded random bit
    patterns; the index's least ranks agree with the midpoints' buckets and
    the largest occupancy bounds every bucket. XLA on the CPU compares
    subnormal inputs as zeros (against the 0.0 midpoint between an unsorted
    table's duplicate zeros that shifts the rank by one), so at a subnormal
    x JAX's rank is held to the port's rank at x flushed to a signed zero;
    the card keeps subnormals, as LutCodec.rank does."""
    q = _tables()[table]
    parts = TO.lut_parts(q)
    mids = parts.mids
    rng = np.random.default_rng(41)
    x = np.concatenate([
        mids, np.nextafter(mids, np.float32(np.inf)), np.nextafter(mids, np.float32(-np.inf)),
        q, -q, np.float32([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40, -1e-40, 1.17e-38,
                           -1.17e-38, 3.4e38, -3.4e38]),
        np.uint32([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF812345]).view(np.float32),
        rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32).view(np.float32),
        rng.normal(size=4000).astype(np.float32),
    ]).astype(np.float32)
    got = TO.lut_bucket_rank(parts, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, TO.LutCodec(parts).rank(torch.from_numpy(x)).numpy())
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    flushed = np.where(sub, np.copysign(np.float32(0.0), x), x).astype(np.float32)
    want = np.where(sub, TO.lut_bucket_rank(parts, torch.from_numpy(flushed)).numpy(), got)
    np.testing.assert_array_equal(want, _rank_jax(q, x))
    assert np.all(got[np.isnan(x)] == 0) and sub.sum() > 4
    keys = TO._order_keys(mids) >> np.uint32(32 - TO.LUT_BUCKET_BITS)
    counts = np.bincount(keys.astype(np.int64), minlength=1 << TO.LUT_BUCKET_BITS)
    assert parts.bucket_max == (counts.max() if mids.size else 0)
    np.testing.assert_array_equal(parts.bucket_lo, (np.cumsum(counts) - counts).astype(np.uint8))
    words = TO.lut_words(parts)
    assert words.size == TO.LUT_WORDS
    assert words[580:].view(np.uint8).tobytes() == parts.bucket_lo.tobytes()
    assert int(words[578:579].view(np.int32)[0]) == parts.bucket_max


def test_lut_table_checks():
    q1, _ = _quantile_maps()
    for q in (q1, q1[:100], q1[::-1].copy(), np.zeros(256, np.float32), None,
              TC.create_normal_map(), np.where(np.arange(256) == 3, np.nan, q1)):
        assert TO.lut_table_ok(q) == JO.lut_table_ok(q)
    assert TO.lut_table_ok(torch.from_numpy(q1))
    bad = q1.copy()
    bad[7] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        TO.LutCodec(bad)


# ------------------------------------------ the JAX entry on (nb, bs) rows


def _rows(name, nb, bs, seed):
    rng = np.random.default_rng(seed)
    two = name in TO.TWO_STATE
    g = (rng.normal(size=(nb, bs)) * 0.01).astype(np.float32)
    g[0, :3] = [np.nan, np.inf, 0.0]
    p = (rng.normal(size=(nb, bs)) * 0.02).astype(np.float32)
    s1 = rng.integers(0, 256, (nb, bs)).astype(np.uint8)
    am1 = (np.abs(rng.normal(size=(nb,))) * 1e-3).astype(np.float32)
    s2 = rng.integers(0, 256, (nb, bs)).astype(np.uint8) if two else None
    am2 = (np.abs(rng.normal(size=(nb,))) * 1e-5).astype(np.float32) if two else None
    if two:
        c1, c2 = 1.0 - 0.9 ** 3, np.float32(np.sqrt(1.0 - 0.999 ** 3))
        sc = np.float32([0.9, 0.999, np.float32(1e-8) * c2, np.float32(-1e-3) * c2 / np.float32(c1),
                         1.0 - 1e-5, 1.0, 0.0, 0.0])
    else:
        sc = np.float32([0.9, 0.99, 1e-8, 1e-3, 0.01, 1.0, 0.0, 0.0])
    return g, p, s1, am1, s2, am2, sc


@pytest.mark.parametrize("name", ["adam", "lion"])
def test_rows_entry_lut_matches_jax_kernel(name):
    """optim8_blockwise_fused(qmap1=, qmap2=) against the JAX package's LUT
    kernel in interpret mode, nb = 16, bs = 512."""
    q1, q2 = _quantile_maps()
    args = _rows(name, 16, 512, seed=7)
    maps = dict(qmap1=q1, qmap2=q2 if name == "adam" else None)
    want = JO.optim8_blockwise_fused(name, *[_j(a) for a in args], **maps)
    got = TO.optim8_blockwise_fused(name, *[_t(a) for a in args], **maps)
    assert len(got) == len(want)
    _close_p(got[0], want[0], 1e-3)
    np.testing.assert_array_equal(_np(got[0])[0, :2], args[1][0, :2])  # non-finite g keeps p
    for ci, ai in ((1, 2), (3, 4))[: len(got) // 2]:
        _codes_close(got[ci], want[ci])
        np.testing.assert_allclose(_np(got[ai]), _np(want[ai]), rtol=1e-6, atol=0)


def test_rows_entry_refuses_what_jax_declines():
    """Where the JAX entry returns None on a table, the port raises
    ValueError naming the reason; the JAX entry's row tiling does not
    apply (any nb runs)."""
    q1, q2 = _quantile_maps()
    g, p, s1, am1, s2, am2, sc = (_t(a) for a in _rows("adam", 3, 512, seed=1))
    u = torch.zeros_like(g)
    with pytest.raises(ValueError, match="stochastic"):
        TO.optim8_blockwise_fused("lion", g, p, s1, am1, None, None, sc, u=u, qmap1=q1)
    with pytest.raises(ValueError, match="qmap2"):
        TO.optim8_blockwise_fused("adam", g, p, s1, am1, s2, am2, sc, qmap1=q1)
    for bad in (q1[:100], q1[::-1].copy(), np.zeros(256, np.float32)):
        assert JO.optim8_blockwise_fused("lion", *[_j(_np(a)) for a in (g, p, s1, am1)], None,
                                         None, _j(_np(sc)), qmap1=bad) is None
        with pytest.raises(ValueError, match="table"):
            TO.optim8_blockwise_fused("lion", g, p, s1, am1, None, None, sc, qmap1=bad)
    out = TO.optim8_blockwise_fused("adam", g, p, s1, am1, s2, am2, sc, qmap1=q1, qmap2=q2)
    assert out[1].shape == (3, 512) and out[2].shape == (3,)


# ---------------------------------------------------- functional updates


def _step_both(name, q1, q2, n, bs, steps, seed, lr=1e-3, cpu_route=False):
    """``steps`` updates of both packages from random codes and absmax,
    then from the JAX package's state, compared each step (``cpu_route``:
    the JAX CPU route's bar); returns the last (port, JAX) outputs."""
    rng = np.random.default_rng(seed)
    nb = -(-n // bs)
    two = name in TO.TWO_STATE
    p = (rng.normal(size=(n,)) * 0.05).astype(np.float32)
    s1 = rng.integers(0, 256, (n,)).astype(np.uint8)
    a1 = (rng.uniform(size=(nb,)) * 1e-3).astype(np.float32)
    s2 = rng.integers(0, 256, (n,)).astype(np.uint8) if two else None
    a2 = (rng.uniform(size=(nb,)) * 1e-5).astype(np.float32) if two else None
    maps = (q1, q2 if two else None)
    for step in range(1, steps + 1):
        g = (rng.normal(size=(n,)) * 0.01).astype(np.float32)
        g[7] = np.nan
        kw = dict(beta1=0.9, beta2=0.99, eps=1e-8, step=step, lr=lr, weight_decay=0.01,
                  blocksize=bs)
        want = JF.optimizer_update_8bit_blockwise(name, _j(g), _j(p), _j(s1), _j(a1), _j(s2),
                                                  _j(a2), _j(maps[0]), _j(maps[1]), **kw)
        got = TF.optimizer_update_8bit_blockwise(name, _t(g), _t(p), _t(s1), _t(a1), _t(s2),
                                                 _t(a2), *maps, **kw)
        _close_p(got[0], want[0], lr, cpu_route)
        for ci, ai in ((1, 2), (3, 4))[: 2 if two else 1]:
            _codes_close(got[ci], want[ci])
            np.testing.assert_allclose(_np(got[ai]), _np(want[ai]),
                                       rtol=1e-4 if cpu_route else 1e-6, atol=0)
        p, s1, a1 = (np.asarray(want[i]) for i in range(3))
        if two:
            s2, a2 = np.asarray(want[3]), np.asarray(want[4])
    return got, want


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_blockwise_update_with_tables_matches_jax_kernel(name, jax_kernel_path):
    """The quantile maps, Adam's and momentum's, bs 512 and n = 3 * 512 +
    100 (a ragged last block), one step, against the JAX kernel route."""
    q1, q2 = _quantile_maps()
    got, _ = _step_both(name, q1, q2, 3 * 512 + 100, 512, 1, seed=11)
    assert got[2].shape == (4,)


def test_blockwise_update_unsorted_table():
    """A permuted linear map (the JAX kernel declines it) against the JAX
    package's CPU route on whole blocks."""
    q = _tables()["unsorted"]
    _step_both("adam", q, np.abs(q), 2 * 512, 512, 2, seed=13, cpu_route=True)


def test_blockwise_update_constant_table():
    """A constant table: every code encodes to the first index (0) and
    decodes to the constant. The JAX package's CPU route raises on such a
    table (its rank -> code tree over one entry gives a scalar), so p and
    the absmax are held against it on an ascending table whose code 0
    decodes alike, from all-zero codes, 2 steps."""
    q = _tables()["constant"]
    ref = np.linspace(0.25, 1.0, 256, dtype=np.float32)
    rng = np.random.default_rng(19)
    n, bs = 2 * 512, 512
    p = (rng.normal(size=(n,)) * 0.05).astype(np.float32)
    zeros = np.zeros((n,), np.uint8)
    a1 = a2 = np.float32([1e-3, 2e-3])
    for step in (1, 2):
        g = (rng.normal(size=(n,)) * 0.01).astype(np.float32)
        kw = dict(beta1=0.9, beta2=0.99, eps=1e-8, step=step, lr=1e-3, blocksize=bs)
        want = JF.optimizer_update_8bit_blockwise("adam", _j(g), _j(p), _j(zeros), _j(a1),
                                                  _j(zeros), _j(a2), _j(ref), _j(ref), **kw)
        got = TF.optimizer_update_8bit_blockwise("adam", _t(g), _t(p), _t(zeros), _t(a1),
                                                 _t(zeros), _t(a2), q, q, **kw)
        _close_p(got[0], want[0], 1e-3, cpu_route=True)
        for ci, ai in ((1, 2), (3, 4)):
            assert not _np(got[ci]).any()
            np.testing.assert_allclose(_np(got[ai]), _np(want[ai]), rtol=1e-4, atol=0)
        p, a1, a2 = np.asarray(want[0]), np.asarray(want[2]), np.asarray(want[4])


def test_stochastic_rounding_with_a_table_warns():
    q1, q2 = _quantile_maps()
    n = 2048
    g = torch.full((n,), 0.01)
    s = torch.zeros((n,), dtype=torch.uint8)
    am = torch.ones((1,))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = TF.optimizer_update_8bit_blockwise(
            "adam", g, g.clone(), s, am, s.clone(), am.clone(), q1, q2, beta1=0.9, beta2=0.999,
            eps=1e-8, step=1, lr=1e-3, blocksize=n, stochastic_rounding=True)
    assert any("stochastic_rounding" in str(x.message) for x in w)
    det = TF.optimizer_update_8bit_blockwise(
        "adam", g, g.clone(), s, am, s.clone(), am.clone(), q1, q2, beta1=0.9, beta2=0.999,
        eps=1e-8, step=1, lr=1e-3, blocksize=n)
    for a, b in zip(out, det):
        _bits_equal(a, b)


# ------------------------------------------------------ blocks past 2048


@pytest.mark.parametrize("codec,name", [("dynamic", "adam"), ("lut", "adam"),
                                        ("dynamic", "lion"), ("lut", "momentum")],
                         ids=["dynamic", "lut", "lion-dynamic", "momentum-lut"])
def test_global_max_update_matches_jax(codec, name, jax_kernel_path):
    """optimizer_update_8bit: n = 3000 in one block of 4096 (ragged), one
    step from random codes and maxima, the maxima of shape (1,); kernel J
    (adam) and kernel K (lion, momentum: its resident route on the card)."""
    rng = np.random.default_rng(21)
    n, lr = 3000, 1e-3
    two = name == "adam"
    q1, q2 = _quantile_maps() if codec == "lut" else (None, None)
    q2 = q2 if two else None
    p = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    s1, s2 = rng.integers(0, 256, (2, n)).astype(np.uint8)
    s2 = s2 if two else None
    m1, m2 = np.float32([2e-3]), np.float32([3e-5]) if two else None
    b2 = 0.999 if two else 0.99
    for step in (3,):
        g = (rng.normal(size=(n,)) * 0.01).astype(np.float32)
        kw = dict(qmap1=q1, qmap2=q2, weight_decay=0.01, codec=None if codec == "lut" else "dynamic")
        want = JF.optimizer_update_8bit(name, _j(g), _j(p), _j(s1), _j(s2), 0.9, b2, 1e-8,
                                        step, lr, max1=_j(m1), max2=_j(m2), **kw)
        got = TF.optimizer_update_8bit(name, _t(g), _t(p), _t(s1), _t(s2), 0.9, b2, 1e-8,
                                       step, lr, max1=_t(m1), max2=_t(m2), **kw)
        assert got[2].shape == (1,) and (got[4].shape == (1,) if two else got[4] is None)
        _close_p(got[0], want[0], lr)
        for ci, ai in ((1, 2), (3, 4)) if two else ((1, 2),):
            _codes_close(got[ci], want[ci])
            np.testing.assert_allclose(_np(got[ai]), _np(want[ai]), rtol=1e-6, atol=0)


def test_two_pass_plain_equals_rows_of_one_block():
    """A leaf of 5000 in blocks of 4096 through the leaf-table plain body
    equals the rows version on the padded (2, 4096) rows bit for bit (the
    JAX kernel route's padding: g, p 0, codes 127 and 0)."""
    rng = np.random.default_rng(5)
    n, bs = 5000, 4096
    g = (rng.normal(size=n) * 0.01).astype(np.float32)
    p = (rng.normal(size=n) * 0.02).astype(np.float32)
    s1, s2 = rng.integers(0, 256, n).astype(np.uint8), rng.integers(0, 256, n).astype(np.uint8)
    a1 = (rng.uniform(size=2) * 1e-3).astype(np.float32)
    a2 = (rng.uniform(size=2) * 1e-5).astype(np.float32)
    sc = TF._optim8_scalars("adam", 0.9, 0.999, 1e-8, 2, 1e-3, 0.0, 1.0, "cpu")
    q1, q2 = _quantile_maps()
    for qmaps in (None, (q1, q2)):
        leaf = TO.Optim8Leaf(_t(g), _t(p), _t(s1), _t(a1), _t(s2), _t(a2))
        TO.optim8_update("adam", [leaf], sc.reshape(1, 8), blocksize=bs, qmaps=qmaps)

        def pad(a, fill):
            return _t(np.concatenate([a, np.full(2 * bs - n, fill, a.dtype)]).reshape(2, bs))

        rows = TO.optim8_2state("adam", pad(g, 0), pad(p, 0), pad(s1, 127), _t(a1), pad(s2, 0),
                                _t(a2), sc, qmaps=qmaps)
        for got, want in zip(leaf[1:6], rows):
            _bits_equal(got, want.reshape(-1)[:got.numel()])


def test_adam8bit_whole_tensor_blocks_match_jax(jax_kernel_path):
    """adam8bit(block_wise=False) over 5 steps as the class test of
    tests/test_torch_optim.py runs it: a ragged leaf (4559, one block), a
    4096 leaf, one just under min_8bit_size and a scalar."""
    import jax
    import optax

    rng = np.random.default_rng(9)
    shapes = {"a": (47, 97), "b": (64, 64), "c": (4095,), "s": ()}
    params = {k: np.asarray(rng.normal(size=s) * 0.05, np.float32) for k, s in shapes.items()}
    tx = jopt.adam8bit(1e-3, block_wise=False)
    jstate = tx.init({k: jnp.asarray(v) for k, v in params.items()})
    order = sorted(shapes)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    opt = topt.adam8bit([tparams[k] for k in order], 1e-3, block_wise=False)

    def jstep(p, st, g):
        upd, st = tx.update(g, st, p)
        return optax.apply_updates(p, upd), st

    jstep = jax.jit(jstep)
    for _ in range(5):
        grads = {k: np.asarray(rng.normal(size=s) * 0.01, np.float32) for k, s in shapes.items()}
        for k in order:
            tparams[k].copy_(torch.from_numpy(np.array(params[k])))
            tparams[k].grad = torch.from_numpy(grads[k])
        optim_state_from_jax(jax.tree.map(np.asarray, jstate), tparams, opt)
        opt.step()
        pj, jstate = jstep({k: jnp.asarray(v) for k, v in params.items()}, jstate,
                           {k: jnp.asarray(v) for k, v in grads.items()})
        for k in order:
            # the bias corrections: f32 in the JAX package, float64 in the port
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(pj[k]), rtol=1e-6,
                                       atol=1e-4 * 1e-3)
            sj, st = jstate.inner[k], opt.state[tparams[k]]
            assert set(sj) == set(st)
            for name in sj:
                if st[name].dtype == torch.uint8:
                    _codes_close(st[name], sj[name])
                else:
                    np.testing.assert_allclose(_np(st[name]), np.asarray(sj[name]),
                                               rtol=1e-5, atol=1e-7)
        params = {k: np.asarray(v) for k, v in pj.items()}
    assert opt.state[tparams["a"]]["absmax1"].shape == (1,)
    assert opt.route_leaves["grouped"] == 10 and opt.route_leaves["per_leaf"] == 0
