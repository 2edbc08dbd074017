"""The port's 8-bit optimizer stack against the JAX package on the CPU: the
dynamic codec, the plain versions of kernels J and K, the functional
updates, percentile clipping and the optimizer classes. Inputs are numpy
arrays from a seed, handed to both packages.

Tolerances, and why:
- the codec (decode, encode, stochastic adjust) is bit for bit;
- XLA on the CPU contracts a*b + c into fused multiply-adds, the port
  rounds every operation (as kernels J and K do on the card), so
  intermediate states differ by an ulp now and then: p within P_TOL
  (rtol 1e-6 of p, and 1e-6 of the step's learning rate where p cancels
  toward 0), absmax within rtol 1e-6, codes >= 99.9% equal and never more
  than one step apart (the JAX package's own kernel-vs-codec bar,
  tests/test_optim.py);
- 32-bit updates and f32 states: rtol 1e-5, atol 1e-7 after 5 steps;
- the optimizer classes: the JAX transforms raise beta to their int32
  step count in f32 (1 - 0.999 keeps 10 bits there), the port in float64,
  so the bias-corrected step size differs by up to ~3e-5 of itself: p
  within rtol 1e-6 and 1e-4 of the learning rate.
The 8-bit comparisons step both packages from the same state each step
(the JAX package's), so one flipped code cannot compound. They run the JAX
package's fused-kernel route (interpret mode), the semantics the port
keeps: its CPU route pads a ragged block's state1 codes with 0, which
decodes to -absmax and enters the block's new absmax, where the kernel
route pads with 127 (0.0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bitsandbytes_sycl_tpu import functional as JF
from bitsandbytes_sycl_tpu import optim as jopt
from bitsandbytes_sycl_tpu.ops import dynamic8 as JD
from bitsandbytes_sycl_tpu.ops.optim8 import optim8_blockwise_fused as j_fused
from bitsandbytes_sycl_tpu_torch import codebooks as TC
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch import optim as topt
from bitsandbytes_sycl_tpu_torch.convert import optim_state_from_jax
from bitsandbytes_sycl_tpu_torch.ops import dynamic8 as TD
from bitsandbytes_sycl_tpu_torch.ops.optim8 import optim8_blockwise_fused as t_fused

NAMES = ["adam", "lamb", "momentum", "rmsprop", "adagrad", "lion"]


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """The JAX package's 8-bit updates through its Pallas kernel
    (interpret mode) instead of its CPU route."""
    import bitsandbytes_sycl_tpu.ops.common as jcommon
    import bitsandbytes_sycl_tpu.ops.optim8 as joptim8

    monkeypatch.setattr(jcommon, "on_tpu", lambda: True)
    monkeypatch.setattr(joptim8, "interpret_mode", lambda: True)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _np(a):
    return None if a is None else (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a))


def _close_p(got, want, lr, atol_lr=1e-6):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol_lr * lr)


def _codes_close(got, want):
    got, want = _np(got).astype(np.int64), _np(want).astype(np.int64)
    assert np.abs(got - want).max() <= 1
    assert np.mean(got == want) >= 0.999, np.mean(got == want)
    return int((got != want).sum())


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("signed", [True, False])
def test_dynamic_map_and_decode_bit_identical(signed):
    from bitsandbytes_sycl_tpu import codebooks as JC

    np.testing.assert_array_equal(TC.create_dynamic_map(signed), JC.create_dynamic_map(signed))
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(JD.dynamic_decode(jnp.asarray(codes), signed))
    got = TD.dynamic_decode(_t(codes), signed).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    table = TD.decode_table("cpu").numpy()[0 if signed else 256:][:256]
    np.testing.assert_array_equal(table.view(np.uint32), want.view(np.uint32))


def _sweep(signed):
    vals = TD.dynamic_decode(torch.arange(256, dtype=torch.int32).to(torch.uint8), signed).numpy()
    mids = ((vals[1:] + vals[:-1]) / np.float32(2)).astype(np.float32)
    edges = np.concatenate([TD._consts(signed)[0], [TD._consts(signed)[1]]]).astype(np.float32)
    return np.concatenate([
        np.linspace(-1.5, 1.5, 400_001, dtype=np.float32),
        mids, np.nextafter(mids, np.float32(2)), np.nextafter(mids, np.float32(-2)),  # exact midpoints
        edges, np.nextafter(edges, np.float32(2)), -edges,  # decade edges
        vals, -vals,
        np.float32([0.0, -0.0, 1.0, -1.0, 1.0000001, -1.0000001, 1.5, -3.0, 1e-7, -1e-7, 3e-8, 1e-30]),
    ]).astype(np.float32)


@pytest.mark.parametrize("signed", [True, False])
def test_dynamic_encode_and_stochastic_bit_identical(signed):
    x = _sweep(signed)
    want = np.asarray(JD.dynamic_encode(jnp.asarray(x), signed))
    got = TD.dynamic_encode(_t(x), signed).numpy()
    np.testing.assert_array_equal(got, want)
    u = np.random.default_rng(3).uniform(size=x.shape).astype(np.float32)
    xc = np.clip(x, -1.0, 1.0) if signed else np.clip(x, 0.0, 1.0)
    want_s = np.asarray(JD.stochastic_adjust(jnp.asarray(want), jnp.asarray(xc), jnp.asarray(u), signed))
    got_s = TD.stochastic_adjust(_t(got), _t(xc), _t(u), signed).numpy()
    np.testing.assert_array_equal(got_s, want_s)
    assert (got_s != got).sum() > 1000  # the noise moved codes


# ------------------------------------------------- kernels J and K (plain)


def _rows_case(name, step, stochastic, nb=32, bs=256, seed=0):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(nb, bs)) * 0.01).astype(np.float32)
    g[0, :4] = [np.nan, np.inf, -np.inf, 0.0]  # masked entries keep p and the states
    g[2] = 0.0
    p = (rng.normal(size=(nb, bs)) * 0.02).astype(np.float32)
    lo = 127 if name in ("rmsprop", "adagrad") else 0  # a nonnegative second moment
    s1 = rng.integers(lo, 256, (nb, bs)).astype(np.uint8)
    s1[5] = 127  # an all-zero block: absmax 0, safe_inv(0) = 0
    am1 = (np.abs(rng.normal(size=(nb,))) * 1e-3).astype(np.float32)
    am1[5] = 0.0
    two = name in ("adam", "lamb")
    s2 = rng.integers(0, 256, (nb, bs)).astype(np.uint8) if two else None
    am2 = (np.abs(rng.normal(size=(nb,))) * 1e-5).astype(np.float32) if two else None
    lr, wd = 1e-3, 0.01
    if two:
        c1 = 1.0 - 0.9 ** step
        c2 = np.float32(np.sqrt(1.0 - 0.999 ** step))
        sc = np.float32([0.9, 0.999, np.float32(1e-8) * c2, np.float32(-lr) * c2 / np.float32(c1),
                         1.0 - lr * wd, 1.0, 0.0, 0.0])
    else:
        sc = np.float32([0.9, 0.99, 1e-8, lr, wd, 1.0, float(step == 1), 0.0])
    u = rng.uniform(size=(nb, bs)).astype(np.float32) if stochastic else None
    return g, p, s1, am1, s2, am2, sc, u, lr


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("step", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_plain_kernels_match_jax_kernel(name, step, stochastic):
    """Measured: every code equal except one state1 code of 8,192 in the
    stochastic step-3 cases of adam and lamb (one step apart)."""
    g, p, s1, am1, s2, am2, sc, u, lr = _rows_case(name, step, stochastic, seed=step)
    ja = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = j_fused(name, ja(g), ja(p), ja(s1), ja(am1), ja(s2), ja(am2), ja(sc), u=ja(u))
    got = t_fused(name, _t(g), _t(p), _t(s1), _t(am1), _t(s2), _t(am2), _t(sc), u=_t(u))
    assert len(got) == len(want)
    _close_p(got[0], want[0], lr)
    np.testing.assert_array_equal(_np(got[0])[0, :3], p[0, :3])  # non-finite g keeps p
    for ci, ai in ((1, 2), (3, 4))[: len(got) // 2]:
        _codes_close(got[ci], want[ci])
        np.testing.assert_allclose(_np(got[ai]), _np(want[ai]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_custom_qmap_matches_jax_kernel(name):
    """The dynamic maps as tables (the LUT codec) through the JAX entry's
    rows, against the JAX package's LUT kernel (interpret mode), 16 rows
    of 256: the codes equal, p within P_TOL."""
    g, p, s1, am1, s2, am2, sc, _, lr = _rows_case(name, 3, False, nb=16, seed=5)
    q1, q2 = TC.create_dynamic_map(True), TC.create_dynamic_map(False)
    two = name == "adam"
    ja = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    maps = dict(qmap1=q1, qmap2=q2 if two else None)
    want = j_fused(name, ja(g), ja(p), ja(s1), ja(am1), ja(s2), ja(am2), ja(sc), **maps)
    got = t_fused(name, _t(g), _t(p), _t(s1), _t(am1), _t(s2), _t(am2), _t(sc), **maps)
    assert len(got) == len(want)
    _close_p(got[0], want[0], lr)
    for ci, ai in ((1, 2), (3, 4))[: len(got) // 2]:
        _codes_close(got[ci], want[ci])
        np.testing.assert_allclose(_np(got[ai]), _np(want[ai]), rtol=1e-6, atol=0)


# ---------------------------------------------------- functional updates


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_update_8bit_blockwise_matches_jax(name, stochastic, jax_kernel_path):
    """Ragged n (5000 = 2 blocks + 904), 5 steps from the JAX package's
    state each step; stochastic rounding draws other uniforms in each
    package, so there the codes are held to the deterministic ones' bar
    only in distance (one step)."""
    rng = np.random.default_rng(11)
    n, bs, lr = 5000, 2048, 1e-3
    nb = (n + bs - 1) // bs
    two = name in ("adam", "lamb")
    p = (rng.normal(size=(n,)) * 0.05).astype(np.float32)
    s1 = np.full((n,), 127, np.uint8)
    a1 = np.zeros((nb,), np.float32)
    s2 = np.zeros((n,), np.uint8) if two else None
    a2 = np.zeros((nb,), np.float32) if two else None
    for step in range(1, 6):
        g = (rng.normal(size=(n,)) * 0.01).astype(np.float32)
        g[7] = np.nan
        kw = dict(beta1=0.9, beta2=0.99, eps=1e-8, step=step, lr=lr, weight_decay=0.01,
                  blocksize=bs, codec="dynamic", stochastic_rounding=stochastic)
        ja = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
        want = JF.optimizer_update_8bit_blockwise(name, ja(g), ja(p), ja(s1), ja(a1), ja(s2),
                                                  ja(a2), None, None, **kw)
        got = TF.optimizer_update_8bit_blockwise(name, _t(g), _t(p), _t(s1), _t(a1), _t(s2),
                                                 _t(a2), None, None, **kw)
        if stochastic:  # the port's noise is a function of the step
            again = TF.optimizer_update_8bit_blockwise(name, _t(g), _t(p), _t(s1), _t(a1),
                                                       _t(s2), _t(a2), None, None, **kw)
            np.testing.assert_array_equal(_np(again[1]), _np(got[1]))
        _close_p(got[0], want[0], lr)
        for ci, ai in ((1, 2), (3, 4))[: 2 if two else 1]:
            if stochastic:
                assert np.abs(_np(got[ci]).astype(int) - _np(want[ci]).astype(int)).max() <= 1
            else:
                _codes_close(got[ci], want[ci])
            np.testing.assert_allclose(_np(got[ai]), _np(want[ai]), rtol=1e-6, atol=0)
        p, s1, a1 = (np.asarray(want[i]) for i in range(3))
        if two:
            s2, a2 = np.asarray(want[3]), np.asarray(want[4])


@pytest.mark.parametrize("max_unorm", [0.0, 0.05])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_update_32bit_matches_jax(name, max_unorm):
    rng = np.random.default_rng(5)
    shape = (37, 51)
    two = name in ("adam", "lamb")
    pj = pt = (rng.normal(size=shape) * 0.05).astype(np.float32)
    sj1 = st1 = np.zeros(shape, np.float32)
    sj2 = st2 = np.zeros(shape, np.float32) if two else None
    for step in range(1, 6):
        g = (rng.normal(size=shape) * 0.01).astype(np.float32)
        kw = dict(beta1=0.9, beta2=0.99, eps=1e-8, step=step, lr=1e-2, weight_decay=0.01,
                  max_unorm=max_unorm, skip_zeros=step == 3)
        if step == 3:
            g[:4] = 0.0
        ja = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
        pj, sj1, sj2 = (np.asarray(a) if a is not None else None for a in
                        JF.optimizer_update_32bit(name, ja(g), ja(pj), ja(sj1), ja(sj2), **kw))
        pt, st1, st2 = (_np(a) for a in
                        TF.optimizer_update_32bit(name, _t(g), _t(pt), _t(st1), _t(st2), **kw))
    tol = dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pt, pj, **tol)
    np.testing.assert_allclose(st1, sj1, **tol)
    if two:
        np.testing.assert_allclose(st2, sj2, **tol)


def test_percentile_clipping_matches_jax():
    rng = np.random.default_rng(2)
    vj = vt = np.zeros((100,), np.float32)
    for step in range(1, 106):
        gn = np.float32(rng.uniform(0.5, 2.0) * (50.0 if step % 17 == 0 else 1.0))
        vj, sj = JF.percentile_clipping(jnp.asarray(gn), jnp.asarray(vj), step, 5)
        vt, stt = TF.percentile_clipping(torch.tensor(gn), _t(np.asarray(vt)), step, 5)
        vj, vt = np.asarray(vj), vt.numpy()
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_allclose(float(stt), float(sj), rtol=1e-6)


# ------------------------------------------------------- optimizer classes


def _jax_step(tx, params, state, grads):
    upd, state = tx.update(grads, state, params)
    return optax.apply_updates(params, upd), state


CLASSES = [
    ("adam8bit", dict(learning_rate=1e-3)),
    ("adamw8bit", dict(learning_rate=1e-3, weight_decay=0.05)),
    ("lamb8bit", dict(learning_rate=1e-2, max_unorm=0.01)),
    ("lion8bit", dict(learning_rate=1e-4)),
    ("sgd8bit", dict(learning_rate=1e-2)),
    ("rmsprop8bit", dict(learning_rate=1e-3)),
    ("adagrad8bit", dict(learning_rate=1e-2)),
    ("adam32bit", dict(learning_rate=1e-3)),
    ("adamw32bit", dict(learning_rate=1e-3)),
    ("lamb32bit", dict(learning_rate=1e-2, max_unorm=0.01)),
    ("lion32bit", dict(learning_rate=1e-4)),
    ("sgd32bit", dict(learning_rate=1e-2)),
    ("rmsprop32bit", dict(learning_rate=1e-3)),
    ("adagrad32bit", dict(learning_rate=1e-2)),
    ("lars8bit", dict(learning_rate=1e-2)),
    ("paged_adamw8bit", dict(learning_rate=1e-3, percentile_clipping=5)),
]


@pytest.mark.parametrize("ctor,kw", CLASSES, ids=[c for c, _ in CLASSES])
def test_optimizer_class_matches_jax(ctor, kw, jax_kernel_path):
    """5 steps with identical gradients on a ragged 8-bit leaf (47 x 97 =
    4559 elements), a leaf at the min_8bit_size boundary (4096: 8-bit), one
    just under it (4095: 32-bit) and a scalar. Each step both start from
    the JAX package's params and state (``optim_state_from_jax``)."""
    rng = np.random.default_rng(9)
    shapes = {"a": (47, 97), "b": (64, 64), "c": (4095,), "s": ()}
    params = {k: np.asarray(rng.normal(size=s) * 0.05, np.float32) for k, s in shapes.items()}
    tx = getattr(jopt, ctor)(**kw)
    jstate = tx.init({k: jnp.asarray(v) for k, v in params.items()})
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    order = sorted(shapes)  # the JAX package's tree order
    opt = getattr(topt, ctor)([tparams[k] for k in order], **kw)
    lr = kw["learning_rate"]
    eight = "8bit" in ctor
    jstep = jax.jit(lambda p, st, g: _jax_step(tx, p, st, g))
    for step in range(1, 6):
        grads = {k: np.asarray(rng.normal(size=s) * 0.01, np.float32) for k, s in shapes.items()}
        for k in order:
            tparams[k].copy_(torch.from_numpy(np.array(params[k])))
            tparams[k].grad = torch.from_numpy(grads[k])
        optim_state_from_jax(jax.tree.map(np.asarray, jstate), tparams, opt)
        opt.step()
        pj, jstate = jstep({k: jnp.asarray(v) for k, v in params.items()}, jstate,
                           {k: jnp.asarray(v) for k, v in grads.items()})
        assert opt.count == step
        for k in order:
            _close_p(tparams[k], pj[k], lr, atol_lr=1e-4)
            sj, st = jstate.inner[k], opt.state[tparams[k]]
            assert set(sj) == set(st)
            is8 = eight and np.prod(shapes[k]) >= 4096
            assert (st["state1"].dtype == torch.uint8) == is8
            for name in sj:
                if st[name].dtype == torch.uint8:
                    _codes_close(st[name], sj[name])
                else:
                    np.testing.assert_allclose(_np(st[name]), np.asarray(sj[name]),
                                               rtol=1e-5, atol=1e-7)
        params = {k: np.asarray(v) for k, v in pj.items()}


def test_optimizer_class_runs_free_and_raises(jax_kernel_path):
    """Without re-synchronising, 5 adam8bit steps stay within the 8-bit
    drift envelope of the JAX package's (mean |dp| 1e-5 at lr 1e-3), and
    the options not ported raise."""
    rng = np.random.default_rng(4)
    p0 = (rng.normal(size=(64, 128)) * 0.05).astype(np.float32)
    tx = jopt.adam8bit(1e-3, min_8bit_size=64)
    jp, js = {"w": jnp.asarray(p0)}, tx.init({"w": jnp.asarray(p0)})
    tp = torch.tensor(p0)
    opt = topt.adam8bit([tp], 1e-3, min_8bit_size=64)
    for _ in range(5):
        g = (rng.normal(size=p0.shape) * 0.01).astype(np.float32)
        jp, js = _jax_step(tx, jp, js, {"w": jnp.asarray(g)})
        tp.grad = torch.from_numpy(g)
        opt.step()
    assert np.abs(tp.numpy() - np.asarray(jp["w"])).mean() < 1e-5
    with pytest.raises(NotImplementedError, match="Queue A #13"):
        topt.adam8bit([tp], mesh=object())
    with pytest.raises(ValueError):
        topt.lars([tp], momentum=0)
