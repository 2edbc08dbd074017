"""The port's ``parallel`` building blocks against the JAX package on the
CPU: the row-parallel retile, the sharding guards, the five tensor-parallel
collectives in a gloo world of two processes, and the sharded 8-bit
optimizer update.

One world serves the file: a module-scoped fixture starts the two ranks
(``tests/torch_parallel_cases.py``, one thread each, ``init_method=file://``
under the test's temporary directory), computes the JAX references while
they run, and each check below is its own test. The JAX side calls its
single-device functions (no ``shard_map``), as its own tests hold its TP
against its single device.

Tolerances, and why:
- the retile is integer work and a scale reshape: bit for bit, codes,
  bf16 and f32 scales; with compressed statistics the scales are encoded
  anew over the retiled grouping, and ``torch.mean`` and ``jnp.mean``
  differ in the last bit, so codes are >= 99.9% equal and at most one step
  apart, and the sidecars within 1e-6 (``tests/test_torch_compressed.py``'s
  bar);
- the collectives: rtol = atol = 2e-2, the JAX package's
  tests/test_parallel.py bar, against JAX's ``matmul_4bit_fused`` and
  ``llm_int8_matmul`` (row-parallel LLM.int8 against the sum of its
  products over the two K slices: each rank quantizes its own slice);
- the sharded 8-bit update: the ranks' rows laid end to end equal the
  port's unsharded update bit for bit (as the JAX package's sharded update
  equals its unsharded one), and they meet the port's bar against JAX's
  unsharded update (``tests/test_torch_optim.py``: XLA contracts a*b + c
  into FMAs where the port rounds every operation): p within rtol 1e-6,
  codes >= 99.9% equal and at most one step apart, absmax within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as C
from bitsandbytes_sycl_tpu import functional as JF
from bitsandbytes_sycl_tpu.ops.matmul_4bit import matmul_4bit_fused as j_mm4
from bitsandbytes_sycl_tpu.parallel import make_mesh as j_make_mesh
from bitsandbytes_sycl_tpu.parallel import mesh as JM
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native
from bitsandbytes_sycl_tpu_torch.parallel import mesh as TM

WORLD = 2
TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs on one thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory, _one_thread):
    """Every rank's outputs and the JAX references (computed while the
    ranks run)."""
    tmp = tmp_path_factory.mktemp("tp_ops")
    procs = C.start_world("ops", WORLD, tmp)
    inp = C.ops_inputs()
    x = jnp.asarray(inp["x"].numpy())
    CB, SCB = (jnp.asarray(t.numpy()) for t in inp["int8"])
    ref = {"mm4": np.asarray(j_mm4(x, C.to_jax(inp["qw"])), np.float32),
           "mm4_c": np.asarray(j_mm4(x, C.to_jax(inp["qwc"])), np.float32),
           "int8": np.asarray(JF.llm_int8_matmul(x, CB, SCB, threshold=0.0), np.float32)}
    k = C.K // WORLD
    ref["int8_row"] = sum(
        np.asarray(JF.llm_int8_matmul(x[:, r * k:(r + 1) * k], CB[:, r * k:(r + 1) * k], SCB,
                                      threshold=0.0), np.float32) for r in range(WORLD))
    dyn, lut = C.optim_inputs()
    import bitsandbytes_sycl_tpu.ops.common as jcommon
    import bitsandbytes_sycl_tpu.ops.optim8 as joptim8

    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's kernel route (interpret mode), whose semantics
        # the port keeps (tests/test_torch_optim.py)
        mp.setattr(jcommon, "on_tpu", lambda: True)
        mp.setattr(joptim8, "interpret_mode", lambda: True)
        for key, d, qmaps, step in (("dynamic", dyn, (None, None), 1),
                                    ("lut", lut, C.lut_maps(), 2)):
            ja = {n: jnp.asarray(a) for n, a in d.items()}
            ref[f"opt_{key}"] = [np.asarray(a) for a in JF.optimizer_update_8bit_blockwise(
                "adam", ja["g"], ja["p"], ja["s1"], ja["a1"], ja["s2"], ja["a2"],
                None if qmaps[0] is None else jnp.asarray(qmaps[0]),
                None if qmaps[1] is None else jnp.asarray(qmaps[1]), 0.9, 0.999, 1e-8, step,
                1e-3, blocksize=2048, codec="dynamic" if key == "dynamic" else None)]
    outs = C.finish_world(procs, tmp)
    return outs, ref, inp


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ----------------------------------------------------------------- retile


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("bs", [64, 128])
@pytest.mark.parametrize("absmax_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("quant", ["nf4", "fp4"])
def test_retile_bit_equal_to_jax(quant, absmax_dtype, bs, tp):
    W = torch.from_numpy(np.random.default_rng(bs + tp).normal(size=(256, 1024))
                         .astype(np.float32))
    qw = quantize_4bit_native(W, blocksize=bs, quant_type=quant, absmax_dtype=absmax_dtype)
    got = TM.retile_qweight_row_tp(qw, tp)
    want = JM.retile_qweight_row_tp(C.to_jax(qw), tp)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    assert got.absmax.dtype == absmax_dtype and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.absmax.float().numpy(), np.asarray(want.absmax, np.float32))
    # each rank's byte rows decode to its contiguous K range
    d = tp - 1
    loc = TM._local_qw(got, packed=got.packed[d * 512 // tp:(d + 1) * 512 // tp],
                       absmax=got.absmax[:, d * 512 // (bs * tp):(d + 1) * 512 // (bs * tp)])
    np.testing.assert_array_equal(loc.dequantize().float().numpy(),
                                  qw.dequantize().float()[:, d * 1024 // tp:(d + 1) * 1024 // tp]
                                  .numpy())


@pytest.mark.parametrize("tp", [2, 4])
def test_retile_compressed_within_a_code_step_of_jax(tp):
    W = torch.from_numpy(np.random.default_rng(tp).normal(size=(256, 1024)).astype(np.float32))
    qw = quantize_4bit_native(W, blocksize=64, quant_type="nf4", compress_statistics=True)
    got = TM.retile_qweight_row_tp(qw, tp)
    want = JM.retile_qweight_row_tp(C.to_jax(qw), tp)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    g, w = got.absmax.numpy().astype(np.int64), np.asarray(want.absmax).astype(np.int64)
    assert np.abs(g - w).max() <= 1 and np.mean(g == w) >= 0.999, np.mean(g == w)
    # the sidecars are statistics of the decoded scales, which the two
    # packages decode within 2 ulps of each other (tests/test_torch_compressed.py)
    for name in ("absmax_scale", "absmax_offset"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6)


def test_shard_qweight_guards_as_jax(world):
    outs, _, inp = world
    mesh = j_make_mesh({"model": WORLD})
    for key, W, bs, dim in (("guard_col", inp["W"][:384], 64, "col"),
                            ("guard_row", inp["W"], 512, "row")):
        with pytest.raises(ValueError) as e:
            JM.shard_qweight(C.to_jax(quantize_4bit_native(W, blocksize=bs)), mesh, dim)
        assert all(o[key] == f"ValueError: {e.value}" for o in outs), (outs[0][key], e.value)


# ------------------------------------------------------------ collectives


def test_local_weights_carry_local_shapes(world):
    outs, _, _ = world
    assert all(o["local_shapes"] == ((C.N // WORLD, C.K), (C.N, C.K // WORLD)) for o in outs)


@pytest.mark.parametrize("case", ["col", "col_gather", "row", "row_bias", "all_gather", "col_c",
                                  "row_c", "int8_col", "int8_row"])
def test_collective_matches_jax_single_device(world, case):
    outs, ref, inp = world
    bias = inp["bias"].numpy()
    want = {"col": ref["mm4"], "col_gather": ref["mm4"] + bias, "row": ref["mm4"],
            "row_bias": ref["mm4"] + bias, "all_gather": ref["mm4"], "col_c": ref["mm4_c"],
            "row_c": ref["mm4_c"], "int8_col": ref["int8"], "int8_row": ref["int8_row"]}[case]
    if case == "col":  # each rank's N slice, laid side by side
        got = np.concatenate([_np(o[case]) for o in outs], axis=-1)
    else:  # replicated: every rank holds the same bits
        got = _np(outs[0][case])
        assert all(torch.equal(o[case], outs[0][case]) for o in outs)
    np.testing.assert_allclose(got, want, **TOL)


def test_psum_gives_every_rank_the_sum(world):
    outs, _, _ = world
    assert all(torch.equal(o["psum"], torch.full((3,), 3.0)) for o in outs)


# -------------------------------------------------- sharded 8-bit update


@pytest.mark.parametrize("codec", ["dynamic", "lut"])
def test_sharded_update_bit_equal_to_unsharded(world, codec):
    outs, ref, _ = world
    dyn, lut = C.optim_inputs()
    d, qmaps, step = (dyn, (None, None), 1) if codec == "dynamic" else (lut, C.lut_maps(), 2)
    t = {n: torch.from_numpy(a) for n, a in d.items()}
    whole = TF.optimizer_update_8bit_blockwise(
        "adam", t["g"], t["p"], t["s1"], t["a1"], t["s2"], t["a2"], qmaps[0], qmaps[1], 0.9,
        0.999, 1e-8, step, 1e-3, blocksize=2048, codec="dynamic" if codec == "dynamic" else None)
    for i in range(5):
        got = torch.cat([o[f"opt_{codec}"][i] for o in outs])
        assert torch.equal(got, whole[i]), i
        want = ref[f"opt_{codec}"][i]
        if i == 0:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
        elif i in (1, 3):
            g, w = got.numpy().astype(np.int64), want.astype(np.int64)
            assert np.abs(g - w).max() <= 1 and np.mean(g == w) >= 0.999
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_sharded_update_guards_as_jax(world):
    outs, _, _ = world
    mesh = j_make_mesh({"data": WORLD})
    for key, shape in (("opt_guard_dim0", (3, 4096)), ("opt_guard_blocks", (2, 1024))):
        z = jnp.zeros(shape, jnp.float32)
        with pytest.raises(ValueError) as e:
            JF.optimizer_update_8bit_blockwise_sharded(
                "adam", z, z, None, None, None, None, None, None, 0.9, 0.999, 1e-8, 1, 1e-3,
                mesh=mesh)
        assert all(o[key] == f"ValueError: {e.value}" for o in outs), (outs[0][key], e.value)


@pytest.mark.parametrize("clip", [100, 5], ids=["plain", "percentile_clipping"])
def test_adam8bit_with_mesh_equals_unsharded(world, clip):
    """adam8bit(mesh=) keeps each sharded leaf's rows of the states and
    ends every rank's params where the unsharded optimizer does, bit for
    bit. Under percentile clipping the whole gradient's norm is the ranks'
    squared norms summed in another order, so its clip scale can differ in
    the last bit and flip a state code at a rounding boundary: there
    99.9% of p within 1e-6 and every element within 5% of the learning
    rate (one code step of a state moves p by about 1% of it)."""
    outs, _, _ = world
    key = "opt_class" if clip == 100 else "opt_class_clip"
    want_p, want_s, _ = outs[0][key + "_ref"]  # rank 0 ran the unsharded optimizer
    for r, o in enumerate(outs):
        got_p, got_s, routes = o[key]
        assert routes["grouped"] == len(C.OPT_LEAVES) * C.OPT_STEPS
        for name, shape in C.OPT_LEAVES.items():
            if clip == 100:
                assert torch.equal(got_p[name], want_p[name]), name
            else:
                diff = (got_p[name] - want_p[name]).abs()
                assert (diff <= 1e-6).float().mean() >= 0.999 and diff.max() <= 0.05 * 1e-3
            sharded = shape[0] % WORLD == 0
            rows = shape[0] // WORLD if sharded else shape[0]
            assert got_s[name]["state1"].shape == (rows,) + shape[1:]
            if clip == 100:
                lo = r * rows if sharded else 0
                assert torch.equal(got_s[name]["state1"], want_s[name]["state1"][lo:lo + rows])


def test_param_and_cache_specs_match_jax():
    """The spec trees as plain data (a tuple of mesh-dim names a leaf) are
    the JAX package's PartitionSpecs, leaf for leaf: a tiny NF4 Llama with
    qkv biases, its LLM.int8 twin with outlier sidecars, a stacked-expert
    Mixtral layer, and the caches."""
    from bitsandbytes_sycl_tpu.parallel import llama_tp as JT
    from bitsandbytes_sycl_tpu_torch.models import llama as TL
    from bitsandbytes_sycl_tpu_torch.ops.common import QLinearWeight
    from bitsandbytes_sycl_tpu_torch.parallel import llama_tp as TT

    def same(t, j):
        if isinstance(t, QLinearWeight):
            for name in ("packed", "absmax", "absmax_scale", "absmax_offset"):
                if getattr(t, name) is not None:
                    same(getattr(t, name), getattr(j, name))
        elif isinstance(t, dict):
            assert set(t) == set(j)
            for k in t:
                same(t[k], j[k])
        elif isinstance(t, list):
            assert len(t) == len(j)
            for a, b in zip(t, j):
                same(a, b)
        else:  # trailing Nones say nothing: (axis,) is P(axis, None, None)
            strip = lambda spec: tuple(spec)[:max([i + 1 for i, n in enumerate(spec)  # noqa: E731
                                                   if n is not None], default=0)]
            assert strip(t) == strip(j), (t, j)

    for kw in (dict(attn_bias=True), dict(quant="int8"), dict(num_experts=4),
               dict(compress_stats=True)):
        cfg = TL.LlamaConfig.tiny(num_layers=1, **kw)
        params = TL.init_params(cfg, device="cpu")
        same(TT.llama_param_specs(params, cfg), JT.llama_param_specs(C.to_jax(params), cfg))
    for kv_quant in (True, False):
        cfg = TL.LlamaConfig.tiny(kv_quant=kv_quant)
        same(TT.kv_cache_specs(cfg), JT.kv_cache_specs(cfg))
