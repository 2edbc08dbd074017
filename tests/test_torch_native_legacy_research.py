"""The port's ``native``, ``legacy``, ``research`` and ``profiling`` modules
and the last missing names (``codebooks.FP4_SORT_ORDER``,
``functional.QTensor``, the ``*_cublas`` matmuls) against the JAX package
on the CPU.

- ``native``: the host library (built by g++ into the ignored build
  directory) gives the JAX package's bytes for the blockwise 8-bit and
  4-bit quantizers and the bf16/fp16 converters, and the port's torch
  quantizers' bytes; its numpy paths give the same.
- ``legacy``: igemm and batched_igemm exact; the vectorwise family bit for
  bit (zeropoint within one code: XLA contracts ``x * q + z`` into an FMA
  on the CPU); spmm within f32 rounding; the transforms, outliers and
  paged API as the JAX package's; ``matmul_cublas`` equal to the JAX
  package's (the same int8 codes and int32 sums) and its gradients within
  f32 rounding, ``bmm_cublas`` too.
- ``research``: the FP8 matmuls' outputs and gradients equal the JAX
  package's within f32 rounding (the same codes), inside the JAX tests'
  envelopes against the f32 product.
- ``profiling``: ``device_time`` positive on the CPU, ``roofline_report``'s
  fields, ``current_chip()`` the CPU entry without a card, the H100 entry
  by name, ``trace`` writing a Chrome trace.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_sycl_tpu as jbnb
import bitsandbytes_sycl_tpu_torch as bnb
from bitsandbytes_sycl_tpu import codebooks as JCB
from bitsandbytes_sycl_tpu import legacy as JL
from bitsandbytes_sycl_tpu import native as JN
from bitsandbytes_sycl_tpu import research as JR
from bitsandbytes_sycl_tpu_torch import codebooks as TCB
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch import legacy as TL
from bitsandbytes_sycl_tpu_torch import native as TN
from bitsandbytes_sycl_tpu_torch import profiling as TP
from bitsandbytes_sycl_tpu_torch import research as TR
from bitsandbytes_sycl_tpu_torch import types as TT

F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------- native


def test_native_library_builds_into_the_build_directory():
    lib = TN.get_native_library()
    assert lib is not None and "build/bnb_torch_native" in lib._name
    assert lib.quant_cpu_version() >= 2


@pytest.mark.parametrize("n", [4096, 3000])
def test_native_quantizers_equal_jax_and_the_torch_quantizers(n):
    A = np.random.default_rng(0).normal(size=(n,)).astype(np.float32)
    code8 = np.sort(JCB.create_dynamic_map().astype(np.float32))
    got, want = TN.quantize_blockwise_np(A, code8, 256), JN.quantize_blockwise_np(A, code8, 256)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    for qt in ("nf4", "fp4"):
        code16 = JCB.get_4bit_type(qt)
        got, want = TN.quantize_4bit_np(A, code16, 64), JN.quantize_4bit_np(A, code16, 64)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        packed, qs = TF.quantize_4bit(torch.from_numpy(A), blocksize=64, quant_type=qt)
        assert np.array_equal(got[0], packed.numpy()) and np.array_equal(got[1], qs.absmax.numpy())


def test_native_converters_and_numpy_paths(monkeypatch):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2**16, size=(70001,)).astype(np.uint16)
    bits[bits & 0x7C00 == 0x7C00] = 0  # no fp16 NaN payloads: compare values
    for t_fn, j_fn in ((TN.bf16_to_f32, JN.bf16_to_f32), (TN.fp16_to_f32, JN.fp16_to_f32)):
        np.testing.assert_array_equal(t_fn(bits).view(np.uint32), j_fn(bits).view(np.uint32))
    A = rng.normal(size=(64, 200)).astype(np.float32)
    code16, code8 = JCB.get_4bit_type("nf4"), np.sort(JCB.create_dynamic_map()).astype(np.float32)
    with_lib = (TN.quantize_4bit_np(A, code16, 64), TN.quantize_blockwise_np(A, code8, 64),
                TN.bf16_to_f32(bits))
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_tried", True)  # the numpy paths
    without = (TN.quantize_4bit_np(A, code16, 64), TN.quantize_blockwise_np(A, code8, 64),
               TN.bf16_to_f32(bits))
    for a, b in zip(with_lib[:2], without[:2]):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    np.testing.assert_array_equal(with_lib[2], without[2])


def test_the_last_names():
    np.testing.assert_array_equal(TCB.FP4_SORT_ORDER, JCB.FP4_SORT_ORDER)
    assert TF.QTensor is TT.QTensor


# ---------------------------------------------------------------- legacy


def test_igemm_exact():
    rng = np.random.default_rng(2)
    A = rng.integers(-128, 128, (32, 64)).astype(np.int8)
    B = rng.integers(-128, 128, (64, 48)).astype(np.int8)
    A3 = rng.integers(-64, 64, (4, 16, 32)).astype(np.int8)
    B3 = rng.integers(-64, 64, (4, 16, 24)).astype(np.int8)
    B2 = rng.integers(-64, 64, (32, 24)).astype(np.int8)
    Ab = rng.integers(-50, 50, (3, 8, 16)).astype(np.int8)
    Bb = rng.integers(-50, 50, (3, 16, 12)).astype(np.int8)
    t = torch.from_numpy
    for got, want in ((TL.igemm(t(A), t(B)), JL.igemm(jnp.asarray(A), jnp.asarray(B))),
                      (TL.igemm(t(A3), t(B3)), JL.igemm(jnp.asarray(A3), jnp.asarray(B3))),
                      (TL.igemm(t(A3), t(B2)), JL.igemm(jnp.asarray(A3), jnp.asarray(B2))),
                      (TL.batched_igemm(t(Ab), t(Bb)),
                       JL.batched_igemm(jnp.asarray(Ab), jnp.asarray(Bb)))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant_type", ["linear", "vector", "row", "truncated-vector",
                                        "zeropoint", "vector-zeropoint"])
def test_vectorwise_quant_matches_jax(quant_type):
    x = np.random.default_rng(3).normal(size=(32, 64)).astype(np.float32)
    tq, ts = TL.vectorwise_quant(torch.from_numpy(x), dim=1, quant_type=quant_type)
    jq, js = JL.vectorwise_quant(jnp.asarray(x), dim=1, quant_type=quant_type)
    assert tq.dtype == torch.int8
    if "zeropoint" in quant_type:
        assert np.abs(tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32)).max() <= 1
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        return
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    if quant_type in ("linear", "vector"):
        np.testing.assert_allclose(TL.vectorwise_dequant(tq, ts, quant_type).numpy(),
                                   np.asarray(JL.vectorwise_dequant(jq, js, quant_type)), **F32_TOL)


def test_vectorwise_epilogues_match_jax():
    rng = np.random.default_rng(4)
    xq = rng.integers(-5000, 5000, (8, 12)).astype(np.int32)
    S1 = rng.uniform(0.5, 2, (8, 1)).astype(np.float32)
    S2 = rng.uniform(0.5, 2, (1, 12)).astype(np.float32)
    got = TL.vectorwise_mm_dequant(torch.from_numpy(xq), torch.from_numpy(S1),
                                   torch.from_numpy(S2), dtype=torch.float32)
    want = JL.vectorwise_mm_dequant(jnp.asarray(xq), jnp.asarray(S1), jnp.asarray(S2),
                                    dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    A = rng.integers(-127, 127, (8, 16)).astype(np.int8)
    B = rng.integers(-127, 127, (16, 12)).astype(np.int8)
    SA, SB = (np.float32(1.5), np.float32(0.25)), (np.float32(2.0),)
    got = TL.dequant_min_max(torch.from_numpy(xq), torch.from_numpy(A), torch.from_numpy(B),
                             [torch.tensor(v) for v in SA], [torch.tensor(v) for v in SB],
                             dtype=torch.float32)
    want = JL.dequant_min_max(jnp.asarray(xq), jnp.asarray(A), jnp.asarray(B), SA, SB,
                              dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _coo(mod, rng, rows, cols, nnz, conv):
    ri = rng.integers(0, rows, nnz).astype(np.int32)
    ci = rng.integers(0, cols, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    return mod.COOSparseTensor(rows, cols, nnz, conv(ri), conv(ci), conv(vals))


def test_sparse_containers_and_spmm_match_jax():
    t = torch.from_numpy
    tcoo = _coo(TL, np.random.default_rng(5), 16, 32, 40, t)
    jcoo = _coo(JL, np.random.default_rng(5), 16, 32, 40, jnp.asarray)
    B = np.random.default_rng(6).normal(size=(32, 24)).astype(np.float32)
    np.testing.assert_allclose(TL.spmm_coo(tcoo, t(B)).numpy(),
                               np.asarray(JL.spmm_coo(jcoo, jnp.asarray(B))), **F32_TOL)
    B8 = np.random.default_rng(7).integers(-127, 127, (32, 12)).astype(np.int8)
    stats = np.random.default_rng(8).random(32).astype(np.float32) + 0.5
    np.testing.assert_allclose(
        TL.spmm_coo_very_sparse(tcoo, t(B8), t(stats)).numpy(),
        np.asarray(JL.spmm_coo_very_sparse(jcoo, jnp.asarray(B8), jnp.asarray(stats))), **F32_TOL)
    for conv in ("coo2csr", "coo2csc"):
        a, b = getattr(TL, conv)(tcoo), getattr(JL, conv)(jcoo)
        for f in ("rowptr", "colptr", "rowidx", "colidx", "values"):
            if hasattr(b, f):
                np.testing.assert_array_equal(_np(getattr(a, f)), np.asarray(getattr(b, f)), f)
    z = TL.coo_zeros(4, 4, 3)
    assert z.nnz == 3 and z.values.shape == (3,) and int(z.rowidx.sum()) == 0


def test_transforms_outliers_and_paged_api():
    A = torch.arange(12, dtype=torch.int8).reshape(3, 4)
    out, state = TL.transform(A, to_order="col32")
    assert torch.equal(out, A) and state == ((3, 4), "col32")
    out_t, _ = TL.transform(A, to_order="col_turing", transpose=True)
    assert out_t.shape == (4, 3)
    jA = jnp.arange(12, dtype=jnp.int8).reshape(3, 4)
    np.testing.assert_array_equal(TL.extract_outliers(A, state, torch.tensor([1, 3])).numpy(),
                                  np.asarray(JL.extract_outliers(jA, None, jnp.asarray([1, 3]))))
    t = TL.get_paged(4, 4, dtype=torch.float32, device="cpu")
    assert t.shape == (4, 4) and TL.prefetch_tensor(t) is None
    assert t in TL.GlobalPageManager.get_instance().paged_tensors
    TL.GlobalPageManager.get_instance().prefetch_all()
    assert torch.equal(TL.fill(t, 3.0), torch.full((4, 4), 3.0)) and float(t.sum()) == 0
    assert TL.arange(t).max() == 15 and torch.equal(TL._mul(t + 2, t + 3), torch.full((4, 4), 6.0))


def test_matmul_cublas_matches_jax_value_and_gradient():
    rng = np.random.default_rng(9)
    A = rng.normal(size=(2, 8, 64)).astype(np.float32)
    B = rng.normal(size=(64, 24)).astype(np.float32)
    ta = torch.from_numpy(A).requires_grad_()
    tb = torch.from_numpy(B).requires_grad_()
    out = bnb.matmul_cublas(ta, tb)
    (out * out).sum().backward()
    want, vjp = jax.vjp(lambda a, b: jbnb.matmul_cublas(a, b), jnp.asarray(A), jnp.asarray(B))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    gA, gB = vjp(2 * want)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gA), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gB), rtol=1e-4, atol=1e-4)
    assert bnb.mm_cublas is not None and torch.equal(bnb.mm_cublas(ta, tb), out)
    A3 = rng.normal(size=(2, 8, 32)).astype(np.float32)
    B3 = rng.normal(size=(2, 32, 16)).astype(np.float32)
    np.testing.assert_allclose(
        bnb.bmm_cublas(torch.from_numpy(A3), torch.from_numpy(B3)).numpy(),
        np.asarray(jbnb.bmm_cublas(jnp.asarray(A3), jnp.asarray(B3))), **F32_TOL)


def test_the_root_exports_legacy_and_research():
    assert bnb.legacy is TL and bnb.research is TR
    assert {"legacy", "matmul_cublas", "mm_cublas", "bmm_cublas"} <= set(bnb.__all__)


# ---------------------------------------------------------------- research


@pytest.mark.parametrize("name", ["matmul_fp8_mixed", "matmul_fp8_global"])
def test_fp8_matmuls_match_jax(name):
    rng = np.random.default_rng(10)
    m, k, n = 32, 64, 48
    A = rng.normal(size=(m, k)).astype(np.float32)
    B = (rng.normal(size=(k, n)) * np.sqrt(2.0 / (k + n))).astype(np.float32)
    tgt = rng.normal(size=(m, n)).astype(np.float32)
    ta = torch.from_numpy(A).requires_grad_()
    tb = torch.from_numpy(B).requires_grad_()
    out = getattr(TR, name)(ta, tb)
    ((out - torch.from_numpy(tgt)) ** 2).mean().backward()
    jfn = getattr(JR, name)
    want = jfn(jnp.asarray(A), jnp.asarray(B))
    gA, gB = jax.grad(lambda a, b: jnp.mean((jfn(a, b) - tgt) ** 2), argnums=(0, 1))(
        jnp.asarray(A), jnp.asarray(B))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gA), **F32_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gB), **F32_TOL)
    # the JAX tests' envelope against the f32 product
    assert np.abs(out.detach().numpy() - A @ B).mean() < 0.115
    # bf16 passes through, empty inputs give empty outputs and zero gradients
    y = getattr(TR, name)(ta.detach().to(torch.bfloat16), tb.detach().to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    e = torch.zeros((0, k), requires_grad=True)
    b2 = tb.detach().clone().requires_grad_()
    out0 = getattr(TR, name)(e, b2)
    out0.sum().backward()
    assert out0.shape == (0, n) and float(b2.grad.abs().sum()) == 0.0


def test_fp8_default_codes_equal_jax():
    for t, j in zip(TR.default_fp8_codes(), JR.default_fp8_codes()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------- profiling


def test_profiling_on_the_cpu(tmp_path, caplog):
    x = torch.randn(128, 128)
    t = TP.device_time(lambda a: a @ a, x, lo_iters=10, hi_iters=60, reps=3)
    assert t > 0
    r = TP.roofline_report("mm", lambda a: a @ a, x, flops=2 * 128 ** 3,
                           bytes_accessed=3 * 4 * 128 ** 2, lo_iters=10, hi_iters=60, reps=3)
    assert set(r) == {"name", "chip", "time_us", "achieved_tflops", "achieved_gbps",
                      "frac_mxu_roofline", "frac_hbm_roofline"}
    assert r["chip"] == "cpu" and r["time_us"] > 0 and r["achieved_tflops"] > 0
    assert TP.current_chip() is TP.CHIP_SPECS["cpu"]  # no card here
    h100 = TP.CHIP_SPECS["H100"]
    assert (h100.hbm_gbps, h100.bf16_tflops, h100.int8_tops) == (3350.0, 989.0, 1979.0)
    with TP.trace(str(tmp_path / "trace")):
        (x @ x).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with caplog.at_level(logging.INFO, logger="bitsandbytes_sycl_tpu_torch"):
        TP.log_metrics(3, loss=torch.tensor(1.5), tokens_per_s=10)
    assert '"step": 3' in caplog.text and '"loss": 1.5' in caplog.text


def test_current_chip_names_the_h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert TP.current_chip().name == "H100"
