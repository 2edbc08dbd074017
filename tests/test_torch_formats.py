"""The port's 4-bit formats against the JAX package: codebooks, quantized
bytes and scales (bit-identical), dequantize (exact) and 4-bit packing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu import codebooks as jcb
from bitsandbytes_sycl_tpu import functional as JF
from bitsandbytes_sycl_tpu.ops.common import quantize_4bit_native as j_quantize
from bitsandbytes_sycl_tpu_torch import codebooks as tcb
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch.convert import tensor_from_numpy
from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native as t_quantize


@pytest.mark.parametrize("qt", ["nf4", "fp4", "int4", "af4"])
def test_codebooks_equal(qt):
    a, b = jcb.get_4bit_type(qt), tcb.get_4bit_type(qt)
    np.testing.assert_array_equal(a, b)
    assert np.signbit(a).tolist() == np.signbit(b).tolist()  # int4 keeps its -0.0
    np.testing.assert_array_equal(jcb.code_midpoints(np.sort(a)), tcb.code_midpoints(np.sort(b)))


def _weight(seed=0):
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(256, 1024)) * 0.02).astype(np.float32)
    W[3, :128] = 0.0  # an all-zero block (every blocksize)
    W[5, 70] = np.nan
    return W


@pytest.mark.parametrize("absmax_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [64, 128])
@pytest.mark.parametrize("qt", ["nf4", "fp4", "int4", "af4"])
def test_quantize_bytes_bit_identical(qt, bs, absmax_dtype):
    W = _weight()
    a = j_quantize(jnp.asarray(W), blocksize=bs, quant_type=qt, absmax_dtype=jnp.dtype(absmax_dtype))
    b = t_quantize(torch.from_numpy(W), blocksize=bs, quant_type=qt,
                   absmax_dtype=getattr(torch, absmax_dtype))
    np.testing.assert_array_equal(np.asarray(a.packed), b.packed.numpy())
    assert str(b.absmax.dtype) == f"torch.{absmax_dtype}"
    ja = tensor_from_numpy(np.asarray(a.absmax), "cpu")
    assert ja.dtype == b.absmax.dtype
    # raw bits equal; a NaN scale (the block holding the NaN) only has to be NaN
    bits = torch.int16 if absmax_dtype == "bfloat16" else torch.int32
    nan = torch.isnan(ja)
    assert torch.equal(nan, torch.isnan(b.absmax)) and int(nan.sum()) == 1
    np.testing.assert_array_equal(ja.view(bits)[~nan].numpy(), b.absmax.view(bits)[~nan].numpy())
    assert (b.shape, b.blocksize, b.quant_type, b.dtype) == (a.shape, a.blocksize, a.quant_type, a.dtype)


@pytest.mark.parametrize("absmax_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qt", ["nf4", "fp4", "int4", "af4"])
def test_dequantize_equal(qt, absmax_dtype):
    W = _weight(1)
    W[5, 70] = 0.0
    a = j_quantize(jnp.asarray(W), blocksize=64, quant_type=qt, absmax_dtype=jnp.dtype(absmax_dtype))
    b = t_quantize(torch.from_numpy(W), blocksize=64, quant_type=qt,
                   absmax_dtype=getattr(torch, absmax_dtype))
    np.testing.assert_array_equal(np.asarray(a.dequantize(), np.float32), b.dequantize().numpy())


def test_quantize_rejects_what_jax_rejects():
    with pytest.raises(ValueError):
        t_quantize(torch.zeros((8, 96)), blocksize=64)
    # compressed statistics are ported (tests/test_torch_compressed.py) and
    # reject what the JAX package rejects
    with pytest.raises(ValueError):
        t_quantize(torch.zeros((8, 96)), blocksize=64, compress_statistics=True)
    assert t_quantize(torch.zeros((8, 128)), blocksize=64, compress_statistics=True).compressed


def test_pack_unpack_4bit_match():
    codes = np.random.default_rng(2).integers(0, 16, 33).astype(np.uint8)
    a = np.asarray(JF.pack_4bit(jnp.asarray(codes)))
    b = TF.pack_4bit(torch.from_numpy(codes))
    np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(TF.unpack_4bit(b, 33).numpy(), codes)


def test_bf16_numpy_reads_through_uint16():
    x = jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))
