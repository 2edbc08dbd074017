"""The port's ``checkpoints`` against the JAX package's on the CPU.

- The bitsandbytes quant-state format: ``quant_state_as_dict`` gives the
  same keys and the same bytes (absmax, code, the JSON-packed fields) as
  the JAX package for the same QuantState, nested and not, and
  ``quant_state_from_dict`` inverts it; ``export_params4bit`` /
  ``import_params4bit`` likewise.
- ``read_safetensors``: every dtype of the JAX reader's table, bit for bit
  against the JAX reader (upcast to f32 where it upcasts) and against the
  ``safetensors`` package, an unaligned tensor included; the ``.bin``
  route through ``torch.load(weights_only=True)``.
- ``save_checkpoint`` / ``load_checkpoint``: quantized weights (raw and
  compressed scales), nested QuantStates, QTensors and plain leaves back
  bit for bit under ``weights_only=True``; and a mid-training 8-bit
  optimizer resume equal to the uninterrupted run (after the JAX
  package's test_checkpoints_utils.py).
"""

import json
import struct

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu import checkpoints as JC
from bitsandbytes_sycl_tpu import functional as JF
from bitsandbytes_sycl_tpu_torch import checkpoints as TC
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch import optim
from bitsandbytes_sycl_tpu_torch.convert import quant_state_from_jax
from bitsandbytes_sycl_tpu_torch.ops.common import QLinearWeight, quantize_4bit_native
from bitsandbytes_sycl_tpu_torch.types import QTensor


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


@pytest.mark.parametrize("quant_type,nested", [("nf4", False), ("nf4", True), ("fp4", True)])
def test_quant_state_dict_bytes_equal_jax(quant_type, nested):
    a = np.random.default_rng(0).normal(size=(64, 128)).astype(np.float32)
    jp, jqs = JF.quantize_4bit(jnp.asarray(a), quant_type=quant_type, compress_statistics=nested)
    tqs = quant_state_from_jax(jqs, device="cpu")
    want = JC.quant_state_as_dict(jqs, packed=True)
    got = TC.quant_state_as_dict(tqs, packed=True)
    assert list(got) == list(want)
    assert f"quant_state.bitsandbytes__{quant_type}" in got
    for k in want:
        assert _bytes(got[k]) == _bytes(want[k]), k
    back = TC.quant_state_from_dict(got)
    assert back.nested == nested and back.shape == (64, 128) and back.quant_type == quant_type
    packed = torch.from_numpy(np.array(jp))
    assert torch.equal(TF.dequantize_4bit(packed, back), TF.dequantize_4bit(packed, tqs))
    # the unpacked form and prefixed keys read back too
    plain = TC.quant_state_as_dict(tqs, packed=False)
    assert TC.quant_state_from_dict({f"w.{k}": v for k, v in plain.items()}).blocksize == 64
    with pytest.raises(ValueError, match="unknown"):
        TC.quant_state_from_dict({**plain, "bogus": 1})


def test_params4bit_export_import_equal_jax():
    a = np.random.default_rng(1).normal(size=(32, 64)).astype(np.float32)
    jp, jqs = JF.quantize_4bit(jnp.asarray(a), quant_type="fp4")
    packed = torch.from_numpy(np.array(jp))
    want = JC.export_params4bit(jp, jqs, prefix="model.layer.weight")
    got = TC.export_params4bit(packed, quant_state_from_jax(jqs, device="cpu"),
                               prefix="model.layer.weight")
    assert list(got) == list(want) and got["model.layer.weight"].shape == (a.size // 2, 1)
    for k in want:
        assert _bytes(got[k]) == _bytes(want[k]), k
    p2, qs2 = TC.import_params4bit(got, prefix="model.layer.weight")
    assert torch.equal(p2, packed)
    np.testing.assert_array_equal(TF.dequantize_4bit(p2, qs2).numpy(),
                                  np.asarray(JF.dequantize_4bit(jp, jqs)))


_SAMPLES = {  # safetensors name -> numpy array (BF16 as its bits)
    "F32": lambda r: r.normal(size=(4, 8)).astype(np.float32),
    "F64": lambda r: r.normal(size=(3,)).astype(np.float64),
    "F16": lambda r: r.normal(size=(3, 5)).astype(np.float16),
    "BF16": lambda r: (r.normal(size=(2, 6)).astype(np.float32).view(np.uint32) >> 16).astype(
        np.uint16),
    "I64": lambda r: r.integers(-2**40, 2**40, size=(7,)).astype(np.int64),
    "I32": lambda r: r.integers(-2**30, 2**30, size=(2, 3)).astype(np.int32),
    "I16": lambda r: r.integers(-2**14, 2**14, size=(5,)).astype(np.int16),
    "U16": lambda r: r.integers(0, 2**16, size=(5,)).astype(np.uint16),
    "I8": lambda r: r.integers(-128, 128, size=(9,)).astype(np.int8),
    "U8": lambda r: r.integers(0, 256, size=(3,)).astype(np.uint8),
    "BOOL": lambda r: r.integers(0, 2, size=(6,)).astype(np.bool_),
}


def _write(path, arrays, dtypes, pad_first=0):
    """A safetensors file by hand; ``pad_first`` bytes of a U8 tensor first
    leave the following tensors unaligned."""
    header, off, blobs = {}, 0, []
    if pad_first:
        arrays = {"pad": np.zeros(pad_first, np.uint8), **arrays}
        dtypes = {"pad": "U8", **dtypes}
    for name, a in arrays.items():
        b = a.tobytes()
        header[name] = {"dtype": dtypes[name], "shape": list(a.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)) + hb + b"".join(blobs))


def _as_f32_bits(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    t = np.asarray(t)
    return t.astype(np.float32) if t.dtype.kind == "f" or t.dtype == ml_dtypes.bfloat16 else t


@pytest.mark.parametrize("pad", [0, 3])
def test_read_safetensors_bit_equal_jax(tmp_path, pad):
    rng = np.random.default_rng(2)
    arrays = {f"t_{k.lower()}": fn(rng) for k, fn in _SAMPLES.items()}
    dtypes = {f"t_{k.lower()}": k for k in _SAMPLES}
    path = str(tmp_path / "x.safetensors")
    _write(path, arrays, dtypes, pad_first=pad)
    want = JC.read_safetensors(path)
    got = TC.read_safetensors(path)
    assert set(got) == set(want)
    for name, a in arrays.items():
        g, w = got[name], want[name]
        assert tuple(g.shape) == a.shape
        if dtypes[name] == "BF16":
            assert g.dtype == torch.bfloat16
            assert np.array_equal(g.view(torch.int16).numpy().view(np.uint16), a)
        elif dtypes[name] == "F64":
            assert g.dtype == torch.float32
        elif dtypes[name] == "F16":
            assert g.dtype == torch.float16
        np.testing.assert_array_equal(_as_f32_bits(g), _as_f32_bits(w))
    # the mapped file is copy-on-write: writing a view leaves the file as it was
    got["t_f32"][0, 0] = 123.0
    assert TC.read_safetensors(path)["t_f32"][0, 0] != 123.0


def test_read_safetensors_matches_the_safetensors_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(3)
    tensors = {"w_bf16": torch.randn(16, 8, generator=g).to(torch.bfloat16),
               "w_f16": torch.randn(5, 4, generator=g).to(torch.float16),
               "w_f32": torch.randn(3, 7, generator=g),
               "ids": torch.arange(11, dtype=torch.int64), "mask": torch.tensor([True, False])}
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path)
    got, want = TC.read_safetensors(path), load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_bin_route_matches_jax(tmp_path):
    g = torch.Generator().manual_seed(4)
    sd = {"a": torch.randn(6, 4, generator=g).to(torch.float16),
          "b": torch.randn(3, generator=g).to(torch.bfloat16), "c": torch.randn(2, 2, generator=g)}
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    got = TC._read_hf_tensors(str(tmp_path))
    want = JC._read_hf_tensors(str(tmp_path))
    for k in sd:
        assert got[k].dtype == sd[k].dtype  # kept as stored; upcast per tensor on load
        np.testing.assert_array_equal(got[k].float().numpy(), want[k])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        TC._read_hf_tensors(str(empty))


def test_save_load_checkpoint_round_trip(tmp_path):
    g = torch.Generator().manual_seed(5)
    W = torch.randn(256, 512, generator=g)
    raw = quantize_4bit_native(W, 64, "nf4", absmax_dtype=torch.bfloat16)
    comp = quantize_4bit_native(W, 64, "nf4", compress_statistics=True)
    packed, qs = TF.quantize_4bit(W, compress_statistics=True)
    tree = {"layers": [{"q_proj": raw, "o_proj": comp}], "bnb": QTensor(packed, qs),
            "qs": qs, "codes": torch.randint(0, 256, (33,), dtype=torch.uint8, generator=g),
            "pair": (torch.ones(2, dtype=torch.bfloat16), 3), "step": 7, "name": "x"}
    path = str(tmp_path / "ck" / "tree.pt")
    TC.save_checkpoint(path, tree)
    # what save_checkpoint wrote reads with weights_only=True
    assert isinstance(torch.load(path, weights_only=True), dict)
    back = TC.load_checkpoint(path, device="cpu")
    assert isinstance(back["layers"][0]["q_proj"], QLinearWeight)
    assert isinstance(back["bnb"], QTensor) and back["bnb"].quant_state.nested
    for a, b in ((raw, back["layers"][0]["q_proj"]), (comp, back["layers"][0]["o_proj"])):
        assert a.shape == b.shape and a.quant_type == b.quant_type
        for f in ("packed", "absmax", "absmax_scale", "absmax_offset"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None and y is None) or (x.dtype == y.dtype and torch.equal(x, y)), f
    assert torch.equal(back["bnb"].dequantize(), QTensor(packed, qs).dequantize())
    assert torch.equal(back["codes"], tree["codes"]) and back["pair"][1] == 3
    assert isinstance(back["pair"], tuple) and back["step"] == 7 and back["name"] == "x"
    # a target places every tensor on the target's device and checks the structure
    again = TC.load_checkpoint(path, target=back)
    assert torch.equal(again["qs"].state2.absmax, qs.state2.absmax)
    with pytest.raises(ValueError):
        TC.load_checkpoint(path, target={"layers": []})


def test_optimizer_resume_mid_training_equals_uninterrupted(tmp_path):
    """Ten adam8bit steps, the params and optimizer state saved, restored
    into a fresh optimizer, ten more steps on both: the same bits, states
    and step count included."""
    rng = np.random.default_rng(0)
    p = torch.tensor(rng.normal(size=(8192,)) * 0.1, dtype=torch.float32, requires_grad=True)
    small = torch.tensor(rng.normal(size=(16,)), dtype=torch.float32, requires_grad=True)
    opt = optim.adam8bit([p, small], 1e-3)

    def step(o, params):
        for q in params:
            q.grad = torch.sin(q.detach())
        o.step()

    for _ in range(10):
        step(opt, [p, small])
    path = str(tmp_path / "ckpt.pt")
    TC.save_checkpoint(path, {"params": [p.detach(), small.detach()], "opt": opt.state_dict()})
    back = TC.load_checkpoint(path, device="cpu")
    p2, s2 = (t.clone().requires_grad_() for t in back["params"])
    opt2 = optim.adam8bit([p2, s2], 1e-3)
    opt2.load_state_dict(back["opt"])
    assert opt2.count == 10
    assert opt2.state[p2]["state1"].dtype == torch.uint8
    assert torch.equal(opt2.state[p2]["state1"], opt.state[p]["state1"])
    for _ in range(10):
        step(opt, [p, small])
        step(opt2, [p2, s2])
    assert torch.equal(p, p2) and torch.equal(small, s2)
    for k, v in opt.state[p].items():
        assert torch.equal(v, opt2.state[p2][k]), k
    assert opt2.route_leaves["grouped"] == 10  # the reloaded 8-bit leaf stayed on the J route
