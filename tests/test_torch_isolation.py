"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bitsandbytes_sycl_tpu_torch as port
from bitsandbytes_sycl_tpu_torch import convert
from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine, init_page_pool
from bitsandbytes_sycl_tpu_torch.models import llama as TL
from bitsandbytes_sycl_tpu_torch.models.lora import init_lora, lora_leaves
from bitsandbytes_sycl_tpu_torch.ops.common import check_cuda_tensors, resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "bitsandbytes_sycl_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
    for p in PORT.rglob("*.py"))


def test_import_leaves_jax_out():
    assert {f"bitsandbytes_sycl_tpu_torch.{m}" for m in (
        "checkpoints", "native", "legacy", "research", "profiling")} <= set(MODULES)
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'bitsandbytes_sycl_tpu')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_parallel_package_alone_leaves_jax_out():
    """parallel/ holds the JAX package's seven modules, and importing it on
    its own pulls in neither JAX nor the JAX package."""
    names = {p.stem for p in (PORT / "parallel").glob("*.py")}
    assert {"mesh", "collectives", "llama_tp", "gptj_tp", "opt_tp", "pipeline", "ring"} <= names
    code = (
        "import sys\n"
        "import bitsandbytes_sycl_tpu_torch.parallel as P\n"
        "assert P.make_mesh and P.ring_attention and P.llama_forward_pp_decode\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'bitsandbytes_sycl_tpu')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_parallel_entry_points_need_cuda_and_nccl_unless_told(monkeypatch):
    """make_mesh defaults to CUDA and initialize_distributed to NCCL; both
    raise without a GPU unless given the CPU or gloo."""
    import inspect

    from bitsandbytes_sycl_tpu_torch import parallel as P

    assert inspect.signature(P.make_mesh).parameters["device_type"].default == "cuda"
    assert inspect.signature(P.initialize_distributed).parameters["backend"].default == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        P.make_mesh({"model": 1})
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        P.initialize_distributed(world_size=2, rank=0)
    P.initialize_distributed(world_size=1, backend="gloo")  # one process: nothing to do


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    pat = re.compile(r"^\s*(from|import)\s+(jax|bitsandbytes_sycl_tpu)(?!_torch)\b", re.M)
    assert not pat.search(path.read_text()), path


def test_kernel_sources_are_in_the_package():
    from bitsandbytes_sycl_tpu_torch.ops import KERNELS

    names = sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert names == ["decode_attn_int8", "dequant_int8", "dequantize_transposed", "int8_matmul",
                     "mm4_fused", "optim8_1state", "optim8_2state", "paged_attn_int8",
                     "prefill_attn_int8", "w4a8_gemv", "w4a8_grouped"]
    # one wrapper with a launch counter for each source
    assert sorted(k.__name__ for k in KERNELS) == names
    assert all(k.launches == 0 for k in KERNELS)  # the CPU runs no kernel


def test_entry_points_need_cuda_unless_given_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TL.LlamaConfig.tiny(num_layers=1, head_dim=128, num_heads=2, num_kv_heads=1,
                              max_seq_len=128)
    for call in (
        lambda: resolve_device(),
        lambda: TL.init_params(cfg),
        lambda: TL.init_kv_cache(cfg, 1),
        lambda: init_page_pool(cfg, 2, 128),
        lambda: convert.params_from_jax({"embed": np.zeros((2, 2), np.float32)}, cfg),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lora(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lora_from_jax([], None)
    params = TL.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    lora = init_lora(cfg, device="cpu")
    assert all(t.device.type == "cpu" and t.requires_grad for t in lora_leaves(lora))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg, params, EngineConfig(paged=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg, params)  # the default: contiguous cache
    for ecfg in (EngineConfig(paged=True, max_new_tokens=2), EngineConfig(max_new_tokens=2)):
        eng = InferenceEngine(cfg, params, ecfg, device="cpu")
        assert len(eng.generate([[1, 2, 3]])[0]) == 2


def test_wrappers_dispatch_on_the_tensor_device():
    assert check_cuda_tensors("t", torch.zeros(1), None) is False
    with pytest.raises(ValueError):
        check_cuda_tensors("t", torch.zeros(1), torch.zeros(1, device="meta"))
    assert port.QLinearWeight is TL.QLinearWeight


def test_engine_step_records_no_graph(monkeypatch):
    """llama_forward records a graph when an input requires grad (QLoRA
    training); the engine serves under torch.no_grad(), so neither its
    prefill nor its decode steps build one, even with a leaf that requires
    grad in the params."""
    import bitsandbytes_sycl_tpu_torch.engine.engine as E

    cfg = TL.LlamaConfig.tiny(num_layers=1, head_dim=128, num_heads=2, num_kv_heads=1,
                              max_seq_len=128)
    params = TL.init_params(cfg, device="cpu")
    params["final_norm"].requires_grad_()
    seen = []

    def spy(*a, **kw):
        logits, cache = TL.llama_forward(*a, **kw)
        seen.append(logits.requires_grad)
        return logits, cache

    monkeypatch.setattr(E, "llama_forward", spy)
    for ecfg in (EngineConfig(max_new_tokens=3), EngineConfig(paged=True, max_new_tokens=3)):
        eng = InferenceEngine(cfg, params, ecfg, device="cpu")
        assert len(eng.generate([[1, 2, 3], [4, 5]])[0]) == 3
    assert len(seen) >= 4 and not any(seen)
    logits, _ = TL.llama_forward(params, cfg, torch.tensor([[1, 2, 3]]))
    assert logits.requires_grad  # outside the engine the graph is recorded
