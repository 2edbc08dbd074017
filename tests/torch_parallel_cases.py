"""The rank side of tests/test_torch_parallel.py and
tests/test_torch_parallel_models.py: the inputs (from seeds, so every
process builds the same ones) and what each rank of a gloo world computes
with the port's ``parallel`` package on the CPU.

Run as a script, one process per rank:
``python tests/torch_parallel_cases.py SUITE RANK WORLD DIR`` joins the
world through ``DIR/store`` (``init_method=file://``), runs SUITE ("ops" or
"models") on one thread and writes ``DIR/out<RANK>.pt``. It imports no JAX.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bitsandbytes_sycl_tpu_torch import functional as F  # noqa: E402
from bitsandbytes_sycl_tpu_torch.models import gptj as TG  # noqa: E402
from bitsandbytes_sycl_tpu_torch.models import llama as TL  # noqa: E402
from bitsandbytes_sycl_tpu_torch.models import opt as TO  # noqa: E402
from bitsandbytes_sycl_tpu_torch.models.bloom import BloomConfig  # noqa: E402
from bitsandbytes_sycl_tpu_torch.models.lora import init_lora, stack_lora  # noqa: E402
from bitsandbytes_sycl_tpu_torch.models.mixtral import MixtralConfig  # noqa: E402
from bitsandbytes_sycl_tpu_torch.models.phi import PhiConfig  # noqa: E402
from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native  # noqa: E402

# ------------------------------------------------------------------ ops

N, K = 512, 1024  # the JAX package's tests/test_parallel.py shapes
OPT_ROWS, OPT_COLS = 64, 2048  # 32 rows = 32 blocks of 2048 per rank at world 2


def ops_inputs():
    rng = np.random.default_rng(0)
    W = torch.from_numpy((rng.normal(size=(N, K)) * 0.02).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(8, K)).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=(N,)) * 0.1).astype(np.float32))
    return dict(
        W=W, x=x, bias=bias,
        qw=quantize_4bit_native(W, blocksize=64, quant_type="nf4"),
        qwc=quantize_4bit_native(W, blocksize=64, quant_type="nf4", compress_statistics=True),
        int8=F.int8_vectorwise_quant(W),
    )


def lut_maps():
    """Two sorted 256-entry tables (the JAX package's custom-qmap test)."""
    rng = np.random.default_rng(5)
    q1 = np.sort(np.unique(np.tanh(rng.normal(size=400)))).astype(np.float32)[:256]
    q2 = np.sort(np.unique(np.abs(np.tanh(rng.normal(size=500)))))[:256].astype(np.float32)
    return q1, q2


def optim_inputs():
    """(dynamic-codec args at step 1, LUT-codec args at step 2): g, p and
    the states of a (64, 2048) leaf."""
    rng = np.random.default_rng(0)
    g = (rng.normal(size=(OPT_ROWS, OPT_COLS)) * 1e-2).astype(np.float32)
    p = (rng.normal(size=(OPT_ROWS, OPT_COLS)) * 1e-1).astype(np.float32)
    n = OPT_ROWS * OPT_COLS
    dyn = dict(g=g, p=p, s1=np.full(g.shape, 127, np.uint8), a1=np.zeros((n // 2048,), np.float32),
               s2=np.zeros(g.shape, np.uint8), a2=np.zeros((n // 2048,), np.float32))
    rng = np.random.default_rng(6)
    lut = dict(g=(rng.normal(size=g.shape) * 1e-2).astype(np.float32),
               p=(rng.normal(size=g.shape) * 1e-1).astype(np.float32),
               s1=rng.integers(0, 256, g.shape).astype(np.uint8),
               a1=(np.abs(rng.normal(size=(n // 2048,))) * 1e-3).astype(np.float32),
               s2=rng.integers(0, 256, g.shape).astype(np.uint8),
               a2=(np.abs(rng.normal(size=(n // 2048,))) * 1e-5).astype(np.float32))
    return dyn, lut


# leaves of the optimizer-class case: two that shard at world 2 and one
# that does not (dim 0 of 7)
OPT_LEAVES = {"w": (OPT_ROWS, OPT_COLS), "v": (6, 4096), "odd": (7, 4096)}
OPT_STEPS = 3


def optim_leaves():
    rng = np.random.default_rng(3)
    params = {k: torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
              for k, s in OPT_LEAVES.items()}
    grads = [{k: torch.from_numpy((rng.normal(size=s) * 0.01).astype(np.float32))
              for k, s in OPT_LEAVES.items()} for _ in range(OPT_STEPS)]
    return params, grads


def run_optimizer(mesh=None, clip=100):
    """adam8bit over OPT_LEAVES for OPT_STEPS steps; returns the final
    params and (local) states."""
    from bitsandbytes_sycl_tpu_torch import optim

    params, grads = optim_leaves()
    opt = optim.adam8bit(list(params.values()), 1e-3, min_8bit_size=1024,
                         percentile_clipping=clip, mesh=mesh)
    for gs in grads:
        for k, p in params.items():
            p.grad = gs[k].clone()
        opt.step()
    states = {k: {n: v.clone() for n, v in opt.state[p].items()} for k, p in params.items()}
    return {k: p.detach().clone() for k, p in params.items()}, states, dict(opt.route_leaves)


def _msg(fn):
    try:
        fn()
    except Exception as e:  # the message is what the test compares
        return f"{type(e).__name__}: {e}"
    return None


def ops_rank(rank, world):
    from bitsandbytes_sycl_tpu_torch import parallel as P
    from bitsandbytes_sycl_tpu_torch.parallel.mesh import psum

    mesh = P.make_mesh({"model": world}, device_type="cpu")
    dmesh = P.make_mesh({"data": world}, device_type="cpu")
    inp = ops_inputs()
    x, qw, qwc, bias = inp["x"], inp["qw"], inp["qwc"], inp["bias"]
    CB, SCB = inp["int8"]
    out = {}
    qc, qr = P.shard_qweight(qw, mesh, "col"), P.shard_qweight(qw, mesh, "row")
    out["local_shapes"] = (qc.shape, qr.shape)
    out["col"] = P.tp_matmul_4bit_col(x, qc, mesh)
    out["col_gather"] = P.tp_matmul_4bit_col(x, qc, mesh, bias=bias, gather_output=True)
    out["row"] = P.tp_matmul_4bit_row(x, qr, mesh)
    out["row_bias"] = P.tp_matmul_4bit_row(x, qr, mesh, bias=bias)
    out["all_gather"] = P.tp_all_gather_matmul_4bit(x, qc, mesh)
    out["col_c"] = P.tp_matmul_4bit_col(x, P.shard_qweight(qwc, mesh, "col"), mesh,
                                        gather_output=True)
    out["row_c"] = P.tp_matmul_4bit_row(x, P.shard_qweight(qwc, mesh, "row"), mesh)
    rows, cols = N // world, K // world
    out["int8_col"] = P.tp_matmul_int8_col(x, CB[rank * rows:(rank + 1) * rows],
                                           SCB[rank * rows:(rank + 1) * rows], mesh,
                                           gather_output=True)
    out["int8_row"] = P.tp_matmul_int8_row(x, CB[:, rank * cols:(rank + 1) * cols].contiguous(),
                                           SCB, mesh)
    # guards, with the JAX package's messages
    out["guard_col"] = _msg(lambda: P.shard_qweight(
        quantize_4bit_native(inp["W"][:384], blocksize=64), mesh, "col"))
    out["guard_row"] = _msg(lambda: P.shard_qweight(
        quantize_4bit_native(inp["W"], blocksize=512), mesh, "row"))
    out["psum"] = psum(torch.full((3,), float(rank + 1)), P.mesh.axis_group(mesh, "model"))
    # the sharded 8-bit update, both codecs, this rank's rows
    dyn, lut = optim_inputs()
    r0, r1 = rank * OPT_ROWS // world, (rank + 1) * OPT_ROWS // world
    nb = (OPT_ROWS // world) * OPT_COLS // 2048
    sl = lambda a, i: torch.from_numpy(a[r0:r1] if i == 0 else a[rank * nb:(rank + 1) * nb])  # noqa
    for key, d, qmaps, step in (("dynamic", dyn, (None, None), 1), ("lut", lut, lut_maps(), 2)):
        out[f"opt_{key}"] = F.optimizer_update_8bit_blockwise_sharded(
            "adam", torch.from_numpy(d["g"]), torch.from_numpy(d["p"]), sl(d["s1"], 0),
            sl(d["a1"], 1), sl(d["s2"], 0), sl(d["a2"], 1), qmaps[0], qmaps[1], 0.9, 0.999,
            1e-8, step, 1e-3, mesh=dmesh, blocksize=2048,
            codec="dynamic" if key == "dynamic" else None)
    out["opt_guard_dim0"] = _msg(lambda: F.optimizer_update_8bit_blockwise_sharded(
        "adam", torch.zeros(3, 4096), torch.zeros(3, 4096), None, None, None, None,
        mesh=dmesh))
    out["opt_guard_blocks"] = _msg(lambda: F.optimizer_update_8bit_blockwise_sharded(
        "adam", torch.zeros(2, 1024), torch.zeros(2, 1024), None, None, None, None,
        mesh=dmesh))
    out["opt_class"] = run_optimizer(dmesh)
    out["opt_class_clip"] = run_optimizer(dmesh, clip=5)
    if rank == 0:  # the unsharded references, beside the test process's JAX work
        out["opt_class_ref"] = run_optimizer()
        out["opt_class_clip_ref"] = run_optimizer(clip=5)
    return out


# --------------------------------------------------------------- models

B, T = 2, 8


def llama_cfg(**kw):
    """The JAX package's TP test config (f32, NF4, head_dim 128)."""
    d = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
             num_heads=4, num_kv_heads=4, head_dim=128, max_seq_len=128, quant="nf4",
             kv_quant=True, dtype=torch.float32, a8_decode=False)
    d.update(kw)
    return TL.LlamaConfig(**d)


A8_CFG = dict(hidden_size=512, intermediate_size=1024, max_seq_len=32, kv_quant=False,
              a8_decode=True)
INT8_CFG = dict(max_seq_len=64, quant="int8", kv_quant=False)


def family_cfgs():
    """name -> (config, init function, forward) of the TP = 4 families (the
    JAX package's tests/test_parallel.py configs)."""
    common = dict(vocab_size=256, hidden_size=512, num_layers=2, max_seq_len=64, quant="nf4",
                  kv_quant=True, dtype=torch.float32, a8_decode=False)
    return {
        "gptj": (TG.GPTJConfig(num_heads=4, rotary_dim=32, **common), TG.init_gptj_params,
                 TG.gptj_forward),
        "phi": (PhiConfig(num_heads=4, rotary_dim=64, **common), TG.init_gptj_params,
                TG.gptj_forward),
        "opt": (TO.OPTConfig(num_heads=4, ffn_dim=1024, **common), TO.init_opt_params,
                TO.opt_forward),
        "bloom": (BloomConfig.tiny(num_heads=8, ffn_dim=1024, **common), TO.init_opt_params,
                  TO.opt_forward),
    }


FAMILY_T = 6
# the families whose TP = 4 decode step is held against JAX too (BLOOM: the
# ALiBi slope blocks over the cache); the others' prefill only (the Llama
# cases hold the TP decode of the shared cache and attention)
FAMILY_DECODED = ("bloom",)


def family_params(name):
    cfg, init, _ = family_cfgs()[name]
    params = init(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(9)
    for layer in params["layers"]:  # non-zero biases, so their sharded adds show
        for k, v in layer.items():
            if k.endswith(("_b", "_bias")):
                layer[k] = torch.randn(v.shape, generator=gen) * 0.02
    return params


def tokens(seed, b=B, t=T):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int64))


def mixtral_cfg():
    return MixtralConfig.tiny(dtype=torch.float32, a8_decode=False, head_dim=128)


ENGINE_PROMPTS = [[1, 2, 3], [7, 8], [4, 5, 6, 9], [10]]


def engine_cfg():
    # a8_decode=False: the exact path (W4A8 x TP noise is the a8 case's)
    return TL.LlamaConfig.tiny(quant="nf4", dtype=torch.float32, head_dim=128, a8_decode=False)


def engine_lora(cfg):
    adapters = []
    for seed in (1, 2):
        a = init_lora(cfg, seed=seed, rank=4, targets=("q_proj", "o_proj"), device="cpu")
        gen = torch.Generator().manual_seed(10 + seed)
        for layer in a:
            for ab in layer.values():
                ab["B"] = (torch.randn(ab["B"].shape, generator=gen) * 0.05).requires_grad_()
        adapters.append(a)
    return stack_lora(adapters)


def run_engines(cfg, params, mesh=None, tp_axis="model"):
    """Greedy tokens of the contiguous and paged engines, the stacked-lora
    engine and speculative decoding (the same params as the draft)."""
    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(max_batch=2, max_new_tokens=6, prefill_buckets=(16, 32))
    kw = dict(device="cpu", mesh=mesh, tp_axis=tp_axis)
    out = {"contiguous": InferenceEngine(cfg, params, ecfg, **kw).generate(ENGINE_PROMPTS),
           "paged": InferenceEngine(cfg, params, dataclasses.replace(ecfg, paged=True),
                                    **kw).generate(ENGINE_PROMPTS)}
    with torch.no_grad():
        lora = engine_lora(cfg)
    eng = InferenceEngine(cfg, params, dataclasses.replace(ecfg, prefill_buckets=(16,)),
                          lora=lora, **kw)
    out["lora"] = eng.generate([[1, 2, 3], [1, 2, 3]], adapter_ids=[0, 1])
    eng = InferenceEngine(cfg, params, ecfg, **kw)
    out["speculative"] = eng.generate_speculative([[1, 2, 3, 4], [9, 8, 7, 6]], 6, params, cfg,
                                                  gamma=3)
    return out


def ring_inputs():
    rng = np.random.default_rng(9)
    return [torch.from_numpy(rng.normal(size=(2, 64, 4, 128)).astype(np.float32))
            for _ in range(3)]


def models_rank(rank, world):
    from bitsandbytes_sycl_tpu_torch import parallel as P
    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
    from bitsandbytes_sycl_tpu_torch.parallel.llama_tp import local_config

    mesh2 = P.make_mesh({"data": 2, "model": 2}, device_type="cpu")
    mesh4 = P.make_mesh({"model": 4}, device_type="cpu")
    out = {}
    pos = torch.arange(T).expand(B, T)
    posd = torch.full((B, 1), T)
    toks = tokens(0, t=T + 1)

    # Llama TP = 2: prefill and a cached decode step
    cfg = llama_cfg()
    params = TL.init_params(cfg, seed=0, device="cpu")
    sp = P.shard_llama_params(params, cfg, mesh2)
    cache = TL.init_kv_cache(local_config(cfg, 2), B, device="cpu")
    lp, cache = P.llama_forward_tp(sp, cfg, toks[:, :T], cache, pos, mesh2)
    ld, _ = P.llama_forward_tp(sp, cfg, toks[:, T:], cache, posd, mesh2)
    out["llama"] = (lp, ld)
    # W4A8 decode (one token at position 0, bf16-free f32 cache)
    cfg8 = llama_cfg(**A8_CFG)
    p8 = TL.init_params(cfg8, seed=6, device="cpu")
    out["llama_a8"] = P.llama_forward_tp(
        P.shard_llama_params(p8, cfg8, mesh2), cfg8, toks[:, :1],
        TL.init_kv_cache(local_config(cfg8, 2), B, device="cpu"),
        torch.zeros((B, 1), dtype=torch.long), mesh2)[0]
    # LLM.int8, cacheless
    cfgi = llama_cfg(**INT8_CFG)
    pi = TL.init_params(cfgi, seed=7, device="cpu")
    out["llama_int8"] = P.llama_forward_tp(P.shard_llama_params(pi, cfgi, mesh2), cfgi,
                                           toks[:, :T], None, pos, mesh2)[0]
    # Mixtral, expert parallel (2 experts a rank), cacheless
    cfgm = mixtral_cfg()
    pm = TL.init_params(cfgm, seed=2, device="cpu")
    out["mixtral"] = P.llama_forward_tp(P.shard_llama_params(pm, cfgm, mesh2), cfgm,
                                        toks[:, :T], None, pos, mesh2)[0]
    # the families at TP = 4: prefill and a cached decode step
    for name, (fcfg, _, _) in family_cfgs().items():
        fp = family_params(name)
        shard, fwd = ((P.shard_gptj_params, P.gptj_forward_tp) if name in ("gptj", "phi")
                      else (P.shard_opt_params, P.opt_forward_tp))
        spf = shard(fp, fcfg, mesh4)
        ft = tokens(2, t=FAMILY_T + 1)
        fpos = torch.arange(FAMILY_T).expand(B, FAMILY_T)
        fc = TL.init_kv_cache(local_config(fcfg, 4), B, device="cpu")
        lp_f, fc = fwd(spf, fcfg, ft[:, :FAMILY_T], fc, fpos, mesh4)
        out[name] = [lp_f]
        if name in FAMILY_DECODED:
            out[name].append(fwd(spf, fcfg, ft[:, FAMILY_T:], fc, torch.full((B, 1), FAMILY_T),
                                 mesh4)[0])
    # pipeline: 2 stages ("data") x 2 microbatches, cacheless; then cached
    # prefill + decode, without and with TP inside the stage ("model")
    layers, rest = P.stack_stage_params(params, cfg, 2, mesh2, axis="data")
    out["pp"] = P.llama_forward_pp(layers, rest, cfg, toks[:, :T], mesh2, n_micro=2, axis="data")
    for key, tp_axis in (("pp_decode", None), ("pp_decode_tp", "model")):
        layers, rest = P.stack_stage_params(params, cfg, 2, mesh2, axis="data", tp_axis=tp_axis)
        pc = P.init_stage_kv_cache(cfg, B, 2, mesh2, axis="data", tp_axis=tp_axis)
        lp_p, pc = P.llama_forward_pp_decode(layers, rest, cfg, toks[:, :T], pc, pos, mesh2,
                                             n_micro=2, axis="data", tp_axis=tp_axis)
        ld_p, _ = P.llama_forward_pp_decode(layers, rest, cfg, toks[:, T:], pc, posd, mesh2,
                                            n_micro=2, axis="data", tp_axis=tp_axis)
        out[key] = (lp_p, ld_p)
    # ring attention over 4 ranks: this rank's chunk of 16 positions
    q, k, v = (t[:, rank * 16:(rank + 1) * 16] for t in ring_inputs())
    out["ring"] = P.ring_attention(q, k, v, mesh4, axis="model")
    # the engine over TP = 2 (each "data" pair serves the same requests)
    ecfg_model = engine_cfg()
    ep = TL.init_params(ecfg_model, seed=0, device="cpu")
    out["engine"] = run_engines(ecfg_model, P.shard_llama_params(ep, ecfg_model, mesh2), mesh2)
    # the guards JAX's engine raises under a mesh
    out["guard_kv4"] = _msg(lambda: InferenceEngine(
        dataclasses.replace(ecfg_model, kv_bits=4), ep, EngineConfig(paged=True), device="cpu",
        mesh=mesh2))
    out["guard_w8a8"] = _msg(lambda: InferenceEngine(
        ecfg_model, ep, EngineConfig(w8a8_prefill=True), device="cpu", mesh=mesh2))
    return out


def main(suite, rank, world, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world)
    try:
        out = (ops_rank if suite == "ops" else models_rank)(rank, world)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()



# ------------------------------------------------ the test process's side


def start_world(suite, world, tmp):
    """Start the ranks of SUITE, one process each, on one thread each."""
    import subprocess

    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for r in range(world):
        with open(os.path.join(tmp, f"log{r}"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r),
                                           str(world), str(tmp)], stdout=log,
                                          stderr=subprocess.STDOUT, env=env))
    return procs


def finish_world(procs, tmp, timeout=300):
    """Wait for the ranks (killing them past ``timeout`` s) and load their
    outputs; a rank that failed fails the fixture with its log."""
    import subprocess

    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        rcs = [p.wait() for p in procs]
    logs = ""
    for r in range(len(procs)):
        with open(os.path.join(tmp, f"log{r}")) as log:
            logs += log.read()[-4000:] + "\n"
    assert rcs == [0] * len(procs), f"ranks exited {rcs}:\n{logs}"
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(len(procs))]


class one_rank_mesh:
    """A gloo world of this process alone and a mesh over it, for the
    tests that serve one rank through the mesh paths."""

    def __init__(self, tmp, shape):
        self.tmp, self.shape = tmp, shape

    def __enter__(self):
        import torch.distributed as dist

        from bitsandbytes_sycl_tpu_torch.parallel import make_mesh

        dist.init_process_group("gloo", init_method=f"file://{os.path.join(self.tmp, 'store1')}",
                                rank=0, world_size=1)
        return make_mesh(self.shape, device_type="cpu")

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


def to_jax(tree):
    """A port tree (QLinearWeights, dicts, lists, tensors) as the JAX
    package's, leaf for leaf (the test side only)."""
    import jax.numpy as jnp

    from bitsandbytes_sycl_tpu.ops.common import QLinearWeight as JQ
    from bitsandbytes_sycl_tpu_torch.ops.common import QLinearWeight as TQ

    def leaf(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.detach().numpy())

    if isinstance(tree, TQ):
        return JQ(packed=leaf(tree.packed), absmax=leaf(tree.absmax), shape=tuple(tree.shape),
                  blocksize=tree.blocksize, quant_type=tree.quant_type, dtype=tree.dtype,
                  absmax_scale=leaf(tree.absmax_scale), absmax_offset=leaf(tree.absmax_offset))
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jax(v) for v in tree]
    return leaf(tree)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
