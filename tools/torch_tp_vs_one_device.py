"""TP = 2 against one device, Llama-7B NF4 at 2, 8 and 32 layers, with W4A8
decode (the default) and on the exact path: the relative L2 and the max
error over the largest logit of the prefill logits of chip_smoke.py's
phase-5 prompts and of one decode step after them, and whether the
argmax agrees. Two ranks on cuda:0 over gloo; rank 0 prints.

Usage (from the repository root, on a machine with a GPU, the kernels
built first):
    python3 -c 'from bitsandbytes_sycl_tpu_torch.ops import _build; _build.build_all()'
    python3 tools/torch_tp_vs_one_device.py
"""
import dataclasses, os, subprocess, sys, time
sys.path.insert(0, os.getcwd())
import chip_smoke as CS

if len(sys.argv) > 1 and sys.argv[1] == "--rank":
    import torch, torch.distributed as dist
    from bitsandbytes_sycl_tpu_torch import parallel as P
    from bitsandbytes_sycl_tpu_torch.models.llama import LlamaConfig, init_params, init_kv_cache, llama_forward
    from bitsandbytes_sycl_tpu_torch.parallel.llama_tp import local_config
    r, d = int(sys.argv[2]), sys.argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=r, world_size=2)
    mesh = P.make_mesh({"model": 2})
    res = {}
    for a8 in (True, False):
        for layers in (2, 8, 32):
            cfg = LlamaConfig.llama7b(a8_decode=a8, num_layers=layers)
            full = init_params(cfg, seed=0, device="cuda")
            toks = CS.twelve_c_tokens(torch, cfg.vocab_size).cuda()
            pos = torch.arange(32, device="cuda").expand(2, 32)
            one, c1 = llama_forward(full, cfg, toks, init_kv_cache(cfg, 2, "cuda"), pos)
            loc = P.shard_llama_params(full, cfg, mesh)
            tp, c2 = P.llama_forward_tp(loc, cfg, toks, init_kv_cache(local_config(cfg, 2), 2, "cuda"), pos, mesh)
            one, tp = one[:, -1].float(), tp[:, -1].float()
            nxt = one.argmax(-1)[:, None]
            p1 = torch.full((2, 1), 32, device="cuda")
            d1, _ = llama_forward(full, cfg, nxt, c1, p1)
            d2, _ = P.llama_forward_tp(loc, cfg, nxt, c2, p1, mesh)
            d1, d2 = d1[:, 0].float(), d2[:, 0].float()
            for name, a, b in (("prefill", one, tp), ("decode", d1, d2)):
                res[(a8, layers, name)] = (float((b - a).norm() / a.norm()), float((b - a).abs().max() / a.abs().max()),
                                           (a.argmax(-1) == b.argmax(-1)).tolist())
            del full, loc
            torch.cuda.empty_cache()
    if r == 0:
        for k, v in res.items():
            print("a8=%s layers=%d %s: rel L2 %.4f, max err / max|logit| %.4f, argmax equal %s" % (k + v))
    dist.destroy_process_group()
    sys.exit(0)

d = os.path.abspath("build/tp_vs_one_device"); os.makedirs(d, exist_ok=True)
for f in os.listdir(d):
    os.remove(os.path.join(d, f))
ps = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), d]) for r in range(2)]
t0 = time.time()
while time.time() - t0 < 400 and any(p.poll() is None for p in ps):
    time.sleep(0.5)
for p in ps:
    if p.poll() is None:
        p.kill()
print("rcs", [p.wait() for p in ps], time.time() - t0)
