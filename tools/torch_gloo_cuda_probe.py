"""Which gloo collectives take CUDA tensors on this torch build: two ranks
on cuda:0 try all_reduce, all_gather_into_tensor and broadcast (bf16 and
f32) and isend/irecv on CUDA tensors, and time 64 all-reduces of a (4, 1,
4096) bf16 tensor directly and staged through host memory. Results in
chiprun_out/probe12/probe<rank>.json and on stdout.

Usage (from the repository root, on a machine with a GPU):
    python3 tools/torch_gloo_cuda_probe.py
"""
import json, os, subprocess, sys, time

if len(sys.argv) > 1 and sys.argv[1] == "--rank":
    import torch, torch.distributed as dist
    r, d = int(sys.argv[2]), sys.argv[3]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=r, world_size=2)
    res = {}
    def trial(name, fn):
        try:
            ok = fn()
            res[name] = "ok" if ok else "wrong values"
        except Exception as e:
            res[name] = f"{type(e).__name__}: {str(e)[:200]}"
    for dt in (torch.bfloat16, torch.float32):
        n = str(dt).split(".")[-1]
        def ar():
            x = torch.full((4, 4096), float(r + 1), dtype=dt, device="cuda")
            dist.all_reduce(x); torch.cuda.synchronize()
            return bool((x == 3).all())
        trial(f"all_reduce_{n}", ar)
        def ag():
            x = torch.full((2, 8), float(r + 1), dtype=dt, device="cuda")
            o = torch.empty((4, 8), dtype=dt, device="cuda")
            dist.all_gather_into_tensor(o, x); torch.cuda.synchronize()
            return bool((o[:2] == 1).all() and (o[2:] == 2).all())
        trial(f"all_gather_into_tensor_{n}", ag)
        def bc():
            x = torch.full((8,), float(r + 5), dtype=dt, device="cuda")
            dist.broadcast(x, src=1); torch.cuda.synchronize()
            return bool((x == 6).all())
        trial(f"broadcast_{n}", bc)
    def p2p():
        x = torch.full((8,), 7.0, device="cuda") if r == 0 else torch.zeros(8, device="cuda")
        w = dist.isend(x, 1) if r == 0 else dist.irecv(x, 0)
        w.wait(); torch.cuda.synchronize()
        return bool((x == 7).all())
    trial("isend_irecv_f32", p2p)
    # time a staged all-reduce of phase 3's decode activation vs direct
    x = torch.randn((4, 1, 4096), device="cuda").to(torch.bfloat16)
    for label, staged in (("direct", False), ("staged", True)):
        try:
            t0 = time.perf_counter()
            for _ in range(64):
                if staged:
                    h = x.cpu(); dist.all_reduce(h); x.copy_(h)
                else:
                    dist.all_reduce(x)
            torch.cuda.synchronize()
            res[f"64_all_reduces_{label}_ms"] = (time.perf_counter() - t0) * 1e3
        except Exception as e:
            res[f"64_all_reduces_{label}_ms"] = f"{type(e).__name__}: {str(e)[:200]}"
    json.dump(res, open(f"{d}/probe{r}.json", "w"), indent=1)
    dist.destroy_process_group()
    sys.exit(0)

import torch
print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
d = os.path.abspath("chiprun_out/probe12"); os.makedirs(d, exist_ok=True)
for f in os.listdir(d):
    os.remove(os.path.join(d, f))
ps = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), d]) for r in range(2)]
t0 = time.time()
while time.time() - t0 < 120 and any(p.poll() is None for p in ps):
    time.sleep(0.5)
for p in ps:
    if p.poll() is None:
        p.kill()
print("rcs", [p.wait() for p in ps])
for r in range(2):
    f = f"{d}/probe{r}.json"
    print(r, open(f).read() if os.path.exists(f) else "no result")
