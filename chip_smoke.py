#!/usr/bin/env python3
"""Smoke run of bitsandbytes_sycl_tpu_torch on one CUDA card (H100).

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --probe    # where A's-K's time goes
    python3 chip_smoke.py --probe attention   # C's and D's only
    python3 chip_smoke.py --probe decode      # A's fused and H's split bodies only
    python3 chip_smoke.py --probe optim       # J's and K's leaf-table bodies, J's branches only
    python3 chip_smoke.py --probe int8        # F's tiled and I's wgmma bodies only
    python3 chip_smoke.py --probe dequant     # E's TMA body only: parts, stores, plans
    python3 chip_smoke.py --probe tc          # A's tensor-core body only: parts, split counts
    python3 chip_smoke.py --time-i [DIR]      # I's times, from the package under DIR
    python3 chip_smoke.py --time-decode [DIR] # phase 3's decode step, from the package under DIR
    python3 chip_smoke.py --time-optim [DIR]  # J's and K's branches, from the package under DIR
    python3 chip_smoke.py --phase12           # phase 12 alone, after the references of 3 and 3c

Phases, each of which exits non-zero on failure:
  1. build the hand-written kernels (nvcc, csrc/*.cu) and print the card;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the 7B serving path gives it (attention inputs with O(1)
     scores, and the plain version fed deliberate faults must land outside
     the tolerance; kernel A's fused body at 1, 4 and 8 rows and its
     tensor-core body at 16-128 rows (blocksize 64), 4, 32 and 128
     (blocksize 128) and 256 (blocksize 256), each timed beside its SIMT
     body, which it must beat, B's tensor-core body at 256 and 1024 rows,
     G's wgmma body at 512 and 2048,
     C's tensor-core body at T = 32 and 512, D's split body at 1 and 16
     pages, H's split body at B = 1, 2, 4 and 8, each checked to have run;
     C's tensor-core and H's split bodies at head_dim 256, the shapes of
     GPT-J-6B and Gemma-2-9B with every option, and both at 384 to 1024,
     each timed beside its SIMT body and SDPA and required to beat the
     SIMT body,
     and every plan of the fast bodies of A, B, C, D, G, H and I, E's TMA
     body and unaligned route and F's tiled body launched 100 times on one
     input must repeat its output bit for bit), and time
     kernel, plain version and one PyTorch
     library call that computes the same function (for attention, SDPA's
     fused backends only, each alone, the fastest kept); then hold the W8A8
     route at 4096 rows and the dequantize-once route at 2048 (and 256)
     rows, glue included, against plain versions at the 7B shapes;
  3. serve Llama-7B (NF4, bs 64, bf16 scales, W4A8 decode, int8 paged KV,
     random weights from a seed) through the paged engine: 8 prompts, 4
     slots, 32 new tokens each; the W4A8, prefill and paged-attention
     kernels must have been launched, every prefill's 225 W4A8 launches on
     A's tensor-core body; then profile decode steps on the
     device (torch.profiler) and on the host (cProfile, and each step
     against a host-speed yardstick);
  3b. long prompts through the paged engine at full 7B width and depth
     (max_batch 8): one prompt of 129-256 tokens (256 prefill rows: kernels
     B and E), four of 257-512 (2048 rows: G), eight of 257-512 (4096 rows:
     F, once per linear on its tiled body), each batch decoded to its end,
     the 256-row batch on B's tensor-core body and the 2048-row one on G's
     wgmma body; then chunked
     prefill (256-token chunks) of two 700-1000-token prompts against the
     whole-prompt engine, with W4A8 linears (chunks on G) and with
     a8_decode=False (chunks on B);
  3e. LlamaConfig.serving7b() (NF4 at blocksize 128: the JAX package's
     single-chip 7B serving preset) at full width and depth through the
     paged engine, 32 prompts, max_batch 32, 16 new tokens each: every
     launch of A on its tensor-core body (225 a decode step at 32 rows), a
     profiled decode step at 32 rows, and 2 layers card against CPU;
  4. the same weights, 4 layers, on the exact path (a8_decode=False): the
     exact 4-bit kernel must have been launched, and a batch of four
     257-512-token prompts must decode every linear's weight once (E);
  5. a 2-layer model at full 7B width from one seed, on the card and on
     the CPU (plain versions): prefill logits within tolerance at T=32 and
     at Kb=2, T=512 (kernel G), greedy tokens equal wherever the CPU's
     top-2 logit gap exceeds it;
  6. LLM.int8 Llama-7B (quant="int8", threshold 6, static outlier columns)
     through the default contiguous engine: kernels I (225 per decode step)
     and H (32); then, 2 layers at 7B width, card against CPU: prefill
     logits at T=32 and 4 decode steps, and greedy tokens;
  3d. the memory-lean NF4 configuration, LlamaConfig.llama7b(
     compress_stats=True, kv_bits=4) (compressed statistics: uint8
     dynamic-map codes of the block scales; kv4 pages: nibble pairs),
     after phase 7b frees phase 3's model: phase 3's prompts through the
     paged engine (225 launches of B's compressed branch on its tensor-core
     body and 32 of D's kv4 split body per decode step, none of A), phase
     3b's 256-, 2048- (E's compressed branch once per linear) and 4096-row
     (F on the decoded scales) batches, 3 adamw8bit QLoRA steps of phase
     7b's setting on this base (447 compressed E launches a step: forward
     and backward), then 2 layers at 7B width card against CPU (prefill
     logits and greedy tokens under phase 5's rule, one QLoRA step under
     phase 7c's limits);
  7. QLoRA: (a, in phase 2) the 8-bit optimizer kernels J and K, one launch
     over a leaf table, bit for bit against their plain version over the
     448-leaf QLoRA table, a mixed table with ragged leaves and 16.8M
     parameters, with eight deliberate faults, 100 repeated launches, and
     the encode's exponent-bit search and the LUT codec's bucketed rank
     (four tables) checked on every f32; then their
     LUT codec (every optimizer over those three tables under seven maps:
     quantile, linear signed and unsigned, fp8, normal, a padded 7-bit
     map, a permuted one) and their blocks past 2048 (blocks of 4096,
     262144, 704512 and 16.8M and each codec's resident capacity and the
     next multiple of 128, one block and several, ragged, and the QLoRA
     table's whole-leaf blocks as block_wise=False launches them, under
     both codecs and stochastic rounding: J's two-pass body, K's resident
     body up to its capacity and its two-pass body past it), bit for bit, with
     six deliberate faults (side='right', no sign fix, the last index of a
     duplicate run, state2 encoded with state1's table, pad code 0, a
     per-CTA maximum cut at the plan's slices), 100 repeated launches of
     each new plan, each branch timed (K's resident route beside its
     two-pass body, in turns), and estimate_quantiles at 32M elements
     against numpy; (b) QLoRA
     fine-tuning of Llama-7B on phase 3's NF4 base, rank 64 on all seven
     projections, 4 adamw8bit and 2 lion8bit steps on a (4, 513) batch
     (225 G on its wgmma body, 222 E and one J launch per Adam step, one
     K launch per Lion step, for the 448 8-bit leaves), the last step of each
     profiled with its optimizer apart; (d) the same setting through the
     new branches: 2 adamw8bit(block_wise=False) steps and a lion8bit one
     (J's two-pass body, a launch pair per leaf size; K's resident body,
     one launch per leaf size), one lion8bit(block_wise=False) step of a
     4096 x 4096 full weight (K's two-pass body), then 2 Adam
     steps and a Lion one with every 8-bit leaf's states through
     optimizer_update_8bit_blockwise(qmap1=, qmap2=) (quantile maps of a
     seeded normal sample and of its squares; 448 LUT launches a step);
     (c) 2 layers at 7B width, card against CPU: loss, adapter gradients
     and 3 Adam steps, with adamw8bit, block_wise=False and the LUT maps.
  8. the library at Llama-7B width and depth, after phase 7c: (a) the
     docstring path, bnb.quantize_nf4(w) then bnb.matmul_4bit(x, packed,
     qs), at the four 7B shapes with raw and compressed statistics at M =
     1, 4, 256 and 2048 (kernels B and E) against functional.
     matmul_4bit_ref, the bnb-format -> kernel-layout repack bit for bit
     against quantize_4bit_native, a flipped nibble as the fault; (b) the
     225 linears of Llama-7B as bf16 torch.nn.Linear under their Hugging
     Face names, utils.replace_linear into LinearNF4 (NF4, bs 64), every
     module forward at 4 rows (225 launches of B) and forward and backward
     at 2048 rows (450 of E); (c) 225 Linear8bitLt (threshold 6, 32 static
     outlier columns) at 4 rows (225 launches of I) and one layer's seven
     trainable ones forward and backward at 128 rows (7 of I), against the
     plain route;
  9. the rest of the serving engine at Llama-7B width and depth, after
     phase 4b, on phase 3's NF4 weights and prompts: (a) the paged engine
     serving 4 stacked adapters (rank 64, alpha 16, all seven projections):
     all 8 requests on adapter 0 (B = 0) give phase 3's tokens bit for bit,
     then the requests spread over the four; (b) a seeded 512-token prefix
     registered once (G at 512 rows, C at T = 512), phase 3's prompts as
     suffixes, contiguous and paged, whole and in 16-token chunks: every
     slot's first 512 positions hold the stored prefix KV bit for bit, C
     runs every suffix prefill at starts 512 (+ the chunk's offset), and
     the suffix prefill is timed beside the same prompts prefilled whole;
     (c) snapshots of the paged and the contiguous engine after 8 decode
     steps, greedy and sampled: 8 more steps after restore() and after
     restore_durable() of a torch.save'd durable_snapshot() equal the
     uninterrupted engine's bit for bit; (d) the bf16 KV cache
     (kv_quant=False, contiguous): no C, D or H launch, A 225 times a
     decode step; (e) PagedKVPool at the 7B layer shape: its bytes equal
     paged_ingest's, one decode step written, one layer attended (one D
     launch within 1% of its plain version); (f) speculative decoding with
     the LLM.int8 7B target (built here from seed 0, kept for phase 6) and
     the NF4 7B draft, gamma 4, 4 ragged prompts, 32 new tokens: greedy
     tokens equal to the target's own generate() under the gap rule,
     launches exactly I 225 a target forward, A 225 a draft forward, H 32 a
     draft decode step, and the dequantize-then-attend route 32 a verify
     and a draft ingest (and nowhere else in the script); sampling runs;
     at 2 layers the host loop against the loop variant. (a), (b) and (d)
     also run 2 layers at 7B width on the card against the CPU;
  10. the other model families, after phase 8 (10o, the optimizer manager
     over phase 7b's adapters, after 7d: o_proj's overridden to 32-bit, J
     once a step for the 8-bit group): (k) kernels H and D at group sizes
     3, 5, 7 and 16 and H and C at head_dim 384, 640 and 1024 (D at 256
     and over kv4 pages) in every body, within 1% of their plain versions
     with the options, the faults outside, 100 launches bit for bit, H and
     D timed at rep 7 beside rep 4, and C and H timed at head_dim 1024
     (B = 4, 4 kv heads, S = 2048); (a) Mixtral-8x7B at full width and
     16 of its 32 layers, (b) Qwen2-7B, (c) GPT-J-6B, (d) BLOOM-7B1, each served
     contiguous and paged through its forward (8 prompts, 4 slots, 32 new
     tokens), greedy tokens of the two modes under the gap rule, the
     launches of one prefill and one decode step exact (Mixtral: A 897 a
     step; every prefill launch of C on its tensor-core body and every
     decode launch of D and H on their split bodies, GPT-J's head_dim 256
     too), and the first layer (Mixtral) or two against the CPU; (e)
     eight more families at their published widths and 2 layers (OPT-6.7B
     with its published 32 heads of 128), the dequantize routes exactly
     where head_dim % 128 != 0, the new bodies as in (c) elsewhere (Gemma-7B
     and Gemma-2-9B at head_dim 256);
  11. checkpoints, after phase 10: (a) a HuggingFace Llama-2-7B checkpoint
     written by the script (its published config.json, 4 layers, bf16
     weights from seed 0 in two hand-written safetensors shards, 2.1 GB)
     and loaded on the card by checkpoints.load_llama_from_hf: q_proj of
     layer 0, down_proj of layer 3 and lm_head bit for bit against the CPU
     quantizer, every leaf against the same tensors quantized in memory,
     phase 3's prompts served paged and contiguous with tokens equal to
     the in-memory tree's and A, C, D and H launches per layer equal to
     phases 3 and 3c's, the load's seconds, GB/s and peak RSS (a fresh
     process); (b) GPT-J-6B at 2 layers as an F16 pytorch_model.bin
     (torch.save), load_gptj_from_hf, served through gptj_forward with
     the same checks, every prefill on C's tensor-core body and every
     decode launch on D's or H's split body; (c)
     save_checkpoint/load_checkpoint of (a)'s tree and of a 2-layer QLoRA
     run's adamw8bit state, bit for bit, and a resumed
     step equal to the uninterrupted one; (d) the host library built by
     g++ here, quantize_4bit_np on a 4096 x 11008 weight byte-equal to the
     card's quantizers; (e) legacy.igemm at the 7B shapes exact,
     research.matmul_fp8_mixed card against CPU; (f, run in phase 2 before
     any other profiler) profiling.roofline_report of A at 4096 x 4096,
     M = 4, within 10% of A's duration on the device's clock
     (torch.profiler through profiling.trace) and under phase 2's cold
     time;
  12. parallel/ on torch.distributed, after phase 11: (a) NCCL at world
     size 1 in this process: phase 3's tree through shard_llama_params on
     make_mesh({"model": 1}), phase 3's prompts through the paged and the
     contiguous TP engine, tokens bit for bit and A, C, D and H launches
     equal to phases 3 and 3c, 64 all-reduces a decode step; (b) a gloo
     world of two child processes on this card (chip_smoke.py --tp-rank):
     Llama-7B NF4 at TP = 2, full width and depth, kernel A at the shard
     shapes (N = 2048, 5504; K = 2048, 5504) within 1% of its plain
     version with the fault outside, the prefill logits within 10% of one
     device's (W4A8's per-rank activation scales), phase 3's prompts
     paged and contiguous, 16 new tokens each, under the gap rule (10%
     against phase 3, 5% between the two TP runs), the same on both
     ranks; (c) in
     that world, each path on the card against the same path on the CPU:
     LLM.int8 Llama-7B, Mixtral-8x7B expert parallel, GPT-J-6B, OPT-6.7B
     and BLOOM-7B1 (ALiBi) at TP = 2 and 2 layers (phase 5's limits), a
     2-stage pipeline, ring attention at S = 4096, and adamw8bit over phase
     7b's leaf table with sharded states, bit for bit against the
     unsharded update. The ranks' logs and summaries go to
     chiprun_out/phase12/; their times are two ranks sharing one card;
Every prefill of phases 3, 3b, 3c, 4b and 6 must run C's tensor-core body
(the model's q is bf16), every paged decode launch D's split body, every
contiguous decode launch H's split body, every decode step's W4A8
linears A's fused body (one launch each; phases 3 and 3c), and no launch
of A its SIMT body.
Between them: 3c serves phase 3's prompts through the engine's default,
the contiguous int8 cache (kernel H, 32 launches per step), and its greedy
tokens must equal the paged engine's under the gap rule; 4b prefills on
the transient int8 repack (EngineConfig(w8a8_prefill=True)) a batch of 128
rows (kernel I) and one of 2048 (torch._int_mm) in both engine modes,
first tokens equal to the default engine's under the gap rule. Phase 2
also holds kernels H and I at the 7B shapes (H within 1% with four
deliberate faults; I bit for bit at M = 1-128, and within 1 bf16 ulp with
the next row's SCB as fault) and the LLM.int8 route at 256 and 1024 rows;
kernel E bit for bit on both routes (its TMA body, and the unaligned route
at N % 16 != 0): nf4, fp4 and int4, bf16 and f32 out, raw f32, raw bf16 and
compressed scales, at the 7B shapes, 4544 x 4544 (bs 32), 4100 x 4096 and
two narrow shapes, timed beside the bodies it replaced (a BNB_E_OLD_BODIES
build, made alongside phase 1's); kernel F's tiled body bit for bit at the
7B shapes (blocksizes 64 and 128)
and three small ones (one with a ragged column tile), its stride body at
blocksize 8, and 100 repeated launches of F and of every plan of I (each
wgmma width at 4096 x 4096); the compressed branches of B (both bodies at
4, 256 and 2048 rows, within 1%, two faults) and E (bf16 and f32 out, bit
for bit) at the 7B shapes and on small shapes in every decode mode, tile
and blocksize, and D's kv4 branch (split and SIMT bodies at 1 and 16
pages, B = 1, 2, 4, with new_kv, within 1%, four faults: swapped nibbles,
scales in token order, V at 1/127, the next kv head; the options on small
shapes), each fast plan repeated 100 times.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12


class SmokeFailure(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cold(torch, fn, iters=30, warmup=3, flush_by_read=False, spin_cycles=1_000_000):
    """Median milliseconds of one call on the card, L2 flushed before each
    call (the serving path meets its weights cold: a decode step reads
    ~3.5 GB). A spin kernel queued after the flush lets the host enqueue
    the call before the start event fires, so host overhead is not timed.
    The flush writes 96 MB, so the call also meets up to 50 MB of dirty
    lines that the card writes back as the call's reads evict them; with
    ``flush_by_read`` the flush reads instead and leaves L2 clean (as a
    decode step, whose weight reads dominate, leaves it)."""
    flush = torch.empty(96 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush_by_read:
            flush.view(torch.int64).sum()
        else:
            flush.zero_()
        torch.cuda._sleep(spin_cycles)  # 1M cycles: ~0.5 ms of device time
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


SDPA_FUSED = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def time_sdpa(torch, q, k, v, flush_by_read=False, **kw):
    """The yardstick of an attention kernel: scaled_dot_product_attention
    restricted to each fused backend in turn (never the math fallback), on
    inputs laid out as those backends need (last dimension contiguous).
    Returns (ms of the fastest backend that takes the inputs or None, its
    name or None, {backend: ms, or why it declined})."""
    import torch.nn.functional as Fnn
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name in SDPA_FUSED:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            times[name] = "not in this PyTorch"
            continue

        def run(backend=backend):
            with sdpa_kernel([backend]):
                return Fnn.scaled_dot_product_attention(q, k, v, **kw)

        try:
            run()
            torch.cuda.synchronize()
        except RuntimeError as e:  # the backend declines these inputs
            times[name] = "declined: " + " ".join(str(e).split())[:120]
            continue
        times[name] = time_cold(torch, run, flush_by_read=flush_by_read)
    ok = {n: t for n, t in times.items() if isinstance(t, float)}
    best = min(ok, key=ok.get) if ok else None
    return (ok[best] if best else None), best, times


def fmt_us(ms):
    return "n/a" if ms is None else f"{ms * 1e3:.1f} us"


def max_err(torch, got, ref):
    g, r = got.float(), ref.float()
    return float((g - r).abs().max()), float(r.abs().max())


def faults_exceed(torch, name, ref, faults, tol):
    """The tolerance must tell apart a kernel that computes the wrong
    function: each plain version fed a deliberate fault (wrong K head, K
    of another layer, k_scale dropped, ...) must land outside it. Returns
    the smallest fault error over the tolerance."""
    worst = float("inf")
    for label, fn in faults:
        err, _ = max_err(torch, fn(), ref)
        need(err > tol, f"{name}: a plain version with {label} lands within the tolerance "
                        f"({err} <= {tol}), so the check cannot see that fault")
        worst = min(worst, err / tol)
    return worst


# --------------------------------------------------------------- phase 2
# kernel A past the fused body: (blocksize, rows) of the 7B linears that
# take the tensor-core body (check_linears holds and times each of them)
A_TC_CELLS = ((64, 16), (64, 32), (64, 64), (64, 128), (128, 4), (128, 32), (128, 128), (256, 256))


def a_bound(M, N, K, bs):
    """(bytes, bound ms, bound_by) of kernel A at (M, N, K, bs): bf16 x
    and output, the packed weight and its bf16 scales, each once, over the
    card's memory rate, against 2 M N K int8 operations."""
    nbytes = M * K * 2 + N * K // 2 + N * K // bs * 2 + M * N * 2
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 2 * M * N * K / INT8_OPS_PER_S
    return nbytes, max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def check_linears(torch, report):
    """Kernels A and B against their plain versions at the 7B shapes, within
    1% of the largest output (bf16 output: a few ulps after a reordered f32
    sum). A at 1, 4 and 8 rows (its fused body; 8 is the edge of gemv_plan)
    and at A_TC_CELLS (its tensor-core body: 16-128 rows at blocksize 64, 4,
    32 and 128 at blocksize 128, 256 at blocksize 256 where K % 512 == 0),
    each call shown to have run the body gemv_plan names; B at 4 and 128
    rows and at the 256 and 1024 rows of the exact prefill path (its
    tensor-core body). The plain version fed the lo plane's scales on the
    hi plane must land outside the tolerance (A at every row count, B from
    256). Timed: A at 1 and 4 rows and at every tensor-core row beside its
    SIMT body (the earlier design, three launches, through simt_plan), which
    the tensor-core body must beat; B at 4 rows and at 256 and 1024 rows
    beside its SIMT body at 256."""
    import dataclasses as dc

    from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit, matmul_w4a8
    from bitsandbytes_sycl_tpu_torch.ops.common import (LaunchPlan, _ksplit, quantize_4bit_native,
                                                        sm_count)

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"w4a8_gemv": [], "mm4_fused": [], "w4a8_gemv (tc)": []}
    mode = matmul_4bit._MODE_BF16_TABLE
    edge = matmul_w4a8.GEMV_FUSED_MAX_M
    gemv = matmul_w4a8.w4a8_gemv

    def a_case(x, w, w_bad, Wd, timed):
        """A on the body gemv_plan picks, within 1%, the fault outside; with
        ``timed`` its cold time beside its SIMT body, bf16 torch.matmul, its
        plain version and the bound."""
        M, K = x.shape
        N, bs = w.shape[0], w.blocksize
        plan = matmul_w4a8.gemv_plan(M, N, K, bs, sm_count(x.device))
        n0, fu0, tc0 = gemv.launches, gemv.launches_fused, gemv.launches_tc
        got = matmul_w4a8.w4a8_gemv(x, w, None, torch.bfloat16)
        ref = matmul_w4a8._w4a8_plain(x, w, None, torch.bfloat16)
        torch.cuda.synchronize()
        ran = {"fused": gemv.launches_fused - fu0, "tc": gemv.launches_tc - tc0}
        ran["simt"] = gemv.launches - n0 - ran["fused"] - ran["tc"]
        need(ran == {b: int(b == plan.body) for b in ran},
             f"w4a8_gemv N={N} K={K} bs={bs} M={M}: launches by body {ran}, not the {plan.body} body")
        err, scale = max_err(torch, got, ref)
        tol = 1e-2 * scale  # bf16 output: a few ulps after a reordered f32 sum
        need(err <= tol, f"w4a8_gemv N={N} K={K} bs={bs} M={M}: max err {err} > {tol}")
        row = dict(N=N, K=K, bs=bs, M=M, max_abs_err=err, tol=tol, plan=tuple(plan))
        row["fault_over_tol"] = faults_exceed(torch, f"w4a8_gemv N={N} K={K} bs={bs} M={M}", ref, [
            ("the lo plane's scales on the hi plane",
             lambda: matmul_w4a8._w4a8_plain(x, w_bad, None, torch.bfloat16))], tol)
        if timed:
            nbytes, bound, by = a_bound(M, N, K, bs)
            row.update(
                ms=time_cold(torch, lambda: matmul_w4a8.w4a8_gemv(x, w, None, torch.bfloat16)),
                plain_ms=time_cold(torch, lambda: matmul_w4a8._w4a8_plain(x, w, None, torch.bfloat16),
                                   iters=5),
                library_ms=time_cold(torch, lambda: torch.matmul(x, Wd.T)),
                simt_ms=time_cold(torch, lambda: matmul_w4a8._gemv_launch(
                    x, w, None, torch.bfloat16, matmul_w4a8.simt_plan(M, N, K, bs))),
                bytes=nbytes, bound_ms=bound, bound_by=by)
            if plan.body == "tc":
                need(row["ms"] < row["simt_ms"], f"w4a8_gemv N={N} K={K} bs={bs} M={M}: the"
                     f" tensor-core body ({row['ms'] * 1e3:.1f} us) is not faster than the SIMT body"
                     f" ({row['simt_ms'] * 1e3:.1f} us)")
        print(f"  w4a8_gemv  N={N:5d} K={K:5d} bs={bs:3d} M={M:4d} err={err:.3g} rel={err / scale:.2g}"
              f" (tol {tol:.3g}); fault {row['fault_over_tol']:.3g}x tol"
              + (f" kernel {row['ms']*1e3:.1f} us plain {row['plain_ms']*1e3:.1f} us bf16 matmul"
                 f" {row['library_ms']*1e3:.1f} us SIMT body {row['simt_ms']*1e3:.1f} us bound"
                 f" {row['bound_ms']*1e3:.2f} us ({row['bound_ms']/row['ms']:.0%})" if timed else "")
              + f" plan {row['plan']}", flush=True)
        rows["w4a8_gemv" if plan.body == "fused" else "w4a8_gemv (tc)"].append(row)

    # the tensor-core body's CTAs an SM at each row tile: what gemv_plan
    # assumes against the kernel's occupancy (its shared memory, registers)
    from bitsandbytes_sycl_tpu_torch.ops import _build
    ctas = {bm: _build.kernel_fn("w4a8_gemv", "w4a8_gemv_tc_ctas", 1, int_args=(0,))(bm)
            for bm in matmul_w4a8._GEMV_TC_CTAS}
    need(ctas == matmul_w4a8._GEMV_TC_CTAS, f"w4a8_gemv (tc): the kernel holds {ctas} CTAs an SM"
         f" by row tile, gemv_plan plans for {matmul_w4a8._GEMV_TC_CTAS}")
    for N, K in SHAPES_7B:
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        Wd = W.to(torch.bfloat16)
        for bs in sorted({64} | {b for b, _ in A_TC_CELLS if K % (2 * b) == 0}):
            w = quantize_4bit_native(W, bs, "nf4", absmax_dtype=torch.bfloat16)
            w_bad = dc.replace(w, absmax=w.absmax[1:].expand(2, -1, -1).contiguous())  # lo scales on hi
            cells = [m for b, m in A_TC_CELLS if b == bs] + ([1, 4, edge] if bs == 64 else [])
            for M in sorted(cells):
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                a_case(x, w, w_bad, Wd, timed=M not in (edge,))
            if bs != 64:
                continue
            for M in (4, 128, 256, 1024):
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                tc0 = matmul_4bit.mm4_fused.launches_tc
                got = matmul_4bit.mm4_fused(x, w, None, torch.bfloat16)
                ref = matmul_4bit._mm4_plain(x, w, None, torch.bfloat16, mode)
                torch.cuda.synchronize()
                err, scale = max_err(torch, got, ref)
                tol = 1e-2 * scale
                need(err <= tol, f"mm4_fused N={N} K={K} M={M}: max err {err} > {tol}")
                need(matmul_4bit.mm4_fused.launches_tc == tc0 + 1,
                     f"mm4_fused N={N} K={K} M={M}: bf16 x did not take the tensor-core body")
                row = dict(N=N, K=K, M=M, max_abs_err=err, tol=tol)
                if M >= 256:
                    row["fault_over_tol"] = faults_exceed(torch, f"mm4_fused N={N} K={K} M={M}", ref, [
                        ("the lo plane's scales on the hi plane",
                         lambda: matmul_4bit._mm4_plain(x, w_bad, None, torch.bfloat16, mode))], tol)
                if M in (4, 256, 1024):
                    nbytes = M * K * 2 + N * K // 2 + N * K // 64 * 2 + M * N * 2
                    ops_ = 2 * M * N * K
                    # the M = 4 rows keep the f32 peak (bytes bound them either way)
                    peak = F32_FLOPS_PER_S if M == 4 else BF16_FLOPS_PER_S
                    kern = lambda: matmul_4bit.mm4_fused(x, w, None, torch.bfloat16)  # noqa: E731
                    row.update(
                        ms=time_cold(torch, kern),
                        plain_ms=time_cold(torch, lambda: matmul_4bit._mm4_plain(
                            x, w, None, torch.bfloat16, mode), iters=5 if M < 1024 else 3),
                        library_ms=time_cold(torch, lambda: torch.matmul(x, Wd.T)),
                        bytes=nbytes, bound_ms=max(nbytes / HBM_BYTES_PER_S, ops_ / peak) * 1e3,
                        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops_ / peak else "operations",
                        plan=tuple(matmul_4bit.mm4_plan(M, N, K, 64, x.dtype, sm_count(x.device))))
                    if M == 256:
                        g, ks = _ksplit(K // 128, N // 128, -(-M // 4))
                        row["simt_ms"] = time_cold(torch, lambda: matmul_4bit._mm4_launch(
                            x, w, None, mode, LaunchPlan("simt", 4, g, ks)), iters=3)
                rows["mm4_fused"].append(row)
                print(f"  mm4_fused  N={N:5d} K={K:5d} M={M:4d} err={err:.3g} rel={err / scale:.2g}"
                      f" (tol {tol:.3g})"
                      + (f"; fault {row['fault_over_tol']:.3g}x tol" if "fault_over_tol" in row else "")
                      + (f" kernel {row['ms']*1e3:.1f} us plain {row['plain_ms']*1e3:.1f} us"
                         f" bf16 matmul {row['library_ms']*1e3:.1f} us bound"
                         f" {row['bound_ms']*1e3:.2f} us ({row['bound_ms']/row['ms']:.0%})"
                         f" plan {row['plan']}" if "ms" in row else "")
                      + (f" SIMT body {row['simt_ms']*1e3:.1f} us" if "simt_ms" in row else ""),
                      flush=True)
            del w, w_bad
        del W, Wd
    # the JSON line: A at 4 rows (decode, fused), at 32 rows and blocksize
    # 128 (phase 3e's serving7b decode step, tensor-core body), B at 256
    # rows (the exact prefill)
    for name, rs in rows.items():
        timed = [r for r in rs if "ms" in r and (r["M"], r.get("bs", 64)) == {
            "w4a8_gemv": (4, 64), "mm4_fused": (256, 64), "w4a8_gemv (tc)": (32, 128)}[name]]
        report[name] = dict(
            shapes=rs, ms=sum(r["ms"] for r in timed), plain_ms=sum(r["plain_ms"] for r in timed),
            library_ms=sum(r["library_ms"] for r in timed),
            bound_ms=sum(r["bound_ms"] for r in timed), bound_by=timed[0]["bound_by"],
            max_abs_err=max(r["max_abs_err"] for r in rs))
    report["w4a8_gemv (tc)"]["simt_ms"] = sum(
        r["simt_ms"] for r in rows["w4a8_gemv (tc)"] if "ms" in r and (r["M"], r["bs"]) == (32, 128))
    report["w4a8_gemv (tc)"]["ctas_per_sm"] = ctas


def ulp_ratio(torch, got, ref, dtype, bias=None):
    """Largest |got - ref| in units of the last place in dtype of ref, or of
    the bias where that is larger: where the bias cancels the product, a
    rounding of the product is an ulp of the bias, not of the small sum."""
    mag = ref.float().abs()
    if bias is not None:
        mag = torch.maximum(mag, bias.float().abs()[None, :])
    _, e = torch.frexp(mag)  # mag = m 2^e, m in [0.5, 1)
    bits = 24 if dtype == torch.float32 else 8
    ulp = torch.ldexp(torch.ones_like(mag), (e - bits).float())
    return float(((got.float() - ref.float()).abs() / ulp).max())


def check_prefill_linears(torch, report):
    """Kernels F (dequant_int8) and G (w4a8_grouped) against their plain
    versions at the four 7B linear shapes (E: check_dequant4). F must be bit
    for bit equal; G within 2 f32 ulps (1 bf16 ulp for bf16 output) of the
    output, or of the bias where it is larger, since its int32 sum is exact
    and its epilogue keeps the plain version's order; the column-grid
    kernel that F's route and G run must give the plain version's colmax
    and f bit for bit. F runs its tiled body at every 7B shape (nf4 and
    int4 at blocksize 64, nf4 at 128), at two small shapes that
    dequantize_to_int8 accepts (blocksizes 64 and 48) and, called directly,
    at N = 400 (a ragged last column tile); its stride body at a
    blocksize of 8 that dequantize_to_int8 accepts. Each check
    also feeds the plain version a deliberate fault (F: the lo plane scaled
    by the hi plane's factors; G: the colmax of the next column), which must
    land outside the tolerance."""
    from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit as m4
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as mw
    from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {"dequant_int8": [], "w4a8_grouped": []}
    for N, K in [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]:
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        Wd = W.to(torch.bfloat16)
        nbh = K // 128
        # (weight, blocksize, type, through dequantize_to_int8, body)
        f_cases = [(W, 64, "nf4", True, "tiled"), (W, 64, "int4", True, "tiled"),
                   (W, 128, "nf4", True, "tiled")]
        if N == 4096 and K == 4096:  # small shapes
            f_cases += [(W[:384, :1152].contiguous(), 64, "nf4", True, "tiled"),
                        (W[:512, :1536].contiguous(), 48, "nf4", True, "tiled"),
                        (W[:400, :1152].contiguous(), 64, "nf4", False, "tiled"),
                        (W[:384, :1152].contiguous(), 8, "nf4", True, "stride")]
        for Wc, bs, qt, route, body in f_cases:
            w = quantize_4bit_native(Wc, bs, qt, absmax_dtype=torch.bfloat16)
            Nc, Kc = Wc.shape
            colmax, f = mw._col_grid(w)
            cm_k, f_k = mw.col_grid(w)  # the column-grid kernel of F's route and G
            need(torch.equal(cm_k, colmax) and torch.equal(f_k, f),
                 f"col_grid {qt} N={Nc} K={Kc}: colmax or f differ from the plain version's")
            del cm_k, f_k
            t0, s0 = mw.dequant_int8.launches_tiled, mw.dequant_int8.launches
            got, ref = mw.dequant_int8(w, f), mw._dequant8_plain(w, f)
            wq, cm = mw.dequantize_to_int8(w) if route else (got, colmax)
            torch.cuda.synchronize()
            need(wq is not None, f"dequantize_to_int8 declined N={Nc} K={Kc} bs={bs}")
            calls = 2 if route else 1
            tiled = mw.dequant_int8.launches_tiled - t0
            need(mw.dequant_int8.launches == s0 + calls
                 and tiled == (calls if body == "tiled" else 0),
                 f"dequant_int8 {qt} N={Nc} K={Kc} bs={bs}: {tiled} of "
                 f"{mw.dequant_int8.launches - s0} launches on the tiled body, the {body} body expected")
            need(torch.equal(got, ref) and torch.equal(wq, ref),
                 f"dequant_int8 {qt} N={Nc} K={Kc} bs={bs}: codes differ from the plain version")
            need(torch.equal(cm.cpu(), w.absmax.float().cpu().amax(dim=(0, 1))),
                 f"dequant_int8 {qt}: colmax differs")
            f_bad = f.clone()
            f_bad[1] = f[0]
            need(not torch.equal(mw._dequant8_plain(w, f_bad), ref),
                 "dequant_int8: the plain version with the lo plane on the hi plane's factors matches")
            row = dict(N=Nc, K=Kc, quant=qt, bs=bs, body=body, max_abs_err=0.0)
            if qt == "nf4" and bs == 64 and (Nc, Kc) == (N, K):
                nbytes = K // 2 * N + 2 * nbh * N * 4 + K * N
                row.update(ms=time_cold(torch, lambda: mw.dequant_int8(w, f)),
                           plain_ms=time_cold(torch, lambda: mw._dequant8_plain(w, f), iters=5),
                           library_ms=None, bytes=nbytes,
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
            rows["dequant_int8"].append(row)
            del got, ref, wq, f, f_bad, w
        for bs in (64, 128):
            w = quantize_4bit_native(W, bs, "nf4", absmax_dtype=torch.bfloat16)
            bias = torch.randn((N,), generator=gen, device="cuda")
            for M in (512, 2048):
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                for od in (torch.bfloat16, torch.float32):
                    wg0 = mw.w4a8_grouped.launches_wgmma
                    got = mw.w4a8_grouped(x, w, bias, od)
                    ref = mw._grouped_plain(x, w, bias, od)
                    torch.cuda.synchronize()
                    need(mw.w4a8_grouped.launches_wgmma == wg0 + 1,
                         f"w4a8_grouped N={N} K={K} M={M}: did not take the wgmma body")
                    ratio = ulp_ratio(torch, got, ref, od, bias)
                    n_ulp = 2 if od == torch.float32 else 1
                    need(ratio <= n_ulp, f"w4a8_grouped N={N} K={K} M={M} bs={bs} {od}: "
                                         f"{ratio} ulps > {n_ulp}")
                    col_grid = mw._col_grid
                    mw._col_grid = lambda w_: (lambda cm_, f_: (cm_.roll(-1), f_))(*col_grid(w_))
                    try:
                        bad = mw._grouped_plain(x, w, bias, od)
                    finally:
                        mw._col_grid = col_grid
                    fault = ulp_ratio(torch, bad, ref, od, bias)
                    need(fault > n_ulp, f"w4a8_grouped: the plain version with the next column's "
                                        f"colmax lands within {n_ulp} ulps")
                    row = dict(N=N, K=K, M=M, bs=bs, out=str(od), ulps=ratio, fault_ulps=fault,
                               max_abs_err=max_err(torch, got, ref)[0])
                    if bs == 64 and od == torch.bfloat16:
                        nbytes = M * K * 2 + K // 2 * N + 2 * (K // (2 * bs)) * N * 2 + M * N * 2
                        ops_ = 2 * M * N * K
                        row.update(
                            ms=time_cold(torch, lambda: mw.w4a8_grouped(x, w, bias, od)),
                            plain_ms=time_cold(torch, lambda: mw._grouped_plain(x, w, bias, od), iters=3),
                            library_ms=time_cold(torch, lambda: torch.matmul(x, Wd.T)),
                            bytes=nbytes, ops=ops_,
                            bound_ms=max(nbytes / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S) * 1e3,
                            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops_ / INT8_OPS_PER_S
                            else "operations")
                    rows["w4a8_grouped"].append(row)
                    del got, ref, bad
            del w
        del W, Wd
        for name, rs in rows.items():
            for r in rs:
                if r["N"] == N and r["K"] == K and "ms" in r:
                    print(f"  {name:12s} N={N:5d} K={K:5d}" + (f" M={r['M']}" if "M" in r else "")
                          + f" kernel {r['ms']*1e3:.1f} us plain {r['plain_ms']*1e3:.1f} us"
                          + (f" bf16 matmul {r['library_ms']*1e3:.1f} us" if r["library_ms"] else "")
                          + f" bound {r['bound_ms']*1e3:.2f} us ({r['bound_ms'] / r['ms']:.0%},"
                          f" {r['bound_by']})", flush=True)
    g = rows["w4a8_grouped"]
    print(f"  checked: dequant_int8 "
          f"{len(rows['dequant_int8'])} bit-exact, w4a8_grouped {len(g)} within "
          f"{max(r['ulps'] for r in g):.3g} ulps (faults >= {min(r['fault_ulps'] for r in g):.3g} ulps)")
    for name, rs in rows.items():
        timed = [r for r in rs if "ms" in r and (name != "w4a8_grouped" or r["M"] == 2048)]
        report[name] = dict(
            shapes=rs, ms=sum(r["ms"] for r in timed), plain_ms=sum(r["plain_ms"] for r in timed),
            library_ms=None if name != "w4a8_grouped" else sum(r["library_ms"] for r in timed),
            bound_ms=sum(r["bound_ms"] for r in timed), bound_by=timed[0]["bound_by"],
            max_abs_err=max(r["max_abs_err"] for r in rs))


# kernel E: the build of the bodies its TMA body replaced, timed beside it
E_OLD_BODIES = ("dequantize_transposed", ("BNB_E_OLD_BODIES",))
# shapes past the 7B ones: Falcon-7B's width at blocksize 32 (a ragged
# column tile), N % 16 != 0 (the unaligned route), N = 400 (ragged) and a
# weight narrower than one tile
E_SHAPES = ([(N, K, 64) for N, K in [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]]
            + [(4544, 4544, 32), (4100, 4096, 64), (400, 1152, 64), (48, 1024, 32),
               (2048, 2048, 4), (512, 1680, 4)])
# a 7B layer's seven linears: q, k, v, o (4096 x 4096), gate and up
# (11008 x 4096), down (4096 x 11008)
E_LAYER = {(4096, 4096): 4, (11008, 4096): 2, (4096, 11008): 1}


def start_variant_build(variants):
    """Build kernel variants (``_build.build_variants``) in a thread beside
    the package's own build; returns a function that waits for them and
    gives {key: library}."""
    import threading

    from bitsandbytes_sycl_tpu_torch.ops import _build

    box = {}

    def run():
        try:
            box["libs"] = _build.build_variants(variants)
        except Exception as e:  # noqa: BLE001 — raised where the libraries are wanted
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def wait():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["libs"]

    return wait


def e_bytes(N, K, bs, out_bytes, compressed, scale_bytes=2):
    """The bytes kernel E must move: the packed weight read, the scales
    read (the codes, each column's range and mean of both planes and the
    1 KB decode table, or the raw scales), the output written."""
    nbh = K // (2 * bs)
    scales = 2 * nbh * N + 16 * N + 1024 if compressed else 2 * nbh * N * scale_bytes
    return K // 2 * N + scales + K * N * out_bytes


def check_dequant4(torch, report, old_lib):
    """Kernel E (dequantize_transposed) bit for bit against its plain
    version on both routes: nf4, fp4 and int4, bf16 and f32 out, raw f32,
    raw bf16 and compressed scales, at the four 7B shapes (blocksize 64),
    Falcon-7B's 4544 x 4544 at blocksize 32, 4100 x 4096 (N % 16 != 0: the
    unaligned route), 400 x 1152, 48 x 1024, and 2048 x 2048 and 512 x 1680
    at blocksize 4 (16 and 15 scale rows a 64- or 60-row tile, more than
    compressed scales fit: the plan takes 32 and 56 rows). Each launch must take the
    route dequant4_plan picks; the plain version with the planes swapped
    must differ. Timed at the 7B shapes (nf4, bs 64, raw bf16 and
    compressed scales, bf16 and f32 out): the kernel, the bodies it
    replaced (``old_lib``, the BNB_E_OLD_BODIES build) in the same call,
    the plain version, and the byte bound; and over a 7B layer's seven
    linears."""
    from bitsandbytes_sycl_tpu_torch.ops import _build
    from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit as m4
    from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native, sm_count

    E = m4.dequantize_transposed
    gen = torch.Generator(device="cuda").manual_seed(9)
    sms = sm_count(torch.device("cuda"))
    rows, n_cases = [], 0
    for N, K, bs in E_SHAPES:
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        for qt in ("nf4", "fp4", "int4"):
            for fmt in ("f32", "bf16", "compressed"):
                plan = m4.dequant4_plan(N, K, bs, sms, fmt == "compressed")
                need(plan.body == ("tma" if N % 16 == 0 else "unaligned"),
                     f"dequant4_plan gave N={N} the {plan.body} route")
                w = quantize_4bit_native(W, bs, qt, compress_statistics=fmt == "compressed",
                                         absmax_dtype=torch.bfloat16 if fmt == "bf16" else torch.float32)
                for od in (torch.bfloat16, torch.float32):
                    before = (E.launches, E.launches_tma, E.launches_compressed)
                    got, ref = E(w, od), m4._dequant4_plain(w, od)
                    torch.cuda.synchronize()
                    moved = tuple(a - b for a, b in zip((E.launches, E.launches_tma,
                                                         E.launches_compressed), before))
                    want = (1, int(plan.body == "tma"), int(fmt == "compressed"))
                    label = f"dequantize_transposed {qt} {fmt} scales N={N} K={K} bs={bs} {od}"
                    need(moved == want, f"{label}: launches (all, tma, compressed) moved by {moved},"
                                        f" not {want}")
                    need(torch.equal(got, ref), f"{label} ({plan.body}): {int((got != ref).sum())}"
                                                " elements differ from the plain version")
                    half = K // 2
                    need(not torch.equal(torch.cat([ref[half:], ref[:half]]), ref),
                         f"{label}: the plain version with the planes swapped matches")
                    n_cases += 1
                    if qt == "nf4" and fmt != "f32" and (N, K) in SHAPES_7B:  # timed
                        ob = 2 if od == torch.bfloat16 else 4
                        nbytes = e_bytes(N, K, bs, ob, fmt == "compressed")
                        run = lambda: E(w, od)  # noqa: E731
                        ms = time_cold(torch, run)
                        old = _build.use_library("dequantize_transposed", old_lib)
                        try:
                            old_ms = time_cold(torch, run)
                        finally:
                            _build.use_library("dequantize_transposed", old)
                        row = dict(N=N, K=K, bs=bs, out=str(od).replace("torch.", ""), scales=fmt,
                                   route=plan.body, plan=tuple(plan), max_abs_err=0.0, ms=ms,
                                   old_ms=old_ms,
                                   plain_ms=time_cold(torch, lambda: m4._dequant4_plain(w, od),
                                                      iters=3),
                                   bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                                   bound_by="bytes", library_ms=None)
                        rows.append(row)
                        print(f"  dequantize_transposed N={N:5d} K={K:5d} {row['out']:8s} {fmt:10s}"
                              f" scales: {plan.body} {ms * 1e3:.1f} us (old bodies"
                              f" {old_ms * 1e3:.1f} us, {ms / old_ms:.2f}x) plain"
                              f" {row['plain_ms'] * 1e3:.1f} us bound {row['bound_ms'] * 1e3:.2f} us"
                              f" ({row['bound_ms'] / ms:.0%})", flush=True)
                    del got, ref
                del w
        del W
    layer = {}
    for out in ("bfloat16", "float32"):
        for fmt in ("bf16", "compressed"):
            rs = {(r["N"], r["K"]): r for r in rows if r["out"] == out and r["scales"] == fmt}
            agg = {k: sum(c * rs[nk][k] for nk, c in E_LAYER.items())
                   for k in ("ms", "old_ms", "bound_ms")}
            agg["share"] = agg["bound_ms"] / agg["ms"]
            layer[f"{out} out, {fmt} scales"] = agg
            print(f"  dequantize_transposed over a 7B layer's seven linears, {out} out, {fmt}"
                  f" scales: {agg['ms'] * 1e3:.1f} us (old bodies {agg['old_ms'] * 1e3:.1f} us)"
                  f" against a bound of {agg['bound_ms'] * 1e3:.1f} us ({agg['share']:.0%})",
                  flush=True)
    print(f"  dequantize_transposed: {n_cases} cases bit for bit on both routes (the planes"
          " swapped differ in each)", flush=True)
    for name, out, fmt in (("dequantize_transposed", "bfloat16", "bf16"),
                           ("dequantize_transposed (compressed)", "bfloat16", "compressed"),
                           ("dequantize_transposed (f32 out)", "float32", "bf16")):
        rs = [r for r in rows if r["out"] == out and r["scales"] == fmt]
        report[name] = dict(
            shapes=rs, ms=sum(r["ms"] for r in rs), old_ms=sum(r["old_ms"] for r in rs),
            plain_ms=sum(r["plain_ms"] for r in rs), library_ms=None,
            bound_ms=sum(r["bound_ms"] for r in rs), bound_by="bytes", max_abs_err=0.0,
            layer=layer, cases=n_cases)
    report["dequantize_transposed (compressed, f32 out)"] = dict(
        shapes=[r for r in rows if r["out"] == "float32" and r["scales"] == "compressed"])


def check_repeatable(torch, report, n=100):
    """A race check of the tensor-core bodies: B's tensor-core body in each
    of its tiles (the plans mm4_plan picks at 256 and 1024 rows, and every
    tile forced at 256 rows) and G's wgmma body at 512 and 2048 rows, each
    launched n times on one input at 4096 x 4096; C's tensor-core body and
    the split bodies of D and H and the fused and tensor-core bodies of A
    (whose last CTA merges the splits in order) at their 7B shapes, every
    plan that decode_plan and gemv_plan pick there and other split counts; F's tiled
    body at 4096 x 4096 and I's body (whose last CTA adds the splits) at
    every plan int8_plan picks at the 7B shapes for 4 and 128 rows, at
    three splits, and at 4096 x 4096 in each of its ten wgmma widths; E's
    TMA body at 4096 x 4096 (raw scales, bf16 out; compressed, f32 out)
    and at 32000 x 4096 (compressed, bf16 out: the lean prefill's
    instance, many tiles a CTA, so the ring wraps) and its unaligned route
    at 4100 x 4096. Their
    sums run in a fixed order, so every output must equal the first bit
    for bit; a difference is a race between warps or warpgroups."""
    from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit as m4
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as mw
    from bitsandbytes_sycl_tpu_torch.ops.common import LaunchPlan, quantize_4bit_native, sm_count

    gen = torch.Generator(device="cuda").manual_seed(8)
    N = K = 4096
    W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
    w = quantize_4bit_native(W, 64, "nf4", absmax_dtype=torch.bfloat16)
    del W
    sms = sm_count(w.packed.device)
    cases = ([("mm4_fused", M, m4.mm4_plan(M, N, K, 64, torch.bfloat16, sms)) for M in (256, 1024)]
             + [("mm4_fused", 256, LaunchPlan("tc", bm, 32, 2, bn))
                for bm, bn in ((64, 128), (128, 128), (128, 256), (256, 128))]
             + [("w4a8_grouped", M, mw.grouped_plan(M, N, K, 64, sms)) for M in (512, 2048)])
    rows = []
    for name, M, plan in cases:
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        if name == "mm4_fused":
            run = lambda: m4._mm4_launch(x, w, None, m4._MODE_BF16_TABLE, plan)  # noqa: E731
        else:
            run = lambda: mw._grouped_launch(x, w, None, torch.bfloat16, plan)  # noqa: E731
        first = run()
        differ = sum(int(not torch.equal(run(), first)) for _ in range(n - 1))
        need(differ == 0, f"{name} M={M} plan {tuple(plan)}: {differ} of {n - 1} repeated launches "
                          f"differ from the first (a race)")
        rows.append(dict(kernel=name, M=M, plan=tuple(plan), launches=n))
    # kernel C's tensor-core body at B = 2, T = 512 and D's split body at 16
    # pages (the 7B shapes of check_prefill and check_paged)
    from bitsandbytes_sycl_tpu_torch.ops import attention, paged_attention

    L, H, D, S = 2, 32, 128, 2048
    q = torch.randn((2, 512, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    kq = torch.randint(-127, 128, (L, 2, H, D, S), generator=gen, device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (L, 2, H, S, D), generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand((L, 2, H, S), generator=gen, device="cuda") * 2 + 1
    vs = torch.rand((L, 2, H, S), generator=gen, device="cuda") + 0.5
    starts = torch.zeros((2,), dtype=torch.int32, device="cuda")
    kp, kps, vp, vps, table, qd, new_kv = paged_inputs(torch, gen, L, 4, H, D, 128, 16)
    lens = torch.tensor([2047, 1500, 900, 2000], dtype=torch.int32, device="cuda")
    attn_cases = [
        ("prefill_attn_int8", "tc", lambda: attention.prefill_attn_int8(
            q, kq, ks, vq, vs, 1, starts, 0.01 / 127), lambda: attention.prefill_attn_int8.launches_tc),
        ("paged_attn_int8", "split", lambda: paged_attention.paged_attn_int8(
            qd, kp, kps, vp, vps, 1, table, lens, 0.01 / 127, new_kv=new_kv),
         lambda: paged_attention.paged_attn_int8.launches_split),
        # three splits a row: the last CTA merges the others' partials
        ("paged_attn_int8", "split, 3 splits", lambda: paged_attention._paged_launch(
            qd, kp, kps, vp, vps, 1, table, lens, 0.01 / 127, new_kv, None, None, None,
            paged_attention.PagedPlan("split", 3)),
         lambda: paged_attention.paged_attn_int8.launches_split),
    ]
    # kernel H's split body: the plan's pick at B = 1, 2, 4 (4 rows of
    # check_decode's full cache) and every split count at B = 4
    lens4 = torch.tensor([2047, 1500, 900, 2000], dtype=torch.int32, device="cuda")
    qh = torch.randn((4, H, 1, D), generator=gen, device="cuda").to(torch.bfloat16)
    new4 = tuple(t[:4] for t in new_kv)
    kq4 = torch.randint(-127, 128, (L, 4, H, D, S), generator=gen, device="cuda", dtype=torch.int8)
    vq4 = torch.randint(-127, 128, (L, 4, H, S, D), generator=gen, device="cuda", dtype=torch.int8)
    ks4 = torch.rand((L, 4, H, S), generator=gen, device="cuda") * 2 + 1
    vs4 = torch.rand((L, 4, H, S), generator=gen, device="cuda") + 0.5
    h_plans = [(b, attention.decode_plan(b, H, S, D, 1, torch.bfloat16, sms)) for b in (1, 2, 4)]
    h_plans += [(4, attention.DecodePlan("split", ns)) for ns in (2, 3, 4, 8)]
    for b, plan in h_plans:
        attn_cases.append((
            "decode_attn_int8", f"split, B={b}, {plan.nsplit} splits",
            lambda b=b, plan=plan: attention._decode_launch(
                qh[:b], kq4[:, :b], ks4[:, :b], vq4[:, :b], vs4[:, :b], 1, lens4[:b], 0.01 / 127,
                tuple(t[:b] for t in new4), None, None, None, plan),
            lambda: attention.decode_attn_int8.launches_split))
    for name, body, run, count in attn_cases:
        c0 = count()
        first = run()
        differ = sum(int(not torch.equal(run(), first)) for _ in range(n - 1))
        need(count() == c0 + n, f"{name}: the {body} body did not take every launch")
        need(differ == 0, f"{name} ({body} body): {differ} of {n - 1} repeated launches differ from"
                          f" the first (a race)")
        rows.append(dict(kernel=name, body=body, launches=n))
    del q, kq, vq, ks, vs, kp, kps, vp, vps, kq4, vq4
    # kernel A's fused body: the plan's pick at the four 7B shapes and 1, 4
    # and 8 rows, and every split count at 4096 x 4096 and 4 rows; its
    # tensor-core body: the plan's pick at every A_TC_CELLS row of the 7B
    # shapes, and at 4096 x 4096 four splits at 128 rows (blocksize 64) and
    # one split at 4 rows (blocksize 128)
    n_a = n_tc = 0
    for N2, K2 in SHAPES_7B:
        W2 = torch.randn((N2, K2), generator=gen, device="cuda") / K2 ** 0.5
        for bs in sorted({64} | {b for b, _ in A_TC_CELLS if K2 % (2 * b) == 0}):
            w2 = quantize_4bit_native(W2, bs, "nf4", absmax_dtype=torch.bfloat16)
            for M in sorted([m for b, m in A_TC_CELLS if b == bs]
                            + ([1, 4, mw.GEMV_FUSED_MAX_M] if bs == 64 else [])):
                x = torch.randn((M, K2), generator=gen, device="cuda").to(torch.bfloat16)
                plans = [mw.gemv_plan(M, N2, K2, bs, sms)]
                body = "fused" if M <= mw.GEMV_FUSED_MAX_M and bs == 64 else "tc"
                steps = K2 // 128
                if (N2, K2, M, bs) == (4096, 4096, 4, 64):
                    plans += [LaunchPlan("fused", 4, -(-steps // ks), -(-steps // -(-steps // ks)))
                              for ks in (1, 2, 3, 4, 6)]
                if (N2, K2, M, bs) == (4096, 4096, 128, 64):
                    plans.append(LaunchPlan("tc", 128, steps // 4, 4, 64))
                if (N2, K2, M, bs) == (4096, 4096, 4, 128):
                    plans.append(LaunchPlan("tc", 16, steps, 1, 128))
                for plan in plans:
                    need(plan.body == body, f"gemv_plan gave M={M} bs={bs} the {plan.body} body")
                    count = lambda: getattr(mw.w4a8_gemv, f"launches_{body}")  # noqa: E731
                    c0 = count()
                    run = lambda: mw._gemv_launch(x, w2, None, torch.bfloat16, plan)  # noqa: E731
                    first = run()
                    differ = sum(int(not torch.equal(run(), first)) for _ in range(n - 1))
                    need(count() == c0 + n, f"w4a8_gemv: the {body} body did not run")
                    need(differ == 0, f"w4a8_gemv N={N2} K={K2} bs={bs} M={M} plan {tuple(plan)}:"
                                      f" {differ} of {n - 1} repeated launches differ from the first"
                                      " (a race)")
                    rows.append(dict(kernel="w4a8_gemv", N=N2, K=K2, bs=bs, M=M, plan=tuple(plan),
                                     launches=n))
                    n_a += body == "fused"
                    n_tc += body == "tc"
            del w2
        del W2
    # kernel E on each route: the TMA body at 4096 x 4096 (raw and
    # compressed scales) and 32000 x 4096 (compressed, bf16 out), and the
    # unaligned route at 4100 x 4096
    W4 = torch.randn((32000, K), generator=gen, device="cuda") / K ** 0.5
    e_cases = [("tma", w, torch.bfloat16), ("tma", quantize_4bit_native(
        W4[:N].contiguous(), 64, "nf4", compress_statistics=True), torch.float32),
        ("tma", quantize_4bit_native(W4, 64, "nf4", compress_statistics=True), torch.bfloat16),
        ("unaligned", quantize_4bit_native(W4[:4100].contiguous(), 64, "nf4",
                                           absmax_dtype=torch.bfloat16), torch.bfloat16)]
    del W4
    for route, we, od in e_cases:
        plan = m4.dequant4_plan(we.shape[0], K, 64, sms, we.compressed)
        need(plan.body == route, f"dequant4_plan gave N={we.shape[0]} the {plan.body} route")
        first = m4._dequant4_launch(we, od, plan)
        differ = sum(int(not torch.equal(m4._dequant4_launch(we, od, plan), first))
                     for _ in range(n - 1))
        need(differ == 0, f"dequantize_transposed {route} N={we.shape[0]} plan {tuple(plan)}:"
                          f" {differ} of {n - 1} repeated launches differ from the first")
        rows.append(dict(kernel="dequantize_transposed", N=we.shape[0], K=K, plan=tuple(plan),
                         compressed=we.compressed, launches=n))
    del e_cases, first
    # kernel F's tiled body at 4096 x 4096, and kernel I (whose last CTA
    # adds the splits' sums) at every plan int8_plan picks at the 7B shapes
    # for 4 and 128 rows, one other split count, and 4096 x 4096 at the
    # other wgmma widths (rows 2 short of each)
    from bitsandbytes_sycl_tpu_torch import functional as F
    from bitsandbytes_sycl_tpu_torch.ops import matmul_int8 as mi

    _, f = mw.col_grid(w)
    plan = mw.dequant8_plan(N, K, 64, sms)
    t0 = mw.dequant_int8.launches_tiled
    first = mw._dequant8_launch(w, f, plan)
    differ = sum(int(not torch.equal(mw._dequant8_launch(w, f, plan), first)) for _ in range(n - 1))
    need(mw.dequant_int8.launches_tiled == t0 + n, "dequant_int8: the tiled body did not run")
    need(differ == 0, f"dequant_int8 plan {tuple(plan)}: {differ} of {n - 1} repeated launches"
                      f" differ from the first")
    rows.append(dict(kernel="dequant_int8", N=N, K=K, plan=tuple(plan), launches=n))
    n_i = 0
    for N2, K2 in ((4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)):
        W2 = torch.randn((N2, K2), generator=gen, device="cuda") / K2 ** 0.5
        CB, SCB = F.int8_vectorwise_quant(W2)
        del W2
        widths = mi.INT8_WIDTHS[1:-1] if (N2, K2) == (4096, 4096) else ()
        for M in (4, 128) + tuple(wd - 2 for wd in widths):
            x = torch.randn((M, K2), generator=gen, device="cuda").to(torch.bfloat16)
            inv = 127.0 * F._safe_inv(x.float().abs().amax(dim=1))
            plans = [mi.int8_plan(M, N2, K2, sms)]
            if (N2, K2, M) == (4096, 4096, 4):
                plans.append(mi.int8_split_plan(M, N2, K2, 3, sms))  # three splits
            for plan in plans:
                run = lambda: mi._int8_launch(x, inv, CB, SCB, None, torch.bfloat16, plan)  # noqa: E731
                first = run()
                differ = sum(int(not torch.equal(run(), first)) for _ in range(n - 1))
                need(differ == 0, f"int8_matmul N={N2} K={K2} M={M} plan {tuple(plan)}: {differ} of"
                                  f" {n - 1} repeated launches differ from the first (a race)")
                rows.append(dict(kernel="int8_matmul", N=N2, K=K2, M=M, plan=tuple(plan), launches=n))
                n_i += 1
        del CB, SCB
    print(f"  {len(cases)} plans of B's tensor-core and G's wgmma bodies, C's tensor-core, D's and"
          f" H's split bodies ({len(h_plans)} plans of H), {n_a} plans of A's fused body and {n_tc}"
          f" of its tensor-core body, E's TMA"
          f" body (raw and compressed scales) and unaligned route, F's tiled"
          f" body and {n_i} plans of I at 7B shapes, {n} launches each on one input: every output"
          f" equal to the first bit for bit", flush=True)
    report["repeatable"] = rows


def check_routes(torch, report):
    """The long-prompt routes whole, with the glue around their kernels, at
    the four 7B shapes and the row counts that reach them:
    - W8A8 (kernel F, the row quantization kernel, torch._int_mm and the
      f32 epilogue) at 4096 rows against its plain version (float64 int8
      product) on the same inputs, within 2 f32 ulps (1 bf16 ulp), with
      the colmax of the next column as its fault;
    - dequantize-once (kernel E, then cuBLAS) at 2048 rows, and at 256 for
      down_proj (half-K not a multiple of 8 blocks), against an f32 product
      of the plain dense weight, within 1% of the largest output (bf16: the
      bias lands after the cast), with the planes swapped as its fault.
    Each call must launch its kernel once and no other linear kernel."""
    from bitsandbytes_sycl_tpu_torch.ops import KERNELS
    from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit as m4
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as mw
    from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for N, K in [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]:
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        w = quantize_4bit_native(W, 64, "nf4", absmax_dtype=torch.bfloat16)
        del W
        bias = torch.randn((N,), generator=gen, device="cuda")
        cases = [("w8a8", 4096), ("dequantize-once", 2048)]
        if K == 11008:
            cases.append(("dequantize-once", 256))
        for route, M in cases:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            reset_counts(KERNELS)
            if route == "w8a8":
                got = mw.matmul_4bit_w8a8_prefill(x, w, bias, torch.bfloat16)
                want = {"dequant_int8": 1, "dequant_int8.tiled": 1}
                ref = mw._w8a8_plain(x, w, bias, torch.bfloat16)
                col_grid = mw._col_grid
                mw._col_grid = lambda w_: (lambda cm_, f_: (cm_.roll(-1), f_))(*col_grid(w_))
                try:
                    bad = mw._w8a8_plain(x, w, bias, torch.bfloat16)
                finally:
                    mw._col_grid = col_grid
                err = ulp_ratio(torch, got, ref, torch.bfloat16, bias)
                fault, tol = ulp_ratio(torch, bad, ref, torch.bfloat16, bias), 1.0
                unit = "bf16 ulps"
            else:
                got = m4.matmul_4bit_fused(x, w, bias, torch.bfloat16)
                want = {"dequantize_transposed": 1, "dequantize_transposed.tma": 1}
                hi, lo = m4._decode_planes(w, m4._MODE_BF16_TABLE, torch.bfloat16)
                ref = x.float() @ torch.cat([hi, lo]).float() + bias
                bad = x.float() @ torch.cat([lo, hi]).float() + bias
                del hi, lo
                err, scale = max_err(torch, got, ref)
                tol = 1e-2 * scale
                fault = max_err(torch, bad, ref)[0]
                unit = "abs"
            counts = {k: v for k, v in read_counts(KERNELS).items() if v}
            need(counts == want, f"{route} route N={N} K={K} M={M}: launches {counts}, not {want}")
            need(err <= tol, f"{route} route N={N} K={K} M={M}: error {err} > {tol} ({unit})")
            need(fault > tol, f"{route} route N={N} K={K} M={M}: its fault lands within the "
                              f"tolerance ({fault} <= {tol})")
            fn = ((lambda: mw.matmul_4bit_w8a8_prefill(x, w, bias, torch.bfloat16)) if route == "w8a8"
                  else (lambda: m4.matmul_4bit_fused(x, w, bias, torch.bfloat16)))
            row = dict(route=route, N=N, K=K, M=M, err=err, tol=tol, unit=unit, fault=fault,
                       ms=time_cold(torch, fn, iters=10))
            rows.append(row)
            print(f"  {route:15s} route N={N:5d} K={K:5d} M={M:4d} err {err:.3g} (tol {tol:.3g} {unit};"
                  f" fault {fault:.3g}) route {row['ms']*1e3:.1f} us", flush=True)
            del x, got, ref, bad
        del w, bias
    reset_counts(KERNELS)
    report["routes"] = rows


# Kernel C's precision limit: relative L2 error over every output of the
# 7B check. On the H100 the tensor-core body reads about a third of it, its
# plain version with P rounded to f16 about three times it and to bf16
# about nine times (PERF.md).
PREFILL_L2_TOL = 3e-4


def rel_l2(torch, got, ref):
    g, r = got.float(), ref.float()
    return float((g - r).norm() / r.norm())


def prefill_plain_p_rounded(torch, q, kq, ks, vq, vs, li, scale, dtype):
    """A deliberate precision fault of kernel C: its plain version (causal,
    starts 0, no options, Hq = Hkv) with P, the softmax weights times
    v_scale / 127, rounded to ``dtype`` before P.V."""
    T, S = q.shape[1], vq.shape[3]
    sc = (q.float().permute(0, 2, 1, 3) @ kq[li].float()) * (ks[li][:, :, None, :] * scale)
    causal = torch.arange(S, device=q.device)[None, :] <= torch.arange(T, device=q.device)[:, None]
    sc = torch.where(causal, sc, torch.full_like(sc, -1e30))
    w = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = (w * (vs[li][:, :, None, :] / 127.0)).to(dtype).float()
    return ((p @ vq[li].float()) / w.sum(dim=-1, keepdim=True)).permute(0, 2, 1, 3).to(q.dtype)


def check_prefill(torch, report):
    """Kernel C at the prefill batch of short prompts (B=4, T=32) and of one
    long-prompt batch (B=2, T=512), over a 2048-position cache, bf16 q: the
    body prefill_plan picks (the tensor-core one) within 1% of the largest
    output, deliberate faults outside it; its precision within a relative
    L2 error of PREFILL_L2_TOL, which the plain version with P rounded to
    bf16 or to f16 exceeds; both bodies timed (the SIMT one is what bf16 q
    ran on before), beside the plain version and SDPA's fused backends over
    the same bf16 K/V prefix."""
    from bitsandbytes_sycl_tpu_torch.ops import attention
    from bitsandbytes_sycl_tpu_torch.ops.attention import prefill_plan

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for B, T in ((4, 32), (2, 512)):
        L, H, D, S, li = 2, 32, 128, 2048, 1
        q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        kq = torch.randint(-127, 128, (L, B, H, D, S), generator=gen, device="cuda", dtype=torch.int8)
        vq = torch.randint(-127, 128, (L, B, H, S, D), generator=gen, device="cuda", dtype=torch.int8)
        # k scales in [1, 3) give O(1) scores (q ~ N(0, 1) and codes uniform in
        # +-127 make q.k_i8 ~ 73 sqrt(D) wide, times ks / (127 sqrt(D))), so a
        # wrong QK product moves the softmax well past the tolerance
        ks = torch.rand((L, B, H, S), generator=gen, device="cuda") * 2 + 1
        vs = torch.rand((L, B, H, S), generator=gen, device="cuda") + 0.5
        starts = torch.zeros((B,), dtype=torch.int32, device="cuda")
        scale = (1.0 / D ** 0.5) / 127.0
        body = prefill_plan(D, S, q.dtype)
        need(body == "tc", f"prefill_plan gave bf16 q at D=128 the {body} body")
        tc0 = attention.prefill_attn_int8.launches_tc
        kern = lambda: attention.prefill_attn_int8(q, kq, ks, vq, vs, li, starts, scale)  # noqa: E731
        simt = lambda: attention._prefill_launch(  # noqa: E731
            q, kq, ks, vq, vs, li, starts, scale, None, None, None, "simt")
        plain = lambda: attention._prefill_plain(q, kq, ks, vq, vs, li, starts, scale, None, None, None)  # noqa: E731
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        need(attention.prefill_attn_int8.launches_tc == tc0 + 1,
             f"prefill_attn_int8 T={T}: bf16 q did not take the tensor-core body")
        err, mag = max_err(torch, got, ref)
        tol = 1e-2 * mag
        need(err <= tol, f"prefill_attn_int8 T={T}: max err {err} > {tol}")
        err_simt, _ = max_err(torch, simt(), ref)
        need(err_simt <= tol, f"prefill_attn_int8 SIMT body T={T}: max err {err_simt} > {tol}")
        # the 1% limit is one or two ulps of the bf16 output, so it cannot
        # see P rounded to bf16 (which moved phase 5's logits over 4%); the
        # relative L2 error over every output can
        l2 = rel_l2(torch, got, ref)
        need(l2 <= PREFILL_L2_TOL, f"prefill_attn_int8 T={T}: relative L2 err {l2} > {PREFILL_L2_TOL}")
        l2_faults = {}
        for dt in (torch.bfloat16, torch.float16):
            l2_faults[str(dt)[6:]] = e = rel_l2(torch, prefill_plain_p_rounded(
                torch, q, kq, ks, vq, vs, li, scale, dt), ref)
            need(e > PREFILL_L2_TOL, f"prefill_attn_int8 T={T}: the plain version with P rounded to"
                                     f" {dt} lands within the L2 limit ({e} <= {PREFILL_L2_TOL})")
        k_other = kq.clone()
        k_other[li] = kq[li - 1]
        margin = faults_exceed(torch, f"prefill_attn_int8 T={T}", ref, [
            ("K of the next kv head", lambda: attention._prefill_plain(
                q, kq.roll(1, dims=2), ks, vq, vs, li, starts, scale, None, None, None)),
            ("K of another layer", lambda: attention._prefill_plain(
                q, k_other, ks, vq, vs, li, starts, scale, None, None, None)),
            ("k_scale dropped", lambda: attention._prefill_plain(
                q, kq, torch.full_like(ks, 2.0), vq, vs, li, starts, scale, None, None, None)),
        ], tol)
        del k_other
        # SDPA over the same causal prefix, bf16 K/V dequantized, every
        # operand with a contiguous last dimension (the fused backends need it)
        kd = (kq[li, :, :, :, :T].float() * (ks[li, :, :, None, :T] / 127)).permute(0, 1, 3, 2) \
            .contiguous().to(torch.bfloat16)
        vd = (vq[li, :, :, :T].float() * (vs[li, :, :, :T, None] / 127)).to(torch.bfloat16)
        qh = q.permute(0, 2, 1, 3).contiguous()
        lib_ms, lib_name, lib_all = time_sdpa(torch, qh, kd, vd, is_causal=True)
        # bytes: q and out (bf16), the int8 K/V prefix and its scales
        nbytes = 2 * B * T * H * D * 2 + 2 * B * H * T * D + 2 * B * H * T * 4
        flops = 4 * B * H * T * (T + 1) // 2 * D
        bound_tc = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
        bound_f32 = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        row = dict(B=B, T=T, H=H, D=D, S=S, body=body, max_abs_err=err, tol=tol,
                   simt_max_abs_err=err_simt, fault_margin=margin, rel_l2=l2,
                   rel_l2_tol=PREFILL_L2_TOL, rel_l2_p_rounded=l2_faults,
                   ms=time_cold(torch, kern), simt_ms=time_cold(torch, simt),
                   plain_ms=time_cold(torch, plain, iters=5), library_ms=lib_ms,
                   library_backend=lib_name, library_all=lib_all, bytes=nbytes, flops=flops,
                   bound_ms=bound_tc, bound_f32_ms=bound_f32,
                   bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
                   else "operations")
        rows.append(row)
        print(f"  prefill_attn_int8 B={B} T={T} S={S} err={err:.3g} rel={err / mag:.2g} (tol {tol:.3g};"
              f" faults >= {margin:.3g}x tol; rel L2 {l2:.3g}, P rounded to bf16 / f16"
              f" {l2_faults['bfloat16']:.3g} / {l2_faults['float16']:.3g}, limit {PREFILL_L2_TOL})"
              f" tensor-core {row['ms']*1e3:.1f} us, SIMT"
              f" {row['simt_ms']*1e3:.1f} us, plain {row['plain_ms']*1e3:.1f} us, sdpa"
              f" {fmt_us(lib_ms)} ({lib_name}); bound {bound_tc*1e3:.2f} us bf16"
              f" ({bound_tc / row['ms']:.0%}), {bound_f32*1e3:.2f} us f32"
              f" ({bound_f32 / row['simt_ms']:.0%} of SIMT)", flush=True)
        print(f"    sdpa backends: {json.dumps({k: (round(v * 1e3, 1) if isinstance(v, float) else v) for k, v in lib_all.items()})}",
              flush=True)
        del q, kq, vq, ks, vs, kd, vd, qh
    report["prefill_attn_int8"] = dict(rows[0], shapes=rows)


def paged_inputs(torch, gen, L, B, H, D, P, MAXP):
    """A page pool with O(1) scores, a random page table over pages 1.., a
    bf16 query and a new_kv token."""
    NP = B * MAXP + 1
    kp = torch.randint(-127, 128, (L, NP, H, P, D), generator=gen, device="cuda", dtype=torch.int8)
    vp = torch.randint(-127, 128, (L, NP, H, P, D), generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand((L, NP, H, P), generator=gen, device="cuda") * 2 + 1  # O(1) scores
    vs = torch.rand((L, NP, H, P), generator=gen, device="cuda") + 0.5
    perm = torch.randperm(NP - 1, generator=gen, device="cuda")[: B * MAXP] + 1
    table = perm.reshape(B, MAXP).to(torch.int32)
    q = torch.randn((B, H, 1, D), generator=gen, device="cuda").to(torch.bfloat16)
    new_kv = (torch.randint(-127, 128, (B, H, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, H), generator=gen, device="cuda") * 2 + 1,
              torch.randint(-127, 128, (B, H, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, H), generator=gen, device="cuda") + 0.5)
    return kp, ks, vp, vs, table, q, new_kv


def check_paged(torch, report):
    """Kernel D at Hkv = 32, D = P = 128 over a 16-page table: B = 4 at one
    used page and at 16, B = 1 at 15 and B = 2 at 16 (where paged_plan
    splits the rows to fill the SMs; a page of B = 1's table stays unused,
    so the table read one entry off shows). The body paged_plan picks (the split one) within
    1% of the largest output, deliberate faults outside it; timed beside
    the SIMT body, every split count (one CTA per row among them), the
    plain version and SDPA's fused backends over the gathered bf16 K/V."""
    from bitsandbytes_sycl_tpu_torch.ops import paged_attention
    from bitsandbytes_sycl_tpu_torch.ops.common import sm_count
    from bitsandbytes_sycl_tpu_torch.ops.paged_attention import PagedPlan, paged_plan

    gen = torch.Generator(device="cuda").manual_seed(3)
    L, H, D, P, MAXP, li = 2, 32, 128, 128, 16, 1
    scale = (1.0 / D ** 0.5) / 127.0
    rows = []
    B = None
    for label, lens_l in (("1 page", [40, 64, 17, 33]), ("16 pages", [2047, 1500, 900, 2000]),
                          ("15 pages", [1900]), ("16 pages", [2047, 1500])):
        if len(lens_l) != B:
            B = len(lens_l)
            kp, ks, vp, vs, table, q, new_kv = paged_inputs(torch, gen, L, B, H, D, P, MAXP)
            k_other = kp.clone()
            k_other[li] = kp[li - 1]
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        # with the page horizon the engine passes (the used pages, bucketed)
        hint = max(-(-n // P) for n in lens_l)
        plan = paged_plan(B, H, MAXP, P, D, 1, sm_count(q.device), hint)
        need(plan.body == "split", f"paged_plan gave the 7B shape the {plan.body} body")
        sp0 = paged_attention.paged_attn_int8.launches_split
        kern = lambda: paged_attention.paged_attn_int8(  # noqa: E731
            q, kp, ks, vp, vs, li, table, lens, scale, new_kv=new_kv, pages_hint=hint)
        plain = lambda: paged_attention._paged_plain(  # noqa: E731
            q, kp, ks, vp, vs, li, table, lens, new_kv, scale, None, None, None)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        need(paged_attention.paged_attn_int8.launches_split == sp0 + 1,
             f"paged_attn_int8 ({label}): the 7B shape did not take the split body")
        err, mag = max_err(torch, got, ref)
        tol = 1e-2 * mag
        need(err <= tol, f"paged_attn_int8 ({label}): max err {err} > {tol}")

        def plain_with(kp_=kp, ks_=ks, table_=table):
            return paged_attention._paged_plain(q, kp_, ks_, vp, vs, li, table_, lens, new_kv,
                                                scale, None, None, None)

        margin = faults_exceed(torch, f"paged_attn_int8 ({label})", ref, [
            ("K of the next kv head", lambda: plain_with(kp_=kp.roll(1, dims=2))),
            ("K of another layer", lambda: plain_with(kp_=k_other)),
            ("k_scale dropped", lambda: plain_with(ks_=torch.full_like(ks, 2.0))),
            ("the page table read one entry off", lambda: plain_with(table_=table.roll(1, dims=1))),
        ], tol)
        # every split count, and the SIMT body (what ran before)
        alts = {}
        for body, nsplit in [("simt", 1)] + [("split", n) for n in (1, 2, 3, 4, 6, 8, 16)]:
            alt = PagedPlan(body, nsplit)
            run = lambda alt=alt: paged_attention._paged_launch(  # noqa: E731
                q, kp, ks, vp, vs, li, table, lens, scale, new_kv, None, None, None, alt)
            e_alt, _ = max_err(torch, run(), ref)
            need(e_alt <= tol, f"paged_attn_int8 ({label}) {tuple(alt)}: max err {e_alt} > {tol}")
            alts[f"{body} nsplit={alt.nsplit}"] = time_cold(torch, run)
        Smax = max(lens_l) + 1
        used = [-(-n // P) for n in lens_l]
        pt = table.long()

        def gathered(pages, scales):
            return (pages[li][pt].permute(0, 2, 1, 3, 4).reshape(B, H, MAXP * P, D)[:, :, :Smax]
                    .float() * (scales[li][pt].permute(0, 2, 1, 3).reshape(B, H, MAXP * P)
                                [:, :, :Smax, None] / 127)).contiguous().to(torch.bfloat16)

        kd, vd = gathered(kp, ks), gathered(vp, vs)
        mask = (torch.arange(Smax, device="cuda")[None, :] <= lens[:, None])[:, None, None, :]
        lib_ms, lib_name, lib_all = time_sdpa(torch, q, kd, vd, attn_mask=mask)
        # the K/V rows the lengths need (token-major rows: a kernel can stop
        # at len), q and out, the new token, the used table entries, lengths
        nbytes = (sum(lens_l) * H * (2 * D + 8) + 2 * B * H * D * 2 + B * H * (2 * D + 8)
                  + 4 * sum(used) + 4 * B)
        flops = 4 * (sum(lens_l) + B) * H * D
        row = dict(label=label, B=B, lens=lens_l, plan=tuple(plan), max_abs_err=err, tol=tol,
                   fault_margin=margin, ms=time_cold(torch, kern), plans_ms=alts,
                   one_cta_per_row_ms=alts["split nsplit=1"],
                   plain_ms=time_cold(torch, plain, iters=5), library_ms=lib_ms,
                   library_backend=lib_name, library_all=lib_all, bytes=nbytes,
                   bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3,
                   bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations")
        rows.append(row)
        print(f"  paged_attn_int8 B={B} {label} {tuple(plan)} err={err:.3g} rel={err / mag:.2g} (tol"
              f" {tol:.3g}; faults >= {margin:.3g}x tol) kernel {row['ms']*1e3:.1f} us (one CTA"
              f" per row {row['one_cta_per_row_ms']*1e3:.1f} us) plain"
              f" {row['plain_ms']*1e3:.1f} us sdpa {fmt_us(lib_ms)} ({lib_name}) bound"
              f" {row['bound_ms']*1e3:.2f} us ({row['bound_ms'] / row['ms']:.0%})", flush=True)
        print(f"    plans (us): {json.dumps({k: round(v * 1e3, 1) for k, v in alts.items()})};"
              f" sdpa backends: {json.dumps({k: (round(v * 1e3, 1) if isinstance(v, float) else v) for k, v in lib_all.items()})}",
              flush=True)
        del kd, vd
    del k_other, kp, vp
    report["paged_attn_int8"] = dict(rows[0], shapes=rows)


# --------------------------------------------------------------- slice 10: compressed scales, kv4 pages
def check_compressed(torch, report):
    """Kernel B on compressed statistics (compress_stats: uint8 dynamic-map
    codes of the block scales with a range and mean per plane and column)
    at the 7B shapes, NF4 bs 64 (E's: check_dequant4). B in both bodies, the
    tensor-core one (bf16 x) and the SIMT one (f32 x), at 4, 256 and 2048
    rows (the SIMT body at 2048 rows at 4096 x 4096 only: it decodes the
    weight again for every 4-row tile), within 1% of the largest output;
    the plain version fed the lo plane's codes on the hi plane, or the
    scales decoded without their column mean, must land outside it. The
    W8A8 route's col_grid (which decodes the codes) and F on its grid, bit
    for bit. Every tensor-core plan repeats its bits over 100 launches.
    Timed: B at 4 and 256 rows beside the same weight with raw bf16 scales,
    its plain version and bf16 torch.matmul; a small-shape sweep of the
    decode modes, tiles and blocksizes follows."""
    import dataclasses as dc

    from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit as m4
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as mw
    from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native, sm_count

    gen = torch.Generator(device="cuda").manual_seed(21)
    shapes = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]
    rows_b = []
    n_rep = 0
    for N, K in shapes:
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        w = quantize_4bit_native(W, 64, "nf4", compress_statistics=True)
        w_raw = quantize_4bit_native(W, 64, "nf4", absmax_dtype=torch.bfloat16)
        Wd = W.to(torch.bfloat16)
        del W
        need(w.compressed and w.absmax.dtype == torch.uint8, "compress_statistics gave raw scales")
        # the W8A8 route's grid: col_grid decodes the codes in its kernel,
        # then F, both bit for bit
        colmax, f = mw.col_grid(w)
        colmax_p, f_p = mw._col_grid(w)
        need(torch.equal(colmax, colmax_p) and torch.equal(f, f_p),
             f"col_grid compressed N={N} K={K}: not bit for bit")
        need(torch.equal(mw.dequant_int8(w, f), mw._dequant8_plain(w, f_p)),
             f"dequant_int8 on decoded compressed scales N={N} K={K}: not bit for bit")
        del colmax, f, colmax_p, f_p
        w_lo = dc.replace(w, absmax=w.absmax[1:].expand(2, -1, -1).contiguous())
        w_nomean = dc.replace(w, absmax_offset=torch.zeros_like(w.absmax_offset))
        # B, both bodies
        for M in (4, 256, 2048):
            for body, dt in (("tc", torch.bfloat16), ("simt", torch.float32)):
                if body == "simt" and M == 2048 and (N, K) != (4096, 4096):
                    continue
                x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
                mode = m4._decode_mode(w, dt, None)
                plan = m4.mm4_plan(M, N, K, 64, dt, sm_count(x.device), True)
                need(plan.body == body, f"mm4_plan gave {dt} x the {plan.body} body")
                kern = lambda: m4.mm4_fused(x, w, None, dt)  # noqa: E731
                plain = lambda: m4._mm4_plain(x, w, None, dt, mode)  # noqa: E731
                tc0, c0 = m4.mm4_fused.launches_tc, m4.mm4_fused.launches_compressed
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                need(m4.mm4_fused.launches_compressed == c0 + 1
                     and m4.mm4_fused.launches_tc == tc0 + int(body == "tc"),
                     f"mm4_fused compressed N={N} K={K} M={M}: not one {body} launch")
                err, scale = max_err(torch, got, ref)
                tol = 1e-2 * scale
                need(err <= tol, f"mm4_fused compressed {body} N={N} K={K} M={M}: max err {err} > {tol}")
                margin = faults_exceed(torch, f"mm4_fused compressed {body} N={N} K={K} M={M}", ref, [
                    ("the lo plane's codes on the hi plane",
                     lambda: m4._mm4_plain(x, w_lo, None, dt, mode)),
                    ("the scales decoded without their column mean",
                     lambda: m4._mm4_plain(x, w_nomean, None, dt, mode))], tol)
                row = dict(N=N, K=K, M=M, body=body, plan=tuple(plan), max_abs_err=err, tol=tol,
                           fault_over_tol=margin)
                if body == "tc":
                    first = m4._mm4_launch(x, w, None, mode, plan)
                    differ = sum(int(not torch.equal(m4._mm4_launch(x, w, None, mode, plan), first))
                                 for _ in range(99))
                    need(differ == 0, f"mm4_fused compressed N={N} K={K} M={M} plan {tuple(plan)}:"
                                      f" {differ} of 99 repeated launches differ from the first")
                    n_rep += 1
                if body == "tc" and M in (4, 256):
                    nbytes = M * K * 2 + N * K // 2 + N * K // 64 + 16 * N + M * N * 2
                    ops_ = 2 * M * N * K
                    peak = F32_FLOPS_PER_S if M == 4 else BF16_FLOPS_PER_S
                    row.update(ms=time_cold(torch, kern),
                               raw_ms=time_cold(torch, lambda: m4.mm4_fused(x, w_raw, None, dt)),
                               plain_ms=time_cold(torch, plain, iters=5),
                               library_ms=time_cold(torch, lambda: torch.matmul(x, Wd.T)),
                               bytes=nbytes,
                               bound_ms=max(nbytes / HBM_BYTES_PER_S, ops_ / peak) * 1e3,
                               bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops_ / peak
                               else "operations")
                rows_b.append(row)
                print(f"  mm4_fused compressed {body:4s} N={N:5d} K={K:5d} M={M:4d} {tuple(plan)}"
                      f" err={err:.3g} rel={err / scale:.2g} (tol {tol:.3g}; faults >= {margin:.3g}x"
                      f" tol)" + (f"; 100 launches equal" if body == "tc" else "")
                      + (f"; kernel {row['ms']*1e3:.1f} us (raw bf16 scales {row['raw_ms']*1e3:.1f}"
                         f" us) plain {row['plain_ms']*1e3:.1f} us bf16 matmul"
                         f" {row['library_ms']*1e3:.1f} us bound {row['bound_ms']*1e3:.2f} us"
                         f" ({row['bound_ms'] / row['ms']:.0%})" if "ms" in row else ""), flush=True)
                del got, ref, x
        del w, w_raw, w_lo, w_nomean, Wd
    n_edge = compressed_edges(torch, gen)
    print(f"  compressed scales: {n_edge} small-shape cases (decode modes 0-2 in both bodies, every"
          f" tile, blocksizes 32-256, int4, E's ragged strips) within tolerance; {n_rep} plans and"
          f" shapes repeated 100 times", flush=True)
    timed = [r for r in rows_b if "ms" in r and r["M"] == 4 and r["body"] == "tc"]
    report["mm4_fused (compressed)"] = dict(
        shapes=rows_b, ms=sum(r["ms"] for r in timed), plain_ms=sum(r["plain_ms"] for r in timed),
        raw_ms=sum(r["raw_ms"] for r in timed), library_ms=sum(r["library_ms"] for r in timed),
        bound_ms=sum(r["bound_ms"] for r in timed), bound_by=timed[0]["bound_by"],
        max_abs_err=max(r["max_abs_err"] for r in rows_b))


def compressed_edges(torch, gen):
    """Compressed scales on small shapes the 7B path does not reach: kernel
    B's decode modes 0 (f32 table), 1 (int4) and 2 (bf16 table) in its
    tensor-core body (every tile it takes with compressed scales) and its
    SIMT body (bf16 x too), blocksizes 32, 64, 128 and 256, a whole-half K
    (1152) and 384 columns; kernel E at the same weights, f32 and bf16
    out, bit for bit, its strips ragged in rows and columns (N = 400).
    Returns the number of comparisons."""
    from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit as m4
    from bitsandbytes_sycl_tpu_torch.ops.common import LaunchPlan, _ksplit, quantize_4bit_native

    n = 0
    for qt, bs, N, K in (("nf4", 64, 384, 1152), ("int4", 32, 256, 512), ("fp4", 128, 384, 1024),
                         ("nf4", 256, 256, 1024), ("nf4", 64, 400, 640)):
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        w = quantize_4bit_native(W, bs, qt, compress_statistics=True)
        for od in (torch.float32, torch.bfloat16):
            got, ref = m4.dequantize_transposed(w, od), m4._dequant4_plain(w, od)
            torch.cuda.synchronize()
            need(torch.equal(got, ref), f"dequantize_transposed compressed {qt} bs={bs} N={N} K={K}"
                                        f" {od}: not bit for bit")
            n += 1
        if N % 128:
            continue
        for M in (3, 70):
            for dt, decode_dtype in ((torch.bfloat16, None), (torch.bfloat16, torch.float32),
                                     (torch.float32, None)):
                x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
                mode = m4._decode_mode(w, dt, decode_dtype)
                ref = m4._mm4_plain(x, w, None, dt, mode)
                plans = []
                if dt == torch.bfloat16 and (K // 2) % 32 == 0 and (bs % 32 == 0 or 32 % bs == 0):
                    plans += [LaunchPlan("tc", bm, per, 1, bn) for bm, bn, per in
                              ((64, 128, K // 64), (128, 128, K // 64), (256, 128, K // 64),
                               (64, 128, max(1, bs // 32)))]
                g, ks = _ksplit(K // (2 * bs), N // 128, -(-M // 4))
                plans.append(LaunchPlan("simt", 4, g, ks))
                for plan in plans:
                    if plan.body == "tc" and plan.per * 32 < K // 2:
                        plan = plan._replace(ksplit=-(-(K // 64) // plan.per))
                    got = m4._mm4_launch(x.contiguous(), w, None, mode, plan)
                    torch.cuda.synchronize()
                    err, mag = max_err(torch, got, ref)
                    need(err <= 1e-2 * mag, f"mm4_fused compressed {qt} bs={bs} M={M} {dt} mode"
                                            f" {mode} plan {tuple(plan)}: max err {err} > 1% of {mag}")
                    n += 1
    return n


def kv4_inputs(torch, gen, L, B, H, D, P, MAXP):
    """A kv4 page pool (sign-magnitude nibble pairs on the +-7 grid, scales
    in column order) with O(1) scores, a random page table over pages 1..,
    a bf16 query and a new_kv token on the +-7 grid."""
    NP = B * MAXP + 1

    def pages():
        c = torch.randint(-7, 8, (L, NP, H, P, D), generator=gen, device="cuda", dtype=torch.int8)
        nib = (c.abs() + 8 * (c < 0)).to(torch.uint8)
        return (nib[..., 0::2, :] << 4) | nib[..., 1::2, :]

    kp, vp = pages(), pages()
    ks = torch.rand((L, NP, H, P), generator=gen, device="cuda") * 8 + 4  # O(1) scores over +-7
    vs = torch.rand((L, NP, H, P), generator=gen, device="cuda") + 0.5
    perm = torch.randperm(NP - 1, generator=gen, device="cuda")[: B * MAXP] + 1
    table = perm.reshape(B, MAXP).to(torch.int32)
    q = torch.randn((B, H, 1, D), generator=gen, device="cuda").to(torch.bfloat16)
    new_kv = (torch.randint(-7, 8, (B, H, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, H), generator=gen, device="cuda") * 8 + 4,
              torch.randint(-7, 8, (B, H, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, H), generator=gen, device="cuda") + 0.5)
    return kp, ks, vp, vs, table, q, new_kv


def check_kv4(torch, report):
    """Kernel D over kv4 pages (kv_bits=4: nibble pairs of adjacent tokens,
    scales in parity-grouped column order) at Hkv = 32, D = P = 128 over a
    16-page table, with new_kv: B = 4 at one used page and at 16, B = 1 at
    15 and B = 2 at 16, odd and even lengths. The split body (the plan's)
    and the SIMT body within 1% of the largest output; the plain version
    fed swapped nibbles, the scales in token order, V at 1/127 or the next
    kv head must land outside it. Timed beside every split count, the
    plain version and SDPA's fused backends over the gathered bf16 K/V;
    the plan and three splits repeat their bits over 100 launches; then
    the options on small shapes (window, softcap, ALiBi, rep 2, 4 and 8,
    length 0)."""
    from bitsandbytes_sycl_tpu_torch.ops import paged_attention as pa
    from bitsandbytes_sycl_tpu_torch.ops.common import sm_count

    gen = torch.Generator(device="cuda").manual_seed(23)
    L, H, D, P, MAXP, li = 2, 32, 128, 128, 16, 1
    scale = (1.0 / D ** 0.5) / 7.0
    rows = []
    B = None
    for label, lens_l in (("1 page", [40, 63, 17, 33]), ("16 pages", [2047, 1499, 900, 2000]),
                          ("15 pages", [1901]), ("16 pages", [2047, 1500])):
        if len(lens_l) != B:
            B = len(lens_l)
            kp, ks, vp, vs, table, q, new_kv = kv4_inputs(torch, gen, L, B, H, D, P, MAXP)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        hint = max(-(-n // P) for n in lens_l)
        plan = pa.paged_plan(B, H, MAXP, P, D, 1, sm_count(q.device), hint)
        need(plan.body == "split", f"paged_plan gave the kv4 7B shape the {plan.body} body")
        k0, s0 = pa.paged_attn_int8.launches_kv4, pa.paged_attn_int8.launches_split
        kern = lambda: pa.paged_attn_int8(  # noqa: E731
            q, kp, ks, vp, vs, li, table, lens, scale, new_kv=new_kv, pages_hint=hint)

        def plain_with(kp_=kp, ks_=ks, vs_=vs):
            return pa._paged_plain(q, kp_, ks_, vp, vs_, li, table, lens, new_kv, scale, None,
                                   None, None)

        got, ref = kern(), plain_with()
        torch.cuda.synchronize()
        need(pa.paged_attn_int8.launches_kv4 == k0 + 1 and pa.paged_attn_int8.launches_split == s0 + 1,
             f"paged_attn_int8 kv4 ({label}): not one kv4 launch of the split body")
        err, mag = max_err(torch, got, ref)
        tol = 1e-2 * mag
        need(err <= tol, f"paged_attn_int8 kv4 ({label}): max err {err} > {tol}")
        margin = faults_exceed(torch, f"paged_attn_int8 kv4 ({label})", ref, [
            ("each byte's nibbles swapped", lambda: plain_with(kp_=((kp & 0xF) << 4) | (kp >> 4))),
            ("the k scales in token order", lambda: plain_with(ks_=pa.kv4_scales_logical(ks))),
            ("V at 1/127", lambda: plain_with(vs_=vs * (7.0 / 127.0))),
            ("K of the next kv head", lambda: plain_with(kp_=kp.roll(1, dims=2))),
        ], tol)
        alts = {}
        for body, nsplit in [("simt", 1)] + [("split", n) for n in (1, 2, 3, 4, 8, 16)]:
            alt = pa.PagedPlan(body, nsplit)
            run = lambda alt=alt: pa._paged_launch(  # noqa: E731
                q, kp, ks, vp, vs, li, table, lens, scale, new_kv, None, None, None, alt)
            e_alt, _ = max_err(torch, run(), ref)
            need(e_alt <= tol, f"paged_attn_int8 kv4 ({label}) {tuple(alt)}: max err {e_alt} > {tol}")
            alts[f"{body} nsplit={nsplit}"] = time_cold(torch, run)
        if label == "16 pages" and B == 4:
            for alt in (plan, pa.PagedPlan("split", 3)):
                run = lambda alt=alt: pa._paged_launch(  # noqa: E731
                    q, kp, ks, vp, vs, li, table, lens, scale, new_kv, None, None, None, alt)
                first = run()
                differ = sum(int(not torch.equal(run(), first)) for _ in range(99))
                need(differ == 0, f"paged_attn_int8 kv4 plan {tuple(alt)}: {differ} of 99 repeated"
                                  " launches differ from the first")
        Smax = max(lens_l) + 1
        used = [-(-n // P) for n in lens_l]
        pt = table.long()

        def gathered(pages, scales):
            codes = pa.kv4_unpack(pages[li][pt])  # (B, MAXP, H, P, D)
            sc = pa.kv4_scales_logical(scales[li][pt])
            return (codes.permute(0, 2, 1, 3, 4).reshape(B, H, MAXP * P, D)[:, :, :Smax].float()
                    * (sc.permute(0, 2, 1, 3).reshape(B, H, MAXP * P)[:, :, :Smax, None] / 7)
                    ).contiguous().to(torch.bfloat16)

        kd, vd = gathered(kp, ks), gathered(vp, vs)
        mask = (torch.arange(Smax, device="cuda")[None, :] <= lens[:, None])[:, None, None, :]
        lib_ms, lib_name, lib_all = time_sdpa(torch, q, kd, vd, attn_mask=mask)
        # the K/V nibbles and scales the lengths need, q and out, the new
        # token, the used table entries and the lengths
        nbytes = (sum(lens_l) * H * (D + 8) + 2 * B * H * D * 2 + B * H * (2 * D + 8)
                  + 4 * sum(used) + 4 * B)
        flops = 4 * (sum(lens_l) + B) * H * D
        row = dict(label=label, B=B, lens=lens_l, plan=tuple(plan), max_abs_err=err, tol=tol,
                   fault_margin=margin, ms=time_cold(torch, kern), plans_ms=alts,
                   simt_ms=alts["simt nsplit=1"], plain_ms=time_cold(torch, plain_with, iters=5),
                   library_ms=lib_ms, library_backend=lib_name, bytes=nbytes,
                   bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3,
                   bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
                   else "operations")
        rows.append(row)
        print(f"  paged_attn_int8 kv4 B={B} {label} {tuple(plan)} err={err:.3g} rel={err / mag:.2g}"
              f" (tol {tol:.3g}; faults >= {margin:.3g}x tol) kernel {row['ms']*1e3:.1f} us (SIMT"
              f" body {row['simt_ms']*1e3:.1f} us) plain {row['plain_ms']*1e3:.1f} us sdpa"
              f" {fmt_us(lib_ms)} ({lib_name}) bound {row['bound_ms']*1e3:.2f} us"
              f" ({row['bound_ms'] / row['ms']:.0%})", flush=True)
        print(f"    plans (us): {json.dumps({k: round(v * 1e3, 1) for k, v in alts.items()})}",
              flush=True)
        del kd, vd
    del kp, vp
    n_opt = kv4_edges(torch, gen)
    print(f"  paged_attn_int8 kv4: {n_opt} option cases (window, softcap, ALiBi, rep 2/4/8, len 0)"
          f" within tolerance; the plan and 3 splits repeat their bits over 100 launches", flush=True)
    # the JSON line: B = 4 at 16 pages (the engine's decode step at a full table)
    report["paged_attn_int8 (kv4)"] = dict(rows[1], shapes=rows)


def kv4_edges(torch, gen):
    """Kernel D over kv4 pages on small shapes: window, softcap and ALiBi
    on both bodies, GQA rep 2 and 4 (split) and 8 (SIMT), a row of length
    0 with and without new_kv, within 1% (rel 1e-4 against each other
    would not hold across bodies). Returns the number of comparisons."""
    from bitsandbytes_sycl_tpu_torch.ops import paged_attention as pa

    n = 0
    L, Hkv, D, P, MAXP, li = 2, 2, 128, 128, 4, 1
    for rep, window, softcap, alibi, new, lens_l in (
            (1, 100, None, False, True, [300, 51, 0]), (2, None, 30.0, False, True, [511, 2, 129]),
            (4, None, None, True, False, [257, 0, 64]), (8, 200, 20.0, True, True, [400, 7, 1])):
        B = len(lens_l)
        kp, ks, vp, vs, table, _, new_kv = kv4_inputs(torch, gen, L, B, Hkv, D, P, MAXP)
        q = torch.randn((B, Hkv, rep, D), generator=gen, device="cuda")
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        al = (torch.rand((Hkv * rep,), generator=gen, device="cuda") * 0.1) if alibi else None
        nk = new_kv if new else None
        scale = (1.0 / D ** 0.5) / 7.0
        ref = pa._paged_plain(q, kp, ks, vp, vs, li, table, lens, nk, scale, window, softcap, al)
        bodies = [pa.PagedPlan("simt", 1)] + ([pa.PagedPlan("split", s) for s in (1, 3)]
                                              if rep <= 4 else [])
        for plan in bodies:
            got = pa._paged_launch(q, kp, ks, vp, vs, li, table, lens, scale, nk, window, softcap,
                                   al, plan)
            torch.cuda.synchronize()
            err, mag = max_err(torch, got, ref)
            need(err <= 1e-2 * max(mag, 1e-6), f"paged_attn_int8 kv4 rep={rep} window={window}"
                 f" softcap={softcap} alibi={alibi} {tuple(plan)}: max err {err} > 1% of {mag}")
            n += 1
    return n


def check_decode(torch, report):
    """Kernel H (contiguous-cache decode) against its plain version at the 7B
    shapes: B = 1, 2, 4 and 8, Hq = Hkv = 32, D = 128, S = 2048, lengths 0,
    1, 127, 128, 2047, short (<= 64, the lengths of phase 3c's steps) and
    ragged rows, with and without new_kv; window, softcap and ALiBi at one
    shape, GQA (Hq 32 / Hkv 8) at one shape. O(1) scores; each case must
    take the split body and hold within 1% of the output's largest
    magnitude, and the plain version fed each deliberate fault (the wrong
    layer, the wrong kv head, k_scale dropped, lengths off by one) must land
    outside it. Timed (with new_kv): the body decode_plan picks, every split
    count beside it, the SIMT body (the earlier design), the plain version
    and SDPA's fused backends."""
    from bitsandbytes_sycl_tpu_torch.ops import attention
    from bitsandbytes_sycl_tpu_torch.ops.common import sm_count

    gen = torch.Generator(device="cuda").manual_seed(7)
    L, D, S, li = 2, 128, 2048, 1
    scale = (1.0 / D ** 0.5) / 127.0
    cases = [  # label, B, Hq, Hkv, lengths, options, timed
        ("B=4 full", 4, 32, 32, [2047] * 4, {}, True),
        ("B=4 short", 4, 32, 32, [40, 64, 17, 33], {}, True),
        ("B=4 edges", 4, 32, 32, [0, 1, 127, 128], {}, False),
        ("B=8 ragged", 8, 32, 32, [1, 127, 128, 2047, 900, 1500, 33, 2000], {}, True),
        ("B=1 full", 1, 32, 32, [1900], {}, True),
        ("B=2 full", 2, 32, 32, [2047, 1500], {}, True),
        ("B=4 window+softcap+alibi", 4, 32, 32, [2047, 1000, 128, 5],
         dict(window=512, softcap=30.0, alibi=True), False),
        ("B=4 GQA 32/8", 4, 32, 8, [2047, 1, 700, 128], {}, False),
    ]
    rows = []
    for label, B, Hq, Hkv, lens_l, opt, timed in cases:
        rep = Hq // Hkv
        kq = torch.randint(-127, 128, (L, B, Hkv, D, S), generator=gen, device="cuda", dtype=torch.int8)
        vq = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
        ks = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") * 2 + 1  # O(1) scores
        vs = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 0.5
        q = torch.randn((B, Hkv, rep, D), generator=gen, device="cuda").to(torch.bfloat16)
        new_kv = (torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
                  torch.rand((B, Hkv), generator=gen, device="cuda") * 2 + 1,
                  torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
                  torch.rand((B, Hkv), generator=gen, device="cuda") + 0.5)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        window, softcap = opt.get("window"), opt.get("softcap")
        alibi = (torch.rand((Hq,), generator=gen, device="cuda") * 0.01) if opt.get("alibi") else None
        k_other = kq.clone()
        k_other[li] = kq[li - 1]
        plan = attention.decode_plan(B, Hkv, S, D, rep, q.dtype, sm_count(q.device))
        need(plan.body == "split", f"decode_plan gave the 7B shape {label} the {plan.body} body")
        for nk in (new_kv, None):
            kern = lambda: attention.decode_attn_int8(  # noqa: E731
                q, kq, ks, vq, vs, li, lens, scale, new_kv=nk, window=window, softcap=softcap,
                alibi=alibi)

            def plain(kq_=kq, ks_=ks, lens_=lens, nk=nk):
                return attention._decode_plain(q, kq_, ks_, vq, vs, li, lens_, nk, scale, window,
                                               softcap, alibi)

            sp0 = attention.decode_attn_int8.launches_split
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            need(attention.decode_attn_int8.launches_split == sp0 + 1,
                 f"decode_attn_int8 ({label}): the 7B shape did not take the split body")
            err, mag = max_err(torch, got, ref)
            tol = 1e-2 * mag
            name = f"decode_attn_int8 ({label}, new_kv={nk is not None})"
            need(err <= tol, f"{name}: max err {err} > {tol}")
            margin = faults_exceed(torch, name, ref, [
                ("K of another layer", lambda: plain(kq_=k_other)),
                ("K of the next kv head", lambda: plain(kq_=kq.roll(1, dims=2))),
                ("k_scale dropped", lambda: plain(ks_=torch.full_like(ks, 2.0))),
                ("the lengths one too long", lambda: plain(lens_=lens + 1)),
            ], tol)
            row = dict(label=label, B=B, Hq=Hq, Hkv=Hkv, lens=lens_l, options=sorted(opt),
                       new_kv=nk is not None, plan=tuple(plan), max_abs_err=err, tol=tol,
                       fault_margin=margin)
            if timed and nk is not None:
                # every split count, and the SIMT body (the earlier design)
                alts = {}
                for body, nsplit in [("simt", 1)] + [("split", n) for n in (1, 2, 3, 4, 6, 8)]:
                    alt = attention.DecodePlan(body, nsplit)
                    run = lambda alt=alt: attention._decode_launch(  # noqa: E731
                        q, kq, ks, vq, vs, li, lens, scale, nk, window, softcap, alibi, alt)
                    e_alt, _ = max_err(torch, run(), ref)
                    need(e_alt <= tol, f"{name} {tuple(alt)}: max err {e_alt} > {tol}")
                    alts[f"{body} nsplit={nsplit}"] = time_cold(torch, run)
                Smax = max(lens_l) + 1
                # K with a contiguous last dimension, as SDPA's fused backends need
                kd = (kq[li, :, :, :, :Smax].float() * (ks[li, :, :, None, :Smax] / 127)
                      ).transpose(-1, -2).contiguous().to(torch.bfloat16)
                vd = (vq[li, :, :, :Smax].float() * (vs[li, :, :, :Smax, None] / 127)).to(torch.bfloat16)
                mask = (torch.arange(Smax, device="cuda")[None, :] <= lens[:, None])[:, None, None, :]
                lib_ms, lib_name, lib_all = time_sdpa(torch, q, kd, vd, attn_mask=mask)
                # the K/V rows and scales the lengths need, q and out, the new token, lengths
                nbytes = (sum(lens_l) * Hkv * (2 * D + 8) + 2 * B * Hq * D * 2 + B * Hkv * (2 * D + 8)
                          + 4 * B)
                flops = 4 * (sum(lens_l) + B) * Hq * D
                row.update(ms=time_cold(torch, kern), plans_ms=alts, simt_ms=alts["simt nsplit=1"],
                           plain_ms=time_cold(torch, plain, iters=5),
                           library_ms=lib_ms, library_backend=lib_name, library_all=lib_all,
                           bytes=nbytes,
                           bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3,
                           bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
                           else "operations")
                del kd, vd
            rows.append(row)
            print(f"  decode_attn_int8 {label:26s} new_kv={int(nk is not None)} {tuple(plan)}"
                  f" err={err:.3g} rel={err / mag:.2g} (tol {tol:.3g}; faults >= {margin:.3g}x tol)"
                  + (f" kernel {row['ms']*1e3:.1f} us (SIMT body {row['simt_ms']*1e3:.1f} us) plain"
                     f" {row['plain_ms']*1e3:.1f} us sdpa"
                     f" {fmt_us(row['library_ms'])} ({row['library_backend']}) bound"
                     f" {row['bound_ms']*1e3:.2f} us"
                     f" ({row['bound_ms'] / row['ms']:.0%})" if "ms" in row else ""), flush=True)
            if "plans_ms" in row:
                print(f"    plans (us): {json.dumps({k: round(v * 1e3, 1) for k, v in row['plans_ms'].items()})}",
                      flush=True)
        del kq, vq, ks, vs, k_other
    head = next(r for r in rows if "ms" in r)
    report["decode_attn_int8"] = dict(head, max_abs_err=max(r["max_abs_err"] for r in rows), shapes=rows)


def attn_bound(nbytes, flops, peak=BF16_FLOPS_PER_S):
    """(bound ms, what bounds it): bytes at the H100's HBM rate or
    operations at ``peak``, whichever takes longer."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def prefill_pairs(starts, T, S, window):
    """(row, key) pairs a causal prefill attends, and the keys each batch
    row reads (from its first window key to its last row's position)."""
    pairs = keys = 0
    for st in starts:
        for t in range(T):
            qp = min(st + t, S - 1)
            lo = max(0, qp - window + 1) if window else 0
            pairs += qp + 1 - lo
        keys += min(st + T, S) - (max(0, st - window + 1) if window else 0)
    return pairs, keys


def check_wide_bodies(torch, report):
    """Kernels C and H at head_dim 256 on their new bodies (C's tensor-core
    body with two warpgroups, H's split body with 8 dims of q a lane), and
    wider (C to 1024, H's split body in clusters at 384 to 1024): C at
    GPT-J-6B's shape (B = 2, 16 heads, T = 512 from position 0 over S =
    2048) and Gemma-2-9B's (16 q heads over 8 kv heads, softcap 50, a
    256-key window), H at GPT-J-6B's (B = 4 full rows, B = 8 ragged) and
    Gemma-2-9B's, and ALiBi, offset starts, short prompts, empty and
    one-token rows and groups of 3 and 8 heads; each within 1% of its plain
    version's largest output (C also within PREFILL_L2_TOL relative L2),
    the deliberate faults outside, 100 launches bit for bit. Timed in one
    call: the new body, the SIMT body, the plain version, SDPA's fastest
    fused backend and the bound. Then C's tensor-core body at head_dim 384
    to 1024 and H's split body at 384 to 1024 the same way (timed at B =
    4, 4 kv heads of 4 q heads: C at T = 512 and D = 384, 512 and 1024, H
    over full rows at 1024). Every timed shape that a plan gives a new body
    must run faster there than on the SIMT body."""
    from bitsandbytes_sycl_tpu_torch.ops import attention
    from bitsandbytes_sycl_tpu_torch.ops.common import sm_count

    gen = torch.Generator(device="cuda").manual_seed(18)
    L, S, li = 2, 2048, 1
    rows = []

    def cache(B, Hkv, D):
        return (torch.randint(-127, 128, (L, B, Hkv, D, S), generator=gen, device="cuda",
                              dtype=torch.int8),
                torch.rand((L, B, Hkv, S), generator=gen, device="cuda") * 2 + 1,  # O(1) scores
                torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda",
                              dtype=torch.int8),
                torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 0.5)

    def dequant(kq, ks, vq, vs, rep, n):
        """bf16 K and V of layer li's first n positions, kv heads repeated
        per group, every operand with a contiguous last dimension (SDPA's
        fused backends need it)."""
        kd = (kq[li, :, :, :, :n].float() * (ks[li, :, :, None, :n] / 127)).transpose(-1, -2)
        vd = vq[li, :, :, :n].float() * (vs[li, :, :, :n, None] / 127)
        return (kd.repeat_interleave(rep, dim=1).contiguous().to(torch.bfloat16),
                vd.repeat_interleave(rep, dim=1).contiguous().to(torch.bfloat16))

    # kernel C: label, D, B, Hq, Hkv, T, starts, options, timed
    c_cases = [
        ("GPT-J-6B B=2 T=512", 256, 2, 16, 16, 512, [0, 0], {}, True),
        ("Gemma-2-9B B=2 T=512 softcap+window", 256, 2, 16, 8, 512, [0, 0],
         dict(softcap=50.0, window=256), True),
        ("B=2 T=100 starts+alibi", 256, 2, 16, 8, 100, [0, 700], dict(alibi=True), False),
        ("B=4 T=24 all options", 256, 4, 16, 16, 24, [5, 1000, 2000, 64],
         dict(window=300, softcap=30.0, alibi=True), False),
        ("D=384 B=4 T=512", 384, 4, 16, 4, 512, [0] * 4, {}, True),
        ("D=384 B=2 T=130 all options", 384, 2, 8, 4, 130, [0, 900],
         dict(window=200, softcap=30.0, alibi=True), False),
        ("D=512 B=4 T=512", 512, 4, 16, 4, 512, [0] * 4, {}, True),
        ("D=512 B=2 T=70 all options", 512, 2, 8, 4, 70, [33, 1500],
         dict(window=100, softcap=30.0, alibi=True), False),
        # past 512: the cluster instances, a CTA per 128 dims
        ("D=640 B=2 T=100 all options", 640, 2, 8, 4, 100, [0, 700],
         dict(window=150, softcap=30.0, alibi=True), False),
        ("D=768 B=1 T=64", 768, 1, 4, 2, 64, [100], {}, False),
        ("D=896 B=2 T=24 all options", 896, 2, 4, 4, 24, [5, 1000],
         dict(window=300, softcap=30.0, alibi=True), False),
        ("D=1024 B=4 T=512", 1024, 4, 16, 4, 512, [0] * 4, {}, True),
    ]
    for label, D, B, Hq, Hkv, T, starts_l, opt, timed in c_cases:
        kq, ks, vq, vs = cache(B, Hkv, D)
        q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
        starts = torch.tensor(starts_l, dtype=torch.int32, device="cuda")
        scale = (1.0 / D ** 0.5) / 127.0
        window, softcap = opt.get("window"), opt.get("softcap")
        alibi = (torch.rand((Hq,), generator=gen, device="cuda") * 0.01) if opt.get("alibi") else None
        body = attention.prefill_plan(D, S, q.dtype)
        name = f"prefill_attn_int8 D={D} ({label})"
        kern = lambda: attention.prefill_attn_int8(  # noqa: E731
            q, kq, ks, vq, vs, li, starts, scale, window=window, softcap=softcap, alibi=alibi)
        tc = lambda: attention._prefill_launch(  # noqa: E731
            q, kq, ks, vq, vs, li, starts, scale, window, softcap, alibi, "tc")
        simt = lambda: attention._prefill_launch(  # noqa: E731
            q, kq, ks, vq, vs, li, starts, scale, window, softcap, alibi, "simt")

        def plain(kq_=kq, ks_=ks, st_=starts):
            return attention._prefill_plain(q, kq_, ks_, vq, vs, li, st_, scale, window, softcap,
                                            alibi)

        tc0 = attention.prefill_attn_int8.launches_tc
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        need(body == "tc", f"{name}: prefill_plan gave bf16 q the {body} body")
        need(attention.prefill_attn_int8.launches_tc == tc0 + (body == "tc"),
             f"{name}: the launch missed the {body} body")
        got_tc = tc()
        err, mag = max_err(torch, got_tc, ref)
        tol = 1e-2 * mag
        need(err <= tol, f"{name}: tensor-core body max err {err} > {tol}")
        l2 = rel_l2(torch, got_tc, ref)
        need(l2 <= PREFILL_L2_TOL, f"{name}: relative L2 err {l2} > {PREFILL_L2_TOL}")
        err_simt, _ = max_err(torch, simt(), ref)
        need(err_simt <= tol, f"{name}: SIMT body max err {err_simt} > {tol}")
        k_other = kq.clone()
        k_other[li] = kq[li - 1]
        margin = faults_exceed(torch, name, ref, [
            ("K of the next kv head", lambda: plain(kq_=kq.roll(1, dims=2))),
            ("K of another layer", lambda: plain(kq_=k_other)),
            ("k_scale dropped", lambda: plain(ks_=torch.full_like(ks, 2.0))),
            ("the starts one too far", lambda: plain(st_=starts + 1)),
        ], tol)
        del k_other
        repeat_bits(torch, name, tc)
        row = dict(kernel="C", label=label, D=D, B=B, Hq=Hq, Hkv=Hkv, T=T, starts=starts_l,
                   options=sorted(opt), body=body, max_abs_err=err, tol=tol, rel_l2=l2,
                   simt_max_abs_err=err_simt, fault_margin=margin)
        if timed:
            pairs, keys = prefill_pairs(starts_l, T, S, window)
            nbytes = 2 * B * T * Hq * D * 2 + Hkv * keys * (2 * D + 8)
            bound, bound_by = attn_bound(nbytes, 4 * Hq * D * pairs)
            kd, vd = dequant(kq, ks, vq, vs, Hq // Hkv, T)
            lib_ms, lib_name, lib_all = time_sdpa(torch, q.transpose(1, 2).contiguous(), kd, vd,
                                                  is_causal=True)
            del kd, vd
            row.update(tc_ms=time_cold(torch, tc), simt_ms=time_cold(torch, simt, iters=5),
                       plain_ms=time_cold(torch, plain, iters=5), library_ms=lib_ms,
                       library_backend=lib_name, library_all=lib_all, bytes=nbytes,
                       bound_ms=bound, bound_by=bound_by)
            row["ms"] = row["tc_ms"] if body == "tc" else row["simt_ms"]
            need(body != "tc" or row["tc_ms"] < row["simt_ms"],
                 f"{name}: the tensor-core body ({row['tc_ms']} ms) is no faster than the SIMT"
                 f" body ({row['simt_ms']} ms)")
        rows.append(row)
        print(f"  {name} body={body} err={err:.3g} rel={err / mag:.2g} (tol {tol:.3g}; faults >="
              f" {margin:.3g}x tol; rel L2 {l2:.3g}); 100 launches bit for bit"
              + (f"; tensor-core {row['tc_ms'] * 1e3:.1f} us, SIMT {row['simt_ms'] * 1e3:.1f} us"
                 f" ({row['simt_ms'] / row['tc_ms']:.1f}x), plain {row['plain_ms'] * 1e3:.1f} us,"
                 f" sdpa {fmt_us(row['library_ms'])} ({row['library_backend']};"
                 f" {row['tc_ms'] / row['library_ms']:.2f}x), bound {bound * 1e3:.2f} us by"
                 f" {bound_by} ({bound / row['tc_ms']:.0%})" if timed else ""), flush=True)
        del q, kq, vq, ks, vs

    # kernel H: label, D, B, Hkv, rep, lengths, options, timed
    h_cases = [
        ("GPT-J-6B B=4 full", 256, 4, 16, 1, [2047] * 4, {}, True),
        ("GPT-J-6B B=8 ragged", 256, 8, 16, 1, [1, 127, 128, 2047, 900, 1500, 33, 2000], {}, True),
        ("Gemma-2-9B B=4 softcap+window", 256, 4, 8, 2, [2047, 1000, 300, 5],
         dict(softcap=50.0, window=256), True),
        ("B=4 edges+alibi", 256, 4, 16, 1, [0, 1, 127, 128], dict(alibi=True), False),
        ("rep 3 B=2 all options", 256, 2, 4, 3, [1500, 77],
         dict(window=400, softcap=30.0, alibi=True), False),
        ("Gemma-2B rep 8 B=4 full", 256, 4, 1, 8, [2047] * 4, {}, True),
        # past 256: clusters of D / 128 CTAs
        ("D=384 rep 3 B=2 all options", 384, 2, 4, 3, [1500, 77],
         dict(window=400, softcap=30.0, alibi=True), False),
        ("D=640 B=4 edges+alibi", 640, 4, 2, 2, [0, 1, 127, 1300], dict(alibi=True), False),
        ("D=1024 rep 4 B=4 full", 1024, 4, 4, 4, [2047] * 4, {}, True),
    ]
    for label, D, B, Hkv, rep, lens_l, opt, timed in h_cases:
        scale = (1.0 / D ** 0.5) / 127.0
        Hq = Hkv * rep
        kq, ks, vq, vs = cache(B, Hkv, D)
        q = torch.randn((B, Hkv, rep, D), generator=gen, device="cuda").to(torch.bfloat16)
        new_kv = (torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
                  torch.rand((B, Hkv), generator=gen, device="cuda") * 2 + 1,
                  torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
                  torch.rand((B, Hkv), generator=gen, device="cuda") + 0.5)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        window, softcap = opt.get("window"), opt.get("softcap")
        alibi = (torch.rand((Hq,), generator=gen, device="cuda") * 0.01) if opt.get("alibi") else None
        k_other = kq.clone()
        k_other[li] = kq[li - 1]
        plan = attention.decode_plan(B, Hkv, S, D, rep, q.dtype, sm_count(q.device))
        need(plan.body == "split", f"decode_plan gave D = {D} ({label}) the {plan.body} body")
        for nk in (new_kv, None):
            name = f"decode_attn_int8 D={D} ({label}, new_kv={nk is not None})"
            kern = lambda nk=nk: attention.decode_attn_int8(  # noqa: E731
                q, kq, ks, vq, vs, li, lens, scale, new_kv=nk, window=window, softcap=softcap,
                alibi=alibi)

            def plain(kq_=kq, ks_=ks, lens_=lens, nk=nk):
                return attention._decode_plain(q, kq_, ks_, vq, vs, li, lens_, nk, scale, window,
                                               softcap, alibi)

            sp0 = attention.decode_attn_int8.launches_split
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            need(attention.decode_attn_int8.launches_split == sp0 + 1,
                 f"{name}: the launch missed the split body")
            err, mag = max_err(torch, got, ref)
            tol = 1e-2 * mag
            need(err <= tol, f"{name}: max err {err} > {tol}")
            faults = [("K of another layer", lambda: plain(kq_=k_other)),
                      ("k_scale dropped", lambda: plain(ks_=torch.full_like(ks, 2.0))),
                      ("the lengths one too long", lambda: plain(lens_=lens + 1))]
            if Hkv > 1:  # one kv head has no next one
                faults.append(("K of the next kv head", lambda: plain(kq_=kq.roll(1, dims=2))))
            margin = faults_exceed(torch, name, ref, faults, tol)
            repeat_bits(torch, name, kern)
            row = dict(kernel="H", label=label, D=D, B=B, Hq=Hq, Hkv=Hkv, lens=lens_l,
                       options=sorted(opt), new_kv=nk is not None, plan=tuple(plan),
                       max_abs_err=err, tol=tol, fault_margin=margin)
            if timed and nk is not None:
                alts = {}
                for body, nsplit in [("simt", 1)] + [("split", n) for n in (1, 2, 3, 4, 6, 8)]:
                    alt = attention.DecodePlan(body, nsplit)
                    run = lambda alt=alt: attention._decode_launch(  # noqa: E731
                        q, kq, ks, vq, vs, li, lens, scale, nk, window, softcap, alibi, alt)
                    e_alt, _ = max_err(torch, run(), ref)
                    need(e_alt <= tol, f"{name} {tuple(alt)}: max err {e_alt} > {tol}")
                    alts[f"{body} nsplit={nsplit}"] = time_cold(torch, run)
                Smax = max(lens_l) + 1
                kd, vd = dequant(kq, ks, vq, vs, rep, Smax)
                mask = (torch.arange(Smax, device="cuda")[None, :] <= lens[:, None])[:, None, None, :]
                lib_ms, lib_name, lib_all = time_sdpa(torch, q.reshape(B, Hq, 1, D), kd, vd,
                                                      attn_mask=mask)
                del kd, vd
                used = sum(min(n, window) if window else n for n in lens_l)
                nbytes = (used * Hkv * (2 * D + 8) + 2 * B * Hq * D * 2 + B * Hkv * (2 * D + 8)
                          + 4 * B)
                bound, bound_by = attn_bound(nbytes, 4 * (used + B) * Hq * D, F32_FLOPS_PER_S)
                row.update(ms=time_cold(torch, kern), plans_ms=alts, simt_ms=alts["simt nsplit=1"],
                           plain_ms=time_cold(torch, plain, iters=5), library_ms=lib_ms,
                           library_backend=lib_name, library_all=lib_all, bytes=nbytes,
                           bound_ms=bound, bound_by=bound_by)
                need(row["ms"] < row["simt_ms"], f"{name}: the split body ({row['ms']} ms) is no"
                                                 f" faster than the SIMT body ({row['simt_ms']} ms)")
            rows.append(row)
            print(f"  {name} {tuple(plan)} err={err:.3g} rel={err / mag:.2g} (tol {tol:.3g}; faults"
                  f" >= {margin:.3g}x tol); 100 launches bit for bit"
                  + (f"; split {row['ms'] * 1e3:.1f} us, SIMT {row['simt_ms'] * 1e3:.1f} us"
                     f" ({row['simt_ms'] / row['ms']:.1f}x), plain {row['plain_ms'] * 1e3:.1f} us,"
                     f" sdpa {fmt_us(row['library_ms'])} ({row['library_backend']}), bound"
                     f" {row['bound_ms'] * 1e3:.2f} us ({row['bound_ms'] / row['ms']:.0%})"
                     if "ms" in row else ""), flush=True)
            if "plans_ms" in row:
                print(f"    plans (us): {json.dumps({k: round(v * 1e3, 1) for k, v in row['plans_ms'].items()})}",
                      flush=True)
        del q, kq, vq, ks, vs, k_other
    report["wide bodies"] = rows
    for kname, kernel, label in (("prefill_attn_int8", "C", "GPT-J-6B B=2 T=512"),
                                 ("decode_attn_int8", "H", "GPT-J-6B B=4 full")):
        r = next(r for r in rows if r["label"] == label and "ms" in r)
        report[f"{kname} (head_dim 256)"] = dict(
            max_abs_err=max(x["max_abs_err"] for x in rows if x["kernel"] == kernel and x["D"] == 256),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], simt_ms=r["simt_ms"])
    return len(rows)


def check_int8(torch, report):
    """Kernel I (LLM.int8, <= 128 rows) against its plain version at the four
    7B linear shapes, M = 1, 2, 4, 8, 16, 32, 40, 64, 90, 100 and 128 (the
    wgmma widths 8, 16, 32, 48, 64, 96, 112 and 128, every split plan the
    path meets; check_edges runs widths 24 and 80), with and without bias,
    bf16 out: equal bit for bit in every case (its int32 sums are exact and its
    epilogue rounds as the plain version does), and within 1 bf16 ulp of
    the output (or of the bias where larger), with the next row's SCB as
    the fault that must land outside; then the route whole at 256 and 1024
    rows (quantize, torch._int_mm, dequant), within 1 bf16 ulp of its plain
    version (float64 product), which must launch no kernel I."""
    from bitsandbytes_sycl_tpu_torch import functional as F
    from bitsandbytes_sycl_tpu_torch.ops import KERNELS
    from bitsandbytes_sycl_tpu_torch.ops import matmul_int8 as mi

    gen = torch.Generator(device="cuda").manual_seed(8)
    rows, routes = [], []
    for N, K in [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]:
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        CB, SCB = F.int8_vectorwise_quant(W)
        Wd = W.to(torch.bfloat16)
        del W
        bias = torch.randn((N,), generator=gen, device="cuda")
        for M in (1, 2, 4, 8, 16, 32, 40, 64, 90, 100, 128):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            ra = x.float().abs().amax(dim=1)
            inv = torch.where(ra > 0, 127.0 * F._safe_inv(ra), torch.full_like(ra, 127.0))
            for b in (None, bias):
                got = mi.int8_matmul(x, inv, CB, SCB, b, torch.bfloat16)
                ref = mi._mm8_plain(x, inv, CB, SCB, b, torch.bfloat16)
                torch.cuda.synchronize()
                ratio = ulp_ratio(torch, got, ref, torch.bfloat16, b)
                need(ratio <= 1, f"int8_matmul N={N} K={K} M={M} bias={b is not None}: {ratio} ulps > 1")
                need(torch.equal(got, ref), f"int8_matmul N={N} K={K} M={M} bias={b is not None}:"
                                            f" {ratio} ulps from the plain version (must be 0)")
                fault = ulp_ratio(torch, mi._mm8_plain(x, inv, CB, SCB.roll(-1), b, torch.bfloat16),
                                  ref, torch.bfloat16, b)
                need(fault > 1, "int8_matmul: the plain version with the next row's SCB lands within 1 ulp")
                row = dict(N=N, K=K, M=M, bias=b is not None, ulps=ratio, fault_ulps=fault,
                           equal=bool(torch.equal(got, ref)), max_abs_err=max_err(torch, got, ref)[0])
                if b is None and M in (4, 32, 128):
                    kern = lambda: mi.int8_matmul(x, inv, CB, SCB, None, torch.bfloat16)  # noqa: E731
                    nbytes = M * K * 2 + N * K + N * 4 + M * 4 + M * N * 2
                    ops_ = 2 * M * N * K
                    row.update(
                        ms=time_cold(torch, kern),
                        plain_ms=time_cold(torch, lambda: mi._mm8_plain(x, inv, CB, SCB, None,
                                                                        torch.bfloat16), iters=5),
                        library_ms=time_cold(torch, lambda: torch.matmul(x, Wd.T)),
                        bytes=nbytes, bound_ms=max(nbytes / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S) * 1e3,
                        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops_ / INT8_OPS_PER_S
                        else "operations")
                    if M == 32:
                        xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                                           dtype=torch.int8)
                        row["int_mm_ms"] = time_cold(torch, lambda: torch._int_mm(xq, CB.t()))
                    print(f"  int8_matmul N={N:5d} K={K:5d} M={M:3d} {ratio:.3g} ulps (fault {fault:.3g})"
                          f" kernel {row['ms']*1e3:.1f} us plain {row['plain_ms']*1e3:.1f} us bf16 matmul"
                          f" {row['library_ms']*1e3:.1f} us"
                          + (f" _int_mm {row['int_mm_ms']*1e3:.1f} us" if "int_mm_ms" in row else "")
                          + f" bound {row['bound_ms']*1e3:.2f} us ({row['bound_ms'] / row['ms']:.0%})",
                          flush=True)
                rows.append(row)
        for M in (256, 1024):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            reset_counts(KERNELS)
            got = F.llm_int8_matmul(x, CB, SCB, threshold=0.0, bias=bias)
            counts = {k: v for k, v in read_counts(KERNELS).items() if v}
            need(not counts, f"int8 route M={M}: launched {counts}, no kernel expected")

            def route_plain(scb=SCB):
                CA, SCA = F.int8_vectorwise_quant(x)
                out32 = CA.double() @ CB.double().T
                return F.int8_mm_dequant(out32, SCA, scb, bias, torch.bfloat16)

            ref = route_plain()
            torch.cuda.synchronize()
            ratio = ulp_ratio(torch, got, ref, torch.bfloat16, bias)
            fault = ulp_ratio(torch, route_plain(SCB.roll(-1)), ref, torch.bfloat16, bias)
            need(ratio <= 1, f"int8 route N={N} K={K} M={M}: {ratio} ulps > 1")
            need(fault > 1, f"int8 route M={M}: the next row's SCB lands within 1 ulp")
            ms = time_cold(torch, lambda: F.llm_int8_matmul(x, CB, SCB, threshold=0.0, bias=bias), iters=10)
            routes.append(dict(N=N, K=K, M=M, ulps=ratio, fault_ulps=fault, ms=ms))
            print(f"  int8 route (_int_mm) N={N:5d} K={K:5d} M={M:4d} {ratio:.3g} ulps (fault {fault:.3g})"
                  f" route {ms*1e3:.1f} us", flush=True)
        del CB, SCB, Wd, bias
    print(f"  checked: int8_matmul {len(rows)} cases within {max(r['ulps'] for r in rows):.3g} ulps"
          f" ({sum(r['equal'] for r in rows)} of {len(rows)} bit-identical; faults >= "
          f"{min(r['fault_ulps'] for r in rows):.3g} ulps), route {len(routes)} cases")
    timed = [r for r in rows if "ms" in r and r["M"] == 4]
    report["int8_matmul"] = dict(
        shapes=rows, routes=routes, ms=sum(r["ms"] for r in timed),
        plain_ms=sum(r["plain_ms"] for r in timed), library_ms=sum(r["library_ms"] for r in timed),
        bound_ms=sum(r["bound_ms"] for r in timed), bound_by=timed[0]["bound_by"],
        max_abs_err=max(r["max_abs_err"] for r in rows))


def check_edges(torch):
    """The kernels against their plain versions on small shapes that the
    7B path does not reach: odd row counts, f32 outputs and bias, every
    decode mode of kernel B in both bodies (its tensor-core body also at
    ragged rows, N = 384, a whole-half K and blocksizes 32-256), kernel G's
    wgmma body at ragged rows and small blocksizes and its mma.sync body on
    ragged planes, the W8A8 route at few rows, every option of kernels C, D
    and H (H at every group size and head_dim 256, its split body at every
    split count and past a whole tile), kernel A's fused body at every row
    tile and its tensor-core body at ragged rows, blocksizes 32-256 and
    every split count from one to one a stage, and kernel I at odd row
    counts in f32."""
    from bitsandbytes_sycl_tpu_torch.ops import attention, matmul_4bit, matmul_w4a8
    from bitsandbytes_sycl_tpu_torch.ops import paged_attention
    from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native

    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 0

    def close(name, got, ref, rel=1e-2):
        nonlocal n
        torch.cuda.synchronize()
        err, mag = max_err(torch, got, ref)
        need(err <= rel * max(mag, 1e-6), f"{name}: max err {err} > {rel} * {mag}")
        n += 1

    for qt, bs, K, absmax in (("nf4", 64, 1152, torch.float32), ("fp4", 128, 1024, torch.bfloat16),
                              ("int4", 64, 512, torch.float32), ("af4", 64, 512, torch.bfloat16)):
        W = torch.randn((384, K), generator=gen, device="cuda") * 0.02
        w = quantize_4bit_native(W, bs, qt, absmax_dtype=absmax)
        bias = torch.randn((384,), generator=gen, device="cuda")
        for M in (1, 5, 67):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
                for b in (None, bias):
                    if qt != "int4":
                        close(f"w4a8 {qt} M={M} {dt}", matmul_w4a8.w4a8_gemv(x, w, b, dt),
                              matmul_w4a8._w4a8_plain(x, w, b, dt))
                    mode = matmul_4bit._decode_mode(w, dt, None)
                    close(f"mm4 {qt} M={M} {dt} mode {mode}", matmul_4bit.mm4_fused(x, w, b, dt),
                          matmul_4bit._mm4_plain(x, w, b, dt, mode))
    # kernel A's fused body at every row tile (1, 2, 3 -> 4, 5 -> 8, 8), blocksizes 32 and
    # 64, f32 and bf16 x and scales, with bias, one K split and 8, a half-K
    # of 9 stages (1152)
    for qt, bs, K, absmax in (("nf4", 32, 1152, torch.bfloat16), ("fp4", 64, 2048, torch.float32),
                              ("nf4", 64, 1024, torch.bfloat16)):
        W = torch.randn((256, K), generator=gen, device="cuda") * 0.02
        w = quantize_4bit_native(W, bs, qt, absmax_dtype=absmax)
        bias = torch.randn((256,), generator=gen, device="cuda")
        steps = K // 128
        for M in (1, 2, 3, 5, 8):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
                bm = matmul_w4a8.gemv_plan(M, 256, K, bs, 132).bm
                for b in (None, bias):
                    for ks in (1, 8):
                        per = -(-steps // ks)
                        plan = matmul_w4a8.LaunchPlan("fused", bm, per, -(-steps // per))
                        fu0 = matmul_w4a8.w4a8_gemv.launches_fused
                        close(f"w4a8 fused {qt} bs={bs} K={K} M={M} {dt} ksplit={ks}",
                              matmul_w4a8._gemv_launch(x, w, b, dt, plan),
                              matmul_w4a8._w4a8_plain(x, w, b, dt))
                        need(matmul_w4a8.w4a8_gemv.launches_fused == fu0 + 1,
                             "w4a8 fused edge: the fused body did not run")
    # kernel A's tensor-core body: ragged rows (129 and 255 at blocksize 256:
    # two passes), N = 128 and 384, blocksizes 32 (a ragged last stage:
    # half-K 544) to 256, and 96 and 160 (blocks that end inside a stage;
    # half-K 480 ragged), f32 and bf16 x, output and scales, with and
    # without bias, one K split, the most the plan allows (one a stage, or
    # one per run of stages ending on a block) and twice that run
    for qt, bs, N, K, absmax in (("nf4", 32, 384, 1088, torch.bfloat16),
                                 ("fp4", 64, 128, 1024, torch.float32),
                                 ("nf4", 128, 384, 2048, torch.bfloat16),
                                 ("fp4", 256, 128, 2048, torch.float32),
                                 ("nf4", 256, 384, 1024, torch.bfloat16),
                                 ("nf4", 96, 256, 1536, torch.bfloat16),
                                 ("fp4", 96, 384, 960, torch.float32),
                                 ("nf4", 160, 128, 1920, torch.float32)):
        W = torch.randn((N, K), generator=gen, device="cuda") * 0.02
        w = quantize_4bit_native(W, bs, qt, absmax_dtype=absmax)
        bias = torch.randn((N,), generator=gen, device="cuda")
        steps = -(-(K // 2) // 64)
        for M in (9, 17, 63, 65, 100, 127) + ((129, 255) if bs == 256 else ()):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
                plan = matmul_w4a8.gemv_plan(M, N, K, bs, 132)
                need(plan.body == "tc", f"w4a8 tc edge: gemv_plan gave M={M} bs={bs} {plan.body}")
                unit = math.lcm(bs, 64) // 64
                for b in (None, bias):
                    for per in sorted({steps, unit, min(steps, 2 * unit)}):
                        p2 = matmul_w4a8.LaunchPlan("tc", plan.bm, per, -(-steps // per), plan.bn)
                        tc0 = matmul_w4a8.w4a8_gemv.launches_tc
                        close(f"w4a8 tc {qt} bs={bs} N={N} K={K} M={M} {dt} ksplit={p2.ksplit}"
                              f" bias={b is not None}", matmul_w4a8._gemv_launch(x, w, b, dt, p2),
                              matmul_w4a8._w4a8_plain(x, w, b, dt))
                        need(matmul_w4a8.w4a8_gemv.launches_tc == tc0 + 1,
                             "w4a8 tc edge: the tensor-core body did not run")
    # kernel B's tensor-core body (bf16 x): ragged row counts, N = 384 (128-
    # column tiles), a whole-half K (1152), every decode mode (2: table
    # codebooks; 1: int4; 0: an f32 decode asked for) and blocksizes 32-256
    for qt, bs, N, K, absmax in (("nf4", 64, 384, 1152, torch.float32),
                                 ("nf4", 32, 512, 1024, torch.bfloat16),
                                 ("fp4", 128, 512, 1024, torch.float32),
                                 ("nf4", 256, 512, 2048, torch.bfloat16),
                                 ("af4", 64, 256, 1024, torch.bfloat16),
                                 ("int4", 64, 512, 1024, torch.bfloat16)):
        W = torch.randn((N, K), generator=gen, device="cuda") * 0.02
        w = quantize_4bit_native(W, bs, qt, absmax_dtype=absmax)
        bias = torch.randn((N,), generator=gen, device="cuda")
        for M in (65, 129, 200, 1000):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            for dd in ((None, torch.float32) if qt == "nf4" and bs == 64 else (None,)):
                mode = matmul_4bit._decode_mode(w, torch.bfloat16, dd)
                for b in (None, bias):
                    tc0 = matmul_4bit.mm4_fused.launches_tc
                    close(f"mm4 tensor-core {qt} bs={bs} N={N} K={K} M={M} mode {mode}",
                          matmul_4bit.mm4_fused(x, w, b, torch.bfloat16, dd),
                          matmul_4bit._mm4_plain(x, w, b, torch.bfloat16, mode))
                    need(matmul_4bit.mm4_fused.launches_tc == tc0 + 1,
                         f"mm4 {qt} bs={bs} M={M}: bf16 x did not take the tensor-core body")
    # kernel G's wgmma body at ragged row counts, N = 384 and blocksizes 16
    # and 32 (several quantization blocks in one 64-row K step)
    for N, K, bs in ((384, 1152, 64), (256, 1024, 16), (256, 1024, 32), (256, 2048, 128)):
        W = torch.randn((N, K), generator=gen, device="cuda") * 0.02
        w = quantize_4bit_native(W, bs, "nf4", absmax_dtype=torch.bfloat16)
        bias = torch.randn((N,), generator=gen, device="cuda")
        for M in (1, 67, 300, 600):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
                wg0 = matmul_w4a8.w4a8_grouped.launches_wgmma
                got = matmul_w4a8.w4a8_grouped(x, w, bias, dt)
                ratio = ulp_ratio(torch, got, matmul_w4a8._grouped_plain(x, w, bias, dt), dt, bias)
                need(ratio <= (2 if dt == torch.float32 else 1),
                     f"w4a8_grouped wgmma N={N} K={K} bs={bs} M={M} {dt}: {ratio} ulps")
                need(matmul_w4a8.w4a8_grouped.launches_wgmma == wg0 + 1,
                     f"w4a8_grouped N={N} K={K} bs={bs}: did not take the wgmma body")
                n += 1
    # kernel G where half-K is not a multiple of its 64-row step (blocksize
    # 32, a whole-half K step in the JAX kernel), also with planes not 16-byte
    # aligned (K % 32 != 0); the W8A8 route at few rows (torch._int_mm's
    # padding) and at a whole half
    for N, K, bs in ((256, 1088, 32), (256, 1040, 8)):
        W = torch.randn((N, K), generator=gen, device="cuda") * 0.02
        w = quantize_4bit_native(W, bs, "nf4", absmax_dtype=torch.bfloat16)
        bias = torch.randn((N,), generator=gen, device="cuda")
        for M in (1, 67, 300):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
                got = matmul_w4a8.w4a8_grouped(x, w, bias, dt)
                ratio = ulp_ratio(torch, got, matmul_w4a8._grouped_plain(x, w, bias, dt), dt, bias)
                need(ratio <= (2 if dt == torch.float32 else 1),
                     f"w4a8_grouped N={N} K={K} bs={bs} M={M} {dt}: {ratio} ulps")
                n += 1
                if bs == 32:
                    got = matmul_w4a8.matmul_4bit_w8a8_prefill(x, w, bias, dt)
                    ratio = ulp_ratio(torch, got, matmul_w4a8._w8a8_plain(x, w, bias, dt), dt, bias)
                    need(ratio <= (2 if dt == torch.float32 else 1),
                         f"w8a8 route N={N} K={K} M={M} {dt}: {ratio} ulps")
                    n += 1
    L, B, T, Hkv, D, S = 2, 2, 24, 2, 128, 256
    kq = torch.randint(-127, 128, (L, B, Hkv, D, S), generator=gen, device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") * 0.2 + 0.05  # O(1) scores
    vs = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 0.5
    starts = torch.tensor([0, 100], dtype=torch.int32, device="cuda")
    slopes = torch.tensor([0.5, 0.25, 0.125, 0.0625], device="cuda")
    for rep in (1, 2):
        q = torch.randn((B, T, Hkv * rep, D), generator=gen, device="cuda")
        for opt in (dict(), dict(window=40), dict(softcap=5.0), dict(alibi=slopes[: Hkv * rep])):
            args = (q, kq, ks, vq, vs, 1, starts, 0.01)
            close(f"prefill rep={rep} {list(opt)}", attention.prefill_attn_int8(*args, **opt),
                  attention._prefill_plain(*args, opt.get("window"), opt.get("softcap"),
                                           opt.get("alibi")), rel=1e-4)
    # kernel C's tensor-core body (bf16 q): GQA 1 and 2, every option, starts
    # [0, 100], query counts below, at and across its 64-row tiles, within
    # 1% of the largest output (P goes to the tensor cores in two bf16 parts)
    for rep in (1, 2):
        for T2 in (24, 64, 100, 130):
            q = torch.randn((B, T2, Hkv * rep, D), generator=gen, device="cuda").to(torch.bfloat16)
            for opt in (dict(), dict(window=40), dict(softcap=5.0), dict(alibi=slopes[: Hkv * rep])):
                args = (q, kq, ks, vq, vs, 1, starts, 0.01)
                tc0 = attention.prefill_attn_int8.launches_tc
                close(f"prefill tensor-core rep={rep} T={T2} {list(opt)}",
                      attention.prefill_attn_int8(*args, **opt),
                      attention._prefill_plain(*args, opt.get("window"), opt.get("softcap"),
                                               opt.get("alibi")))
                need(attention.prefill_attn_int8.launches_tc == tc0 + 1,
                     f"prefill rep={rep} T={T2}: bf16 q did not take the tensor-core body")
    NP, P, MAXP = 9, 128, 4
    kp = torch.randint(-127, 128, (L, NP, Hkv, P, D), generator=gen, device="cuda", dtype=torch.int8)
    vp = torch.randint(-127, 128, (L, NP, Hkv, P, D), generator=gen, device="cuda", dtype=torch.int8)
    kps = torch.rand((L, NP, Hkv, P), generator=gen, device="cuda") * 0.2 + 0.05
    vps = torch.rand((L, NP, Hkv, P), generator=gen, device="cuda") + 0.5
    table = (torch.randperm(NP - 1, generator=gen, device="cuda")[: 2 * MAXP] + 1).reshape(2, MAXP)
    table = table.to(torch.int32)
    new_kv = (torch.randint(-127, 128, (2, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((2, Hkv), generator=gen, device="cuda") * 0.2 + 0.05,
              torch.randint(-127, 128, (2, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((2, Hkv), generator=gen, device="cuda") + 0.5)
    for rep in (1, 2, 4, 8):  # rep 8 on the SIMT body, the rest on the split body
        q = torch.randn((2, Hkv, rep, D), generator=gen, device="cuda")
        for lens_l in ([0, 300], [511, 1]):
            lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
            for nk in (None, new_kv):
                for opt in (dict(), dict(window=100), dict(softcap=5.0),
                            dict(alibi=torch.rand((Hkv * rep,), generator=gen, device="cuda"))):
                    got = paged_attention.paged_attn_int8(q, kp, kps, vp, vps, 1, table, lens, 0.01,
                                                          new_kv=nk, **opt)
                    ref = paged_attention._paged_plain(q, kp, kps, vp, vps, 1, table, lens, nk, 0.01,
                                                       opt.get("window"), opt.get("softcap"),
                                                       opt.get("alibi"))
                    close(f"paged rep={rep} lens={lens_l} new={nk is not None} {list(opt)}",
                          got, ref, rel=1e-4)
    # kernel D's split body at every split count of the 4-page table:
    # lengths whose shares cross pages, a row with fewer used pages than
    # splits (empty partials), a window that crosses a split
    q = torch.randn((2, Hkv, 2, D), generator=gen, device="cuda")
    for nsplit in (1, 2, 3, 4):
        plan = paged_attention.PagedPlan("split", nsplit)
        for lens_l in ([129, 257], [100, 500], [256, 385]):
            lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
            for nk in (None, new_kv):
                for opt in (dict(), dict(window=200)):
                    sp0 = paged_attention.paged_attn_int8.launches_split
                    got = paged_attention._paged_launch(q, kp, kps, vp, vps, 1, table, lens, 0.01, nk,
                                                        opt.get("window"), None, None, plan)
                    need(paged_attention.paged_attn_int8.launches_split == sp0 + 1,
                         f"paged split {tuple(plan)}: the split body did not run")
                    ref = paged_attention._paged_plain(q, kp, kps, vp, vps, 1, table, lens, nk, 0.01,
                                                       opt.get("window"), None, None)
                    close(f"paged split {tuple(plan)} lens={lens_l} new={nk is not None} {list(opt)}",
                          got, ref, rel=1e-4)
    # a page hint below a row's used pages caps the splits and drops no page,
    # in either body (rep 2 on the split body, rep 8 on the SIMT one)
    lens = torch.tensor([385, 500], dtype=torch.int32, device="cuda")
    for rep in (2, 8):
        q = torch.randn((2, Hkv, rep, D), generator=gen, device="cuda")
        ref = paged_attention._paged_plain(q, kp, kps, vp, vps, 1, table, lens, new_kv, 0.01,
                                           None, None, None)
        for hint in (1, 2, None):
            got = paged_attention.paged_attn_int8(q, kp, kps, vp, vps, 1, table, lens, 0.01,
                                                  new_kv=new_kv, pages_hint=hint)
            close(f"paged rep={rep} lens=[385, 500] pages_hint={hint}", got, ref, rel=1e-4)
    # kernel H at every group size and both head widths it takes, f32 q
    S = 384
    for D in (128, 256):
        kq = torch.randint(-127, 128, (L, B, Hkv, D, S), generator=gen, device="cuda", dtype=torch.int8)
        vq = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
        ks = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") * 0.2 + 0.05
        vs = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 0.5
        new_kv = (torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
                  torch.rand((B, Hkv), generator=gen, device="cuda") * 0.2 + 0.05,
                  torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
                  torch.rand((B, Hkv), generator=gen, device="cuda") + 0.5)
        for rep in (1, 2, 4, 8):
            q = torch.randn((B, Hkv, rep, D), generator=gen, device="cuda")
            for lens_l in ([0, 384], [383, 5]):
                lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
                for nk in (None, new_kv):
                    for opt in (dict(), dict(window=100), dict(softcap=5.0),
                                dict(alibi=torch.rand((Hkv * rep,), generator=gen, device="cuda"))):
                        got = attention.decode_attn_int8(q, kq, ks, vq, vs, 1, lens, 0.01, new_kv=nk, **opt)
                        ref = attention._decode_plain(q, kq, ks, vq, vs, 1, lens, nk, 0.01,
                                                      opt.get("window"), opt.get("softcap"),
                                                      opt.get("alibi"))
                        close(f"decode D={D} rep={rep} lens={lens_l} new={nk is not None} {list(opt)}",
                              got, ref, rel=1e-4)
    # kernel H's split body at every split count, a cache of 400 positions
    # (its last tile runs past S), f32 q, every group size it takes, a
    # window that crosses a split, rows with fewer tiles than splits
    S = 400
    kq = torch.randint(-127, 128, (L, B, Hkv, 128, S), generator=gen, device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (L, B, Hkv, S, 128), generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") * 0.2 + 0.05
    vs = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 0.5
    new_kv = (torch.randint(-127, 128, (B, Hkv, 128), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, Hkv), generator=gen, device="cuda") * 0.2 + 0.05,
              torch.randint(-127, 128, (B, Hkv, 128), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, Hkv), generator=gen, device="cuda") + 0.5)
    for rep in (1, 2, 4):
        q = torch.randn((B, Hkv, rep, 128), generator=gen, device="cuda")
        for nsplit in (1, 2, 3, 4):
            plan = attention.DecodePlan("split", nsplit)
            for lens_l in ([400, 129], [100, 399], [0, 257]):
                lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
                for nk in (None, new_kv):
                    for opt in (dict(), dict(window=200)):
                        sp0 = attention.decode_attn_int8.launches_split
                        got = attention._decode_launch(q, kq, ks, vq, vs, 1, lens, 0.01, nk,
                                                       opt.get("window"), None, None, plan)
                        need(attention.decode_attn_int8.launches_split == sp0 + 1,
                             f"decode split {tuple(plan)}: the split body did not run")
                        ref = attention._decode_plain(q, kq, ks, vq, vs, 1, lens, nk, 0.01,
                                                      opt.get("window"), None, None)
                        close(f"decode split rep={rep} {tuple(plan)} S={S} lens={lens_l}"
                              f" new={nk is not None} {list(opt)}", got, ref, rel=1e-4)
    # kernel I at odd row counts, f32 in and out, with bias
    from bitsandbytes_sycl_tpu_torch import functional as F
    from bitsandbytes_sycl_tpu_torch.ops import matmul_int8

    W = torch.randn((192, 384), generator=gen, device="cuda") * 0.05
    CB, SCB = F.int8_vectorwise_quant(W)
    bias = torch.randn((192,), generator=gen, device="cuda")
    for M in (1, 17, 67, 100, 128):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((M, 384), generator=gen, device="cuda").to(dt)
            x[0] = 0.0  # an all-zero row: inv = 127
            inv = torch.where(x.float().abs().amax(1) > 0, 127.0 * F._safe_inv(x.float().abs().amax(1)),
                              torch.full((M,), 127.0, device="cuda"))
            for b in (None, bias):
                got = matmul_int8.int8_matmul(x, inv, CB, SCB, b, dt)
                ratio = ulp_ratio(torch, got, matmul_int8._mm8_plain(x, inv, CB, SCB, b, dt), dt, b)
                need(ratio <= (2 if dt == torch.float32 else 1),
                     f"int8_matmul M={M} {dt} bias={b is not None}: {ratio} ulps")
                n += 1
    return n


# --------------------------------------------------------------- phases 3-5
def counted(kernels):
    """The kernel wrappers and the model's write_and_attend, whose
    ``dequant_calls`` and ``bf16_calls`` count the layer attentions that
    ran through _attention (the dequantize-then-attend route, the bf16
    cache) instead of a kernel."""
    from bitsandbytes_sycl_tpu_torch.models.llama import write_and_attend

    return (*kernels, write_and_attend)


def reset_counts(kernels):
    """Every launch counter of each wrapper to 0 (``launches`` and the
    per-body ones, ``launches_tc`` of B and ``launches_wgmma`` of G), and
    the model's route counters."""
    for k in counted(kernels):
        for a in [a for a in vars(k) if a.startswith("launches") or a.endswith("_calls")]:
            setattr(k, a, 0)


def read_counts(kernels):
    """{wrapper: launches} plus {wrapper.body: launches} for the per-body
    counters (``mm4_fused.tc``, ``w4a8_grouped.wgmma``), and the model's
    route counters (``write_and_attend.dequant``, ``write_and_attend.bf16``)."""
    out = {}
    for k in counted(kernels):
        for a, v in vars(k).items():
            if a.startswith("launches"):
                out[k.__name__ + a[len("launches"):].replace("_", ".", 1)] = v
            elif a.endswith("_calls"):
                out[f"{k.__name__}.{a[:-len('_calls')]}"] = v
    return out


def need_new_bodies(counts, label, decode=True, per_step=None, a_body="fused"):
    """Every prefill launch of kernel C in ``counts`` went through its
    tensor-core body (the model's q is bf16), with ``decode`` every launch
    of kernel D through its split body, every launch of kernel H
    (decode only) through its split body, every launch of kernel F
    through its tiled body and of kernel E through its TMA body, every
    launch of A through its fused or tensor-core body, and no layer
    attention took the dequantize-then-attend route. With ``per_step``
    (launches per profiled decode step), every decode step's launches of A
    went through its ``a_body`` body and those of H through its split body."""
    need(counts.get("write_and_attend.dequant", 0) == 0,
         f"{label}: {counts.get('write_and_attend.dequant')} layer attentions took the"
         " dequantize-then-attend route")
    need(counts["prefill_attn_int8.tc"] == counts["prefill_attn_int8"],
         f"{label}: {counts['prefill_attn_int8'] - counts['prefill_attn_int8.tc']} of"
         f" {counts['prefill_attn_int8']} prefill attention launches missed C's tensor-core body")
    if decode:
        need(counts["paged_attn_int8.split"] == counts["paged_attn_int8"],
             f"{label}: {counts['paged_attn_int8'] - counts['paged_attn_int8.split']} of"
             f" {counts['paged_attn_int8']} paged decode launches missed D's split body")
    need(counts["decode_attn_int8.split"] == counts["decode_attn_int8"],
         f"{label}: {counts['decode_attn_int8'] - counts['decode_attn_int8.split']} of"
         f" {counts['decode_attn_int8']} contiguous decode launches missed H's split body")
    need(counts["dequant_int8.tiled"] == counts["dequant_int8"],
         f"{label}: {counts['dequant_int8'] - counts['dequant_int8.tiled']} of"
         f" {counts['dequant_int8']} W8A8 decodes missed F's tiled body")
    e_all, e_tma = counts.get("dequantize_transposed", 0), counts.get("dequantize_transposed.tma", 0)
    need(e_tma == e_all, f"{label}: {e_all - e_tma} of {e_all} dense decodes missed E's TMA body")
    a_all = counts.get("w4a8_gemv", 0)
    a_new = counts.get("w4a8_gemv.fused", 0) + counts.get("w4a8_gemv.tc", 0)
    need(a_new == a_all, f"{label}: {a_all - a_new} of {a_all} W4A8 launches took A's SIMT body")
    if per_step is not None:
        for name, body in (("w4a8_gemv", a_body), ("decode_attn_int8", "split")):
            need(per_step.get(f"{name}.{body}", 0) == per_step.get(name, 0),
                 f"{label}: {per_step.get(name, 0)} launches of {name} per decode step, "
                 f"{per_step.get(f'{name}.{body}', 0)} of them on its {body} body")


def prompts_from_seed(seed, n, vocab):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(5, 33))).tolist() for _ in range(n)]


def serve(torch, cfg, params, prompts, max_new, device="cuda", paged=True, per_request=None,
          max_batch=4, lora=None, adapter_ids=None, forward_fn=None, mesh=None, **engine_kw):
    """generate() through an engine of ``max_batch`` slots (paged, or the
    default contiguous cache), with stacked adapters ``lora`` and one
    adapter id per request if given, through the model's ``forward_fn``
    (llama_forward by default), tensor-parallel over ``mesh`` if given.
    ``per_request`` maps each request to the logits rows its tokens were
    sampled from."""
    import numpy as np

    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(max_batch=max_batch, paged=paged, page_size=128, max_new_tokens=max_new,
                        **engine_kw)
    eng = InferenceEngine(cfg, params, ecfg, device=device, lora=lora, forward_fn=forward_fn,
                          mesh=mesh)
    steps = []
    step = eng.step
    state = {"step": False}

    def timed_step():
        t0 = time.perf_counter()
        state["step"] = True
        out = step()
        state["step"] = False
        steps.append(time.perf_counter() - t0)  # step ends in a host copy of the ids
        return out

    eng.step = timed_step
    sample = eng._sample

    def recording_sample(logits):
        # generate() reports a prefill's tokens in request order and a
        # step's in ascending order of the active slots
        rows = np.flatnonzero(eng.active) if state["step"] else range(logits.shape[0])
        state["rows"], state["logits"] = iter(rows), logits.float().cpu()
        return sample(logits)

    def on_token(rid, tok):
        per_request.setdefault(rid, []).append(state["logits"][next(state["rows"])])

    if per_request is not None:
        eng._sample = recording_sample
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, adapter_ids=adapter_ids,
                        on_token=None if per_request is None else on_token)
    if device == "cuda":
        torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, steps


def greedy_agree(ref_outs, ref_logits, outs, label, rel=5e-2):
    """Greedy tokens of two runs of the same requests must be equal up to a
    step where the reference's top-2 logit gap is within ``rel`` of its
    largest |logit| (there the two may part). Returns the tokens compared
    equal; fails on none."""
    checked = 0
    for rid, (a, b) in enumerate(zip(ref_outs, outs)):
        for i, (ta, tb) in enumerate(zip(a, b)):
            if ta != tb:
                lg = ref_logits[rid][i]
                top2 = lg.topk(2).values
                need(float(top2[0] - top2[1]) <= rel * float(lg.abs().max()),
                     f"{label}: token {i} of request {rid} differs with a clear top-2 gap")
                break
            checked += 1
    need(checked > 0, f"{label}: no greedy token was compared")
    return checked


def host_yardsticks(torch):
    """Host speed, read in the same run as the serving step so that steps
    of runs on different hosts can be compared: a fixed pure-Python loop,
    and the host time to enqueue one small CUDA op while a spin kernel
    keeps the device busy (so only the enqueue is timed)."""
    def loop():
        t0, acc = time.perf_counter(), 0
        for i in range(200_000):
            acc += i * i
        return time.perf_counter() - t0

    x = torch.zeros(1, device="cuda")
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # tens of ms of device time
        t0 = time.perf_counter()
        for _ in range(500):
            x.add_(1)
        enqueue.append((time.perf_counter() - t0) / 500)
    torch.cuda.synchronize()
    return dict(python_loop_ms=sorted(loop() for _ in range(7))[3] * 1e3,
                enqueue_us=sorted(enqueue)[2] * 1e6, cpus=len(os.sched_getaffinity(0)),
                loadavg_1min=os.getloadavg()[0], torch_threads=torch.get_num_threads())


HOST_WRAPPERS = ("w4a8_gemv", "_gemv_launch", "decode_attn_int8", "_decode_launch",
                 "paged_attn_int8", "_paged_launch", "int8_matmul")


def host_profile(torch, eng, n=3, name="host_profile.txt"):
    """cProfile of n decode steps: where the host's time goes (the step is
    host-bound). The full table goes to chiprun_out/<name>."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    prof.disable()
    buf = io.StringIO()
    stats = pstats.Stats(prof, stream=buf).sort_stats("tottime")
    stats.print_stats(40)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        f.write(buf.getvalue())
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:10]
    top = [(f"{os.path.basename(fn)}:{line}({name})", tt / n * 1e3, nc // n)
           for (fn, line, name), (_, nc, tt, _, _) in rows]
    # the kernel wrappers' cumulative host time per step
    for (fn, line, name), (_, nc, _, ct, _) in stats.stats.items():
        if name in HOST_WRAPPERS and "bitsandbytes_sycl_tpu_torch" in fn:
            top.append((f"cumulative {os.path.basename(fn)}:{line}({name})", ct / n * 1e3, nc // n))
    return top


def step_vs_host_speed(torch, eng, n=16):
    """n decode steps, each followed by the enqueue yardstick of
    host_yardsticks: pairs (step ms, enqueue us) and their correlation,
    which says whether the step's spread is the host's speed."""
    import numpy as np

    x = torch.zeros(1, device="cuda")
    pairs = []
    for _ in range(n):
        t0 = time.perf_counter()
        eng.step()
        step_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        t0 = time.perf_counter()
        for _ in range(200):
            x.add_(1)
        pairs.append((step_ms, (time.perf_counter() - t0) / 200 * 1e6))
        torch.cuda.synchronize()
    a = np.asarray(pairs)
    return dict(pairs=pairs, corr=float(np.corrcoef(a[:, 0], a[:, 1])[0, 1]))


def profile_steps(torch, cfg, params, prompts, n=4, paged=True, host=True, host_name=None,
                  max_batch=4):
    """Device busy time of n steady decode steps (B = max_batch live rows)
    against their wall time, from torch.profiler's per-kernel device times,
    and each ported kernel's launches per step; with ``host``, also where
    the host's time goes, from cProfile, and whether the step follows the
    host's speed."""
    from torch.profiler import ProfilerActivity, profile

    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
    from bitsandbytes_sycl_tpu_torch.ops import KERNELS

    eng = InferenceEngine(cfg, params, EngineConfig(max_batch=max_batch, paged=paged,
                                                    max_new_tokens=64), device="cuda")
    eng.add_requests(prompts[:max_batch])
    eng.step()
    torch.cuda.synchronize()
    reset_counts(KERNELS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    per_step = {k: v / n for k, v in read_counts(KERNELS).items() if v}
    # device-side entries only: a CPU op's entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = dict(wall_ms=wall * 1e3, device_busy_ms=busy if busy > 0 else None,
               kernels_per_step=sum(e.count for e in kernels) / n, launches_per_step=per_step,
               attention=attention_time(kernels, n),
               top=[(e.key, e.self_device_time_total / 1e3 / n, e.count // n) for e in top],
               device_ms={e.key: e.self_device_time_total / 1e3 / n for e in kernels})
    if host:
        out.update(host_top=host_profile(torch, eng, name=host_name or (
            "host_profile.txt" if paged else "host_profile_contiguous.txt")),
                   step_vs_host=step_vs_host_speed(torch, eng))
    return out


def long_prompts(seed, n, lo, hi, vocab):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi + 1))).tolist() for _ in range(n)]


def profile_prefill(torch, cfg, params, Kb, T):
    """One warm prefill forward of the engine's shape (Kb, T) into a fresh
    scratch cache, under torch.profiler: wall time, the device's busy time
    (the sum of its kernels' times) and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    from bitsandbytes_sycl_tpu_torch.models.llama import init_kv_cache, llama_forward

    toks = torch.randint(1, cfg.vocab_size, (Kb, T), device="cuda")
    pos = torch.arange(T, device="cuda").expand(Kb, T)
    llama_forward(params, cfg, toks, init_kv_cache(cfg, Kb, "cuda"), pos)
    cache = init_kv_cache(cfg, Kb, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llama_forward(params, cfg, toks, cache, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    f_route = {}  # kernel F and the glue kernels of its W8A8 route: (ms, launches)
    for e in kernels:
        name = next((v for k, v in F_ROUTE_KERNELS.items() if k in e.key), None)
        if name is not None:
            ms, n = f_route.get(name, (0.0, 0))
            f_route[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    e = [k for k in kernels if "dequant4_" in k.key]  # kernel E, either route
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy, attention=attention_time(kernels),
                f_route=f_route, e=(sum(k.self_device_time_total for k in e) / 1e3,
                                    sum(k.count for k in e)),
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])


F_ROUTE_KERNELS = {"dequant_tiled_kernel": "F tiled", "dequant_int8_kernel": "F stride",
                   "col_grid_kernel": "col_grid", "quant_rows_kernel": "quant_rows",
                   "i16832gemm_s8": "_int_mm"}


ATTENTION_KERNELS = {  # kernel symbol -> the ported kernel and body it belongs to
    "prefill_tc_kernel": "C tensor-core", "prefill_kernel": "C SIMT",
    "paged_split_kernel": "D split", "paged_kernel": "D SIMT", "decode_split_kernel": "H split",
    "decode_kernel": "H SIMT",
}


def attention_time(kernels, n=1):
    """Device ms (per step, over n) and launches of the attention kernels
    among a profile's device-side entries, by body."""
    out = {}
    for e in kernels:
        for sym, body in ATTENTION_KERNELS.items():
            if f"::{sym}" in e.key or e.key.startswith(sym):
                ms, cnt = out.get(body, (0.0, 0))
                out[body] = (ms + e.self_device_time_total / 1e3 / n, cnt + e.count // n)
    return out


def serve_long(torch, cfg, params, kernels, lean=False):
    """Phase 3b: long prompts through one paged engine (max_batch 8), three
    prefill batches in turn, each decoded to its end: one prompt of 129-256
    tokens (256 rows: kernel B, and E for down_proj), four of 257-512 (2048
    rows: G), eight of 257-512 (4096 rows: F). With ``lean`` (phase 3d:
    compressed statistics, kv4 pages) the 2048-row batch decodes every
    weight once through E's compressed branch instead of G, and F takes the
    decoded scales. Returns one dict per batch."""
    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
    from bitsandbytes_sycl_tpu_torch.engine.engine import _bucket, _pow2_bucket

    max_new = 16
    eng = InferenceEngine(cfg, params, EngineConfig(max_batch=8, paged=True, max_new_tokens=max_new),
                          device="cuda")
    batches = [
        ("rows 256", long_prompts(10, 1, 129, 256, cfg.vocab_size),
         ("mm4_fused", "mm4_fused.tc", "dequantize_transposed")
         + (("mm4_fused.compressed", "dequantize_transposed.compressed") if lean else ())),
        ("rows 2048", long_prompts(11, 4, 257, 512, cfg.vocab_size),
         ("dequantize_transposed.compressed",) if lean else ("w4a8_grouped", "w4a8_grouped.wgmma")),
        ("rows 4096", long_prompts(12, 8, 257, 512, cfg.vocab_size),
         ("dequant_int8", "dequant_int8.tiled")),
    ]
    out = []
    for label, prompts, want in batches:
        T = _bucket(max(len(p) for p in prompts), eng.ecfg.prefill_buckets)
        prof = profile_prefill(torch, cfg, params, _pow2_bucket(len(prompts), 8), T)
        reset_counts(kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        slots = eng.add_requests(prompts)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        counts = read_counts(kernels)
        steps = []
        while eng.active.any():
            t0 = time.perf_counter()
            eng.step()
            steps.append(time.perf_counter() - t0)
        outs = [eng.slot_tokens[s][len(p):] for s, p in zip(slots, prompts)]
        for k in want:
            need(counts[k] > 0, f"long prompts ({label}): the prefill never launched {k}")
        if label == "rows 4096":
            need(counts["dequant_int8"] == 7 * cfg.num_layers + 1,
                 f"long prompts ({label}): kernel F launched {counts['dequant_int8']} times, not"
                 f" once per linear ({7 * cfg.num_layers + 1})")
        if lean and label == "rows 2048":
            need(counts["dequantize_transposed.compressed"] == 7 * cfg.num_layers + 1
                 and counts["w4a8_grouped"] == 0,
                 f"long prompts ({label}, compressed): E's compressed branch launched"
                 f" {counts['dequantize_transposed.compressed']} times, G {counts['w4a8_grouped']};"
                 f" expected once per linear ({7 * cfg.num_layers + 1}) and no G")
        need_new_bodies(counts, f"long prompts ({label}) prefill", decode=False)
        need(all(len(o) == max_new for o in outs), f"long prompts ({label}): wrong output lengths "
                                                   f"{[len(o) for o in outs]}")
        need(all(0 <= t < cfg.vocab_size for o in outs for t in o),
             f"long prompts ({label}): token id out of range")
        n_tok = sum(len(p) for p in prompts)
        steps.sort()
        row = dict(label=label, prompts=len(prompts), prompt_tokens=n_tok,
                   prefill_s=t_prefill, prefill_tokens_per_s=n_tok / t_prefill,
                   decode_steps=len(steps), decode_ms_per_step_median=steps[len(steps) // 2] * 1e3,
                   decode_ms_per_step_quartiles=[steps[len(steps) // 4] * 1e3,
                                                 steps[3 * len(steps) // 4] * 1e3],
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
                   profile=prof)
        out.append(row)
        tag = "[3d]" if lean else "[3b]"
        print(f"{tag} {label}: {len(prompts)} prompts, {n_tok} tokens prefilled in {t_prefill:.3f} s"
              f" = {n_tok / t_prefill:.0f} tok/s; then {len(steps)} decode steps, median"
              f" {row['decode_ms_per_step_median']:.2f} ms; peak {row['peak_gb']:.1f} GB;"
              f" prefill launches {counts}", flush=True)
        print(f"{tag} {label}: profiled prefill forward {prof['wall_ms']:.1f} ms, device busy"
              f" {prof['device_busy_ms']:.1f} ms (idle {1 - prof['device_busy_ms'] / prof['wall_ms']:.0%});"
              f" attention (ms, launches) {prof['attention']}; W8A8 route (ms, launches)"
              f" {prof['f_route']}; E (ms, launches) {prof['e']}")
        for key, ms, cnt in prof["top"]:
            print(f"      {ms:8.3f} ms  {cnt:5d}x  {key[:90]}")
    del eng
    torch.cuda.empty_cache()
    return out


def chunked_vs_whole(torch, cfg, params, kernels):
    """Phase 3b, chunked prefill: two prompts of 700-1000 tokens prefilled
    whole (2048 rows) and in chunks of 256 (512 rows a chunk), then 8
    greedy tokens each, with the default W4A8 linears (the chunks on G's
    wgmma body) and with a8_decode=False (the exact path: the chunks on B's
    tensor-core body, the whole prompt dequantized once). Each chunked
    prefill's sampled logits must agree with the same model's whole-prompt
    prefill within the card-vs-CPU limits (4% relative L2, 5% of the
    largest), and the tokens wherever the whole-prompt engine's top-2 logit
    gap exceeds the latter; at least one token must be compared."""
    prompts = long_prompts(13, 2, 700, 1000, cfg.vocab_size)
    out = dict(prompt_tokens=[len(p) for p in prompts])
    for label, cfg_, want in (("w4a8", cfg, "w4a8_grouped.wgmma"),
                              ("exact", dataclasses.replace(cfg, a8_decode=False), "mm4_fused.tc")):
        runs = {}
        for chunk in (0, 256):
            rec = {}
            reset_counts(kernels)
            outs, t, _ = serve(torch, cfg_, params, prompts, 8, per_request=rec, max_batch=2,
                               prefill_chunk=chunk)
            runs[chunk] = (outs, rec, t, read_counts(kernels))
            torch.cuda.empty_cache()
        (whole, rec_w, t_w, _), (chunked, rec_c, t_c, counts) = runs[0], runs[256]
        need(counts[want] > 0, f"chunked prefill ({label} linears) never launched {want}")
        need_new_bodies(counts, f"chunked prefill ({label} linears)")
        # the prefill's sampled logits: the chunks' attention over the cache
        # against the whole prompt's, within the card-vs-CPU limits
        first_w = torch.stack([rec_w[r][0] for r in range(2)])
        first_c = torch.stack([rec_c[r][0] for r in range(2)])
        err, mag = max_err(torch, first_c, first_w)
        rel = float((first_c - first_w).norm() / first_w.norm())
        need(rel <= 4e-2, f"chunked prefill ({label}) logits: relative L2 {rel} > 0.04 of the whole prompt's")
        need(err <= 5e-2 * mag, f"chunked prefill ({label}) logits: max err {err} > {5e-2 * mag}")
        checked = greedy_agree(whole, rec_w, chunked, f"chunked prefill ({label})")
        print(f"[3b] chunked prefill ({label} linears, 256-token chunks, prompts of"
              f" {[len(p) for p in prompts]} tokens): prefill logits relative L2 {rel:.3g} (tol"
              f" 0.04), max err {err:.4g} (tol {5e-2 * mag:.4g}) against whole-prompt prefill;"
              f" {checked} of 16 greedy tokens equal; generate {t_c:.2f} s chunked, {t_w:.2f} s"
              f" whole; launches {({k: v for k, v in counts.items() if v})}", flush=True)
        out[label] = dict(logits_rel_l2=rel, logits_max_err=err, logits_max_abs=mag,
                          tokens_compared_equal=checked, generate_s_chunked=t_c,
                          generate_s_whole=t_w, launches=counts)
    return out


def serve_path(torch, label, cfg, params, prompts, kernels, launched, ref=None, host=False):
    """A serving path whole through the default (contiguous) engine, 4
    slots, 32 new tokens per prompt: the counts set to 0 just before and
    read just after, each kernel in ``launched`` launched, kernel D not;
    with ``ref`` (outputs and per-request logits of another run of the same
    weights), greedy tokens equal under the gap rule. Then a profile of
    four steady decode steps (with ``host``, also the host's cProfile), in
    which A's fused and H's split bodies must take every decode launch."""
    reset_counts(kernels)
    outs, wall, steps = serve(torch, cfg, params, prompts, 32, paged=False)
    counts = read_counts(kernels)
    need(all(len(o) == 32 for o in outs), f"{label}: wrong output lengths {[len(o) for o in outs]}")
    need(all(0 <= t < cfg.vocab_size for o in outs for t in o), f"{label}: token id out of range")
    for k in launched:
        need(counts[k] > 0, f"{label}: the serving path never launched {k}")
    need(counts["paged_attn_int8"] == 0, f"{label}: the contiguous engine launched kernel D")
    need_new_bodies(counts, label, decode=False)
    compared = None if ref is None else greedy_agree(*ref, outs, label)
    steps = sorted(steps)
    n_tok = sum(len(o) for o in outs)
    median = steps[len(steps) // 2] * 1e3
    prof = profile_steps(torch, cfg, params, prompts, paged=False, host=host)
    need_new_bodies(counts, label, decode=False, per_step=prof["launches_per_step"])
    busy = prof["device_busy_ms"]
    stats = dict(tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall, decode_steps=len(steps),
                 decode_ms_per_step_median=median,
                 decode_ms_per_step_quartiles=[steps[len(steps) // 4] * 1e3,
                                               steps[3 * len(steps) // 4] * 1e3],
                 launches=counts, tokens_compared_equal=compared, profile=prof, outs=outs,
                 device_idle_share=None if not busy else 1 - busy / median)
    print(f"{label}: {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s; {len(steps)} decode"
          f" steps, median {median:.2f} ms/step (quartiles {stats['decode_ms_per_step_quartiles'][0]:.2f}"
          f"-{stats['decode_ms_per_step_quartiles'][1]:.2f}); launches {counts}"
          + ("" if compared is None else f"; {compared} greedy tokens equal to the reference"),
          flush=True)
    print(f"{label}: profiled decode step (B=4): wall {prof['wall_ms']:.2f} ms, "
          + (f"device busy {busy:.2f} ms of the {median:.2f} ms median step (idle "
             f"{stats['device_idle_share']:.0%})" if busy else "device busy not measured")
          + f"; {prof['kernels_per_step']:.0f} kernels per step; ported kernels per step "
          f"{prof['launches_per_step']}; attention per step (ms, launches) {prof['attention']}")
    for key, ms, cnt in prof["top"]:
        print(f"      {ms:8.3f} ms/step  {cnt:5d}x  {key[:90]}")
    if host:
        print(f"{label}: host time per decode step under cProfile (tottime):")
        for key, ms, cnt in prof["host_top"]:
            print(f"      {ms:8.3f} ms/step  {cnt:6d}x  {key[:90]}")
    return stats


def serving7b_3e(torch, kernels):
    """3e: LlamaConfig.serving7b() (NF4 at blocksize 128, bf16 scales, W4A8
    decode: the JAX package's single-chip 7B serving preset) at full width
    and depth, random weights from seed 0, through the paged engine:
    max_batch 32, 32 prompts of phase 3's kind, 16 new tokens each. The
    1024-row prefill takes kernel G; every launch of A (225 a decode step at
    32 live rows) its tensor-core body. Then four decode steps at 32 live
    rows profiled (kernels per step, device busy and idle share against the
    unprofiled median step, A's device ms), and 2 layers at 7B width card
    against CPU: 2 prompts (a 64-row prefill and decode steps on A's
    tensor-core body), logits under phase 5's limits, tokens under the gap
    rule."""
    from bitsandbytes_sycl_tpu_torch.models.llama import LlamaConfig, init_params

    label = "[3e] serving7b"
    t0 = time.perf_counter()
    cfg = LlamaConfig.serving7b()
    params = init_params(cfg, seed=0, device="cuda")
    prompts = prompts_from_seed(0, 32, cfg.vocab_size)
    n_lin = 7 * cfg.num_layers + 1
    reset_counts(kernels)
    outs, wall, steps = serve(torch, cfg, params, prompts, 16, max_batch=32)
    counts = read_counts(kernels)
    need(all(len(o) == 16 for o in outs), f"{label}: wrong output lengths {[len(o) for o in outs]}")
    need(all(0 <= t < cfg.vocab_size for o in outs for t in o), f"{label}: token id out of range")
    need(counts["w4a8_grouped"] == n_lin, f"{label}: the 1024-row prefill launched kernel G"
                                          f" {counts['w4a8_grouped']} times, not {n_lin}")
    need(counts["w4a8_gemv"] == n_lin * len(steps) and counts["w4a8_gemv.tc"] == counts["w4a8_gemv"],
         f"{label}: kernel A launched {counts['w4a8_gemv']} times ({counts['w4a8_gemv.tc']} on its"
         f" tensor-core body) over {len(steps)} decode steps of {n_lin} linears")
    need_new_bodies(counts, label)
    steps = sorted(steps)
    median = steps[len(steps) // 2] * 1e3
    prof = profile_steps(torch, cfg, params, prompts, paged=True, host=False, max_batch=32)
    per = prof["launches_per_step"]
    need(per.get("w4a8_gemv.tc") == per.get("w4a8_gemv") == n_lin,
         f"{label}: A launched {per.get('w4a8_gemv')} times a profiled step, {per.get('w4a8_gemv.tc')}"
         " on its tensor-core body")
    need_new_bodies(counts, label, per_step=per, a_body="tc")
    busy = prof["device_busy_ms"]
    a_ms = {k: v for k, v in prof["device_ms"].items() if "w4a8_tc_kernel" in k or "quant_rows" in k}
    stats = dict(tokens=sum(map(len, outs)), wall_s=wall, decode_steps=len(steps),
                 decode_ms_per_step_median=median,
                 decode_ms_per_step_quartiles=[steps[len(steps) // 4] * 1e3,
                                               steps[3 * len(steps) // 4] * 1e3],
                 launches=counts, profile=prof, a_device_ms=a_ms,
                 device_idle_share=None if not busy else 1 - busy / median)
    print(f"{label}: {stats['tokens']} tokens in {wall:.2f} s; {len(steps)} decode steps at 32 rows,"
          f" median {median:.2f} ms/step (quartiles {stats['decode_ms_per_step_quartiles'][0]:.2f}-"
          f"{stats['decode_ms_per_step_quartiles'][1]:.2f}); launches {counts}", flush=True)
    print(f"{label}: profiled decode step (B=32): wall {prof['wall_ms']:.2f} ms, "
          + (f"device busy {busy:.2f} ms of the {median:.2f} ms median step (idle "
             f"{stats['device_idle_share']:.0%})" if busy else "device busy not measured")
          + f"; {prof['kernels_per_step']:.0f} kernels per step; A's device ms per step "
          + json.dumps({k[:60]: round(v, 4) for k, v in a_ms.items()}))
    for key, ms, cnt in prof["top"]:
        print(f"      {ms:8.3f} ms/step  {cnt:5d}x  {key[:90]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p_gpu = init_params(cfg2, seed=1, device="cuda")  # quantized on the card, then copied
    p_cpu = to_cuda(torch, p_gpu, device="cpu")
    reset_counts(kernels)
    stats["card_vs_cpu"] = engine_card_vs_cpu(torch, label, cfg2, p_cpu, p_gpu, prompts[:2], new=3,
                                              paged=True)
    c2 = read_counts(kernels)
    need(c2["w4a8_gemv"] > 0 and c2["w4a8_gemv.tc"] == c2["w4a8_gemv"],
         f"{label} card vs CPU: A launched {c2['w4a8_gemv']} times, {c2['w4a8_gemv.tc']} on its"
         " tensor-core body")
    stats["seconds"] = time.perf_counter() - t0
    return stats


def w8a8_prefill_batches(torch, cfg, params, kernels):
    """EngineConfig(w8a8_prefill=True) on the NF4 weights: a batch of 128
    prefill rows (kernel I) and one of 2048 rows (torch._int_mm), each in
    both engine modes. The prefill logits must equal, bit for bit, those of
    the default engine serving the fully repacked weights (the same int8
    weights; first tokens equal), and stay within 15% relative L2 of the
    default engine's on the NF4 weights: the repack moves this random-weight
    model's logits by ~10% (the phase prints it), far inside what a wrong
    weight or route gives (~100%), so the gap rule at 5% cannot hold there
    and the first tokens equal to the NF4 engine's are counted, not held."""
    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
    from bitsandbytes_sycl_tpu_torch.models.llama import repack_params_int8

    def prefill(cfg_, params_, prompts, **kw):
        gc.collect()  # earlier engines' caches: the peak is this prefill's
        eng = InferenceEngine(cfg_, params_, EngineConfig(max_batch=4, max_new_tokens=2, **kw),
                              device="cuda")
        rec = []
        sample = eng._sample
        eng._sample = lambda logits: (rec.append(logits.float().cpu()), sample(logits))[1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        t0 = time.perf_counter()
        slots = eng.add_requests(prompts)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        first = [eng.slot_tokens[s_][-1] for s_ in slots]
        return rec[0][: len(prompts)], first, t, read_counts(kernels)

    n_lin = 7 * cfg.num_layers + 1
    batches = [("rows 128", prompts_from_seed(20, 4, cfg.vocab_size), n_lin),
               ("rows 2048", long_prompts(21, 4, 257, 512, cfg.vocab_size), 0)]
    runs = []  # the w8a8_prefill engines first: the peak then holds no repacked copy of ours
    for label, prompts, n_i in batches:
        for paged in (False, True):
            lg, first, t, counts = prefill(cfg, params, prompts, paged=paged, w8a8_prefill=True)
            runs.append((label, prompts, n_i, paged, lg, first, t, counts,
                         torch.cuda.max_memory_allocated() / 1e9))
            torch.cuda.empty_cache()
    params8, cfg8 = repack_params_int8(params, cfg)
    refs = {label: (prefill(cfg, params, prompts)[:2], prefill(cfg8, params8, prompts)[:2])
            for label, prompts, _ in batches}
    del params8
    torch.cuda.empty_cache()
    out = []
    for label, prompts, n_i, paged, lg, first, t, counts, peak in runs:
        (lg_nf4, first_nf4), (lg_int8, first_int8) = refs[label]
        name = f"w8a8_prefill {label} paged={paged}"
        need(counts["int8_matmul"] == n_i, f"{name}: kernel I launched {counts['int8_matmul']} "
                                           f"times, not {n_i}")
        need(counts["w4a8_gemv"] == counts["w4a8_grouped"] == 0,
             f"{name}: a 4-bit linear kernel ran in the prefill")
        need(counts["prefill_attn_int8"] > 0, f"{name}: the prefill never launched kernel C")
        need_new_bodies(counts, name, decode=False)
        need(torch.equal(lg, lg_int8) and first == first_int8,
             f"{name}: prefill logits differ from the repacked model's")
        rel = float((lg - lg_nf4).norm() / lg_nf4.norm())
        need(rel <= 0.15, f"{name}: logits {rel} (relative L2) from the NF4 engine's")
        same = sum(a == b for a, b in zip(first, first_nf4))
        n_tok = sum(len(p) for p in prompts)
        out.append(dict(label=label, paged=paged, prompt_tokens=n_tok, prefill_s=t,
                        prefill_tokens_per_s=n_tok / t, peak_gb=peak, launches=counts,
                        rel_l2_vs_nf4=rel, first_tokens_equal_nf4=same))
        print(f"[4b] {name}: {n_tok} tokens prefilled in {t:.3f} s = {n_tok / t:.0f} tok/s"
              f" (int8 repack included); peak {peak:.1f} GB; logits equal to the repacked"
              f" model's; {rel:.3g} relative L2 from the NF4 engine's, {same} of {len(prompts)}"
              f" first tokens equal; launches {counts}", flush=True)
    return out


def int8_card_vs_cpu(torch, cfg8, prompts_seed):
    """LLM.int8, 2 layers at 7B width from one seed, on the card and on the
    CPU (plain versions): prefill logits at T = 32 and 4 teacher-forced
    decode steps over the contiguous cache within 4% relative L2 and 5% of
    the largest logit, then greedy tokens equal under the gap rule."""
    from bitsandbytes_sycl_tpu_torch.models.llama import init_kv_cache, init_params, llama_forward

    cfg2 = dataclasses.replace(cfg8, num_layers=2)
    p_cpu = init_params(cfg2, seed=1, device="cpu")
    p_gpu = to_cuda(torch, p_cpu)
    toks = torch.tensor([p + [0] * (32 - len(p)) for p in prompts_from_seed(prompts_seed, 2, cfg2.vocab_size)])
    c_cpu, c_gpu = init_kv_cache(cfg2, 2, "cpu"), init_kv_cache(cfg2, 2, "cuda")
    lg_cpu, _ = llama_forward(p_cpu, cfg2, toks, c_cpu)
    lg_gpu, _ = llama_forward(p_gpu, cfg2, toks.cuda(), c_gpu)
    errs = []
    for i in range(5):
        err, mag = max_err(torch, lg_gpu.cpu(), lg_cpu)
        rel = float((lg_gpu.cpu() - lg_cpu).norm() / lg_cpu.norm())
        what = "prefill" if i == 0 else f"decode step {i}"
        need(torch.isfinite(lg_gpu).all().item(), f"LLM.int8 {what}: non-finite logits on the card")
        need(rel <= 4e-2, f"LLM.int8 {what} logits card vs CPU: relative L2 error {rel} > 0.04")
        need(err <= 5e-2 * mag, f"LLM.int8 {what} logits card vs CPU: max err {err} > {5e-2 * mag}")
        errs.append(dict(step=what, rel_l2=rel, max_err=err, max_abs=mag))
        if i == 4:
            break
        tok = lg_cpu[:, -1].argmax(dim=-1)[:, None]  # teacher-forced: both take the CPU's token
        pos = torch.full((2, 1), 32 + i, dtype=torch.long)
        lg_cpu, _ = llama_forward(p_cpu, cfg2, tok, c_cpu, pos)
        lg_gpu, _ = llama_forward(p_gpu, cfg2, tok.cuda(), c_gpu, pos.cuda())
    rec_cpu, rec_gpu = {}, {}
    pr = prompts_from_seed(prompts_seed + 1, 2, cfg2.vocab_size)
    out_cpu, _, _ = serve(torch, cfg2, p_cpu, pr, 5, device="cpu", paged=False, per_request=rec_cpu)
    out_gpu, _, _ = serve(torch, cfg2, p_gpu, pr, 5, paged=False, per_request=rec_gpu)
    checked = greedy_agree(out_cpu, rec_cpu, out_gpu, "LLM.int8 card vs CPU")
    print(f"[6] LLM.int8 2-layer 7B-width card vs CPU: " + "; ".join(
        f"{e['step']} rel L2 {e['rel_l2']:.3g} max err {e['max_err']:.4g} (tol {5e-2 * e['max_abs']:.4g})"
        for e in errs) + f"; {checked} of 10 greedy tokens compared equal", flush=True)
    return dict(logits=errs, tokens_compared_equal=checked)


# --------------------------------------------------------------- phase 7
# the 7B QLoRA step's 8-bit leaves: per layer the A and B of q, k, v, o, the A of
# gate and up and the B of down hold 262,144 parameters, the rest 704,512
QLORA_LEAVES = (262144,) * 352 + (704512,) * 96
# a mixed table: 2048-multiples, the 47 x 97 ragged leaf, one element, one block, ragged tails
MIXED_LEAVES = (262144, 4559, 4096, 262144 + 1000, 2048, 1, 704512, 5000)
OPTIM8_TIMED = (262144, 704512, 16777216)
# kernel K's resident route against its two-pass body: pairs of timings in turns
TURN_PAIRS = 10


def turns(torch, fn, other, r):
    """fn and other timed in TURN_PAIRS pairs, each pair's order the last
    one's reversed (fn, other, other, fn, ...): a time moves by ~1 us with
    the order. Records both lists and the spread of their differences in
    r["turns"]; returns the medians (fn, other)."""
    t = ([], [])
    for k in range(TURN_PAIRS):
        for side in ((0, 1) if k % 2 == 0 else (1, 0)):
            t[side].append(time_cold(torch, (fn, other)[side], iters=10, warmup=1,
                                     spin_cycles=20_000_000))
    d = sorted(a - b for a, b in zip(*t))
    r["turns"] = dict(ms=t[0], other_ms=t[1], diff_median_ms=d[len(d) // 2], diff_min_ms=d[0],
                      diff_max_ms=d[-1], faster=sum(x < 0 for x in d), pairs=TURN_PAIRS)
    return sorted(t[0])[TURN_PAIRS // 2], sorted(t[1])[TURN_PAIRS // 2]


def bits_equal(torch, a, b):
    """Equal bit for bit (NaN patterns included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def optim8_table(torch, gen, name, sizes, step, stochastic, packed=False, nrows=1, bs=2048):
    """An 8-bit leaf table on the card, as ops/optim8.Optim8Leaf rows of
    blocksize ``bs``, with the step's scalars (nrows rows, lr 2e-4 and half
    that, weight decay 0.01) and a row per leaf. Leaf 0 carries NaN/Inf
    gradients and, where it holds 5 blocks, an all-zero block, a block of
    values tiny against its absmax (the sign fix's case) and infinite and
    signed-zero p (where p + (new_p - p) differs from new_p); the first two
    ragged leaves of a mixed table get a NaN and an Inf absmax in their
    last block (the padding then decodes to NaN). ``packed`` makes every
    leaf a view of one buffer per kind, so leaves after a ragged one start
    unaligned; returns (leaves, scalars, rows, buffers or None)."""
    from bitsandbytes_sycl_tpu_torch import functional as F
    from bitsandbytes_sycl_tpu_torch.ops import optim8 as O

    dev = "cuda"
    two = name in O.TWO_STATE
    blocks = [-(-n // bs) for n in sizes]
    N, NB = sum(sizes), sum(blocks)
    lo = 127 if name in ("rmsprop", "adagrad") else 0  # a nonnegative second moment
    flat = dict(g=torch.randn(N, generator=gen, device=dev) * 0.01,
                p=torch.randn(N, generator=gen, device=dev) * 0.02,
                state1=torch.randint(lo, 256, (N,), generator=gen, device=dev).to(torch.uint8),
                absmax1=torch.rand(NB, generator=gen, device=dev) * 1e-3)
    if two:
        flat["state2"] = torch.randint(0, 256, (N,), generator=gen, device=dev).to(torch.uint8)
        flat["absmax2"] = torch.rand(NB, generator=gen, device=dev) * 1e-5
    if stochastic:
        flat["u"] = torch.rand(N, generator=gen, device=dev)
    if sizes[0] >= 5 * bs:
        g0, p0 = flat["g"][:5 * bs].view(5, bs), flat["p"][:5 * bs].view(5, bs)
        g0[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")], device=dev)
        g0[1] = 0.0
        g0[3] *= 1e-7
        g0[3, 0] = 1.0
        # p + (new_p - p) equals new_p for every finite p: it differs at
        # infinite p (inf - inf) and signed zeros
        p0[4, :4] = torch.tensor([float("inf"), -float("inf"), -0.0, 0.0], device=dev)
        g0[4, 2:4] = 0.0
        flat["state1"][2 * bs:4 * bs] = 127  # zero states: block 2 stays zero where g is
        flat["absmax1"][2:4] = 0.0
        g0[2] = 0.0
        if two:
            flat["state2"][2 * bs:4 * bs] = 0
    elif sizes[0] >= 3:
        flat["g"][:3] = torch.tensor([float("nan"), float("inf"), -float("inf")], device=dev)
    ragged = [i for i, n in enumerate(sizes) if n % bs]
    ends = [sum(blocks[:i + 1]) - 1 for i in range(len(sizes))]
    for k, i in enumerate(ragged[:2] if len(sizes) < 20 else []):
        flat["absmax1"][ends[i]] = float("nan") if k == 0 else float("inf")
    fields = ("g", "p", "state1", "absmax1", "state2", "absmax2", "u")
    leaves, e0, b0 = [], 0, 0
    for n, nb in zip(sizes, blocks):
        parts = {}
        for f in fields:
            if f in flat:
                lo_, hi_ = (b0, b0 + nb) if f.startswith("absmax") else (e0, e0 + n)
                parts[f] = flat[f][lo_:hi_] if packed else flat[f][lo_:hi_].clone()
        leaves.append(O.Optim8Leaf(**parts))
        e0, b0 = e0 + n, b0 + nb
    rows = [i % nrows for i in range(len(sizes))]
    scalars = torch.stack([F._optim8_scalars(name, 0.9, 0.999 if two else 0.99, 1e-8, step,
                                             2e-4 / (1 + r), 0.01, 1.0, dev) for r in range(nrows)])
    return leaves, scalars, rows, (flat if packed else None)


def clone_table(torch, leaves, flat=None, with_buffers=False):
    """An equal copy of a leaf table (packed tables stay packed; with
    ``with_buffers`` also the copy's buffers)."""
    from bitsandbytes_sycl_tpu_torch.ops import optim8 as O

    if flat is None:
        return [O.Optim8Leaf(*[None if t is None else t.clone() for t in lf]) for lf in leaves]
    copy = {k: v.clone() for k, v in flat.items()}
    base = {k: v.data_ptr() for k, v in flat.items()}
    out = []
    for lf in leaves:
        parts = {}
        for f, t in lf._asdict().items():
            if t is not None:
                off = (t.data_ptr() - base[f]) // t.element_size()
                parts[f] = copy[f][off:off + t.numel()]
        out.append(O.Optim8Leaf(**parts))
    return (out, copy) if with_buffers else out


def tables_equal(torch, a, b):
    """(equal, differing entries per field) of two leaf tables."""
    diff = {}
    for la, lb in zip(a, b):
        for f, x in la._asdict().items():
            y = getattr(lb, f)
            if x is not None and not bits_equal(torch, x, y):
                diff[f] = diff.get(f, 0) + int((x.reshape(-1) != y.reshape(-1)).sum())
    return not diff, diff


def optim8_bytes(two, sizes, bs=2048):
    """The bytes one step must move: g and p read and p written (4 B each),
    each state's code read and written, each block's absmax read and
    written."""
    nb = sum(-(-n // bs) for n in sizes)
    n = sum(sizes)
    return n * (16 if two else 14) + nb * (16 if two else 8)


def check_optim8(torch, report):
    """Kernels J (optim8_2state) and K (optim8_1state), one launch over a
    leaf table, against their plain version (ops/optim8._grouped_plain) on
    the card, bit for bit in p, codes and absmax: every optimizer name over
    the 448-leaf 7B QLoRA table, a mixed table with ragged leaves (NaN/Inf
    absmax in their last blocks, also packed so leaves start unaligned,
    two scalars rows) and 16.8M parameters, with and without stochastic
    rounding, p written as p + (new_p - p) (the optimizer's route) and as
    new_p (the JAX entry's). The encode's exponent-bit decade search
    against the edge-by-edge encode, and the LUT codec's bucketed rank
    against the binary search over the midpoints (four tables), on all
    2^32 f32 patterns. Eight
    deliberate faults in the plain version must each change the result.
    100 launches repeat their bits. Times of J (adam) and K (lion) at the
    three leaf sizes and over the whole table against the byte bound."""
    from bitsandbytes_sycl_tpu_torch import functional as F
    from bitsandbytes_sycl_tpu_torch.ops import optim8 as O

    bad = O.encode_sweep("cuda")
    need(bad == (0, 0), f"the exponent-bit encode differs from the edge-by-edge one on {bad}"
                        " f32 patterns (signed, unsigned)")
    print("  encode: exponent-bit decade search equals the edge-by-edge encode on all 2^32 f32"
          " patterns of both maps", flush=True)
    q = dict(lut_tables())
    for pair in (("quantile", "linear unsigned"), ("7-bit padded", "permuted")):
        bad = O.lut_rank_sweep("cuda", q[pair[0]], q[pair[1]])
        need(bad == (0, 0), f"the LUT codec's bucketed rank differs from the binary search on"
                            f" {bad} f32 patterns ({pair[0]}, {pair[1]})")
    print("  LUT codec: the bucketed rank equals the binary search over the midpoints on all 2^32"
          " f32 patterns of four tables (quantile, linear unsigned, 7-bit padded, permuted)",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {"optim8_2state": [], "optim8_1state": []}
    cases = 0

    def compare(label, name, table, delta):
        leaves, scalars, rws, flat = table
        got, ref = clone_table(torch, leaves, flat), clone_table(torch, leaves, flat)
        O.optim8_update(name, got, scalars, rws, apply_delta=delta)
        cpu_like = [O.Optim8Leaf(*[None if t is None else t for t in lf]) for lf in ref]
        plan = O.leaf_plan(tuple(lf.p.numel() for lf in ref), 2048, 1)
        O._grouped_plain(name, cpu_like, scalars, tuple(rws), plan, 2048, delta)
        torch.cuda.synchronize()
        ok, diff = tables_equal(torch, got, ref)
        need(ok, f"{label} {name}: kernel differs from its plain version ({diff})")
        return got

    for name in O.TWO_STATE + O.ONE_STATE:
        for stochastic in (False, True):
            for label, sizes, packed, nrows in (("QLoRA table", QLORA_LEAVES, True, 1),
                                                ("mixed table", MIXED_LEAVES, False, 2),
                                                ("mixed table, packed", MIXED_LEAVES, True, 2),
                                                ("16.8M", (16777216,), False, 1)):
                table = optim8_table(torch, gen, name, sizes, 3, stochastic, packed, nrows)
                for delta in ((True, False) if label == "mixed table" else (True,)):
                    compare(label, name, table, delta)
                    cases += 1
                del table
    # per-leaf gnorm scales (percentile clipping): one scalars row per leaf
    for name in ("adam", "lion"):
        leaves, scalars, _, flat = optim8_table(torch, gen, name, MIXED_LEAVES, 2, False)
        scalars = scalars.repeat(len(leaves), 1)
        scalars[:, 5] = torch.rand(len(leaves), generator=gen, device="cuda")
        compare("per-leaf rows", name, (leaves, scalars, list(range(len(leaves))), flat), True)
        cases += 1
    # the JAX entry on (nb, bs) rows: the same body over a one-leaf table of copies
    for name in ("adam", "momentum"):
        leaves, scalars, _, _ = optim8_table(torch, gen, name, (262144,), 1, False)
        lf = leaves[0]
        args = [t.reshape(128, 2048) if t is not None and t.numel() == 262144 else t
                for t in (lf.g, lf.p, lf.state1, lf.absmax1, lf.state2, lf.absmax2)]
        got = O.optim8_blockwise_fused(name, *args, scalars[0])
        ref = (O._kernel2_plain if name in O.TWO_STATE else O._kernel1_plain)(
            name, scalars[0], *[a for a in args if a is not None])
        torch.cuda.synchronize()
        need(all(bits_equal(torch, a, b) for a, b in zip(got, ref)),
             f"optim8_blockwise_fused {name}: kernel differs from the rows plain version")
        cases += 1
    print(f"  J and K equal their plain version bit for bit in {cases} tables", flush=True)
    # a table of no block (every leaf empty) launches nothing and counts nothing
    f32, u8 = torch.float32, torch.uint8
    before = (O.optim8_2state.launches, O.optim8_1state.launches)
    for name, kinds in (("adam", (f32, f32, u8, f32, u8, f32)), ("lion", (f32, f32, u8, f32))):
        empty = [O.Optim8Leaf(*[torch.zeros(0, dtype=k, device="cuda") for k in kinds])
                 for _ in range(2)]
        O.optim8_update(name, empty, torch.zeros((1, 8), device="cuda"), apply_delta=True)
    need((O.optim8_2state.launches, O.optim8_1state.launches) == before,
         "optim8: a table of empty leaves counted a launch")

    # deliberate faults in the plain version, each must change the result
    codec, sign_fix, plan_fn = O._DynamicCodec, O._apply_sign_fix, O.leaf_plan

    class SignedState2(codec):
        def __init__(self, signed, sign_fix=False):
            super().__init__(True, sign_fix)

    def plain(name, leaves, scalars, rws, delta=True):
        plan = O.leaf_plan(tuple(lf.p.numel() for lf in leaves), 2048, 1)
        O._grouped_plain(name, leaves, scalars, tuple(rws), plan, 2048, delta)
        return leaves

    n_faults = {}
    for name in ("adam", "momentum"):
        two = name == "adam"
        leaves, scalars, rws, flat = optim8_table(torch, gen, name, MIXED_LEAVES, 1, False, False, 2)
        got = clone_table(torch, leaves)
        O.optim8_update(name, got, scalars, rws, apply_delta=True)
        faults = []
        if two:
            O._DynamicCodec = SignedState2
            try:
                faults.append(("state2 decoded through the signed map",
                               plain(name, clone_table(torch, leaves), scalars, rws)))
            finally:
                O._DynamicCodec = codec
        t = clone_table(torch, leaves)
        t[0] = t[0]._replace(absmax1=t[0].absmax1.roll(-1))
        faults.append(("the next block's absmax", plain(name, t, scalars, rws)))
        O._apply_sign_fix = lambda rank, normed, n_neg, top: rank.to(torch.int32)
        try:
            faults.append(("the sign fix dropped", plain(name, clone_table(torch, leaves),
                                                         scalars, rws)))
        finally:
            O._apply_sign_fix = sign_fix
        sc2 = torch.stack([F._optim8_scalars(name, 0.9, 0.999 if two else 0.99, 1e-8, 2,
                                             2e-4 / (1 + r), 0.01, 1.0, "cuda") for r in range(2)])
        faults.append(("the bias correction of step + 1",
                       plain(name, clone_table(torch, leaves), sc2, rws)))

        def shifted(numels, bs, sms):
            p = plan_fn(numels, bs, sms)
            return p._replace(first=(p.first[0], p.first[1] - 1) + p.first[2:])

        O.leaf_plan = shifted
        try:
            faults.append(("leaf 1's first block off by one",
                           plain(name, clone_table(torch, leaves), scalars, rws)))
        finally:
            O.leaf_plan = plan_fn
        # the ragged leaf 7 (5,000 elements, finite absmax) read past n: its
        # last block's padding holds data instead of the JAX package's fill
        t = clone_table(torch, leaves)
        rag = 7
        n1, pad = t[rag].p.numel(), 3 * 2048 - t[rag].p.numel()
        t[rag] = O.Optim8Leaf(*[x if x is None or x.numel() != n1 else torch.cat(
            [x, torch.randn(pad, device="cuda") if x.is_floating_point()
             else torch.randint(0, 256, (pad,), device="cuda").to(x.dtype)]) for x in t[rag]])
        plain(name, t, scalars, rws)
        t[rag] = O.Optim8Leaf(*[x if x is None or x.numel() != 3 * 2048 else x[:n1]
                                for x in t[rag]])
        faults.append(("the ragged tail read past n", t))
        faults.append(("another leaf's scalars row",
                       plain(name, clone_table(torch, leaves), scalars, [1 - r for r in rws])))
        faults.append(("p written as new_p", plain(name, clone_table(torch, leaves), scalars, rws,
                                                   delta=False)))
        for label, out in faults:
            need(not tables_equal(torch, got, out)[0],
                 f"{name}: a plain version with {label} equals the kernel, so the check "
                 f"cannot see that fault")
        n_faults[name] = len(faults)
        print(f"  {name}: {len(faults)} deliberate faults each change the result", flush=True)

    # repeat: 100 launches over the same inputs give the same bits
    for name, sizes, stochastic in (("adam", QLORA_LEAVES, False), ("lion", MIXED_LEAVES, True)):
        leaves, scalars, rws, flat = optim8_table(torch, gen, name, sizes, 3, stochastic, True, 2)
        work, wflat = clone_table(torch, leaves, flat, with_buffers=True)
        first = None
        for _ in range(100):
            for f, v in flat.items():
                wflat[f].copy_(v)
            O.optim8_update(name, work, scalars, rws, apply_delta=True)
            snap = {f: v.clone() for f, v in wflat.items()}
            if first is None:
                first = snap
            else:
                need(all(bits_equal(torch, snap[f], first[f]) for f in flat),
                     f"{name} over {len(sizes)} leaves: 100 launches differ in their bits")
        print(f"  {name} over {len(sizes)} leaves: 100 launches repeat their bits", flush=True)

    # times: J (adam) and K (lion) at the leaf sizes and over the whole table
    tables = {}
    for name in ("adam", "lion"):
        two = name == "adam"
        kname = "optim8_2state" if two else "optim8_1state"
        for sizes in [(n,) for n in OPTIM8_TIMED] + [QLORA_LEAVES]:
            leaves, scalars, rws, flat = optim8_table(torch, gen, name, sizes, 3, False,
                                                      len(sizes) > 1, 1)
            nbytes = optim8_bytes(two, sizes)
            # the table's host work (checks, the leaf table) takes ~1 ms: a
            # longer spin keeps it out of the device time
            ms = time_cold(torch, lambda: O.optim8_update(name, leaves, scalars, rws,
                                                          apply_delta=True),
                           spin_cycles=20_000_000)
            plain_ms = time_cold(torch, lambda: plain(name, leaves, scalars, rws), iters=3,
                                 warmup=1)
            r = dict(n=sum(sizes), leaves=len(sizes), bytes=nbytes,
                     bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, ms=ms, plain_ms=plain_ms)
            print(f"  {kname:13s} {name:5s} {len(sizes):3d} leaves, n={sum(sizes):9d}: kernel"
                  f" {ms * 1e3:8.1f} us plain {plain_ms * 1e3:9.1f} us bound"
                  f" {r['bound_ms'] * 1e3:7.2f} us ({r['bound_ms'] / ms:.0%})", flush=True)
            if len(sizes) > 1:
                tables[kname] = r
            else:
                rows[kname].append(r)
            del leaves, flat
    for kname, rs in rows.items():
        report[kname] = dict(shapes=rs, table=tables[kname], ms=sum(r["ms"] for r in rs),
                             plain_ms=sum(r["plain_ms"] for r in rs),
                             bound_ms=sum(r["bound_ms"] for r in rs), bound_by="bytes",
                             library_ms=None, max_abs_err=0.0, faults=n_faults)
    return cases


# the blocksizes of the two-pass checks, each with a mixed table: a leaf of one
# block, leaves of several, ragged tails (the third ragged leaf's absmax finite);
# tables of few blocks, so K takes its two-pass body there too
TWO_PASS_LEAVES = {4096: (3 * 4096 + 100, 4096, 4097, 5000, 1),
                   262144: (2 * 262144 + 777, 262144, 262144 + 9, 1000, 3 * 262144),
                   704512: (704512, 2 * 704512 + 5, 7, 100003),
                   16777216: (16777216, 16777216 + 4097, 5, 33)}
# K's resident checks: mixed tables of enough blocks for its resident route
# (two a cluster the card holds: 264 of 4096, 32 of 262144, 16 of 704512)
RESIDENT_LEAVES = {4096: (300 * 4096 + 100, 4096, 4097, 5000, 1),
                   262144: (30 * 262144 + 777, 262144, 262144 + 9, 1000),
                   704512: (14 * 704512 + 5, 704512, 7, 100003)}


def qlora_whole_leaves():
    """[(blocksize, sizes)]: the QLoRA table as a block_wise=False step
    launches it, one table of whole-leaf blocks per leaf size (352 of
    262,144 and 96 of 704,512: K's resident route, each cluster walking
    ~22 and ~12 blocks)."""
    return [(n, (n,) * QLORA_LEAVES.count(n)) for n in sorted(set(QLORA_LEAVES))]


def lut_tables():
    """[(label, (256,) f32 table)] of the LUT checks: a quantile map of a
    seeded normal sample, linear maps signed and unsigned, fp8 (e5m2), the
    normal map (241 duplicate zeros), a 7-bit map padded with zeros and a
    permuted (unsorted) linear map."""
    import numpy as np
    from bitsandbytes_sycl_tpu_torch import codebooks as C

    rng = np.random.default_rng(23)
    sub7 = np.sort(np.tanh(np.linspace(-2.0, 2.0, 129))).astype(np.float32)
    return [("quantile", C.create_quantile_map(rng.normal(size=100000).astype(np.float32))),
            ("linear signed", C.create_linear_map(True)),
            ("linear unsigned", C.create_linear_map(False)),
            ("fp8", C.create_fp8_map(True)),
            ("normal", C.create_normal_map()),
            ("7-bit padded", C._pad_sorted_to_256(list(sub7))),
            ("permuted", rng.permutation(C.create_linear_map(True)).astype(np.float32))]


class patched:
    """Set ``obj.attr`` to ``value`` inside a with block (a deliberate fault)."""

    def __init__(self, obj, attr, value):
        self.obj, self.attr, self.value = obj, attr, value

    def __enter__(self):
        self.old = getattr(self.obj, self.attr)
        setattr(self.obj, self.attr, self.value)

    def __exit__(self, *exc):
        setattr(self.obj, self.attr, self.old)


def capacity_edges():
    """{blocksize: (sizes, modes)}: kernel K's resident capacity under each
    codec (the largest resident multiple of 128) and the next multiple of
    128 (two-pass), each with a mixed ragged table: the dynamic maps'
    edges under the dynamic and stochastic modes, the LUT codec's under
    the LUT mode."""
    from bitsandbytes_sycl_tpu_torch.ops import optim8 as O

    out = {}
    for lut, modes in ((False, ("dynamic", "stochastic")), (True, ("lut",))):
        e = O.resident_max(lut)
        out[e] = ((15 * e + 5, e, 7, 100003), modes)  # 19 blocks: resident
        out[e + 128] = ((e + 128, 2 * (e + 128) - 3, 9), modes)
    return out


def check_optim8_branches(torch, report):
    """The branches of kernels J and K added for any codebook and any block
    size, bit for bit against their plain version (ops/optim8._grouped_plain)
    on the card: the LUT codec for every optimizer over the 448-leaf QLoRA
    table (packed), the mixed ragged table (NaN/Inf absmax and non-finite g)
    and one 16.8M leaf, under each of lut_tables() (state1 a table, state2
    the next one); the blocks past 2048 (J's two-pass body; K's resident
    body up to its capacity, its two-pass body past it) at blocksizes 4096,
    262144, 704512 and 16.8M and at each codec's capacity edge, one block
    and several with ragged tails, for every optimizer under the dynamic
    maps, the LUT codec and stochastic rounding. Each launch must have
    taken its plan's route. Six deliberate faults of the plain version
    must each change the result; 100 launches of each new plan repeat
    their bits; each branch is timed at the three leaf sizes and over the
    QLoRA table against the byte bound of J and K, K's blocks past 2048
    beside its two-pass body (in turns where the route is the resident
    one). Then
    ``functional.estimate_quantiles`` at 32M elements against numpy."""
    import numpy as np
    from bitsandbytes_sycl_tpu_torch import functional as F
    from bitsandbytes_sycl_tpu_torch.ops import optim8 as O
    from bitsandbytes_sycl_tpu_torch.ops.common import sm_count

    gen = torch.Generator(device="cuda").manual_seed(31)
    tables = lut_tables()
    q = dict(tables)
    sms = sm_count(torch.device("cuda"))
    cases = {"lut": 0, "two_pass": 0, "resident": 0}

    def counters(kname):
        fn = O._KERNEL_OF[kname]
        return (fn.launches, fn.launches_lut, fn.launches_two_pass,
                getattr(fn, "launches_resident", 0))

    def card_plan(name, leaves, bs, qmaps=None):
        return O.leaf_plan(tuple(lf.p.numel() for lf in leaves), bs, sms, name in O.ONE_STATE,
                           qmaps is not None)

    def compare(label, name, table, bs=2048, qmaps=None, delta=True):
        leaves, scalars, rws, flat = table
        kname = "optim8_2state" if name in O.TWO_STATE else "optim8_1state"
        got, ref = clone_table(torch, leaves, flat), clone_table(torch, leaves, flat)
        route = card_plan(name, leaves, bs, qmaps).route
        before = counters(kname)
        O.optim8_update(name, got, scalars, rws, blocksize=bs, apply_delta=delta, qmaps=qmaps)
        n = 2 if route == "two_pass" else 1
        want = (n, n if qmaps is not None else 0, n if route == "two_pass" else 0,
                n if route == "resident" else 0)
        moved = tuple(a - b for a, b in zip(counters(kname), before))
        need(moved == want, f"{label} {name}: launches (all, lut, two-pass, resident) moved by"
             f" {moved}, expected {want} (route {route})")
        plan = O.leaf_plan(tuple(lf.p.numel() for lf in ref), bs, 1)
        O._grouped_plain(name, ref, scalars, tuple(rws), plan, bs, delta, qmaps)
        torch.cuda.synchronize()
        ok, diff = tables_equal(torch, got, ref)
        need(ok, f"{label} {name}: kernel differs from its plain version ({diff})")
        return route

    # the LUT codec: every name, every table, three tables of leaves
    for name in O.TWO_STATE + O.ONE_STATE:
        two = name in O.TWO_STATE
        for label, sizes, packed, nrows in (("QLoRA table", QLORA_LEAVES, True, 1),
                                            ("mixed table", MIXED_LEAVES, False, 2),
                                            ("16.8M", (16777216,), False, 1)):
            table = optim8_table(torch, gen, name, sizes, 3, False, packed, nrows)
            for i, (tl, t1) in enumerate(tables):
                qm = (t1, tables[(i + 1) % len(tables)][1] if two else None)
                compare(f"LUT {tl}, {label}", name, table, qmaps=qm)
                cases["lut"] += 1
            del table
    # blocks past 2048: every name at each blocksize in tables of few blocks
    # (two-pass), K's resident tables and capacity edges (the 1-state names),
    # both codecs, stochastic rounding; each with the route K must take
    three = ("dynamic", "stochastic", "lut")
    runs = [(bs, sz, three, O.TWO_STATE + O.ONE_STATE, "two_pass")
            for bs, sz in TWO_PASS_LEAVES.items()]
    runs += [(bs, sz, three, O.ONE_STATE, "resident") for bs, sz in RESIDENT_LEAVES.items()]
    runs += [(bs, sz, three, O.ONE_STATE, "resident") for bs, sz in qlora_whole_leaves()]
    runs += [(bs, sz, modes, O.ONE_STATE, "resident" if bs in (O.resident_max(False),
                                                               O.resident_max(True)) else "two_pass")
             for bs, (sz, modes) in capacity_edges().items()]
    for bs, sizes, modes, names, want in runs:
        for name in names:
            two = name in O.TWO_STATE
            for mode in modes:
                table = optim8_table(torch, gen, name, sizes, 3, mode == "stochastic", False, 2,
                                     bs=bs)
                qm = (q["quantile"], q["linear unsigned"] if two else None) if mode == "lut" \
                    else None
                route = compare(f"bs {bs} ({mode}, {len(sizes)} leaves)", name, table, bs=bs,
                                qmaps=qm, delta=mode != "dynamic")
                need(route == want, f"{name} at bs {bs} ({mode}) over {len(sizes)} leaves took the"
                     f" {route} route, expected {want}")
                cases[route] += 1
                del table
    # the JAX entry's rows with tables, and its refusals
    for name in ("adam", "lion"):
        two = name == "adam"
        leaves, scalars, _, _ = optim8_table(torch, gen, name, (262144,), 1, False)
        lf = leaves[0]
        args = [t.reshape(128, 2048) if t is not None and t.numel() == 262144 else t
                for t in (lf.g, lf.p, lf.state1, lf.absmax1, lf.state2, lf.absmax2)]
        maps = dict(qmap1=q["quantile"], qmap2=q["linear unsigned"] if two else None)
        got = O.optim8_blockwise_fused(name, *args, scalars[0], **maps)
        ref = (O._kernel2_plain if two else O._kernel1_plain)(
            name, scalars[0], *[a for a in args if a is not None],
            qmaps=(maps["qmap1"], maps["qmap2"]))
        torch.cuda.synchronize()
        need(all(bits_equal(torch, a, b) for a, b in zip(got, ref)),
             f"optim8_blockwise_fused {name} with tables: kernel differs from the rows plain version")
        try:
            O.optim8_blockwise_fused(name, *args, scalars[0], u=torch.rand_like(args[0]), **maps)
            need(False, "optim8_blockwise_fused took stochastic rounding with a table")
        except ValueError:
            pass
    print(f"  J and K equal their plain version bit for bit: LUT codec in {cases['lut']} tables"
          f" ({len(tables)} maps), two-pass body in {cases['two_pass']}, K's resident body in"
          f" {cases['resident']} (capacity {O.resident_max(False)} dynamic,"
          f" {O.resident_max(True)} LUT; the next multiple of 128 two-pass)", flush=True)

    # deliberate faults in the plain version, each must change the result
    base = dict(adam=(q["quantile"], q["linear unsigned"]), lion=(q["quantile"], None))

    class RightSide(O.LutCodec):
        def rank(self, x):
            mids = torch.from_numpy(self.parts.mids).to(x.device)
            r = torch.searchsorted(mids, x.contiguous(), right=True)
            return torch.where(torch.isnan(x), torch.zeros_like(r), r)

    def last_of_run(table):
        parts = O.lut_parts(table)
        uq, ridx = np.unique(table[::-1], return_index=True)
        return parts._replace(code=(255 - ridx).astype(np.uint8))

    codecs = O._codecs

    def state2_by_state1(two, qmaps=None):
        c1, c2 = codecs(two, qmaps)
        c2.encode = O.LutCodec(qmaps[0]).encode
        return c1, c2

    def per_cta(size):
        """_requant_rows with each CTA's maximum (slices of ``size``
        elements of a block: the plan's per_cta on K's resident route, a
        2048-element chunk on the two-pass route) instead of the block's."""
        def requant(s, codec, u=None):
            nb, bs = s.shape
            k = -(-bs // size)
            a = torch.nn.functional.pad(s.abs(), (0, k * size - bs)).reshape(nb, k, size)
            a = a.amax(dim=2, keepdim=True)
            amax = a.expand(-1, -1, size).reshape(nb, k * size)[:, :bs]
            return codec.encode(s * O.safe_inv(amax), u=u), a[:, 0]
        return requant

    no_zero = F.codebooks.create_linear_map(True, 8, False)  # 0.0 is a midpoint
    n_faults = {}
    for name in ("adam", "lion"):
        two = name == "adam"
        q1, q2 = base[name]
        faults = [  # label, state tables, blocksize, patch or None
            ("side='right' (0.0 on a midpoint)", (no_zero, q2), 2048, (O, "LutCodec", RightSide)),
            ("the sign fix dropped", (q1, q2), 2048,
             (O, "_apply_sign_fix", lambda rank, normed, n_neg, top: rank.to(torch.int32))),
            ("the last index of a duplicate run", (q["normal"], q2), 2048, None),
            ("pad code 0 instead of 127", (q1, q2), 2048, (O, "PAD_CODES", (0, 0))),
            ("a per-CTA maximum instead of the block's", (q1, q2), 4096, "per_cta"),
            ("a per-CTA maximum, dynamic maps", None, 4096, "per_cta"),
        ]
        if two:
            faults.append(("state2 encoded with state1's table", (q1, q2), 2048,
                           (O, "_codecs", state2_by_state1)))
        for label, qm, bs, patch in faults:
            if patch == "per_cta" and not two:  # K: at its resident route's slices
                bs = 262144
            sizes = MIXED_LEAVES if bs == 2048 else \
                RESIDENT_LEAVES[bs] if patch == "per_cta" and not two else TWO_PASS_LEAVES[bs]
            leaves, scalars, rws, _ = optim8_table(torch, gen, name, sizes, 1, False, False, 2,
                                                   bs=bs)
            if label.startswith("pad code"):  # small gradients: the states set the absmax
                for lf in leaves:
                    lf.g.mul_(1e-4)
            got = clone_table(torch, leaves)
            O.optim8_update(name, got, scalars, rws, blocksize=bs, apply_delta=True, qmaps=qm)
            if patch == "per_cta":
                cp = card_plan(name, leaves, bs, qm)
                patch = (O, "_requant_rows",
                         per_cta(cp.per_cta if cp.route == "resident" else O.ONE_PASS_MAX))
            bad = clone_table(torch, leaves)
            plan = O.leaf_plan(tuple(lf.p.numel() for lf in bad), bs, 1)
            pq = qm
            if label.startswith("the last index"):
                pq = (last_of_run(qm[0]), qm[1])
            if patch is None:
                O._grouped_plain(name, bad, scalars, tuple(rws), plan, bs, True, pq)
            else:
                with patched(*patch):
                    O._grouped_plain(name, bad, scalars, tuple(rws), plan, bs, True, pq)
            ref = clone_table(torch, leaves)
            O._grouped_plain(name, ref, scalars, tuple(rws), plan, bs, True, qm)
            torch.cuda.synchronize()
            need(tables_equal(torch, got, ref)[0], f"{name} {label}: the kernel's own case differs"
                 " from its plain version")
            need(not tables_equal(torch, got, bad)[0],
                 f"{name}: a plain version with {label} equals the kernel, so the check cannot"
                 " see that fault")
        n_faults[name] = len(faults)
        print(f"  {name}: {len(faults)} deliberate faults of the LUT and two-pass plain version"
              " each change the result", flush=True)

    # repeat: 100 launches of each new plan over the same inputs give the same bits
    for name, sizes, bs, stochastic, qm in (
            ("adam", QLORA_LEAVES, 2048, False, base["adam"]),
            ("lion", MIXED_LEAVES, 2048, False, base["lion"]),
            ("adam", TWO_PASS_LEAVES[262144], 262144, False, None),
            ("adam", TWO_PASS_LEAVES[4096], 4096, True, None),
            ("lion", TWO_PASS_LEAVES[704512], 704512, False, base["lion"]),
            ("adam", TWO_PASS_LEAVES[16777216], 16777216, False, base["adam"]),
            # K: its resident body under each mode, its two-pass body past the capacity
            ("momentum", RESIDENT_LEAVES[262144], 262144, False, None),
            ("rmsprop", RESIDENT_LEAVES[4096], 4096, True, None),
            ("lion", RESIDENT_LEAVES[704512], 704512, False, base["lion"]),
            ("lion", TWO_PASS_LEAVES[16777216], 16777216, False, None),
            # K's resident body over the main path's whole-leaf tables
            ("lion",) + qlora_whole_leaves()[0][::-1] + (False, None),
            ("momentum",) + qlora_whole_leaves()[1][::-1] + (True, None)):
        leaves, scalars, rws, flat = optim8_table(torch, gen, name, sizes, 3, stochastic, True, 2,
                                                  bs=bs)
        work, wflat = clone_table(torch, leaves, flat, with_buffers=True)
        first = None
        for _ in range(100):
            for f, v in flat.items():
                wflat[f].copy_(v)
            O.optim8_update(name, work, scalars, rws, blocksize=bs, apply_delta=True, qmaps=qm)
            snap = {f: v.clone() for f, v in wflat.items()}
            if first is None:
                first = snap
            else:
                need(all(bits_equal(torch, snap[f], first[f]) for f in flat),
                     f"{name} bs {bs} ({'LUT' if qm else 'dynamic'}): 100 launches differ")
        print(f"  {name} over {len(sizes)} leaves, bs {bs}, {'LUT' if qm else 'dynamic'}"
              f"{', stochastic' if stochastic else ''} ({card_plan(name, leaves, bs, qm).route}):"
              " 100 launches repeat their bits", flush=True)
        del leaves, flat, work, wflat, first

    # times: each branch at the three leaf sizes and over the QLoRA table;
    # blocks past 2048 one block a leaf (block_wise=False), one update per
    # leaf size, K's also on its two-pass body (in turns with its route)
    dev = torch.device("cuda")
    for name in ("adam", "lion"):
        two = name == "adam"
        kname = "optim8_2state" if two else "optim8_1state"
        for branch in ("lut", "two_pass" if two else "blocks"):
            rows, table_row = [], None
            for sizes in [(n,) for n in OPTIM8_TIMED] + [QLORA_LEAVES]:
                qm = base[name] if branch == "lut" else None
                groups = [(sizes, 2048)] if branch == "lut" else \
                    [((n,) * sizes.count(n), n) for n in sorted(set(sizes))]
                tabs = [(optim8_table(torch, gen, name, sz, 3, False, len(sz) > 1, 1, bs=bs), bs)
                        for sz, bs in groups]

                def run(tabs=tabs, qm=qm):
                    for (lv, sc, rw, _), bs in tabs:
                        O.optim8_update(name, lv, sc, rw, blocksize=bs, apply_delta=True,
                                        qmaps=qm)

                def run_plain(tabs=tabs, qm=qm):
                    for (lv, sc, rw, _), bs in tabs:
                        plan = O.leaf_plan(tuple(lf.p.numel() for lf in lv), bs, 1)
                        O._grouped_plain(name, lv, sc, tuple(rw), plan, bs, True, qm)

                nbytes = sum(optim8_bytes(two, sz, bs) for sz, bs in groups)
                ms = time_cold(torch, run, spin_cycles=20_000_000)
                plain_ms = time_cold(torch, run_plain, iters=3, warmup=1)
                r = dict(n=sum(sizes), leaves=len(sizes), bytes=nbytes,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, ms=ms, plain_ms=plain_ms,
                         routes=[card_plan(name, lv, bs, qm).route for (lv, *_), bs in tabs])
                extra = ""
                if branch == "blocks":  # K's two-pass body, in turns where the route differs
                    forced = []
                    for (lv, sc, rw, _), bs in tabs:
                        rws2, _, tab, _ = O._check_leaves(name, lv, sc, rw, bs)
                        forced.append((tab, sc, rws2, O.leaf_plan(tuple(lf.p.numel() for lf in lv),
                                                                  bs, sms), bs))

                    def run_two_pass(forced=forced):
                        for tab, sc, rws2, plan, bs in forced:
                            O._launch(kname, name, tab, sc, rws2, plan, bs, True, False, dev)

                    if set(r["routes"]) == {"two_pass"}:
                        r["two_pass_ms"] = ms
                        extra = "two-pass"
                    else:
                        ms, r["two_pass_ms"] = turns(torch, run, run_two_pass, r)
                        r["ms"] = ms
                        tr = r["turns"]
                        extra = (f"{'/'.join(r['routes'])}; two-pass body {r['two_pass_ms'] * 1e3:.1f}"
                                 f" us in {tr['pairs']} pairs in turns: route - two-pass median"
                                 f" {tr['diff_median_ms'] * 1e3:+.1f} us, range"
                                 f" {tr['diff_min_ms'] * 1e3:+.1f}..{tr['diff_max_ms'] * 1e3:+.1f}")
                    if sizes == (16777216,):  # weight decay 0 (Lion's default)
                        sc0 = forced[0][1].clone()
                        sc0[:, 4] = 0.0
                        f0 = [(forced[0][0], sc0) + forced[0][2:]]
                        r["wd0_ms"] = time_cold(torch, lambda: run_two_pass(f0),
                                                spin_cycles=20_000_000)
                        extra += f"; weight decay 0: {r['wd0_ms'] * 1e3:.1f} us"
                    extra = f" [{extra}]"
                print(f"  {kname:13s} {name:5s} {branch:8s} {len(sizes):3d} leaves, n={sum(sizes):9d}:"
                      f" kernel {ms * 1e3:8.1f} us plain {plain_ms * 1e3:9.1f} us bound"
                      f" {r['bound_ms'] * 1e3:7.2f} us ({r['bound_ms'] / ms:.0%}){extra}", flush=True)
                if len(sizes) > 1:
                    table_row = r
                else:
                    rows.append(r)
                del tabs
            if branch != "blocks":
                by_route = {f"{kname} ({branch.replace('_', '-')})": rows}
            else:  # each route's rows (the QLoRA table's among them where both leaf sizes share it)
                by_route = {f"{kname} ({route.replace('_', '-')})":
                            [r for r in rows + [table_row] if set(r["routes"]) == {route}]
                            for route in ("resident", "two_pass")}
            for key, rs in by_route.items():
                report[key] = dict(
                    shapes=rs, table=table_row, ms=sum(r["ms"] for r in rs),
                    plain_ms=sum(r["plain_ms"] for r in rs), bound_ms=sum(r["bound_ms"] for r in rs),
                    bound_by="bytes", library_ms=None, max_abs_err=0.0, faults=n_faults[name])

    # estimate_quantiles past torch.quantile's 2^24 elements
    x = torch.randn(32 * 1024 * 1024, generator=gen, device="cuda")
    t0 = time.perf_counter()
    got = F.estimate_quantiles(x).cpu().numpy()
    est_s = time.perf_counter() - t0
    ref = np.quantile(x.cpu().numpy().astype(np.float64), np.linspace(1 / 512, 1 - 1 / 512, 256))
    err = float(np.abs(got - ref).max())
    tol = 2 * float(np.spacing(np.float32(np.abs(ref).max())))
    need(err <= tol, f"estimate_quantiles at 32M elements: {err} from numpy's > {tol}")
    print(f"  estimate_quantiles at 32M elements on the card: {est_s * 1e3:.1f} ms, max"
          f" {err:.3g} from numpy's float64 quantiles (tol 2 f32 ulps = {tol:.3g})", flush=True)
    report["estimate_quantiles"] = dict(n=x.numel(), seconds=est_s, max_err=err, tol=tol)
    return cases


def split_profile(torch, prof, marker="spin_kernel"):
    """The device events (kernels and copies) of a profiled step, split at
    a marker kernel queued after a synchronize: (events before, events
    after), each [(name, us)], or None where the trace holds no marker.
    One trace over the whole step: a second profiler started right after
    another stopped missed the first launches of its window on the H100."""
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    marks = [e for e in dev if marker in e.name]
    if len(marks) != 1:
        return None
    t = marks[0].time_range.start
    before = [(e.name, e.time_range.elapsed_us()) for e in dev if e.time_range.start < t]
    after = [(e.name, e.time_range.elapsed_us()) for e in dev
             if e.time_range.start > t and e is not marks[0]]
    return before, after


def summarize(events, top=8):
    """[(name, ms, count)] of events [(name, us)], by total time."""
    agg = {}
    for name, us in events:
        ms, n = agg.get(name, (0.0, 0))
        agg[name] = (ms + us / 1e3, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in agg.items()), key=lambda r: -r[1])[:top]


def qlora_step(torch, kernels, loss_fn, lora, tokens, opt, profile=False):
    """One fine-tuning step: forward, backward and optimizer, each timed to
    a synchronize; returns (loss, {forward_ms, backward_ms, optimizer_ms},
    the kernel launches of the step, and with ``profile`` the step's
    device events split into forward and backward and optimizer by a
    marker kernel, or None)."""
    from torch.profiler import ProfilerActivity, profile as profiler

    prof = profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profile else None
    reset_counts(kernels)
    torch.cuda.synchronize()
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    loss = loss_fn(lora, tokens)
    lv = loss.item()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if prof is not None:
        torch.cuda._sleep(10)  # the marker: every later device event is the optimizer's
    t2b = time.perf_counter()
    opt.step()
    opt.zero_grad()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    parts = None
    if prof is not None:
        prof.__exit__(None, None, None)
        parts = split_profile(torch, prof)
    return lv, dict(forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
                    optimizer_ms=(t3 - t2b) * 1e3), read_counts(kernels), parts


# per Adam step of phase 7b: G forward, E in every backward but layer 0's q/k/v
QLORA_LAUNCHES = {"w4a8_grouped": 225, "w4a8_grouped.wgmma": 225, "dequantize_transposed": 222,
                  "dequantize_transposed.tma": 222}
# phase 3d's base (compressed statistics): E's compressed branch forward
# (2052 rows: each weight decoded once) and in the backward, and no G
QLORA_LEAN_LAUNCHES = {"w4a8_grouped": 0, "dequantize_transposed": 447,
                       "dequantize_transposed.compressed": 447, "dequantize_transposed.tma": 447}


def qlora_7b(torch, cfg, params, kernels, plan=(("adamw8bit", 4), ("lion8bit", 2)),
             expect=QLORA_LAUNCHES, tag="[7b]"):
    """Phase 7b: QLoRA fine-tuning of Llama-7B (32 layers, NF4 base): rank
    64, alpha 16 on all seven projections, 4 adamw8bit steps (lr 2e-4, no
    weight decay) then 2 lion8bit steps on one seeded (4, 513) batch
    (``plan``). Every step's 448 8-bit leaves go through one launch of J
    (Adam) or K (Lion), the 224 scalar leaves through one batched 32-bit
    update; each Adam step launches the kernels ``expect`` counts; the last
    step of each optimizer is profiled, its forward and backward apart
    from its optimizer (kernels per optimizer step, J's or K's device
    time)."""
    from bitsandbytes_sycl_tpu_torch import optim
    from bitsandbytes_sycl_tpu_torch.models.lora import ALL_TARGETS, init_lora, lora_leaves, qlora_loss_fn

    lora = init_lora(cfg, seed=1, rank=64, alpha=16.0, targets=ALL_TARGETS)
    leaves = lora_leaves(lora)
    n8 = sum(t.numel() >= 4096 for t in leaves)
    n_train = sum(t.numel() for t in leaves)
    need(n8 == 448 and n_train == 159_907_840 + 224,
         f"7B QLoRA: {n8} 8-bit leaves, {n_train} trainable parameters")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(1, cfg.vocab_size, (4, 513), generator=gen, device="cuda")
    loss_fn = qlora_loss_fn(params, cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    totals = {}
    make = {"adamw8bit": lambda: optim.adamw8bit(leaves, 2e-4, weight_decay=0.0),
            "lion8bit": lambda: optim.lion8bit(leaves, 2e-5)}
    for phase, n in plan:
        opt = make[phase]()
        kname = "optim8_2state" if phase == "adamw8bit" else "optim8_1state"
        for i in range(n):
            profiled = i == n - 1
            routes = dict(opt.route_leaves)
            lv, ms, counts, parts = qlora_step(torch, kernels, loss_fn, lora, tokens, opt,
                                               profile=profiled)
            routes = {k: v - routes[k] for k, v in opt.route_leaves.items()}
            row = dict(optimizer=phase, step=i + 1, loss=lv, **ms, leaves_by_route=routes,
                       wall_ms=sum(ms.values()), launches={k: v for k, v in counts.items() if v})
            if profiled:
                need(parts is not None, f"7B QLoRA {phase}: the profile holds no marker kernel")
                fb, ev = parts
                busy = sum(us for _, us in fb + ev) / 1e3
                e_us = [us for name, us in fb if "dequant4_" in name]  # kernel E, the backward's
                row.update(profiled=True, device_busy_ms=busy if busy > 0 else None,
                           e_device_ms=sum(e_us) / 1e3, e_events=len(e_us),
                           optimizer_device_ms=sum(us for _, us in ev) / 1e3,
                           optimizer_kernels=len(ev),
                           optim8_device_ms=sum(us for name, us in ev if "optim8" in name) / 1e3,
                           optimizer_top=summarize(ev, top=16), top=summarize(fb + ev))
                need(any("optim8" in name for name, _ in ev),
                     f"7B QLoRA {phase}: the profiled optimizer step shows no {kname} kernel")
            steps.append(row)
            for k, v in counts.items():
                totals.setdefault(phase, {})[k] = totals.get(phase, {}).get(k, 0) + v
            need(lv == lv and abs(lv) != float("inf"), f"7B QLoRA {phase} step {i + 1}: loss {lv}")
            need(counts.get(kname) == 1 and routes == {"grouped": 448, "batched": 224, "per_leaf": 0},
                 f"7B QLoRA {phase} step {i + 1}: {counts.get(kname)} launches of {kname}, leaves"
                 f" by route {routes}; expected one launch for the 448 8-bit leaves (grouped)"
                 " and the 224 scalars batched")
            if phase == "adamw8bit" and i == 0:
                bmax = torch.stack([lora[li][t]["B"].detach().abs().amax()
                                    for li in range(cfg.num_layers) for t in ALL_TARGETS])
                need(bool((bmax > 0).all()), "7B QLoRA: an adapter B is still zero after step 1")
            print(f"{tag} {phase} step {i + 1}: loss {lv:.5f}; forward {ms['forward_ms']:.1f} ms,"
                  f" backward {ms['backward_ms']:.1f} ms, optimizer {ms['optimizer_ms']:.1f} ms"
                  + (f" (profiled: {row['optimizer_kernels']} device events in the optimizer,"
                     f" {kname} {row['optim8_device_ms']:.3f} ms of"
                     f" {row['optimizer_device_ms']:.3f} ms)" if profiled else "")
                  + f"; launches {row['launches']}", flush=True)
    adam = [r for r in steps if r["optimizer"] == "adamw8bit"]
    lion = [r for r in steps if r["optimizer"] == "lion8bit"]
    for r in adam:
        lc = r["launches"]
        need(all(lc.get(k, 0) == v for k, v in expect.items()),
             f"7B QLoRA adam step {r['step']}: launches {lc}, expected {expect}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof_row = adam[-1]
    # the steps between the first (warm-up) and the profiled last, or the first
    unprof = sorted(r["wall_ms"] for r in adam[1:-1]) or [adam[0]["wall_ms"]]
    median = unprof[len(unprof) // 2]
    busy = prof_row["device_busy_ms"]
    # the whole update moves 2.56 GB: 4 B g + 4 B p read, 4 B p written and
    # 1 B of each state read and written per 8-bit parameter
    opt_bound_ms = n_train * 16 / HBM_BYTES_PER_S * 1e3
    opt_ms = {ph: [r["optimizer_ms"] for r in rs] for ph, rs in (("adamw8bit", adam),
                                                                   ("lion8bit", lion))}
    out = dict(steps=steps, launches=totals, peak_gb=peak, trainable=n_train,
               step_ms_median=median, device_busy_ms=busy,
               device_idle_share=None if not busy else max(0.0, 1 - busy / median),
               optimizer_bound_ms=opt_bound_ms, optim8_device_ms=prof_row["optim8_device_ms"],
               optimizer_ms=opt_ms, optimizer_kernels=prof_row["optimizer_kernels"],
               e_device_ms=prof_row["e_device_ms"], e_events=prof_row["e_events"],
               lion_optim8_device_ms=lion[-1]["optim8_device_ms"] if lion else None,
               lion_optimizer_kernels=lion[-1]["optimizer_kernels"] if lion else None,
               losses=[r["loss"] for r in steps])
    print(f"{tag} 7B QLoRA: {n_train} trainable parameters; adam step median {median:.1f} ms"
          f" (of {len(unprof)} unprofiled steps), device busy {busy if busy else 'not measured'} ms"
          " of the profiled step"
          + (f" (idle {out['device_idle_share']:.0%} of the median)" if busy else "")
          + f"; optimizer wall per step adam {[round(v, 1) for v in opt_ms['adamw8bit']]} ms"
          + (f", lion {[round(v, 1) for v in opt_ms['lion8bit']]} ms" if lion else "")
          + f"; kernel E {prof_row['e_device_ms']:.3f} ms over {prof_row['e_events']} launches"
          + f"; kernel J {prof_row['optim8_device_ms']:.3f}"
          f" ms of device time in the profiled optimizer step ({prof_row['optimizer_kernels']} device"
          f" events) against the update's {opt_bound_ms:.3f} ms bound"
          + (f", kernel K {lion[-1]['optim8_device_ms']:.3f} ms ({lion[-1]['optimizer_kernels']}"
             " events)" if lion else "")
          + f"; peak {peak:.1f} GB; losses {' '.join(f'{v:.5f}' for v in out['losses'])}",
          flush=True)
    for key, ms_, cnt in prof_row.get("top", []):
        print(f"      {ms_:9.3f} ms  {cnt:6d}x  {key[:90]}")
    print(f"{tag} the profiled Adam optimizer step's device events:")
    for key, ms_, cnt in prof_row["optimizer_top"]:
        print(f"      {ms_:9.3f} ms  {cnt:6d}x  {key[:90]}")
    return out


def state_maps(seed=5, n=100_000):
    """The LUT runs' state maps: ``create_quantile_map`` of a seeded sample
    of normal values (state1) and of their squares (state2)."""
    import numpy as np
    from bitsandbytes_sycl_tpu_torch import codebooks as C

    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    return C.create_quantile_map(x), C.create_quantile_map(x * x)


class LutOptimizer:
    """QLoRA's optimizer with table-coded states: every 8-bit leaf steps
    through ``functional.optimizer_update_8bit_blockwise(qmap1=, qmap2=)``
    (one launch of J, or of K for lion, with the LUT codec a leaf), its p
    moved by new_p - p; the small leaves through the package's 32-bit
    optimizer of the same name."""

    def __init__(self, torch, leaves, name, lr, maps):
        from bitsandbytes_sycl_tpu_torch import optim

        self.torch, self.name, self.lr, self.maps = torch, name, lr, maps
        self.big = [t for t in leaves if t.numel() >= 4096]
        small = [t for t in leaves if t.numel() < 4096]
        self.rest = optim.adamw8bit(small, lr, weight_decay=0.0) if name == "adam" else \
            optim.lion8bit(small, lr)
        self.state, self.count = {}, 0

    def step(self):
        from bitsandbytes_sycl_tpu_torch import functional as F

        self.count += 1
        two = self.name == "adam"
        with self.torch.no_grad():
            for p in self.big:
                s = self.state.get(p)
                if s is None:
                    z8 = lambda: p.new_zeros(p.shape, dtype=self.torch.uint8)  # noqa: E731
                    nb = F.blocks_for(p.numel(), 2048)
                    s = self.state[p] = dict(s1=z8(), a1=p.new_zeros(nb), s2=z8() if two else None,
                                             a2=p.new_zeros(nb) if two else None)
                out = F.optimizer_update_8bit_blockwise(
                    self.name, p.grad, p.detach(), s["s1"], s["a1"], s["s2"], s["a2"],
                    self.maps[0], self.maps[1] if two else None, beta1=0.9,
                    beta2=0.999 if two else 0.99, eps=1e-8, step=self.count, lr=self.lr)
                s["s1"], s["a1"], s["s2"], s["a2"] = out[1:]
                p.add_(out[0] - p)
        self.rest.step()

    def zero_grad(self):
        for p in self.big:
            p.grad = None
        self.rest.zero_grad()


def qlora_branches(torch, cfg, params, kernels, maps):
    """Phase 7d: the 7B QLoRA setting of phase 7b on the same base with the
    new branches of J and K: 2 adamw8bit(block_wise=False) steps (a block a
    leaf: J's two-pass body, one launch pair per leaf size, 4 launches a
    step) and one lion8bit(block_wise=False) step (K's resident body, one
    launch per leaf size, 2 a step), then 2 Adam steps and one Lion step
    with every 8-bit leaf's states through
    ``optimizer_update_8bit_blockwise(qmap1=, qmap2=)`` (``maps``; 448 LUT
    launches a step). Each step's branch counters must rise by that count
    and its loss be finite. Then one lion8bit(block_wise=False) step of a
    4096 x 4096 full weight (a 7B projection fine-tuned whole: one block
    past K's resident capacity, its two-pass body's launch pair)."""
    from bitsandbytes_sycl_tpu_torch import optim
    from bitsandbytes_sycl_tpu_torch.models.lora import ALL_TARGETS, init_lora, lora_leaves, qlora_loss_fn

    lora = init_lora(cfg, seed=1, rank=64, alpha=16.0, targets=ALL_TARGETS)
    leaves = lora_leaves(lora)
    sizes = sorted({t.numel() for t in leaves if t.numel() >= 4096})
    n8 = sum(t.numel() >= 4096 for t in leaves)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(1, cfg.vocab_size, (4, 513), generator=gen, device="cuda")
    loss_fn = qlora_loss_fn(params, cfg)
    runs = (("block_wise=False", "adam", 2, "two_pass", 2 * len(sizes),
             lambda: optim.adamw8bit(leaves, 2e-4, weight_decay=0.0, block_wise=False)),
            ("block_wise=False", "lion", 1, "resident", len(sizes),
             lambda: optim.lion8bit(leaves, 2e-5, block_wise=False)),
            ("LUT codec", "adam", 2, "lut", n8,
             lambda: LutOptimizer(torch, leaves, "adam", 2e-4, maps)),
            ("LUT codec", "lion", 1, "lut", n8,
             lambda: LutOptimizer(torch, leaves, "lion", 2e-5, maps)))
    out, totals = [], {}
    for setting, name, n, branch, per_step, make in runs:
        opt = make()
        kname = "optim8_2state" if name == "adam" else "optim8_1state"
        for i in range(n):
            lv, ms, counts, _ = qlora_step(torch, kernels, loss_fn, lora, tokens, opt)
            got = counts.get(f"{kname}.{branch}", 0)
            need(lv == lv and abs(lv) != float("inf"), f"7B QLoRA {setting} {name} step {i + 1}:"
                 f" loss {lv}")
            need(got == per_step and counts.get(kname) == per_step,
                 f"7B QLoRA {setting} {name} step {i + 1}: {got} launches of {kname}'s {branch}"
                 f" branch ({counts.get(kname)} in all), expected {per_step}")
            key = f"{kname} ({branch.replace('_', '-')})"
            totals[key] = totals.get(key, 0) + got
            out.append(dict(setting=setting, optimizer=name, step=i + 1, loss=lv, **ms,
                            wall_ms=sum(ms.values()), launches={k: v for k, v in counts.items() if v}))
            print(f"[7d] {setting} {name} step {i + 1}: loss {lv:.5f}; forward"
                  f" {ms['forward_ms']:.1f} ms, backward {ms['backward_ms']:.1f} ms, optimizer"
                  f" {ms['optimizer_ms']:.1f} ms; {got} launches of {kname}'s {branch} branch",
                  flush=True)
        del opt
    # a full 4096 x 4096 weight, block_wise=False: K's two-pass body
    w = torch.nn.Parameter(torch.randn(4096, 4096, generator=gen, device="cuda") * 0.02)
    opt = optim.lion8bit([w], 2e-5, block_wise=False)
    w.grad = torch.randn(4096, 4096, generator=gen, device="cuda") * 1e-3
    reset_counts(kernels)
    t0 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(kernels)
    got = counts.get("optim8_1state.two_pass", 0)
    need(got == 2 and counts.get("optim8_1state") == 2 and bool(torch.isfinite(w).all()),
         f"lion8bit(block_wise=False) of a 4096 x 4096 weight: {got} two-pass launches of K"
         f" ({counts.get('optim8_1state')} in all; expected 2), finite {bool(torch.isfinite(w).all())}")
    totals["optim8_1state (two-pass)"] = totals.get("optim8_1state (two-pass)", 0) + got
    out.append(dict(setting="block_wise=False, 4096 x 4096 weight", optimizer="lion", step=1,
                    optimizer_ms=step_ms, launches={k: v for k, v in counts.items() if v}))
    print(f"[7d] block_wise=False lion step of a 4096 x 4096 weight: {step_ms:.1f} ms; {got}"
          " launches of optim8_1state's two_pass branch", flush=True)
    del opt, w
    return dict(steps=out, launches=totals)


def qlora_card_vs_cpu(torch, cfg, kernels, launched=("w4a8_gemv", "optim8_2state"), tag="[7c]",
                      steps=3, p_cpu=None, make_opt=None, cpu_first=None):
    """Phase 7c: 2 layers at 7B width, B = 1, T = 128 (the W4A8 route,
    kernel A; with compressed statistics B, and E in the backward),
    adapters with a seeded nonzero B, on the card and on the CPU: the loss
    within 1% relative, the adapter gradients within 4% relative L2 (the
    CPU tests' limit for W4A8 against the JAX package), and after
    ``steps`` optimizer steps (``make_opt(leaves)``, adamw8bit by default)
    a cosine >= 0.9 between the two runs' p - p0; every kernel in
    ``launched`` launched on the card. ``p_cpu``: the 2-layer model on the
    CPU, if the caller has it (seed 1). ``cpu_first``: a dict shared by
    calls on the same ``p_cpu``; the CPU's first loss and gradients, which
    come before any optimizer step and so do not depend on it, are
    computed by the first call and reused by the others."""
    from bitsandbytes_sycl_tpu_torch import optim
    from bitsandbytes_sycl_tpu_torch.models.llama import init_params
    from bitsandbytes_sycl_tpu_torch.models.lora import ALL_TARGETS, init_lora, lora_leaves, qlora_loss_fn

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    if p_cpu is None:
        p_cpu = init_params(cfg2, seed=1, device="cpu")
    p_gpu = to_cuda(torch, p_cpu)
    lo_cpu = init_lora(cfg2, seed=2, rank=64, alpha=16.0, targets=ALL_TARGETS, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for layer in lo_cpu:
            for ab in layer.values():
                ab["B"].copy_(torch.randn(ab["B"].shape, generator=gen) * 0.01)
    lo_gpu = [{t: {k: v.detach().cuda().requires_grad_() for k, v in ab.items()}
               for t, ab in layer.items()} for layer in lo_cpu]
    toks = torch.randint(1, cfg.vocab_size, (1, 129), generator=gen)
    runs = {}
    reset_counts(kernels)
    for dev, params, lora in (("cpu", p_cpu, lo_cpu), ("cuda", p_gpu, lo_gpu)):
        leaves = lora_leaves(lora)
        p0 = [t.detach().clone() for t in leaves]
        opt = optim.adamw8bit(leaves, 2e-4, weight_decay=0.0) if make_opt is None else \
            make_opt(leaves)
        loss_fn = qlora_loss_fn(params, cfg2)
        losses, grads = [], None
        for step in range(steps):
            if dev == "cpu" and step == 0 and cpu_first:
                for t, gr in zip(leaves, cpu_first["grads"]):
                    t.grad = gr.clone()
                losses.append(cpu_first["loss"])
            else:
                loss = loss_fn(lora, toks.to(dev))
                loss.backward()
                losses.append(loss.item())
                if dev == "cpu" and step == 0 and cpu_first is not None:
                    cpu_first.update(loss=losses[0], grads=[t.grad.clone() for t in leaves])
            if step == 0:
                grads = torch.cat([t.grad.reshape(-1).float().cpu() for t in leaves])
            opt.step()
            opt.zero_grad()
        delta = torch.cat([(t.detach() - q).reshape(-1).float().cpu() for t, q in zip(leaves, p0)])
        runs[dev] = dict(losses=losses, grads=grads, delta=delta)
    counts = read_counts(kernels)
    c, g = runs["cpu"], runs["cuda"]
    loss_rel = abs(g["losses"][0] - c["losses"][0]) / abs(c["losses"][0])
    grad_rel = float((g["grads"] - c["grads"]).norm() / c["grads"].norm())
    cos = float(torch.nn.functional.cosine_similarity(g["delta"], c["delta"], dim=0))
    need(all(counts[k] > 0 for k in launched), f"7B-width QLoRA on the card: launches {counts}")
    need(loss_rel <= 1e-2, f"QLoRA card vs CPU: loss {g['losses'][0]} vs {c['losses'][0]}")
    need(grad_rel <= 4e-2, f"QLoRA card vs CPU: adapter gradients {grad_rel:.4f} relative L2 > 0.04")
    need(cos >= 0.9, f"QLoRA card vs CPU: cosine of p - p0 after {steps} steps {cos:.4f} < 0.9")
    print(f"{tag} 2-layer 7B-width QLoRA card vs CPU (B=1, T=128, {launched[0]}): loss {g['losses'][0]:.5f}"
          f" vs {c['losses'][0]:.5f} ({loss_rel:.2e} rel, tol 1e-2); adapter gradients"
          f" {grad_rel:.4f} relative L2 (tol 0.04); cosine of p - p0 after {steps} optimizer steps"
          f" {cos:.4f} (tol 0.9); losses card {g['losses']} CPU {c['losses']}", flush=True)
    return dict(loss_rel=loss_rel, grad_rel_l2=grad_rel, delta_cosine=cos,
                losses_card=g["losses"], losses_cpu=c["losses"],
                launches={k: v for k, v in counts.items() if v})


def lean_scale_bytes(params):
    """Bytes of every 4-bit linear's scales as stored (codes and sidecars
    when compressed) and as bf16 scales would take them."""
    from bitsandbytes_sycl_tpu_torch.ops.common import QLinearWeight

    got = bf16 = 0
    for w in [params["lm_head"]] + [v for layer in params["layers"] for v in layer.values()]:
        if isinstance(w, QLinearWeight):
            got += w.absmax.numel() * w.absmax.element_size() + sum(
                t.numel() * 4 for t in (w.absmax_scale, w.absmax_offset) if t is not None)
            bf16 += w.absmax.numel() * 2
    return got, bf16


def serve_lean(torch, prompts, kernels):
    """Phase 3d: the memory-lean NF4 configuration,
    LlamaConfig.llama7b(compress_stats=True, kv_bits=4), NF4 bs 64 from
    seed 0, at full width and depth through the paged engine: phase 3's 8
    prompts, 4 slots, 32 new tokens each (compressed weights take kernel
    B's compressed branch in every decode linear, 225 per step on its
    tensor-core body, and the kv4 split body of D, 32 per step); phase
    3b's 256-, 2048- (E's compressed branch, once per linear) and 4096-row
    (F on the decoded scales) batches; then 3 adamw8bit QLoRA steps of
    phase 7b's setting on this base (E's compressed branch forward and in
    every backward; the first warms up, the last is profiled)."""
    from bitsandbytes_sycl_tpu_torch.models.llama import LlamaConfig, init_params

    t0 = time.perf_counter()
    cfg = LlamaConfig.llama7b(compress_stats=True, kv_bits=4)
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scale_b, scale_bf16 = lean_scale_bytes(params)
    L, H, D, P = cfg.num_layers, cfg.num_kv_heads, cfg.hd, 128
    page_b = 2 * L * H * (P // 2) * D + 2 * L * H * P * 4  # kv4 K and V nibbles, f32 scales
    page_b8 = 2 * L * H * P * D + 2 * L * H * P * 4
    print(f"[3d] llama7b compress_stats=True kv_bits=4: initialised in {init_s:.1f} s; scales"
          f" {scale_b / 1e9:.3f} GB stored ({scale_bf16 / 1e9:.3f} GB as bf16); a 128-token page"
          f" over the 32 layers {page_b / 1e6:.1f} MB ({page_b8 / 1e6:.1f} MB with int8 pages)",
          flush=True)
    reset_counts(kernels)
    outs, wall, steps = serve(torch, cfg, params, prompts, 32)
    counts = read_counts(kernels)
    label = "[3d] lean serve"
    need(all(len(o) == 32 for o in outs), f"{label}: wrong output lengths {[len(o) for o in outs]}")
    need(all(0 <= t < cfg.vocab_size for o in outs for t in o), f"{label}: token id out of range")
    for k in ("mm4_fused.compressed", "paged_attn_int8.kv4", "prefill_attn_int8"):
        need(counts[k] > 0, f"{label}: the serving path never launched {k}")
    need(counts["w4a8_gemv"] == 0, f"{label}: compressed weights took kernel A")
    need(counts["paged_attn_int8.kv4"] == counts["paged_attn_int8"],
         f"{label}: {counts['paged_attn_int8'] - counts['paged_attn_int8.kv4']} paged launches"
         " over int8 pages")
    need_new_bodies(counts, label)
    steps = sorted(steps)
    median = steps[len(steps) // 2] * 1e3
    n_tok = sum(len(o) for o in outs)
    prof = profile_steps(torch, cfg, params, prompts, host_name="host_profile_lean.txt")
    per = prof["launches_per_step"]
    n_lin = 7 * cfg.num_layers + 1
    need(per.get("mm4_fused.compressed") == n_lin and per.get("mm4_fused.tc") == n_lin,
         f"{label}: per decode step {per}; expected {n_lin} compressed launches of B, all"
         " tensor-core")
    need(per.get("paged_attn_int8.kv4") == cfg.num_layers
         and per.get("paged_attn_int8.split") == cfg.num_layers,
         f"{label}: per decode step {per}; expected {cfg.num_layers} kv4 launches of D's split body")
    busy = prof["device_busy_ms"]
    stats = dict(tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall, decode_steps=len(steps),
                 decode_ms_per_step_median=median,
                 decode_ms_per_step_quartiles=[steps[len(steps) // 4] * 1e3,
                                               steps[3 * len(steps) // 4] * 1e3],
                 launches=counts, profile=prof, init_s=init_s, scale_bytes=scale_b,
                 scale_bytes_bf16=scale_bf16, page_bytes=page_b, page_bytes_int8=page_b8,
                 device_idle_share=None if not busy else 1 - busy / median)
    print(f"{label}: {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s; {len(steps)} decode"
          f" steps, median {median:.2f} ms/step (quartiles"
          f" {stats['decode_ms_per_step_quartiles'][0]:.2f}-{stats['decode_ms_per_step_quartiles'][1]:.2f});"
          f" launches {({k: v for k, v in counts.items() if v})}", flush=True)
    print(f"{label}: profiled decode step (B=4): wall {prof['wall_ms']:.2f} ms, "
          + (f"device busy {busy:.2f} ms of the {median:.2f} ms median step (idle "
             f"{stats['device_idle_share']:.0%})" if busy else "device busy not measured")
          + f"; {prof['kernels_per_step']:.0f} kernels per step; ported kernels per step {per};"
          f" attention per step (ms, launches) {prof['attention']}")
    for key, ms, cnt in prof["top"]:
        print(f"      {ms:8.3f} ms/step  {cnt:5d}x  {key[:90]}")
    print(f"{label}: host time per decode step under cProfile (tottime):")
    for key, ms, cnt in prof["host_top"]:
        print(f"      {ms:8.3f} ms/step  {cnt:6d}x  {key[:90]}")
    stats["long"] = serve_long(torch, cfg, params, kernels, lean=True)
    gc.collect()
    torch.cuda.empty_cache()
    stats["qlora"] = qlora_7b(torch, cfg, params, kernels, plan=(("adamw8bit", 3),),
                              expect=QLORA_LEAN_LAUNCHES, tag="[3d]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, stats


def lean_card_vs_cpu(torch, cfg, kernels):
    """Phase 3d, card against CPU: 2 layers of the lean configuration at
    7B width from one seed: prefill logits at T=32 within phase 5's limits
    (4% relative L2, 5% of the largest), then 5 greedy tokens for 2
    prompts through the kv4 paged engine, equal wherever the CPU's top-2
    logit gap exceeds 5% of its largest logit; then phase 7c's QLoRA
    comparison (loss 1%, adapter gradients 4%) over one adamw8bit step."""
    from bitsandbytes_sycl_tpu_torch.models.llama import init_kv_cache, init_params, llama_forward

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p_cpu = init_params(cfg2, seed=1, device="cpu")
    p_gpu = to_cuda(torch, p_cpu)
    toks = torch.tensor([p + [0] * (32 - len(p)) for p in prompts_from_seed(1, 2, cfg.vocab_size)])
    lg_cpu, _ = llama_forward(p_cpu, cfg2, toks, init_kv_cache(cfg2, 2, "cpu"))
    lg_gpu, _ = llama_forward(p_gpu, cfg2, toks.cuda(), init_kv_cache(cfg2, 2, "cuda"))
    err, mag = max_err(torch, lg_gpu.cpu(), lg_cpu)
    rel = float((lg_gpu.cpu() - lg_cpu).norm() / lg_cpu.norm())
    need(torch.isfinite(lg_gpu).all().item(), "[3d] non-finite logits on the card")
    need(rel <= 4e-2, f"[3d] prefill logits card vs CPU: relative L2 error {rel} > 0.04")
    need(err <= 5e-2 * mag, f"[3d] prefill logits card vs CPU: max err {err} > {5e-2 * mag}")
    rec_cpu, rec_gpu = {}, {}
    pr2 = prompts_from_seed(2, 2, cfg.vocab_size)
    reset_counts(kernels)
    out_cpu, _, _ = serve(torch, cfg2, p_cpu, pr2, 5, device="cpu", per_request=rec_cpu)
    out_gpu, _, _ = serve(torch, cfg2, p_gpu, pr2, 5, per_request=rec_gpu)
    counts = read_counts(kernels)
    need(counts["paged_attn_int8.kv4"] > 0 and counts["mm4_fused.compressed"] > 0,
         f"[3d] 2-layer card run: launches {counts}")
    checked = greedy_agree(out_cpu, rec_cpu, out_gpu, "[3d] card vs CPU")
    print(f"[3d] 2-layer 7B-width lean model card vs CPU: prefill logits relative L2 {rel:.3g}"
          f" (tol 0.04), max err {err:.4g} (tol {5e-2 * mag:.4g}); {checked} of 10 greedy tokens"
          f" (kv4 paged engine) compared equal", flush=True)
    del p_gpu
    torch.cuda.empty_cache()
    qlora = qlora_card_vs_cpu(torch, cfg, kernels,
                              launched=("mm4_fused.compressed", "dequantize_transposed.compressed",
                                        "optim8_2state"), tag="[3d]", steps=1, p_cpu=p_cpu)
    return dict(logits_rel_l2=rel, logits_max_err=err, logits_max_abs=mag,
                tokens_compared_equal=checked, qlora=qlora)


# --------------------------------------------------------------- phase 8
# the seven projections of a Llama decoder layer under their Hugging Face names
LLAMA_PROJECTIONS = (("self_attn", "q_proj"), ("self_attn", "k_proj"), ("self_attn", "v_proj"),
                     ("self_attn", "o_proj"), ("mlp", "gate_proj"), ("mlp", "up_proj"),
                     ("mlp", "down_proj"))


def hf_llama_tree(torch, hidden, intermediate, vocab, layers, device="cuda", dtype=None, seed=0):
    """A module tree under Llama's Hugging Face names, of plain modules
    with seeded normal weights (std 1/sqrt(in)): ``model.embed_tokens``,
    per layer ``model.layers.{i}.self_attn.{q,k,v,o}_proj`` and
    ``model.layers.{i}.mlp.{gate,up,down}_proj`` (``torch.nn.Linear``
    without bias), and ``lm_head``; bf16 unless ``dtype`` says otherwise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = dtype or torch.bfloat16
    shapes = {"q_proj": (hidden, hidden), "k_proj": (hidden, hidden), "v_proj": (hidden, hidden),
              "o_proj": (hidden, hidden), "gate_proj": (hidden, intermediate),
              "up_proj": (hidden, intermediate), "down_proj": (intermediate, hidden)}

    def linear(n_in, n_out):
        lin = torch.nn.Linear(n_in, n_out, bias=False, device=device, dtype=dtype)
        with torch.no_grad():
            lin.weight.normal_(0.0, n_in ** -0.5, generator=gen)
        return lin

    root, model = torch.nn.Module(), torch.nn.Module()
    root.model = model
    model.embed_tokens = torch.nn.Embedding(vocab, hidden, device=device, dtype=dtype)
    with torch.no_grad():
        model.embed_tokens.weight.normal_(generator=gen)
    model.layers = torch.nn.ModuleList()
    for _ in range(layers):
        layer = torch.nn.Module()
        for part, name in LLAMA_PROJECTIONS:
            if not hasattr(layer, part):
                setattr(layer, part, torch.nn.Module())
            setattr(getattr(layer, part), name, linear(*shapes[name]))
        model.layers.append(layer)
    root.lm_head = linear(hidden, vocab)
    return root


def modules_of(tree, cls):
    """[(name, module)] of every module of class ``cls`` in ``tree``, in
    order."""
    return [(n, m) for n, m in tree.named_modules() if type(m) is cls]


def per_layer_counts(tree, cls, layers):
    """How many modules of class ``cls`` each decoder layer holds."""
    counts = [0] * layers
    for name, _ in modules_of(tree, cls):
        if name.startswith("model.layers."):
            counts[int(name.split(".")[2])] += 1
    return counts


def to_int8(torch, tree, predicate=None, outliers=32, **kw):
    """Swap every ``torch.nn.Linear`` of ``tree`` (those ``predicate(name)``
    accepts) for a ``Linear8bitLt`` over its weight, computing in the
    weight's dtype, with ``outliers`` static outlier columns
    (``utils.find_outlier_dims``, phase 6's setting) unless 0."""
    from bitsandbytes_sycl_tpu_torch.nn import Linear8bitLt
    from bitsandbytes_sycl_tpu_torch.utils import find_outlier_dims

    names = [n for n, m in tree.named_modules()
             if isinstance(m, torch.nn.Linear) and (predicate is None or predicate(n))]
    for name in names:
        W = tree.get_submodule(name).weight.detach()
        idx = find_outlier_dims(W, reduction_dim=0, topk=min(outliers, W.shape[1])) \
            if outliers else None
        new = Linear8bitLt(W.shape[1], W.shape[0], bias=False, compute_dtype=W.dtype,
                           outlier_idx=idx, device=W.device, weight=W, **kw)
        parent, _, child = name.rpartition(".")
        setattr(tree.get_submodule(parent) if parent else tree, child, new)
        del W, new
    return tree


def forward_each(torch, mods, rows, seed, check, backward=False):
    """Each module of ``mods`` ([(name, module)]) on its own seeded (rows,
    in_features) input in its compute dtype; with ``backward`` the input
    requires grad and y.backward(g) runs with a seeded g. ``check(name,
    module, x, y, g)`` sees each result (x.grad after the backward)."""
    dev = next(iter(mods[0][1].state_dict().values())).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, m in mods:
        x = torch.randn((rows, m.in_features), generator=gen, device=dev).to(m.compute_dtype)
        g = None
        if backward:
            x.requires_grad_()
            y = m(x)
            g = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
            y.backward(g)
        else:
            with torch.no_grad():
                y = m(x)
        check(name, m, x, y.detach(), g)


def library_launches(n_4bit, n_int8, n_train=7):
    """The kernel launches phase 8's library runs must show: B once per
    LinearNF4 at 4 rows (its tensor-core body: bf16 x), E twice per
    LinearNF4 at 2048 rows forward and backward, I once per Linear8bitLt
    at 4 rows and once per trainable one at 128 rows."""
    return {"nf4, 4 rows": {"mm4_fused": n_4bit, "mm4_fused.tc": n_4bit,
                            "dequantize_transposed": 0},
            "nf4, 2048 rows forward and backward": {"mm4_fused": 0,
                                                    "dequantize_transposed": 2 * n_4bit,
                                                    "dequantize_transposed.tma": 2 * n_4bit},
            "int8, 4 rows": {"int8_matmul": n_int8},
            "int8 trainable, 128 rows forward and backward": {"int8_matmul": n_train}}


def need_launches(counts, want, label, on_card=True):
    """The launches ``want`` on the card; none on the CPU (plain versions)."""
    want = want if on_card else {k: 0 for k in want}
    got = {k: counts.get(k, 0) for k in want}
    need(got == want, f"{label}: launches {got}, not {want}")


SHAPES_7B = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def docstring_path(torch, kernels, device="cuda", shapes=SHAPES_7B):
    """Phase 8a: ``bnb.quantize_nf4(w)`` then ``bnb.matmul_4bit(x, packed,
    qs)`` at the four 7B shapes, raw and compressed statistics, M = 1, 4,
    256 (kernel B; E for down_proj, whose half-K is not a multiple of 8
    blocks) and 2048 (kernel E), each call held against
    ``functional.matmul_4bit_ref`` within 1% of the largest output (phase
    2's tolerance of B and of E's route); the repack
    ``to_kernel_layout(quantize_nf4(w))`` equal to ``quantize_4bit_native(w)``
    bit for bit and ``from_kernel_layout`` giving back the bytes; one
    nibble flipped in ``packed`` (the weight of largest magnitude in the
    input column of largest magnitude) must land outside the tolerance."""
    import bitsandbytes_sycl_tpu_torch as bnb
    from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit as m4
    from bitsandbytes_sycl_tpu_torch.ops.common import (from_kernel_layout, quantize_4bit_native,
                                                        to_kernel_layout)

    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(8)
    rows = []
    for N, K in shapes:
        w = (torch.randn((N, K), generator=gen, device=device) / K ** 0.5).to(torch.bfloat16)
        # rows from which the route decodes the weight once (kernel E)
        half_whole = (K // 2) % (8 * 64) != 0
        e_rows = m4.PREFILL_MIN_M_UNALIGNED if half_whole else m4.PREFILL_MIN_M
        for compress in (False, True):
            packed, qs = bnb.quantize_nf4(w, compress_statistics=compress)
            if not compress:
                qw, nat = to_kernel_layout(packed, qs), quantize_4bit_native(w)
                need(torch.equal(qw.packed, nat.packed) and torch.equal(qw.absmax, nat.absmax),
                     f"to_kernel_layout(quantize_nf4(w)) != quantize_4bit_native(w) at {N}x{K}")
                back, qs_back = from_kernel_layout(qw)
                need(torch.equal(back, packed) and torch.equal(qs_back.absmax, qs.absmax),
                     f"from_kernel_layout did not give back the bytes at {N}x{K}")
                del qw, nat, back, qs_back
            for M in (1, 4, 256, 2048):
                x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
                reset_counts(kernels)
                y = bnb.matmul_4bit(x, packed, qs)
                sync(torch, device)
                counts = read_counts(kernels)
                kname = "dequantize_transposed" if M >= e_rows else "mm4_fused"
                need(counts[kname] == int(on_card)
                     and sum(v for k, v in counts.items() if "." not in k) == int(on_card),
                     f"matmul_4bit {N}x{K} M={M}: launches {counts}, not one of {kname}")
                ref = bnb.functional.matmul_4bit_ref(x, packed, qs)
                err, scale = max_err(torch, y, ref)
                tol = 1e-2 * scale
                need(bool(torch.isfinite(y).all()) and err <= tol,
                     f"matmul_4bit {N}x{K} M={M} compressed={compress}: error {err} > {tol}")
                row = dict(N=N, K=K, M=M, compressed=compress, kernel=kname, err=err, tol=tol)
                if M == 4 and not compress:
                    k = int(x.float().abs().amax(0).argmax())
                    n = int(w[:, k].float().abs().argmax())
                    e = n * K + k
                    bad = packed.clone()
                    bad[e // 2] ^= 0xF0 if e % 2 == 0 else 0x0F
                    row["fault"] = max_err(torch, bnb.matmul_4bit(x, bad, qs), ref)[0]
                    need(row["fault"] > tol, f"matmul_4bit {N}x{K}: a flipped nibble lands within"
                                             f" the tolerance ({row['fault']} <= {tol})")
                    del bad
                rows.append(row)
                del x, y, ref
            del packed, qs
        del w
    worst = max(r["err"] / r["tol"] for r in rows)
    faults = min(r["fault"] / r["tol"] for r in rows if "fault" in r)
    print(f"[8a] bnb.quantize_nf4 + bnb.matmul_4bit at the 7B shapes, raw and compressed, M = 1, 4,"
          f" 256, 2048: {len(rows)} calls within {worst:.3g} of 1% of the largest output; the"
          f" repack equals quantize_4bit_native bit for bit; a flipped nibble lands at >= {faults:.3g}"
          f" x the tolerance", flush=True)
    return rows


def nf4_nn_7b(torch, kernels, cfg, device="cuda"):
    """Phase 8b: Llama-7B's 225 linears as plain bf16 ``torch.nn.Linear``s
    under their Hugging Face names, ``utils.replace_linear`` (NF4, bs 64)
    into ``LinearNF4``s, then every module forward at 4 rows (kernel B)
    and forward and backward at 2048 rows (kernel E both ways); layer 0's
    modules and the lm_head held against ``matmul_4bit_ref`` and the plain
    gradient within 1% of the largest output, every output finite."""
    import bitsandbytes_sycl_tpu_torch as bnb

    t0 = time.perf_counter()
    tree = hf_llama_tree(torch, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                         cfg.num_layers, device=device)
    gb = sum(p.numel() * p.element_size() for p in tree.parameters()) / 1e9
    bnb.utils.replace_linear(tree, "nf4", 64)
    sync(torch, device)
    build_s = time.perf_counter() - t0
    mods = modules_of(tree, bnb.nn.LinearNF4)
    layers = per_layer_counts(tree, bnb.nn.LinearNF4, cfg.num_layers)
    need(len(mods) == 7 * cfg.num_layers + 1 and layers == [7] * cfg.num_layers,
         f"replace_linear gave {len(mods)} LinearNF4 ({layers} a layer)")
    want = library_launches(len(mods), 0)
    checked = []

    def check(name, m, x, y, g):
        need(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
        if not (name.startswith("model.layers.0.") or name == "lm_head"):
            return
        ref = bnb.functional.matmul_4bit_ref(x.detach(), m.packed, m.quant_state)
        err, scale = max_err(torch, y, ref)
        need(err <= 1e-2 * scale, f"{name} at {x.shape[0]} rows: error {err} > {1e-2 * scale}")
        row = dict(name=name, rows=x.shape[0], err=err, tol=1e-2 * scale)
        if g is not None:
            W = bnb.dequantize_4bit(m.packed, m.quant_state).float()
            gref = (g.float() @ W).to(x.dtype)
            gerr, gscale = max_err(torch, x.grad, gref)
            need(gerr <= 1e-2 * gscale, f"{name}: gradient error {gerr} > {1e-2 * gscale}")
            row.update(grad_err=gerr, grad_tol=1e-2 * gscale)
        checked.append(row)

    out = dict(weights_gb=gb, modules=len(mods), build_s=build_s)
    for label, rows, backward in (("nf4, 4 rows", 4, False),
                                  ("nf4, 2048 rows forward and backward", 2048, True)):
        reset_counts(kernels)
        t0 = time.perf_counter()
        forward_each(torch, mods, rows, 80 + rows, check, backward=backward)
        sync(torch, device)
        counts = read_counts(kernels)
        need_launches(counts, want[label], f"[8b] {label}", device == "cuda")
        out[label] = dict(launches={k: counts[k] for k in want[label]},
                          seconds=time.perf_counter() - t0)
    out["checked"] = checked
    print(f"[8b] {cfg.num_layers} layers of {gb:.1f} GB bf16 nn.Linear -> {len(mods)} LinearNF4 by"
          f" replace_linear in {build_s:.1f} s; launches at 4 rows"
          f" {out['nf4, 4 rows']['launches']}, at 2048 rows forward and backward"
          f" {out['nf4, 2048 rows forward and backward']['launches']}; {len(checked)} results"
          f" held against matmul_4bit_ref and the plain gradient", flush=True)
    del tree, mods
    return out


def int8_nn_7b(torch, kernels, cfg, device="cuda"):
    """Phase 8c: Linear8bitLt at 7B. The 225 linears of ``hf_llama_tree``
    as inference modules (threshold 6.0, 32 static outlier columns each,
    phase 6's setting) forward at 4 rows (kernel I), then one layer's seven
    as trainable ones (``has_fp16_weights=True``, threshold 0, so kernel I
    runs) forward and backward at 128 rows. Outputs held against the plain
    route (``llm_int8_matmul(..., use_fused=False)``: quantize, int8
    product, dequant) within one bf16 ulp of the largest output, with the
    next row's SCB as the fault; gradients against the plain f32 ones
    within 1%."""
    from bitsandbytes_sycl_tpu_torch import functional as F
    from bitsandbytes_sycl_tpu_torch.nn import Linear8bitLt

    out = {}
    worst = [0.0, float("inf")]

    def hold(name, x, y, CB, SCB, threshold, outliers):
        ref = F.llm_int8_matmul(x, CB, SCB, threshold, use_fused=False, outliers=outliers)
        bad = F.llm_int8_matmul(x, CB, SCB.roll(-1), threshold, use_fused=False, outliers=outliers)
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        err, fault = max_err(torch, y, ref)[0], max_err(torch, bad, ref)[0]
        need(bool(torch.isfinite(y).all()) and err <= tol, f"{name}: error {err} > {tol}")
        need(fault > tol, f"{name}: the next row's SCB lands within the tolerance")
        worst[0], worst[1] = max(worst[0], err / tol), min(worst[1], fault / tol)

    t0 = time.perf_counter()
    tree = to_int8(torch, hf_llama_tree(torch, cfg.hidden_size, cfg.intermediate_size,
                                        cfg.vocab_size, cfg.num_layers, device=device, seed=1),
                   threshold=6.0)
    sync(torch, device)
    build_s = time.perf_counter() - t0
    mods = modules_of(tree, Linear8bitLt)
    layers = per_layer_counts(tree, Linear8bitLt, cfg.num_layers)
    need(len(mods) == 7 * cfg.num_layers + 1 and layers == [7] * cfg.num_layers,
         f"to_int8 gave {len(mods)} Linear8bitLt ({layers} a layer)")
    gb = sum(b.numel() * b.element_size() for b in tree.buffers()) / 1e9
    want = library_launches(0, len(mods))

    def check(name, m, x, y, g):
        hold(name, x, y, m.CB, m.SCB, m.threshold, m.outliers)

    label = "int8, 4 rows"
    reset_counts(kernels)
    forward_each(torch, mods, 4, 90, check)
    counts = read_counts(kernels)
    need_launches(counts, want[label], f"[8c] {label}", device == "cuda")
    out[label] = dict(launches={k: counts[k] for k in want[label]})
    n_int8 = len(mods)
    del tree, mods

    tree = to_int8(torch, hf_llama_tree(torch, cfg.hidden_size, cfg.intermediate_size,
                                        cfg.vocab_size, 1, device=device, seed=2),
                   predicate=lambda n: n.startswith("model.layers."), outliers=0,
                   has_fp16_weights=True, threshold=0.0)
    train = modules_of(tree, Linear8bitLt)
    need(per_layer_counts(tree, Linear8bitLt, 1) == [7], "to_int8: not 7 trainable modules")
    grads = []

    def check_train(name, m, x, y, g):
        W = m.weight.detach()
        hold(name, x.detach(), y, *F.int8_vectorwise_quant(W), 0.0, None)
        for got, ref in ((x.grad, (g.float() @ W.float()).to(x.dtype)),
                         (m.weight.grad, (g.float().T @ x.detach().float()).to(W.dtype))):
            err, scale = max_err(torch, got, ref)
            need(err <= 1e-2 * scale, f"{name}: gradient error {err} > {1e-2 * scale}")
            grads.append(err / scale)

    label = "int8 trainable, 128 rows forward and backward"
    reset_counts(kernels)
    forward_each(torch, train, 128, 91, check_train, backward=True)
    counts = read_counts(kernels)
    need_launches(counts, want[label], f"[8c] {label}", device == "cuda")
    out[label] = dict(launches={k: counts[k] for k in want[label]})
    out.update(int8_gb=gb, build_s=build_s, worst_err_over_tol=worst[0],
               least_fault_over_tol=worst[1], worst_grad_rel=max(grads))
    print(f"[8c] {n_int8} Linear8bitLt ({gb:.2f} GB int8, threshold 6, 32 outlier columns)"
          f" built in {build_s:.1f} s: launches at 4 rows {out['int8, 4 rows']['launches']}; 7"
          f" trainable at 128 rows {out[label]['launches']}; outputs within {worst[0]:.3g} of one"
          f" bf16 ulp of the largest (the next row's SCB at >= {worst[1]:.3g}), gradients within"
          f" {max(grads):.3g} of the largest", flush=True)
    del tree, train
    return out


def library_7b(torch, kernels, cfg, device="cuda", shapes=SHAPES_7B):
    """Phase 8, the library at the width and depth of ``cfg`` (Llama-7B on
    the card): 8a at ``shapes``, 8b and 8c. On the CPU (``device="cpu"``,
    narrow widths) it checks the same wiring with the plain versions, which
    launch nothing."""
    def free():
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    stats = dict(docstring=docstring_path(torch, kernels, device, shapes))
    free()
    stats["nf4_nn"] = nf4_nn_7b(torch, kernels, cfg, device)
    free()
    stats["int8_nn"] = int8_nn_7b(torch, kernels, cfg, device)
    free()
    stats["seconds"] = time.perf_counter() - t0
    launches = {k: v["launches"] for part in ("nf4_nn", "int8_nn")
                for k, v in stats[part].items() if isinstance(v, dict) and "launches" in v}
    print(f"[8] library launches {json.dumps(launches)}; phase 8 took {stats['seconds']:.1f} s",
          flush=True)
    return stats


# --------------------------------------------------------------- phase 9
def seeded_adapters(torch, cfg, n, rank=64, alpha=16.0, seed=7, device="cuda"):
    """n adapters at phase 7b's QLoRA setting (rank 64, alpha 16, all seven
    projections), stacked: adapter 0 as init_lora leaves it (B = 0), the
    others with seeded normal B (std 0.01)."""
    from bitsandbytes_sycl_tpu_torch.models.lora import ALL_TARGETS, init_lora, stack_lora

    gen = torch.Generator(device=device).manual_seed(seed)
    adapters = []
    with torch.no_grad():
        for i in range(n):
            a = init_lora(cfg, seed=seed + i, rank=rank, alpha=alpha, targets=ALL_TARGETS,
                          device=device)
            if i:
                for layer in a:
                    for ab in layer.values():
                        ab["B"].copy_(torch.randn(ab["B"].shape, generator=gen, device=device)
                                      * 0.01)
            adapters.append(a)
        return stack_lora(adapters)  # under no_grad: leaves without grad


def adapters_to(torch, lora, device, layers=None):
    """A stacked adapter tree (its first ``layers`` layers) on ``device``."""
    lora = lora if layers is None else lora[:layers]
    return [{t: {k: v.to(device) for k, v in ab.items()} for t, ab in layer.items()}
            for layer in lora]


def run_requests(torch, eng, prompts, adapter_ids=None, prefix=None):
    """add_requests then decode steps until every slot retires, recording
    the logits each token came from: (outs, per-request logits)."""
    rec = []
    sample = eng._sample
    eng._sample = lambda logits: (rec.append(logits.float().cpu()), sample(logits))[1]
    slots = eng.add_requests(prompts, adapter_ids=adapter_ids, prefix=prefix)
    while eng.active.any():
        eng.step()
    eng._sample = sample
    head = 0 if prefix is None else len(eng._prefixes[prefix]["tokens"])
    outs = [eng.slot_tokens[s][head + len(p):] for s, p in zip(slots, prompts)]
    logits = {r: [rec[i][s] for i in range(len(outs[r]))] for r, s in enumerate(slots)}
    return outs, logits


def engine_card_vs_cpu(torch, label, cfg2, p_cpu, p_gpu, prompts, lora=None, adapter_ids=None,
                       prefix=None, new=2, **ekw):
    """One engine run of 2 layers at 7B width on the card and on the CPU
    (plain versions): the first tokens' logits within phase 5's limits (4%
    relative L2, 5% of the largest logit), the greedy tokens equal under
    the gap rule."""
    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine

    runs = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = InferenceEngine(cfg2, p, EngineConfig(max_batch=len(prompts), max_new_tokens=new,
                                                    **ekw),
                              device=dev, lora=None if lora is None else adapters_to(torch, lora, dev))
        pid = None if prefix is None else eng.register_prefix(prefix)
        runs[dev] = run_requests(torch, eng, prompts, adapter_ids, pid)
        del eng
    (out_c, lg_c), (out_g, lg_g) = runs["cpu"], runs["cuda"]
    first_c = torch.stack([lg_c[r][0] for r in range(len(prompts))])
    first_g = torch.stack([lg_g[r][0] for r in range(len(prompts))])
    need(torch.isfinite(first_g).all().item(), f"{label}: non-finite logits on the card")
    err, mag = max_err(torch, first_g, first_c)
    rel = float((first_g - first_c).norm() / first_c.norm())
    need(rel <= 4e-2, f"{label} card vs CPU: first-token logits relative L2 {rel} > 0.04")
    need(err <= 5e-2 * mag, f"{label} card vs CPU: first-token logits max err {err} > {5e-2 * mag}")
    checked = greedy_agree(out_c, lg_c, out_g, f"{label} card vs CPU")
    print(f"{label} 2-layer 7B-width card vs CPU: first-token logits rel L2 {rel:.3g}, max err"
          f" {err:.4g} (tol {5e-2 * mag:.4g}); {checked} of {sum(map(len, out_c))} greedy tokens"
          " compared equal", flush=True)
    return dict(rel_l2=rel, max_err=err, max_abs=mag, tokens_compared_equal=checked)


def lora_7b(torch, cfg, params, prompts, ref_outs, kernels, cpu2):
    """9a: the paged engine (max_batch 4) serving 4 stacked adapters at
    phase 7b's setting; all 8 requests on adapter 0 (B = 0) give phase 3's
    tokens bit for bit; then the requests spread over the 4 adapters."""
    t0 = time.perf_counter()
    lora = seeded_adapters(torch, cfg, 4)
    stats = dict(adapter_gb=sum(v.numel() * 4 for layer in lora for ab in layer.values()
                                for v in ab.values()) / 1e9)
    reset_counts(kernels)
    outs0, wall0, steps0 = serve(torch, cfg, params, prompts, 32, lora=lora,
                                 adapter_ids=[0] * len(prompts))
    counts0 = read_counts(kernels)
    need(outs0 == ref_outs, "[9a] adapter 0 (B = 0): tokens differ from phase 3's")
    need_new_bodies(counts0, "[9a] adapter 0")
    ids = [i % 4 for i in range(len(prompts))]
    reset_counts(kernels)
    outs, wall, steps = serve(torch, cfg, params, prompts, 32, lora=lora, adapter_ids=ids)
    counts = read_counts(kernels)
    need(all(len(o) == 32 for o in outs), f"[9a] wrong output lengths {[len(o) for o in outs]}")
    need(all(0 <= t < cfg.vocab_size for o in outs for t in o), "[9a] token id out of range")
    need(any(o != r for o, r, a in zip(outs, ref_outs, ids) if a), "[9a] the adapters never acted")
    need(all(o == r for o, r, a in zip(outs, ref_outs, ids) if not a),
         "[9a] adapter 0's requests differ from phase 3's beside other adapters")
    for k in ("w4a8_gemv", "prefill_attn_int8", "paged_attn_int8"):
        need(counts[k] > 0, f"[9a] the multi-adapter run never launched {k}")
    need_new_bodies(counts, "[9a] four adapters")
    med = sorted(steps)[len(steps) // 2] * 1e3
    stats.update(seconds_zero_adapter=wall0, seconds=wall, decode_ms_per_step_median=med,
                 decode_ms_per_step_median_zero_adapter=sorted(steps0)[len(steps0) // 2] * 1e3,
                 launches=counts, adapter_ids=ids)
    print(f"[9a] 4 stacked adapters (r 64, all seven projections, {stats['adapter_gb']:.2f} GB):"
          f" adapter 0 gives phase 3's tokens bit for bit ({wall0:.2f} s); spread over 4"
          f" adapters {sum(map(len, outs))} tokens in {wall:.2f} s, median {med:.2f} ms/step;"
          f" launches {counts}", flush=True)
    cfg2, p_cpu, p_gpu = cpu2
    lora2 = adapters_to(torch, lora, "cpu", layers=2)
    del lora
    stats["card_vs_cpu"] = engine_card_vs_cpu(torch, "[9a]", cfg2, p_cpu, p_gpu, prompts[:2],
                                              lora=lora2, adapter_ids=[1, 3], paged=True)
    stats["phase_s"] = time.perf_counter() - t0
    return stats


def prefix_7b(torch, cfg, params, prompts, kernels, cpu2):
    """9b: a seeded 512-token prefix registered once (G at 512 rows, C at T
    = 512), phase 3's prompts as suffixes, contiguous and paged, whole and
    in chunks of 16 (a chunk of 64 would not split the 32-token bucket of
    these suffixes, as in the JAX engine); every slot's first 512 positions
    hold the stored prefix KV bit for bit, and kernel C runs every suffix
    prefill at starts = 512 (+ the chunk's offset)."""
    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
    from bitsandbytes_sycl_tpu_torch.ops import attention

    t0 = time.perf_counter()
    prefix = long_prompts(40, 1, 512, 512, cfg.vocab_size)[0]
    starts = []
    original = attention.prefill_attention_int8_stacked

    def recording(q, kq, ks, vq, vs, li, **kw):
        if li == 0:  # the model passes starts= by name
            starts.append((int(kw["starts"].min()), int(kw["starts"].max())))
        return original(q, kq, ks, vq, vs, li, **kw)

    stats = {}
    attention.prefill_attention_int8_stacked = recording
    try:
        for paged in (False, True):
            for chunk in (0, 16):
                label = f"[9b] {'paged' if paged else 'contiguous'}, chunk {chunk or 'none'}"
                eng = InferenceEngine(cfg, params, EngineConfig(
                    max_batch=4, max_new_tokens=8, paged=paged, prefill_chunk=chunk), device="cuda")
                reset_counts(kernels)
                starts.clear()
                t_reg = time.perf_counter()
                pid = eng.register_prefix(prefix)
                torch.cuda.synchronize()
                t_reg = time.perf_counter() - t_reg
                reg = read_counts(kernels)
                need(reg["w4a8_grouped"] == 7 * cfg.num_layers + 1 and
                     reg["prefill_attn_int8"] == cfg.num_layers and starts == [(0, 0)],
                     f"{label}: the prefix prefill launched {reg}, C at {starts}")
                stored = eng._prefixes[pid]["cache"]
                reset_counts(kernels)
                starts.clear()
                outs, t_suffix = [], 0.0
                for i in range(0, len(prompts), 4):
                    sfx = prompts[i:i + 4]
                    slots = eng.add_requests(sfx, prefix=pid)
                    torch.cuda.synchronize()
                    for b, s in enumerate(slots):  # the slot's first 512 positions
                        if paged:
                            for j, page in enumerate(eng._alloc.tables[s][:512 // 128]):
                                for key, pos_axis in (("k", -1), ("v", -2), ("k_scale", -1),
                                                      ("v_scale", -1)):
                                    want = stored[key][:, 0].narrow(pos_axis, j * 128, 128)
                                    if key == "k":
                                        want = want.transpose(-1, -2)
                                    need(torch.equal(eng.cache[key][:, page], want),
                                         f"{label}: page {j} of slot {s} ({key}) is not the prefix's")
                        else:
                            for key, pos_axis in (("k", -1), ("v", -2), ("k_scale", -1),
                                                  ("v_scale", -1)):
                                need(torch.equal(eng.cache[key][:, s].narrow(pos_axis, 0, 512),
                                                 stored[key][:, 0].narrow(pos_axis, 0, 512)),
                                     f"{label}: slot {s}'s first 512 positions ({key}) are not"
                                     " the prefix's")
                    while eng.active.any():
                        eng.step()
                    outs += [eng.slot_tokens[s][512 + len(p):] for s, p in zip(slots, sfx)]
                counts = read_counts(kernels)
                n_calls = len(starts)
                offs = [512 + c for c in range(0, 32, chunk)] if chunk else [512]
                need(sorted(set(starts)) == [(o, o) for o in offs] and n_calls == 2 * len(offs),
                     f"{label}: kernel C ran the suffix prefills at starts {starts}, not {offs}")
                need(all(len(o) == 8 for o in outs) and all(0 <= t < cfg.vocab_size
                                                           for o in outs for t in o),
                     f"{label}: wrong outputs")
                need_new_bodies(counts, label, decode=paged)
                need(torch.equal(stored["k"], eng._prefixes[pid]["cache"]["k"]),
                     f"{label}: the stored prefix changed")
                stats[label] = dict(register_s=t_reg, register_launches=reg, launches=counts,
                                    c_starts=starts[:], outputs=outs)
                # paged decode runs kernel D, contiguous H: the tokens are
                # compared, not held (phase 3c holds them under the gap rule)
                first = stats.setdefault("outputs_contiguous", outs)
                stats[label]["tokens_equal_contiguous"] = sum(
                    a == b for o, f in zip(outs, first) for a, b in zip(o, f))
                print(f"{label}: prefix of 512 registered in {t_reg:.3f} s (G {reg['w4a8_grouped']},"
                      f" C {reg['prefill_attn_int8']}); 8 suffixes over it, C at starts"
                      f" {sorted(set(starts))}; {stats[label]['tokens_equal_contiguous']} of 64"
                      f" tokens equal to the contiguous unchunked run's; launches {counts}",
                      flush=True)
                del eng, stored
                torch.cuda.empty_cache()
    finally:
        attention.prefill_attention_int8_stacked = original
    # the suffix prefill beside the same prompts prefilled whole, one batch of 4
    eng = InferenceEngine(cfg, params, EngineConfig(max_batch=4, max_new_tokens=1),
                          device="cuda")
    pid = eng.register_prefix(prefix)
    times = {}
    for name, batch, kw in (("suffix", prompts[:4], dict(prefix=pid)),
                            ("whole", [prefix + p for p in prompts[:4]], {})):
        for _ in range(2):  # the second, warm
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.add_requests(batch, **kw)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t1
    del eng
    torch.cuda.empty_cache()
    stats.update(suffix_prefill_s=times["suffix"], whole_prefill_s=times["whole"])
    print(f"[9b] 4 prompts after the 512-token prefix: suffix prefill {times['suffix'] * 1e3:.1f} ms,"
          f" the same prompts prefilled whole {times['whole'] * 1e3:.1f} ms", flush=True)
    cfg2, p_cpu, p_gpu = cpu2
    stats["card_vs_cpu"] = engine_card_vs_cpu(
        torch, "[9b]", cfg2, p_cpu, p_gpu, prompts[:2],
        prefix=long_prompts(41, 1, 64, 64, cfg.vocab_size)[0], new=2)
    stats["phase_s"] = time.perf_counter() - t0
    return stats


def snapshots_7b(torch, cfg, params, prompts):
    """9c: snapshot the engine after 8 decode steps, 8 more steps; restore
    into a fresh engine from snapshot() and from durable_snapshot() through
    torch.save: the same 8 steps bit for bit. Paged and contiguous, greedy
    and sampled (temperature 0.8, top-k 5)."""
    import tempfile

    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine

    t0 = time.perf_counter()
    stats = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for paged in (True, False):
            for sampled in (False, True):
                label = f"[9c] {'paged' if paged else 'contiguous'}, {'sampled' if sampled else 'greedy'}"
                # a pool of 9 pages holds the 4 slots (a page each) and page 0
                kw = dict(max_batch=4, max_new_tokens=32, paged=paged, num_pages=9 if paged else 0)
                if sampled:
                    kw.update(temperature=0.8, top_k=5)
                ecfg = EngineConfig(**kw)
                eng = InferenceEngine(cfg, params, ecfg, device="cuda", seed=3)
                eng.add_requests(prompts[:4])
                for _ in range(8):
                    eng.step()
                snap = eng.snapshot()
                path = os.path.join(tmp, "engine.pt")
                t1 = time.perf_counter()
                torch.save(eng.durable_snapshot(), path)
                t_save = time.perf_counter() - t1
                ref = [eng.step() for _ in range(8)]
                del eng
                got = {}
                for how in ("snapshot", "durable"):
                    fresh = InferenceEngine(cfg, params, ecfg, device="cuda", seed=11)
                    if how == "snapshot":
                        fresh.restore(snap)
                    else:
                        fresh.restore_durable(torch.load(path))
                    got[how] = [fresh.step() for _ in range(8)]
                    del fresh
                    need(got[how] == ref, f"{label}: the steps after restore from {how} differ")
                del snap
                torch.cuda.empty_cache()
                stats[label] = dict(tokens=ref, save_s=t_save, file_gb=os.path.getsize(path) / 1e9)
                print(f"{label}: 8 steps after restore from snapshot() and from durable_snapshot()"
                      f" ({stats[label]['file_gb']:.2f} GB through torch.save, {t_save:.2f} s) equal"
                      " the uninterrupted engine's bit for bit", flush=True)
    stats["phase_s"] = time.perf_counter() - t0
    return stats


def bf16_cache_7b(torch, cfg, params, prompts, kernels, cpu2):
    """9d: ``cfg`` with kv_quant=False (LlamaConfig.llama7b(kv_quant=False))
    through the contiguous engine: no attention kernel (C, D, H) launches,
    A 225 times a decode step, the bf16 cache's _attention 32 times a
    forward."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, kv_quant=False)
    reset_counts(kernels)
    outs, wall, steps = serve(torch, cfg, params, prompts, 32, paged=False)
    counts = read_counts(kernels)
    n_fwd = len(steps) + -(-len(prompts) // 4)  # decode steps and prefill batches
    n_lin = 7 * cfg.num_layers + 1
    need(all(len(o) == 32 for o in outs) and all(0 <= t < cfg.vocab_size for o in outs for t in o),
         "[9d] wrong outputs")
    need(counts["prefill_attn_int8"] == counts["paged_attn_int8"] == counts["decode_attn_int8"] == 0,
         f"[9d] an int8 attention kernel ran over the bf16 cache: {counts}")
    need(counts["w4a8_gemv.fused"] == n_lin * len(steps) and counts["w4a8_gemv"] == n_lin * n_fwd,
         f"[9d] kernel A launched {counts['w4a8_gemv']} times ({counts['w4a8_gemv.fused']} fused),"
         f" not {n_lin} a forward over {n_fwd} forwards ({len(steps)} decode steps)")
    need(counts["write_and_attend.bf16"] == cfg.num_layers * n_fwd
         and counts["write_and_attend.dequant"] == 0,
         f"[9d] {counts['write_and_attend.bf16']} bf16-cache attention calls, not"
         f" {cfg.num_layers * n_fwd}")
    med = sorted(steps)[len(steps) // 2] * 1e3
    print(f"[9d] llama7b bf16 cache, contiguous: {sum(map(len, outs))} tokens in {wall:.2f} s,"
          f" median {med:.2f} ms/step; launches {counts}", flush=True)
    stats = dict(seconds=wall, decode_ms_per_step_median=med, launches=counts, outputs=outs)
    cfg2, p_cpu, p_gpu = cpu2
    stats["card_vs_cpu"] = engine_card_vs_cpu(torch, "[9d]", dataclasses.replace(cfg2, kv_quant=False),
                                              p_cpu, p_gpu, prompts[:2])
    stats["phase_s"] = time.perf_counter() - t0
    return stats


def paged_pool_7b(torch, cfg, params, prompts, kernels):
    """9e: PagedKVPool at the 7B layer shape (32 kv heads, D 128, pages of
    128): ingest the contiguous cache of a 7B prefill of phase 3's prompts
    (the pool's bytes equal paged_ingest's of the same cache), write one
    decode step, attend one layer through D's single-layer entry (one
    launch) within 1% against D's plain version."""
    import numpy as np

    from bitsandbytes_sycl_tpu_torch.engine import PagedKVPool, init_page_pool, paged_ingest
    from bitsandbytes_sycl_tpu_torch.models.llama import _kv_quantize, init_kv_cache, llama_forward
    from bitsandbytes_sycl_tpu_torch.ops import paged_attention

    t0 = time.perf_counter()
    batch = prompts[:4]
    toks = torch.tensor([p + [0] * (32 - len(p)) for p in batch], device="cuda")
    with torch.no_grad():
        _, cache = llama_forward(params, cfg, toks, init_kv_cache(cfg, 4, "cuda"))
    pool = PagedKVPool(cfg, num_pages=9, device="cuda")
    lens = [len(p) for p in batch]
    slots = [3, 0, 2, 1]
    for b, s in enumerate(slots):
        pool.ingest_contiguous(s, cache, b, lens[b])
    ref = init_page_pool(cfg, 9, 128, "cuda")
    paged_ingest(ref, cache, np.asarray([pool.tables[s] for s in slots]), [1] * 4, [True] * 4)
    for key in ref:
        need(torch.equal(getattr(pool, key), ref[key]), f"[9e] the pool's {key} differs from"
                                                        " paged_ingest's")
    gen = torch.Generator(device="cuda").manual_seed(9)
    H, D, li = cfg.num_kv_heads, cfg.hd, cfg.num_layers // 2
    kq, ks = _kv_quantize(torch.randn((4, 1, H, D), generator=gen, device="cuda"))
    vq, vs = _kv_quantize(torch.randn((4, 1, H, D), generator=gen, device="cuda"))
    for b, s in enumerate(slots):
        pool.extend_slot(s, lens[b] + 1)
    pool.write_decode_step(li, kq.permute(0, 2, 3, 1), ks.permute(0, 2, 1), vq.permute(0, 2, 1, 3),
                           vs.permute(0, 2, 1), slots, np.asarray(lens))
    q = torch.randn((4, 1, cfg.num_heads, D), generator=gen, device="cuda").to(torch.bfloat16)
    new_len = torch.tensor(lens, dtype=torch.int32, device="cuda") + 1
    reset_counts(kernels)
    got = pool.attend(li, q, slots, np.asarray(lens) + 1)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    need(counts["paged_attn_int8"] == 1, f"[9e] attend launched kernel D {counts['paged_attn_int8']}"
                                         " times, not once")
    pt = torch.as_tensor(pool.table_array(slots), device="cuda")
    plain = paged_attention._paged_plain(
        q.reshape(4, H, 1, D), pool.k[li][None], pool.k_scale[li][None], pool.v[li][None],
        pool.v_scale[li][None], 0, pt, new_len, None, (1.0 / D ** 0.5) / 127.0, None, None, None)
    err, mag = max_err(torch, got.reshape(4, H, 1, D), plain)
    need(err <= 1e-2 * mag, f"[9e] attend: max err {err} > {1e-2 * mag} against D's plain version")
    written = [bool(torch.equal(pool.k[li, pool.tables[s][lens[b] // 128], :, lens[b] % 128],
                                kq[b, 0])) for b, s in enumerate(slots)]
    need(all(written), "[9e] write_decode_step did not write the step's keys where the table says")
    print(f"[9e] PagedKVPool at the 7B layer shape: 4 rows ingested equal to paged_ingest's bytes;"
          f" one decode step written; attend (D once, {counts['paged_attn_int8.split']} on its"
          f" split body) max err {err:.3g} (tol {1e-2 * mag:.3g})", flush=True)
    del cache, pool, ref
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, tol=1e-2 * mag, launches=counts, phase_s=time.perf_counter() - t0)


def speculative_7b(torch, cfg, params, prompts, kernels):
    """9f: the LLM.int8 7B target (phase 6's weights) with the NF4 7B draft
    (phase 3's: the same seed-0 draws), gamma 4, 4 ragged prompts of phase
    3, 32 new tokens through generate_speculative on the int8 engine:
    greedy tokens equal to the target engine's own generate() under the
    gap rule, and exact launch counts (I on every target forward, A and H
    on the draft's steps, the dequantize route on the verify and the
    draft's two-token ingest only). Then the host loop against the loop
    variant at 2 layers, and sampling. Returns (stats, the int8 params)."""
    from bitsandbytes_sycl_tpu_torch.engine import (
        EngineConfig, InferenceEngine, speculative_generate, speculative_generate_jit)
    from bitsandbytes_sycl_tpu_torch.models.llama import init_params

    t0 = time.perf_counter()
    cfg8 = dataclasses.replace(cfg, quant="int8")  # LlamaConfig.llama7b(quant="int8")
    params8 = init_params(cfg8, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    batch = prompts[:4]
    gamma, new = 4, 32
    rec = {}
    ref, t_ref, _ = serve(torch, cfg8, params8, batch, new, paged=False, per_request=rec)
    eng = InferenceEngine(cfg8, params8, EngineConfig(max_batch=4, max_new_tokens=new),
                          device="cuda")
    eng.generate_speculative(batch[:1], 4, params, cfg, gamma=gamma)  # first use of each shape
    reset_counts(kernels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = eng.generate_speculative(batch, new, params, cfg, gamma=gamma)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts(kernels)
    st = eng.last_speculative_stats
    rounds, n_lin, L = st["rounds"], 7 * cfg.num_layers + 1, cfg.num_layers
    T = max(len(p) for p in batch)
    need(all(len(o) == new for o in out), f"[9f] wrong output lengths {[len(o) for o in out]}")
    checked = greedy_agree(ref, rec, out, "[9f] speculative vs the target's greedy")
    want = {"int8_matmul": n_lin * st["target_calls"],
            "w4a8_gemv": n_lin * (1 + gamma * rounds),
            "decode_attn_int8": L * (gamma - 1) * rounds,
            "prefill_attn_int8": 2 * L if T >= 8 else 0,
            "write_and_attend.dequant": L * (2 * rounds + (0 if T >= 8 else 2))}
    got = {k: counts[k] for k in want}
    need(got == want, f"[9f] launches {got}, not {want}")
    need(counts["paged_attn_int8"] == 0, "[9f] kernel D ran")
    ms_tok = wall / (len(batch) * new) * 1e3
    print(f"[9f] speculative, LLM.int8 7B target + NF4 7B draft, gamma {gamma}: {len(batch)} x"
          f" {new} tokens in {wall:.2f} s ({ms_tok:.2f} ms a token; the target alone"
          f" {t_ref / (len(batch) * new) * 1e3:.2f}), acceptance {st['accept_rate']:.3f},"
          f" {st['target_calls']} target calls over {rounds} rounds; {checked} greedy tokens equal"
          f" to the target's own generate(); launches {counts}", flush=True)
    sampled = eng.generate_speculative(batch, 16, params, cfg, gamma=gamma, temperature=0.8, seed=1)
    need(all(len(o) == 16 and all(0 <= t < cfg.vocab_size for t in o) for o in sampled),
         "[9f] sampling: wrong outputs")
    del eng
    # 2 layers: the host loop and the loop variant against the target's greedy
    cfg8_2, cfg_2 = (dataclasses.replace(c, num_layers=2) for c in (cfg8, cfg))
    p8_2, p_2 = (dict(p, layers=p["layers"][:2]) for p in (params8, params))
    uniform = [p[:5] for p in batch]
    rec2 = {}
    ref2, _, _ = serve(torch, cfg8_2, p8_2, uniform, 16, paged=False, per_request=rec2)
    host, _ = speculative_generate(p8_2, cfg8_2, p_2, cfg_2, torch.tensor(uniform, device="cuda"),
                                   16, gamma=gamma)
    loop, _ = speculative_generate_jit(p8_2, cfg8_2, p_2, cfg_2, torch.tensor(uniform, device="cuda"),
                                       16, gamma=gamma)
    equal = host.tolist() == loop.tolist()
    c_host = greedy_agree(ref2, rec2, host.tolist(), "[9f] 2 layers, host loop")
    c_loop = greedy_agree(ref2, rec2, loop.tolist(), "[9f] 2 layers, loop variant")
    print(f"[9f] 2 layers: host loop and loop variant tokens equal: {equal}; {c_host} and {c_loop}"
          " greedy tokens equal to the target's", flush=True)
    stats = dict(init_int8_s=t_init, seconds=wall, ms_per_token=ms_tok,
                 target_alone_ms_per_token=t_ref / (len(batch) * new) * 1e3,
                 accept_rate=st["accept_rate"], target_calls=st["target_calls"], rounds=rounds,
                 launches=counts, tokens_compared_equal=checked, host_equals_loop_2_layers=equal,
                 phase_s=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return stats, params8


def serving_engine_7b(torch, cfg, params, prompts, ref_outs, kernels, p_cpu):
    """Phase 9: the rest of the serving engine at Llama-7B width and depth
    (9a multi-LoRA, 9b the prefix cache, 9c snapshots, 9d the bf16 cache, 9e
    PagedKVPool, 9f speculative decoding); ``p_cpu``: the 2-layer model
    (seed 1) on the CPU. Returns (stats, the LLM.int8 params 9f built, for
    phase 6)."""
    t0 = time.perf_counter()
    stats = {}
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    cpu2 = (cfg2, p_cpu, to_cuda(torch, p_cpu))
    stats["lora"] = lora_7b(torch, cfg, params, prompts, ref_outs, kernels, cpu2)
    gc.collect()
    torch.cuda.empty_cache()
    stats["prefix"] = prefix_7b(torch, cfg, params, prompts, kernels, cpu2)
    stats["snapshots"] = snapshots_7b(torch, cfg, params, prompts)
    stats["bf16_cache"] = bf16_cache_7b(torch, cfg, params, prompts, kernels, cpu2)
    stats["paged_pool"] = paged_pool_7b(torch, cfg, params, prompts, kernels)
    del cpu2
    gc.collect()
    torch.cuda.empty_cache()
    stats["speculative"], params8 = speculative_7b(torch, cfg, params, prompts, kernels)
    stats["seconds"] = {k: v["phase_s"] for k, v in stats.items()}
    stats["seconds"]["total"] = time.perf_counter() - t0
    print(f"[9] phase 9 seconds {json.dumps({k: round(v, 2) for k, v in stats['seconds'].items()})}",
          flush=True)
    return stats, params8


def to_cuda(torch, o, device="cuda"):
    """A params tree (tensors, QLinearWeights, dicts, lists) on the card, or
    on ``device``."""
    from bitsandbytes_sycl_tpu_torch.ops.common import QLinearWeight

    if isinstance(o, (torch.Tensor, QLinearWeight)):
        return o.to(device)
    if isinstance(o, dict):
        return {k: to_cuda(torch, v, device) for k, v in o.items()}
    return [to_cuda(torch, v, device) for v in o]


# --------------------------------------------------------------- phase 10
GROUP_REPS = (3, 5, 7, 16)


def repeat_bits(torch, name, run, n=100):
    """``run`` launched n times on one input gives the same bits each time
    (the split merges add in a fixed order): a race would show here."""
    first = run().clone()
    for _ in range(n - 1):
        out = run()
        need(torch.equal(out.view(torch.int16) if out.dtype == torch.bfloat16 else out,
                         first.view(torch.int16) if first.dtype == torch.bfloat16 else first),
             f"{name}: {n} repeated launches did not give the same bits")


# C's and H's wide head dims checked in phase 10k: C takes bf16 q on its
# tensor-core body (a cluster of CTAs at 640 and 1024) and f32 q on its SIMT
# body; H's split body (a cluster of CTAs at all three) and SIMT body run
# each
WIDE_DIMS = (384, 640, 1024)


def check_group_shapes(torch, report):
    """Phase 10k: kernels H and D at group sizes 3, 5, 7 and 16 (16 q heads
    of one kv head: several head groups per CTA pass), H and C at head_dim
    384, D at head_dim 256 with a group of 7 and over kv4 pages, in every
    body that takes the shape, against their plain versions within 1% of
    the output's largest magnitude, with and without the window, softcap,
    ALiBi and new_kv options. Each case: the deliberate faults of
    check_decode / check_paged land outside the tolerance, and 100 repeated
    launches give equal bits. Then H and D timed at rep 7 beside rep 4 over
    the same K/V bytes (B = 4, 4 kv heads: Qwen2-7B's grouping)."""
    from bitsandbytes_sycl_tpu_torch.ops import attention, paged_attention

    gen = torch.Generator(device="cuda").manual_seed(10)
    L, B, Hkv, li = 2, 4, 4, 1
    n = 0
    rows = []

    def check(name, run, plain, faults, repeat=True):
        nonlocal n
        got, ref = run(), plain()
        torch.cuda.synchronize()
        err, mag = max_err(torch, got, ref)
        tol = 1e-2 * mag
        need(err <= tol, f"{name}: max err {err} > {tol}")
        margin = faults_exceed(torch, name, ref, faults, tol) if faults else None
        if repeat:
            repeat_bits(torch, name, run)
        n += 1
        rows.append(dict(name=name, max_abs_err=err, tol=tol, fault_margin=margin))
        return err

    # kernel H: both bodies at head_dim 128, the SIMT body at 384, 640 and 1024
    S = 1024
    lens = torch.tensor([1023, 1, 500, 0], dtype=torch.int32, device="cuda")
    for rep, D in [(r, 128) for r in GROUP_REPS] + [(r, D) for D in WIDE_DIMS for r in (1, 7)]:
        kq = torch.randint(-127, 128, (L, B, Hkv, D, S), generator=gen, device="cuda", dtype=torch.int8)
        vq = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
        ks = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") * 2 + 1  # O(1) scores
        vs = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 0.5
        q = torch.randn((B, Hkv, rep, D), generator=gen, device="cuda").to(torch.bfloat16)
        new_kv = (torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
                  torch.rand((B, Hkv), generator=gen, device="cuda") * 2 + 1,
                  torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
                  torch.rand((B, Hkv), generator=gen, device="cuda") + 0.5)
        alibi = torch.rand((Hkv * rep,), generator=gen, device="cuda") * 0.01
        scale = (1.0 / D ** 0.5) / 127.0
        k_other = kq.clone()
        k_other[li] = kq[li - 1]
        for body in ("split", "simt"):
            plan = attention.DecodePlan(body, 3 if body == "split" else 1)
            for nk, opt in ((new_kv, dict(window=300, softcap=30.0, alibi=alibi)), (None, {})):
                w, sc, al = opt.get("window"), opt.get("softcap"), opt.get("alibi")

                def plain(kq_=kq, ks_=ks, lens_=lens, nk=nk, w=w, sc=sc, al=al):
                    return attention._decode_plain(q, kq_, ks_, vq, vs, li, lens_, nk, scale, w, sc, al)

                name = f"decode_attn_int8 rep={rep} D={D} {body} new_kv={nk is not None} {sorted(opt)}"
                check(name, lambda nk=nk, w=w, sc=sc, al=al: attention._decode_launch(
                    q, kq, ks, vq, vs, li, lens, scale, nk, w, sc, al, plan), plain, [
                    ("K of another layer", lambda: plain(kq_=k_other)),
                    ("K of the next kv head", lambda: plain(kq_=kq.roll(1, dims=2))),
                    ("k_scale dropped", lambda: plain(ks_=torch.full_like(ks, 2.0))),
                    ("the lengths one too long", lambda: plain(lens_=lens + 1)),
                ] if nk is not None else [])
        del kq, vq, ks, vs, k_other
    # kernel D: both bodies at head_dim 128 and 256, int8 and kv4 pages
    P, MAXP = 128, 8
    lens = torch.tensor([1000, 1, 513, 0], dtype=torch.int32, device="cuda")
    for rep, D, kv4 in [(r, 128, False) for r in GROUP_REPS] + [(7, 256, False), (7, 128, True),
                                                                  (16, 128, True)]:
        make = kv4_inputs if kv4 else paged_inputs
        kp, ks, vp, vs, table, _, new_kv = make(torch, gen, L, B, Hkv, D, P, MAXP)
        q = torch.randn((B, Hkv, rep, D), generator=gen, device="cuda").to(torch.bfloat16)
        alibi = torch.rand((Hkv * rep,), generator=gen, device="cuda") * 0.01
        scale = (1.0 / D ** 0.5) / (7.0 if kv4 else 127.0)
        for body in ("split", "simt"):
            plan = paged_attention.PagedPlan(body, 3 if body == "split" else 1)
            for nk, opt in ((new_kv, dict(window=300, softcap=30.0, alibi=alibi)), (None, {})):
                w, sc, al = opt.get("window"), opt.get("softcap"), opt.get("alibi")

                def plain(table_=table, ks_=ks, lens_=lens, kp_=kp, nk=nk, w=w, sc=sc, al=al):
                    return paged_attention._paged_plain(q, kp_, ks_, vp, vs, li, table_, lens_, nk,
                                                        scale, w, sc, al)

                name = (f"paged_attn_int8 rep={rep} D={D} {'kv4 ' if kv4 else ''}{body}"
                        f" new_kv={nk is not None} {sorted(opt)}")
                check(name, lambda nk=nk, w=w, sc=sc, al=al: paged_attention._paged_launch(
                    q, kp, ks, vp, vs, li, table, lens, scale, nk, w, sc, al, plan), plain, [
                    ("the page table shifted by a row", lambda: plain(table_=table.roll(1, dims=0))),
                    ("K of the next kv head", lambda: plain(kp_=kp.roll(1, dims=2))),
                    ("k_scale dropped", lambda: plain(ks_=torch.full_like(ks, ks.mean().item()))),
                    ("the lengths one too long", lambda: plain(lens_=lens + 1)),
                ] if nk is not None else [])
        del kp, vp, ks, vs
    # kernel C at head_dim 384, 640 and 1024 (its SIMT body), bf16 and f32 q,
    # groups of 1 and 7
    S, T = 256, 40
    starts = torch.tensor([0, 100, 7, 200], dtype=torch.int32, device="cuda")
    for D in WIDE_DIMS:
        kq = torch.randint(-127, 128, (L, B, Hkv, D, S), generator=gen, device="cuda", dtype=torch.int8)
        vq = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
        ks = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") * 2 + 1
        vs = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 0.5
        scale = (1.0 / D ** 0.5) / 127.0
        k_other = kq.clone()
        k_other[li] = kq[li - 1]
        for rep in (1, 7):
            alibi = torch.rand((Hkv * rep,), generator=gen, device="cuda") * 0.01
            for dt in (torch.bfloat16, torch.float32):
                q = torch.randn((B, T, Hkv * rep, D), generator=gen, device="cuda").to(dt)
                for opt in (dict(window=64, softcap=30.0, alibi=alibi), {}):
                    w, sc, al = opt.get("window"), opt.get("softcap"), opt.get("alibi")

                    def plain(kq_=kq, ks_=ks, st_=starts, w=w, sc=sc, al=al, q=q, kq=kq, ks=ks,
                              vq=vq, vs=vs, scale=scale):
                        return attention._prefill_plain(q, kq_, ks_, vq, vs, li, st_, scale, w, sc,
                                                        al)

                    check(f"prefill_attn_int8 rep={rep} D={D} {dt} {sorted(opt)}",
                          lambda w=w, sc=sc, al=al, q=q, kq=kq, ks=ks, vq=vq, vs=vs, scale=scale:
                          attention.prefill_attn_int8(q, kq, ks, vq, vs, li, starts, scale, window=w,
                                                      softcap=sc, alibi=al),
                          plain, [("K of another layer", lambda plain=plain, k_other=k_other:
                                   plain(kq_=k_other)),
                                  ("K of the next kv head", lambda plain=plain, kq=kq:
                                   plain(kq_=kq.roll(1, dims=2))),
                                  ("k_scale dropped", lambda plain=plain, ks=ks:
                                   plain(ks_=torch.full_like(ks, 2.0))),
                                  ("the starts one too far", lambda plain=plain:
                                   plain(st_=starts + 1))])
        del kq, vq, ks, vs, k_other
    report["group shapes"] = dict(cases=n, rows=rows)
    print(f"[10k] {n} cases of H and D at rep {GROUP_REPS}, H and C at D = {WIDE_DIMS}, D at"
          f" D = 256 and over kv4 pages: within 1%, the faults outside, 100 launches bit for bit",
          flush=True)
    time_groups(torch, report)
    time_wide_heads(torch, report)
    return n


def time_wide_heads(torch, report):
    """Kernel C at head_dim 1024 on its SIMT body, H on its split body (the
    SIMT body beside it in check_wide_bodies): B = 4, 4 kv
    heads of 4 q heads, S = 2048; H over full rows with new_kv, C at T =
    512 from position 0 (f32 q, the SIMT body's dtype) beside SDPA over the
    same K/V dequantized to bf16. The bound: K/V bytes the lengths need and
    their scales, q and out, at the H100's HBM rate, or the f32 operations
    (4 D per score a head), whichever is more."""
    from bitsandbytes_sycl_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(13)
    L, B, Hkv, rep, D, S, li = 2, 4, 4, 4, 1024, 2048, 1
    Hq = Hkv * rep
    kq = torch.randint(-127, 128, (L, B, Hkv, D, S), generator=gen, device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") * 2 + 1
    vs = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 0.5
    scale = (1.0 / D ** 0.5) / 127.0
    kd = (kq[li].float() * (ks[li, :, :, None, :] / 127)).transpose(-1, -2)
    vd = vq[li].float() * (vs[li, :, :, :, None] / 127)
    kd = kd.repeat_interleave(rep, dim=1).contiguous().to(torch.bfloat16)
    vd = vd.repeat_interleave(rep, dim=1).contiguous().to(torch.bfloat16)
    out = {}
    # H: full rows, this step's token folded in
    lens_l = [S - 1] * B
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    new_kv = (torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, Hkv), generator=gen, device="cuda") * 2 + 1,
              torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, Hkv), generator=gen, device="cuda") + 0.5)
    q = torch.randn((B, Hkv, rep, D), generator=gen, device="cuda").to(torch.bfloat16)
    nbytes = sum(lens_l) * Hkv * (2 * D + 8) + 2 * B * Hq * D * 2 + B * Hkv * (2 * D + 8) + 4 * B
    flops = 4 * (sum(lens_l) + B) * Hq * D
    run = lambda: attention.decode_attn_int8(q, kq, ks, vq, vs, li, lens, scale, new_kv)  # noqa: E731
    plain = lambda: attention._decode_plain(q, kq, ks, vq, vs, li, lens, new_kv, scale,  # noqa: E731
                                            None, None, None)
    c0 = attention.decode_attn_int8.launches
    err, mag = max_err(torch, run(), plain())
    need(attention.decode_attn_int8.launches == c0 + 1, "H at D = 1024: no launch")
    need(err <= 1e-2 * mag, f"H at D = 1024: max err {err} > {1e-2 * mag}")
    lib_ms, lib_name, _ = time_sdpa(torch, q.reshape(B, Hq, 1, D), kd, vd)
    out["decode_attn_int8 D=1024"] = dict(
        ms=time_cold(torch, run), plain_ms=time_cold(torch, plain, iters=5), library_ms=lib_ms,
        library_backend=lib_name, max_abs_err=err, bytes=nbytes,
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations")
    # C: a 512-token prompt from position 0 (keys 0..t for row t)
    T = 512
    starts = torch.zeros((B,), dtype=torch.int32, device="cuda")
    qp = torch.randn((B, T, Hq, D), generator=gen, device="cuda")
    keys = T * (T + 1) // 2  # causal (row, key) pairs per head
    nbytes = B * Hkv * T * (2 * D + 8) + 2 * B * T * Hq * D * 4
    flops = 4 * B * Hq * keys * D
    run = lambda: attention.prefill_attn_int8(qp, kq, ks, vq, vs, li, starts, scale)  # noqa: E731
    plain = lambda: attention._prefill_plain(qp, kq, ks, vq, vs, li, starts, scale,  # noqa: E731
                                             None, None, None)
    c0 = attention.prefill_attn_int8.launches
    err, mag = max_err(torch, run(), plain())
    need(attention.prefill_attn_int8.launches == c0 + 1, "C at D = 1024: no launch")
    need(err <= 1e-2 * mag, f"C at D = 1024: max err {err} > {1e-2 * mag}")
    lib_ms, lib_name, _ = time_sdpa(torch, qp.transpose(1, 2).to(torch.bfloat16).contiguous(),
                                    kd[:, :, :T].contiguous(), vd[:, :, :T].contiguous(),
                                    is_causal=True)
    out["prefill_attn_int8 D=1024"] = dict(
        ms=time_cold(torch, run, iters=5), plain_ms=time_cold(torch, plain, iters=3),
        library_ms=lib_ms, library_backend=lib_name, max_abs_err=err, bytes=nbytes,
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations")
    del kq, vq, ks, vs, kd, vd
    for k, r in out.items():
        print(f"[10k] {k}: {r['ms'] * 1e3:.1f} us (plain {r['plain_ms'] * 1e3:.1f} us, sdpa"
              f" {fmt_us(r['library_ms'])} {r['library_backend']}), bound {r['bound_ms'] * 1e3:.2f} us"
              f" by {r['bound_by']} ({r['bound_ms'] / r['ms']:.0%}); err {r['max_abs_err']:.3g}",
              flush=True)
    report["wide heads"] = out


def time_groups(torch, report):
    """Kernels H and D at rep 7 (two head groups of 4 per kv head in their
    split bodies) beside rep 4 over the same K/V bytes: B = 4, Hkv = 4,
    D = 128, S = 2048 (H) or 16 pages of 128 (D), full rows, new_kv given.
    The bound: K/V bytes and scales once, q and out, at the H100's HBM
    rate (or the f32 operations, if more)."""
    from bitsandbytes_sycl_tpu_torch.ops import attention, paged_attention
    from bitsandbytes_sycl_tpu_torch.ops.common import sm_count

    gen = torch.Generator(device="cuda").manual_seed(12)
    L, B, Hkv, D, S, li = 2, 4, 4, 128, 2048, 1
    lens_l = [2047] * B
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    kq = torch.randint(-127, 128, (L, B, Hkv, D, S), generator=gen, device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") * 2 + 1
    vs = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 0.5
    new_kv = (torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, Hkv), generator=gen, device="cuda") * 2 + 1,
              torch.randint(-127, 128, (B, Hkv, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, Hkv), generator=gen, device="cuda") + 0.5)
    kp, kps, vp, vps, table, _, pnew = paged_inputs(torch, gen, L, B, Hkv, D, 128, 16)
    plens = torch.tensor([16 * 128 - 1] * B, dtype=torch.int32, device="cuda")
    scale = (1.0 / D ** 0.5) / 127.0
    out = {}
    for rep in (4, 7):
        Hq = Hkv * rep
        q = torch.randn((B, Hkv, rep, D), generator=gen, device="cuda").to(torch.bfloat16)
        nbytes = sum(lens_l) * Hkv * (2 * D + 8) + 2 * B * Hq * D * 2 + B * Hkv * (2 * D + 8) + 4 * B
        flops = 4 * (sum(lens_l) + B) * Hq * D
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations"
        plan = attention.decode_plan(B, Hkv, S, D, rep, q.dtype, sm_count(q.device))
        run = lambda q=q, plan=plan: attention._decode_launch(  # noqa: E731
            q, kq, ks, vq, vs, li, lens, scale, new_kv, None, None, None, plan)
        plain = lambda q=q: attention._decode_plain(  # noqa: E731
            q, kq, ks, vq, vs, li, lens, new_kv, scale, None, None, None)
        err, _ = max_err(torch, run(), plain())
        # SDPA over the same K/V dequantized, the kv heads repeated per group
        kd = (kq[li].float() * (ks[li, :, :, None, :] / 127)).transpose(-1, -2)
        vd = vq[li].float() * (vs[li, :, :, :, None] / 127)
        kd = kd.repeat_interleave(rep, dim=1).contiguous().to(torch.bfloat16)
        vd = vd.repeat_interleave(rep, dim=1).contiguous().to(torch.bfloat16)
        lib_ms, lib_name, _ = time_sdpa(torch, q.reshape(B, Hq, 1, D), kd, vd)
        del kd, vd
        out[f"decode_attn_int8 rep={rep}"] = dict(
            plan=tuple(plan), ms=time_cold(torch, run), plain_ms=time_cold(torch, plain, iters=5),
            library_ms=lib_ms, library_backend=lib_name, bound_ms=bound, bound_by=bound_by,
            max_abs_err=err, bytes=nbytes)
        pplan = paged_attention.paged_plan(B, Hkv, 16, 128, D, rep, sm_count(q.device), 16)
        prun = lambda q=q, pplan=pplan: paged_attention._paged_launch(  # noqa: E731
            q, kp, kps, vp, vps, li, table, plens, scale, pnew, None, None, None, pplan)
        pplain = lambda q=q: paged_attention._paged_plain(  # noqa: E731
            q, kp, kps, vp, vps, li, table, plens, pnew, scale, None, None, None)
        perr, _ = max_err(torch, prun(), pplain())
        out[f"paged_attn_int8 rep={rep}"] = dict(
            plan=tuple(pplan), ms=time_cold(torch, prun), plain_ms=time_cold(torch, pplain, iters=5),
            library_ms=lib_ms, library_backend=lib_name, bound_ms=bound, bound_by=bound_by,
            max_abs_err=perr, bytes=nbytes)
    for k, r in out.items():
        print(f"[10k] {k}: plan {r['plan']} {r['ms'] * 1e3:.1f} us (plain {r['plain_ms'] * 1e3:.1f} us,"
              f" sdpa {fmt_us(r['library_ms'])}), bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}"
              f" ({r['bound_ms'] / r['ms']:.0%}); err {r['max_abs_err']:.3g}", flush=True)
    report["group timing"] = out
    for kname in ("decode_attn_int8", "paged_attn_int8"):
        r = out[f"{kname} rep=7"]
        report[f"{kname} (rep 7)"] = dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                                          plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                                          bound_by=r["bound_by"], library_ms=r["library_ms"])


def forward_steps(torch, fwd, cfg, params, toks, device, steps=2, feed=None, cache_cfg=None):
    """A prefill of ``toks`` then ``steps`` decode steps through ``fwd`` on
    ``device``, each fed the tokens ``feed[s]`` (B,) or, without ``feed``,
    the argmax of the call before: the logits of each call, (B, vocab) f32
    on the CPU. The cache is ``cache_cfg``'s (a rank's under TP), or
    cfg's."""
    from bitsandbytes_sycl_tpu_torch.models.llama import init_kv_cache

    B, T = toks.shape
    cache = init_kv_cache(cache_cfg or cfg, B, device)
    pos = torch.arange(T, device=device).expand(B, T)
    lg, cache = fwd(params, cfg, toks.to(device), cache, pos)
    out = [lg[:, -1].float().cpu()]
    for s in range(steps):
        tok = out[-1].argmax(-1) if feed is None else feed[s]
        lg, cache = fwd(params, cfg, tok[:, None].to(device), cache,
                        torch.full((B, 1), T + s, device=device))
        out.append(lg[:, 0].float().cpu())
    return out


def card_vs_cpu_layers(torch, label, fwd, cfg, params, layers, steps=2):
    """The first ``layers`` layers of the card's params (their bytes copied
    to the CPU, not re-initialized): a prefill of two phase-3 prompts and
    ``steps`` decode steps on the card and through the plain versions on
    the CPU; every call's logits within 4% relative L2 and 5% of the
    largest logit (phase 5's limits), the decode tokens under the gap
    rule."""
    cfg_n = dataclasses.replace(cfg, num_layers=layers)
    p_gpu = dict(params, layers=params["layers"][:layers])
    p_cpu = to_cuda(torch, p_gpu, "cpu")
    prompts = prompts_from_seed(1, 2, cfg.vocab_size)
    toks = torch.tensor([p + [0] * (32 - len(p)) for p in prompts])
    # both sides decode the CPU's greedy tokens, so every call sees one input
    want = forward_steps(torch, fwd, cfg_n, p_cpu, toks, "cpu", steps)
    got = forward_steps(torch, fwd, cfg_n, p_gpu, toks, "cuda", steps,
                        feed=[w.argmax(-1) for w in want[:-1]])
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        need(torch.isfinite(g).all().item(), f"{label} card vs CPU: non-finite logits (call {i})")
        rel = float((g - w).norm() / w.norm())
        err, mag = max_err(torch, g, w)
        need(rel <= 4e-2 and err <= 5e-2 * mag,
             f"{label} card vs CPU, call {i}: relative L2 {rel} (tol 0.04), max err {err}"
             f" (tol {5e-2 * mag})")
        worst = max(worst, rel)
    # the greedy token of every call, compared under the gap rule
    gt = [[int(g[r].argmax()) for g in got] for r in range(2)]
    wt = [[int(w[r].argmax()) for w in want] for r in range(2)]
    compared = greedy_agree(wt, [[w[r] for w in want] for r in range(2)], gt,
                            f"{label} card vs CPU")
    del p_cpu
    return dict(layers=layers, worst_rel_l2=worst, calls=len(got), tokens_compared_equal=compared)


def family_step_counts(torch, cfg, params, fwd, prompts, kernels, paged):
    """The launches of one 4-prompt prefill and of the decode step after it,
    through an engine of 4 slots with ``fwd``."""
    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine

    eng = InferenceEngine(cfg, params, EngineConfig(max_batch=4, paged=paged, max_new_tokens=8),
                          device="cuda", forward_fn=fwd)
    reset_counts(kernels)
    eng.add_requests(prompts[:4])
    torch.cuda.synchronize()
    prefill = {k: v for k, v in read_counts(kernels).items() if v}
    reset_counts(kernels)
    eng.step()
    torch.cuda.synchronize()
    step = {k: v for k, v in read_counts(kernels).items() if v}
    del eng
    return prefill, step


def serve_family(torch, label, cfg, params, fwd, prompts, kernels, max_new=32, expect=None):
    """Serve ``prompts`` (4 slots, ``max_new`` tokens) through ``fwd``
    contiguous and paged with the counts set to 0 just before each run and
    read just after; greedy tokens of the two under the gap rule; the
    launches of one prefill and one decode step in each mode against
    ``expect`` (a function of the mode giving {counter: launches}); peak
    memory of each run."""
    out = {}
    recs = {}
    for paged in (False, True):
        mode = "paged" if paged else "contiguous"
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        rec = {}
        outs, wall, steps = serve(torch, cfg, params, prompts, max_new, paged=paged, per_request=rec,
                                  forward_fn=fwd)
        counts = {k: v for k, v in read_counts(kernels).items() if v}
        need(all(len(o) == max_new for o in outs), f"{label} {mode}: wrong output lengths")
        need(all(0 <= t < cfg.vocab_size for o in outs for t in o), f"{label} {mode}: token out of range")
        prefill, step = family_step_counts(torch, cfg, params, fwd, prompts, kernels, paged)
        if expect is not None:
            for k, v in expect(paged, "prefill").items():
                need(prefill.get(k, 0) == v, f"{label} {mode}: {prefill.get(k, 0)} launches of {k}"
                                             f" in one prefill, expected {v} ({prefill})")
            for k, v in expect(paged, "step").items():
                need(step.get(k, 0) == v, f"{label} {mode}: {step.get(k, 0)} launches of {k} in"
                                          f" one decode step, expected {v} ({step})")
        steps = sorted(steps)
        out[mode] = dict(tokens=sum(map(len, outs)), wall_s=wall, decode_steps=len(steps),
                         decode_ms_per_step_median=steps[len(steps) // 2] * 1e3,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
                         prefill_launches=prefill, step_launches=step)
        recs[mode] = (outs, rec)
        print(f"{label} {mode}: {out[mode]['tokens']} tokens in {wall:.2f} s, median"
              f" {out[mode]['decode_ms_per_step_median']:.2f} ms/step, peak"
              f" {out[mode]['peak_gb']:.1f} GB; one step's launches {step}", flush=True)
    out["tokens_compared_equal"] = greedy_agree(*recs["paged"], recs["contiguous"][0],
                                                f"{label} paged vs contiguous")
    return out


def attention_expect(cfg):
    """{counter: launches} of one prefill (4 prompts) and one decode step of
    a model whose attention runs on kernels C, D and H: a layer each, every
    prefill launch of C on its tensor-core body and every decode launch of
    D and H on their split bodies (the served families' head dims 128 and
    256 and their group sizes all take them)."""
    L = cfg.num_layers

    def expect(paged, what):
        if what == "prefill":
            return {"prefill_attn_int8": L, "prefill_attn_int8.tc": L, "write_and_attend.dequant": 0}
        if paged:
            return {"paged_attn_int8": L, "paged_attn_int8.split": L, "decode_attn_int8": 0,
                    "write_and_attend.paged_dequant": 0}
        return {"decode_attn_int8": L, "decode_attn_int8.split": L, "paged_attn_int8": 0,
                "write_and_attend.dequant": 0}

    return expect


def families_10(torch, prompts, kernels, report):
    """Phase 10: kernel checks of the new shapes (10k), then Mixtral-8x7B
    (10a) at full width and depth, Qwen2-7B (10b), GPT-J-6B (10c) and
    BLOOM-7B1 (10d) at full width, each served contiguous and paged
    through its forward and held against the CPU at its first layers, and
    eight more families at their published widths and 2 layers (10e, held
    against the CPU at a prefill and one decode step). Each model is freed
    before the next."""
    from bitsandbytes_sycl_tpu_torch import models as M

    stats = {}
    seconds = {}
    t0 = time.perf_counter()
    stats["10k"] = check_group_shapes(torch, report)
    seconds["10k"] = time.perf_counter() - t0

    def big(key, label, cfg, init, fwd, expect, cpu_layers, extra=None):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = init(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gb = torch.cuda.memory_allocated() / 1e9
        row = serve_family(torch, label, cfg, params, fwd, prompts, kernels, expect=expect)
        row.update(init_s=init_s, weights_gb=weights_gb, layers=cfg.num_layers)
        if extra is not None:
            row.update(extra(params))
        row["card_vs_cpu"] = card_vs_cpu_layers(torch, label, fwd, cfg, params, cpu_layers)
        print(f"{label}: {cfg.num_layers} layers, {weights_gb:.1f} GB on the card, init"
              f" {init_s:.1f} s; card vs CPU at {cpu_layers} layer(s): worst relative L2"
              f" {row['card_vs_cpu']['worst_rel_l2']:.3g}, {row['card_vs_cpu']['tokens_compared_equal']}"
              " decode tokens equal", flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        stats[key] = row
        seconds[key] = time.perf_counter() - t0

    # 10a: Mixtral-8x7B: 8 experts x 3 GEMVs a layer (dense combine) beside attention's 4;
    # 16 of its 32 layers, to pay for phase 12
    mix = M.MixtralConfig(num_layers=16)

    def mix_expect(paged, what):
        e = attention_expect(mix)(paged, what)
        if what == "step":
            e["w4a8_gemv"] = mix.num_layers * (4 + 3 * mix.num_experts) + 1
        return e

    big("10a", "[10a] Mixtral-8x7B NF4", mix, M.init_params, M.mixtral_forward, mix_expect, 1)
    # 10b: Qwen2-7B: 28 q heads over 4 kv heads (rep 7) on H and D
    qwen = M.Qwen2Config()
    big("10b", "[10b] Qwen2-7B NF4", qwen, M.init_params, M.qwen2_forward, attention_expect(qwen), 2)
    # 10c: GPT-J-6B: head_dim 256 on C's tensor-core body and D's and H's split bodies
    gptj = M.GPTJConfig()
    big("10c", "[10c] GPT-J-6B NF4", gptj, M.init_gptj_params, M.gptj_forward,
        attention_expect(gptj), 2)
    # 10d: BLOOM-7B1: ALiBi slopes on C, D and H
    bloom = M.BloomConfig()
    big("10d", "[10d] BLOOM-7B1 NF4", bloom, M.init_opt_params, M.bloom_forward,
        attention_expect(bloom), 2)
    # 10e: the other families at their published widths, 2 layers each
    t0 = time.perf_counter()
    stats["10e"] = {}
    for name, cfg, init, fwd in (
            ("Mistral-7B", M.MistralConfig(num_layers=2), M.init_params, M.mistral_forward),
            ("Gemma-7B", M.GemmaConfig(num_layers=2), M.init_params, M.gemma_forward),
            ("Gemma-2-9B", M.Gemma2Config(num_layers=2), M.init_params, M.gemma2_forward),
            ("Phi-2", M.PhiConfig(num_layers=2), M.init_gptj_params, M.phi_forward),
            ("Pythia-6.9B", M.NeoXConfig(num_layers=2), M.init_gptj_params, M.neox_forward),
            # 4544 = 71 x 64: K's halves hold whole blocks of 32, not of 64
            ("Falcon-7B", M.FalconConfig(num_layers=2, blocksize=32), M.init_gptj_params,
             M.falcon_forward),
            # OPTConfig keeps the reference's 16 heads (GPTJConfig's); OPT-6.7B has 32 of 128
            ("OPT-6.7B", M.OPTConfig(num_layers=2, num_heads=32), M.init_opt_params,
             M.opt_forward),
            ("GPT-2", M.GPT2Config(num_layers=2), M.init_opt_params, M.gpt2_forward)):
        t1 = time.perf_counter()
        params = init(cfg, seed=0, device="cuda")
        kernel_route = cfg.hd % 128 == 0
        L = cfg.num_layers

        def expect(paged, what, kernel_route=kernel_route, L=L):
            if kernel_route:
                return attention_expect(cfg)(paged, what)
            # head_dim not a multiple of 128: the dequantize routes, no attention kernel
            if what == "prefill":
                return {"prefill_attn_int8": 0, "write_and_attend.dequant": L}
            if paged:
                return {"paged_attn_int8": 0, "write_and_attend.paged_dequant": L}
            return {"decode_attn_int8": 0, "write_and_attend.dequant": L}

        row = serve_family(torch, f"[10e] {name}", cfg, params, fwd, prompts[:4], kernels,
                           max_new=9, expect=expect)
        row["card_vs_cpu"] = card_vs_cpu_layers(torch, f"[10e] {name}", fwd, cfg, params, 2, steps=1)
        row.update(head_dim=cfg.hd, kernel_route=kernel_route, seconds=time.perf_counter() - t1)
        stats["10e"][name] = row
        print(f"[10e] {name}: head_dim {cfg.hd} ({'kernels' if kernel_route else 'dequantize routes'});"
              f" card vs CPU worst relative L2 {row['card_vs_cpu']['worst_rel_l2']:.3g};"
              f" {row['seconds']:.1f} s", flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    seconds["10e"] = time.perf_counter() - t0
    stats["seconds"] = seconds
    return stats


# --------------------------------------------------------------- phase 11
# checkpoints written and loaded here, removed at the end (build/ is not committed)
PHASE11_DIR = os.path.join(ROOT, "build", "phase11")
# meta-llama/Llama-2-7b-hf config.json as published; num_hidden_layers is cut to 4 below
LLAMA2_7B_HF = dict(
    architectures=["LlamaForCausalLM"], bos_token_id=1, eos_token_id=2, hidden_act="silu",
    hidden_size=4096, initializer_range=0.02, intermediate_size=11008,
    max_position_embeddings=4096, model_type="llama", num_attention_heads=32,
    num_hidden_layers=32, num_key_value_heads=32, pretraining_tp=1, rms_norm_eps=1e-05,
    rope_scaling=None, tie_word_embeddings=False, torch_dtype="float16", vocab_size=32000)
# EleutherAI/gpt-j-6b config.json as published; n_layer is cut to 2 below
GPTJ_6B_HF = dict(
    activation_function="gelu_new", architectures=["GPTJForCausalLM"], attn_pdrop=0.0,
    bos_token_id=50256, embd_pdrop=0.0, eos_token_id=50256, initializer_range=0.02,
    layer_norm_epsilon=1e-05, model_type="gptj", n_embd=4096, n_head=16, n_inner=None,
    n_layer=28, n_positions=2048, resid_pdrop=0.0, rotary=True, rotary_dim=64,
    scale_attn_weights=True, tie_word_embeddings=False, vocab_size=50400)
LLAMA_LAYERS, GPTJ_LAYERS = 4, 2


def write_safetensors(torch, path, tensors):
    """A safetensors file written by hand (no safetensors package is
    needed): the 8-byte little-endian header length, the JSON header padded
    with spaces to 8 bytes, then each tensor's bytes in order. Returns the
    file's bytes."""
    import struct

    names = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for n, t in tensors.items():
        nb = t.numel() * t.element_size()
        header[n] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + nb]}
        off += nb
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for t in tensors.values():
            f.write(memoryview(t.contiguous().cpu().view(torch.uint8).numpy()))
    return 8 + len(hb) + off


def seeded_tensors(torch, shapes, dtype, seed=0):
    """{name: tensor on the card}: weights and biases N(0, 0.02), norm
    weights 1 + N(0, 0.1), from one generator in the order given."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=gen, device="cuda")
        if len(shape) == 1 and ("norm" in name or name.endswith(("ln_1.weight", "ln_f.weight"))):
            t = 1 + 0.1 * t
        else:
            t = 0.02 * t
        out[name] = t.to(dtype)
    return out


def llama_hf_shapes(hf):
    h, i, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    shapes = {"model.embed_tokens.weight": (v, h)}
    for li in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{li}."
        shapes.update({pre + "self_attn.q_proj.weight": (h, h), pre + "self_attn.k_proj.weight": (h, h),
                       pre + "self_attn.v_proj.weight": (h, h), pre + "self_attn.o_proj.weight": (h, h),
                       pre + "mlp.gate_proj.weight": (i, h), pre + "mlp.up_proj.weight": (i, h),
                       pre + "mlp.down_proj.weight": (h, i), pre + "input_layernorm.weight": (h,),
                       pre + "post_attention_layernorm.weight": (h,)})
    shapes.update({"model.norm.weight": (h,), "lm_head.weight": (v, h)})
    return shapes


def gptj_hf_shapes(hf):
    h, v = hf["n_embd"], hf["vocab_size"]
    f = hf["n_inner"] or 4 * h
    shapes = {"transformer.wte.weight": (v, h)}
    for li in range(hf["n_layer"]):
        pre = f"transformer.h.{li}."
        shapes.update({pre + "ln_1.weight": (h,), pre + "ln_1.bias": (h,),
                       pre + "attn.q_proj.weight": (h, h), pre + "attn.k_proj.weight": (h, h),
                       pre + "attn.v_proj.weight": (h, h), pre + "attn.out_proj.weight": (h, h),
                       pre + "mlp.fc_in.weight": (f, h), pre + "mlp.fc_in.bias": (f,),
                       pre + "mlp.fc_out.weight": (h, f), pre + "mlp.fc_out.bias": (h,)})
    shapes.update({"transformer.ln_f.weight": (h,), "transformer.ln_f.bias": (h,),
                   "lm_head.weight": (v, h), "lm_head.bias": (v,)})
    return shapes


def llama_tree(T, cfg):
    """Phase 11's in-memory Llama tree: each tensor of ``T`` (HF names, on
    the card) upcast and quantized where it stands, no checkpoint read."""
    from bitsandbytes_sycl_tpu_torch.models.llama import _quantize_linear

    def q(n):
        return _quantize_linear(T[n].float(), cfg)

    layers = []
    for li in range(cfg.num_layers):
        pre = f"model.layers.{li}."
        layer = {k: q(pre + f"{part}.{k}.weight") for part, ks in (
            ("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
            ("mlp", ("gate_proj", "up_proj", "down_proj"))) for k in ks}
        layer["input_norm"] = T[pre + "input_layernorm.weight"].float()
        layer["post_attn_norm"] = T[pre + "post_attention_layernorm.weight"].float()
        layers.append(layer)
    return {"embed": T["model.embed_tokens.weight"].float().to(cfg.dtype), "layers": layers,
            "final_norm": T["model.norm.weight"].float(), "lm_head": q("lm_head.weight")}


def gptj_tree(T, cfg):
    """Phase 11's in-memory GPT-J tree, as llama_tree."""
    from bitsandbytes_sycl_tpu_torch.models.llama import _quantize_linear

    def q(n):
        return _quantize_linear(T[n].float(), cfg)

    layers = []
    for li in range(cfg.num_layers):
        pre = f"transformer.h.{li}."
        layers.append({"ln_w": T[pre + "ln_1.weight"].float(), "ln_b": T[pre + "ln_1.bias"].float(),
                       "q_proj": q(pre + "attn.q_proj.weight"), "k_proj": q(pre + "attn.k_proj.weight"),
                       "v_proj": q(pre + "attn.v_proj.weight"),
                       "out_proj": q(pre + "attn.out_proj.weight"),
                       "fc_in": q(pre + "mlp.fc_in.weight"),
                       "fc_in_b": T[pre + "mlp.fc_in.bias"].float(),
                       "fc_out": q(pre + "mlp.fc_out.weight"),
                       "fc_out_b": T[pre + "mlp.fc_out.bias"].float()})
    return {"wte": T["transformer.wte.weight"].float().to(cfg.dtype), "layers": layers,
            "ln_f_w": T["transformer.ln_f.weight"].float(), "ln_f_b": T["transformer.ln_f.bias"].float(),
            "lm_head": q("lm_head.weight"), "lm_head_b": T["lm_head.bias"].float()}


def tree_leaves(torch, tree, path=""):
    """[(path, tensor)] of a params tree (QLinearWeights and dicts of
    tensors), in order."""
    from bitsandbytes_sycl_tpu_torch.ops.common import QLinearWeight

    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, QLinearWeight):
        return [(f"{path}.{f}", getattr(tree, f)) for f in ("packed", "absmax", "absmax_scale",
                                                            "absmax_offset")
                if getattr(tree, f) is not None]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in tree_leaves(torch, v, f"{path}/{k}")]
    return [x for i, v in enumerate(tree) for x in tree_leaves(torch, v, f"{path}/{i}")]


def need_same_tree(torch, a, b, label):
    """Every leaf of ``a`` equals ``b``'s at the same path, dtype and bits."""
    la, lb = tree_leaves(torch, a), tree_leaves(torch, b)
    need([p for p, _ in la] == [p for p, _ in lb], f"{label}: the trees differ in their leaves")
    for (p, x), (_, y) in zip(la, lb):
        need(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y.to(x.device)),
             f"{label}: leaf {p} differs")
    return len(la)


def vm_rss() -> int:
    """This process's resident set, bytes (/proc/self/status VmRSS)."""
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))


def load_rss_main(model_dir) -> int:
    """``--load-rss DIR``: load a Llama checkpoint directory on the card in
    this fresh process and print one JSON line, in bytes and seconds: the
    load's time, the files' bytes, the RSS before the load (VmRSS) and the
    peak RSS (``resource.getrusage``'s ru_maxrss). Start it from a small
    process (a shell that forks it): ru_maxrss carries over the RSS of the
    process that forked it."""
    import resource

    import torch

    sys.path.insert(0, ROOT)
    from bitsandbytes_sycl_tpu_torch.checkpoints import load_llama_from_hf

    torch.zeros(1, device="cuda")  # the CUDA context, before the baseline
    rss0 = vm_rss()
    t0 = time.perf_counter()
    cfg, params = load_llama_from_hf(model_dir, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    files = sum(os.path.getsize(os.path.join(model_dir, n)) for n in os.listdir(model_dir)
                if n.endswith(".safetensors"))
    print(json.dumps(dict(load_s=secs, file_bytes=files, rss_before=rss0,
                          peak_rss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
                          layers=cfg.num_layers)))
    return 0


def checkpoints_11(torch, prompts, kernels, report, ref_counts):
    """Phase 11: (a) a Llama-2-7B-width HF checkpoint written here (4 layers,
    bf16, two safetensors shards) loaded on the card: three weights' bytes
    against the CPU quantizer, the whole tree against the same tensors
    quantized in memory, phase 3's prompts served paged and contiguous with
    tokens equal to the in-memory tree's and launches per layer equal to
    phases 3 and 3c; the load's seconds, GB/s and peak RSS from a fresh
    process; (b) GPT-J-6B at 2 layers as an F16 ``.bin``, served through
    gptj_forward with the same checks; (c) save_checkpoint/load_checkpoint
    of (a)'s tree and of a 2-layer QLoRA run's 8-bit optimizer state, every
    leaf bit for bit and one more step after the reload equal to the
    uninterrupted one; (d) the host library built by g++ here against the
    card's quantizers; (e) legacy.igemm at the 7B shapes against exact
    products, research.matmul_fp8_mixed card against CPU. (f), the roofline
    report, runs in phase 2 (``roofline_11``)."""
    import shutil

    from bitsandbytes_sycl_tpu_torch import checkpoints as CK
    from bitsandbytes_sycl_tpu_torch.models.gptj import gptj_forward
    from bitsandbytes_sycl_tpu_torch.models.llama import _quantize_linear

    stats, seconds = {}, {}
    shutil.rmtree(PHASE11_DIR, ignore_errors=True)
    os.makedirs(PHASE11_DIR)
    try:
        # (a) Llama-2-7B width, 4 layers, bf16, two shards
        t0 = time.perf_counter()
        hf = dict(LLAMA2_7B_HF, num_hidden_layers=LLAMA_LAYERS)
        d = os.path.join(PHASE11_DIR, "llama2-7b-4l")
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf, f, indent=2)
        T = seeded_tensors(torch, llama_hf_shapes(hf), torch.bfloat16, seed=0)
        names = list(T)
        cut = names.index(f"model.layers.{LLAMA_LAYERS // 2}.self_attn.q_proj.weight")
        shards = {"model-00001-of-00002.safetensors": names[:cut],
                  "model-00002-of-00002.safetensors": names[cut:]}
        file_bytes = 0
        for fname, ns in shards.items():
            file_bytes += write_safetensors(torch, os.path.join(d, fname), {n: T[n] for n in ns})
        with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": file_bytes},
                       "weight_map": {n: fn for fn, ns in shards.items() for n in ns}}, f)
        write_s = time.perf_counter() - t0
        # a shell forks the loader (the command is not its last, so it forks
        # rather than execs): the loader's ru_maxrss then starts from the
        # shell's small RSS, not from this process's
        child = subprocess.run(["/bin/sh", "-c", '"$0" "$1" --load-rss "$2"; exit $?',
                                sys.executable, os.path.abspath(__file__), d],
                               capture_output=True, text=True, timeout=300)
        need(child.returncode == 0, f"[11a] the load in a fresh process failed:\n{child.stderr[-2000:]}")
        rss = json.loads(child.stdout.strip().splitlines()[-1])
        peak = rss["peak_rss"]
        t1 = time.perf_counter()
        cfg, loaded = CK.load_llama_from_hf(d, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        need(cfg.num_layers == LLAMA_LAYERS and cfg.hidden_size == 4096 and cfg.vocab_size == 32000,
             f"[11a] config read as {cfg}")
        # three weights against the CPU quantizer, bit for bit
        for name, leaf in (("model.layers.0.self_attn.q_proj.weight", loaded["layers"][0]["q_proj"]),
                           (f"model.layers.{LLAMA_LAYERS - 1}.mlp.down_proj.weight",
                            loaded["layers"][-1]["down_proj"]),
                           ("lm_head.weight", loaded["lm_head"])):
            want = _quantize_linear(T[name].float().cpu(), cfg)
            need(torch.equal(leaf.packed.cpu(), want.packed)
                 and torch.equal(leaf.absmax.cpu().view(torch.int16), want.absmax.view(torch.int16)),
                 f"[11a] {name}: the card's bytes differ from the CPU quantizer's")
        mem = llama_tree(T, cfg)
        n_leaves = need_same_tree(torch, mem, loaded, "[11a] loaded vs in-memory tree")
        serve_rows = {}
        for paged, ref in ((True, "paged"), (False, "contiguous")):
            runs = []
            for tree in (loaded, mem):
                reset_counts(kernels)
                outs, wall, steps = serve(torch, cfg, tree, prompts, 32, paged=paged)
                runs.append((outs, read_counts(kernels), wall, steps))
            need(runs[0][0] == runs[1][0], f"[11a] {ref}: the loaded tree's tokens differ from the"
                                           " in-memory tree's")
            counts, L, L3 = runs[0][1], cfg.num_layers, 32
            rc = ref_counts[ref]
            per_layer = {"w4a8_gemv": (counts["w4a8_gemv"] * (7 * L3 + 1),
                                       rc["w4a8_gemv"] * (7 * L + 1)),
                         "prefill_attn_int8": (counts["prefill_attn_int8"] * L3,
                                               rc["prefill_attn_int8"] * L)}
            att = "paged_attn_int8" if paged else "decode_attn_int8"
            per_layer[att] = (counts[att] * L3, rc[att] * L)
            for k, (a, b) in per_layer.items():
                need(a == b and counts[k] > 0, f"[11a] {ref}: {counts[k]} launches of {k} over"
                                               f" {L} layers against phase 3's {rc[k]} over {L3}")
            steps = sorted(runs[0][3])
            serve_rows[ref] = dict(launches={k: v for k, v in counts.items() if v}, wall_s=runs[0][2],
                                   decode_ms_per_step_median=steps[len(steps) // 2] * 1e3)
        stats["llama"] = dict(file_bytes=file_bytes, write_s=write_s, load_s=load_s,
                              load_gb_per_s=file_bytes / load_s / 1e9, fresh_process=rss,
                              fresh_load_gb_per_s=rss["file_bytes"] / rss["load_s"] / 1e9,
                              peak_rss_gb=peak / 1e9,
                              rss_over_baseline_gb=(peak - rss["rss_before"]) / 1e9,
                              rss_beyond_files_gb=(peak - rss["rss_before"] - file_bytes) / 1e9,
                              leaves_equal=n_leaves, serve=serve_rows)
        print(f"[11a] Llama-2-7B width, {LLAMA_LAYERS} layers, bf16 in two safetensors shards:"
              f" {file_bytes / 1e9:.2f} GB written in {write_s:.1f} s; loaded on the card in"
              f" {load_s:.2f} s ({file_bytes / load_s / 1e9:.2f} GB/s, warm page cache); a fresh"
              f" process {rss['load_s']:.2f} s ({stats['llama']['fresh_load_gb_per_s']:.2f} GB/s),"
              f" peak RSS {peak / 1e9:.2f} GB (ru_maxrss)"
              f" ({(peak - rss['rss_before']) / 1e9:.2f} GB over the"
              f" {rss['rss_before'] / 1e9:.2f} GB before the load: the mapped files'"
              f" {file_bytes / 1e9:.2f} GB and {stats['llama']['rss_beyond_files_gb']:.2f} GB more);"
              f" q_proj 0,"
              f" down_proj {LLAMA_LAYERS - 1} and lm_head equal the CPU quantizer's bytes;"
              f" {n_leaves} leaves equal the in-memory tree's; tokens paged and contiguous equal;"
              f" launches per layer as phase 3's: {json.dumps(serve_rows['paged']['launches'])}",
              flush=True)
        seconds["11a"] = time.perf_counter() - t0

        # (c) save_checkpoint / load_checkpoint: (a)'s tree, then a QLoRA run's optimizer
        t0 = time.perf_counter()
        stats["save_load"] = save_load_11(torch, cfg, loaded, kernels)
        seconds["11c"] = time.perf_counter() - t0
        del T, mem, loaded
        gc.collect()
        torch.cuda.empty_cache()

        # (b) GPT-J-6B width, 2 layers, F16 .bin through torch.save
        t0 = time.perf_counter()
        hfj = dict(GPTJ_6B_HF, n_layer=GPTJ_LAYERS)
        dj = os.path.join(PHASE11_DIR, "gpt-j-6b-2l")
        os.makedirs(dj)
        with open(os.path.join(dj, "config.json"), "w") as f:
            json.dump(hfj, f, indent=2)
        Tj = seeded_tensors(torch, gptj_hf_shapes(hfj), torch.float16, seed=1)
        torch.save({n: t.cpu() for n, t in Tj.items()}, os.path.join(dj, "pytorch_model.bin"))
        bin_bytes = os.path.getsize(os.path.join(dj, "pytorch_model.bin"))
        t1 = time.perf_counter()
        cfgj, loadedj = CK.load_gptj_from_hf(dj, device="cuda")
        torch.cuda.synchronize()
        loadj_s = time.perf_counter() - t1
        memj = gptj_tree(Tj, cfgj)
        nj = need_same_tree(torch, memj, loadedj, "[11b] loaded vs in-memory GPT-J tree")
        gj = {}
        for paged in (False, True):
            outs = []
            for tree in (loadedj, memj):
                reset_counts(kernels)
                o, wall, _ = serve(torch, cfgj, tree, prompts[:4], 16, paged=paged,
                                   forward_fn=gptj_forward)
                outs.append((o, read_counts(kernels)))
            mode = "paged" if paged else "contiguous"
            need(outs[0][0] == outs[1][0], f"[11b] GPT-J {mode}: the loaded tree's tokens differ")
            gj[mode] = {k: v for k, v in outs[0][1].items() if v}
            # head_dim 256: every prefill on C's tensor-core body, every decode
            # launch on the split body of D (paged) or H (contiguous)
            for counts in (gj[mode], outs[1][1]):
                need(counts.get("prefill_attn_int8", 0) > 0
                     and counts.get("prefill_attn_int8.tc", 0) == counts["prefill_attn_int8"],
                     f"[11b] GPT-J {mode}: prefill launches off C's tensor-core body ({counts})")
                dk = "paged_attn_int8" if paged else "decode_attn_int8"
                need(counts.get(dk, 0) > 0 and counts.get(f"{dk}.split", 0) == counts[dk],
                     f"[11b] GPT-J {mode}: decode launches off {dk}'s split body ({counts})")
        stats["gptj"] = dict(file_bytes=bin_bytes, load_s=loadj_s, leaves_equal=nj, launches=gj)
        print(f"[11b] GPT-J-6B width, {GPTJ_LAYERS} layers, F16 .bin ({bin_bytes / 1e9:.2f} GB):"
              f" loaded in {loadj_s:.2f} s; {nj} leaves equal the in-memory tree's; tokens paged"
              f" and contiguous equal; launches {json.dumps(gj)}", flush=True)
        del Tj, memj, loadedj
        gc.collect()
        torch.cuda.empty_cache()
        seconds["11b"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(PHASE11_DIR, ignore_errors=True)

    t0 = time.perf_counter()
    stats["native"] = native_11(torch)
    seconds["11d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats["legacy_research"] = legacy_research_11(torch)
    seconds["11e"] = time.perf_counter() - t0
    stats["seconds"] = seconds
    return stats


def save_load_11(torch, cfg, params, kernels):
    """Phase 11c: (a)'s quantized tree through save_checkpoint and
    load_checkpoint, every leaf bit for bit; then a QLoRA run on its first
    2 layers (rank 64 on all seven projections, adamw8bit): one step, the
    adapters and optimizer state saved and loaded, one more step from the
    loaded state equal, bit for bit, to the uninterrupted run's second."""
    from bitsandbytes_sycl_tpu_torch import checkpoints as CK
    from bitsandbytes_sycl_tpu_torch import optim
    from bitsandbytes_sycl_tpu_torch.models.lora import (ALL_TARGETS, init_lora, lora_leaves,
                                                          qlora_loss_fn)

    path = os.path.join(PHASE11_DIR, "tree.pt")
    t0 = time.perf_counter()
    CK.save_checkpoint(path, params)
    save_s = time.perf_counter() - t0
    tree_bytes = os.path.getsize(path)
    t0 = time.perf_counter()
    back = CK.load_checkpoint(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_tree = need_same_tree(torch, params, back, "[11c] the saved and loaded quantized tree")
    del back
    os.remove(path)

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = dict(params, layers=params["layers"][:2])
    lora = init_lora(cfg2, seed=2, rank=64, alpha=16.0, targets=ALL_TARGETS, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(1, cfg.vocab_size, (2, 129), generator=gen, device="cuda")
    loss_fn = qlora_loss_fn(p2, cfg2)

    def step(lo, opt):
        loss = loss_fn(lo, toks)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.item()

    opt = optim.adamw8bit(lora_leaves(lora), 2e-4, weight_decay=0.0)
    losses = [step(lora, opt)]
    path = os.path.join(PHASE11_DIR, "qlora.pt")
    CK.save_checkpoint(path, {"lora": lora, "opt": opt.state_dict()})
    saved_states = [{k: v.clone() for k, v in opt.state[p].items()} for p in lora_leaves(lora)]
    losses.append(step(lora, opt))
    back = CK.load_checkpoint(path, device="cuda")
    os.remove(path)
    lora_b = back["lora"]
    leaves_b = lora_leaves(lora_b)
    need(all(t.is_leaf and t.requires_grad for t in leaves_b),
         "[11c] the reloaded adapters are not trainable leaves")
    opt_b = optim.adamw8bit(leaves_b, 2e-4, weight_decay=0.0)
    opt_b.load_state_dict(back["opt"])
    n_states = 0
    for p, st in zip(leaves_b, saved_states):
        for k, v in st.items():
            need(opt_b.state[p][k].dtype == v.dtype and torch.equal(opt_b.state[p][k], v),
                 f"[11c] optimizer state {k} differs after the reload")
            n_states += 1
    need(opt_b.count == 1, f"[11c] the reloaded step count is {opt_b.count}")
    reset_counts(kernels)
    loss_b = step(lora_b, opt_b)
    j = read_counts(kernels)["optim8_2state"]
    need(loss_b == losses[1], f"[11c] the resumed loss {loss_b} differs from {losses[1]}")
    for a, b in zip(lora_leaves(lora), leaves_b):
        need(torch.equal(a.detach(), b.detach()), "[11c] an adapter leaf differs after the resumed step")
    for a, b in zip(lora_leaves(lora), leaves_b):
        for k, v in opt.state[a].items():
            need(torch.equal(v, opt_b.state[b][k]), f"[11c] optimizer state {k} differs after the"
                                                    " resumed step")
    need(j == 1, f"[11c] the resumed step launched J {j} times")
    out = dict(tree_bytes=tree_bytes, save_s=save_s, load_s=load_s, tree_leaves=n_tree,
               optimizer_states=n_states, losses=losses, resumed_loss=loss_b)
    print(f"[11c] save_checkpoint of the 4-layer quantized tree ({tree_bytes / 1e9:.2f} GB) in"
          f" {save_s:.2f} s, load_checkpoint in {load_s:.2f} s: {n_tree} leaves bit for bit; QLoRA"
          f" (2 layers, rank 64, adamw8bit): {n_states} optimizer states reloaded bit for bit, the"
          f" resumed step equals the uninterrupted one (loss {loss_b:.5f}, J once)", flush=True)
    return out


def native_11(torch):
    """Phase 11d: the host library built by g++ on this machine, then its
    4-bit quantizer on a 4096 x 11008 weight (NF4, blocksize 64) against
    the card's: the bnb-order bytes and absmax of functional.quantize_4bit,
    and, repacked to the kernel layout, quantize_4bit_native's (f32
    scales), byte for byte."""
    from bitsandbytes_sycl_tpu_torch import codebooks, functional, native
    from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native, to_kernel_layout
    from bitsandbytes_sycl_tpu_torch.types import QuantState

    build_s = native.build_native()
    gen = torch.Generator(device="cuda").manual_seed(11)
    N, K = 4096, 11008
    W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
    Wh = W.cpu().numpy()
    code = codebooks.get_4bit_type("nf4")
    t0 = time.perf_counter()
    packed, absmax = native.quantize_4bit_np(Wh, code, 64)
    host_ms = (time.perf_counter() - t0) * 1e3
    p_card, qs = functional.quantize_4bit(W, blocksize=64, quant_type="nf4")
    need(torch.equal(torch.from_numpy(packed), p_card.cpu())
         and torch.equal(torch.from_numpy(absmax), qs.absmax.cpu()),
         "[11d] the host library's bytes differ from functional.quantize_4bit on the card")
    kl = quantize_4bit_native(W, 64, "nf4", absmax_dtype=torch.float32)
    st = QuantState(absmax=torch.from_numpy(absmax), code=torch.from_numpy(code), shape=(N, K),
                    dtype="float32", blocksize=64, quant_type="nf4")
    mine = to_kernel_layout(torch.from_numpy(packed), st)
    need(torch.equal(mine.packed, kl.packed.cpu()) and torch.equal(mine.absmax, kl.absmax.cpu()),
         "[11d] the host library's bytes differ from quantize_4bit_native on the card")
    card_ms = time_cold(torch, lambda: quantize_4bit_native(W, 64, "nf4",
                                                            absmax_dtype=torch.float32), iters=5)
    print(f"[11d] host library built by g++ here in {build_s:.1f} s; quantize_4bit_np of"
          f" {N} x {K} (NF4, bs 64) in {host_ms:.1f} ms on the host, byte-equal to"
          f" functional.quantize_4bit and quantize_4bit_native ({card_ms:.2f} ms) on the card",
          flush=True)
    return dict(build_s=build_s, host_ms=host_ms, card_ms=card_ms, shape=[N, K])


def legacy_research_11(torch):
    """Phase 11e: legacy.igemm on the card at the 7B shapes (32 int8 rows,
    torch._int_mm) against the exact product (float64 on the card holds
    every int8 sum exactly; at 4096 x 4096 also int64 on the CPU), and
    batched_igemm; research.matmul_fp8_mixed on the card against the CPU:
    forward within the JAX tests' envelope (mean |error| < 0.115 against
    the f32 product) on both, and card against CPU within 1e-4 relative
    L2 (the same codes, another summation order), gradients too."""
    from bitsandbytes_sycl_tpu_torch import legacy, research

    gen = torch.Generator(device="cuda").manual_seed(12)
    M = 32
    shapes = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]
    for N, K in shapes:
        A = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
        B = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        got = legacy.igemm(A, B)
        want = (A.double() @ B.double()).long()
        need(got.dtype == torch.int32 and torch.equal(got.long(), want),
             f"[11e] igemm {M} x {K} x {N}: not the exact product")
        if (N, K) == (4096, 4096):
            need(torch.equal(got.cpu().long(), A.cpu().long() @ B.cpu().long()),
                 "[11e] igemm 4096 x 4096: not the CPU's int64 product")
            igemm_ms = time_cold(torch, lambda: legacy.igemm(A, B))
    Ab = torch.randint(-127, 128, (4, 64, 512), generator=gen, device="cuda", dtype=torch.int8)
    Bb = torch.randint(-127, 128, (4, 512, 256), generator=gen, device="cuda", dtype=torch.int8)
    need(torch.equal(legacy.batched_igemm(Ab, Bb).cpu(), legacy.batched_igemm(Ab.cpu(), Bb.cpu())),
         "[11e] batched_igemm: card and CPU differ")
    m, k, n = 64, 4096, 4096
    A = torch.randn((m, k), generator=gen, device="cuda")
    B = torch.randn((k, n), generator=gen, device="cuda") * (2.0 / (k + n)) ** 0.5
    outs = {}
    for dev in ("cuda", "cpu"):
        a = A.detach().to(dev).requires_grad_()
        b = B.detach().to(dev).requires_grad_()
        out = research.matmul_fp8_mixed(a, b)
        out.square().mean().backward()
        ref = a.detach() @ b.detach()
        outs[dev] = (out.detach().cpu(), a.grad.cpu(), b.grad.cpu(),
                     float((out.detach() - ref).abs().mean()))
    g, c = outs["cuda"], outs["cpu"]
    need(g[3] < 0.115 and c[3] < 0.115, f"[11e] fp8 mixed forward mean error {g[3]} / {c[3]} >= 0.115")
    rels = [float((x - y).norm() / y.norm()) for x, y in zip(g[:3], c[:3])]
    need(max(rels) <= 1e-4, f"[11e] fp8 mixed card vs CPU relative L2 {rels} > 1e-4")
    print(f"[11e] igemm at the four 7B shapes ({M} rows) exact ({igemm_ms * 1e3:.1f} us at 4096 x 4096);"
          f" batched_igemm card = CPU; fp8 mixed forward mean error {g[3]:.4f} (card) /"
          f" {c[3]:.4f} (CPU), card vs CPU relative L2 out/gradA/gradB {rels}", flush=True)
    return dict(igemm_us=igemm_ms * 1e3, fp8_mean_err_card=g[3], fp8_mean_err_cpu=c[3],
                fp8_card_vs_cpu_rel_l2=rels)


def roofline_11(torch, report):
    """Phase 11f: profiling.roofline_report of kernel A (fused body) at
    4096 x 4096, M = 4, NF4 bs 64 with bf16 scales (phase 2's setting),
    cold (L2 flushed before every call, the flushes' own loop
    subtracted). Its time must be within 10% of A's own duration on the
    device's clock (torch.profiler, through profiling.trace, the median
    over 100 cold calls) and no more than phase 2's cold time for A at that
    shape, which adds time_cold's event floor (the gap between the start
    event and the kernel, measured at 3.6 us here); its HBM fraction
    below 1.05; current_chip() the H100 entry."""
    import statistics

    from bitsandbytes_sycl_tpu_torch import profiling
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8
    from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native

    chip = profiling.current_chip()
    need(chip.name == "H100", f"[11f] current_chip() gave {chip}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    M, N, K = 4, 4096, 4096
    W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
    w = quantize_4bit_native(W, 64, "nf4", absmax_dtype=torch.bfloat16)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)

    def op(x, w):
        return matmul_w4a8.w4a8_gemv(x, w, None, torch.bfloat16)

    nbytes = M * K * 2 + N * K // 2 + N * K // 64 * 2 + M * N * 2
    r = profiling.roofline_report("w4a8_gemv 4096x4096 M=4", op, x, w, flops=2.0 * M * N * K,
                                  bytes_accessed=nbytes, cold=True)
    warm = profiling.device_time(op, x, w) * 1e6
    flush = torch.empty(96 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    # a profiler started after others stopped has missed the first launches
    # of its window (phase 7b): a spin kernel first, then 100 cold calls
    with profiling.trace() as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(100):
            flush.zero_()
            op(x, w)
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "w4a8_fused" in e.name]
    need(len(durs) >= 30, f"[11f] the trace holds {len(durs)} of 100 launches of A's fused body")
    kernel_us = statistics.median(durs)
    phase2 = next(row["ms"] for row in report["w4a8_gemv"]["shapes"]
                  if (row["N"], row["K"], row["M"]) == (N, K, M) and "ms" in row) * 1e3
    print(f"[11f] roofline_report of A at 4096 x 4096, M = 4 on {chip.name}: {r['time_us']:.2f} us"
          f" cold ({r['achieved_gbps']:.0f} GB/s = {r['frac_hbm_roofline']:.1%} of HBM); A's"
          f" duration on the device's clock {kernel_us:.2f} us (median of {len(durs)} traced cold"
          f" calls); phase 2's"
          f" cold time {phase2:.2f} us with time_cold's event floor; warm back to back"
          f" {warm:.2f} us", flush=True)
    need(abs(r["time_us"] - kernel_us) <= 0.1 * kernel_us,
         f"[11f] roofline time {r['time_us']:.2f} us is not within 10% of A's traced {kernel_us:.2f} us")
    need(r["time_us"] <= phase2,
         f"[11f] roofline time {r['time_us']:.2f} us over phase 2's {phase2:.2f}")
    need(r["frac_hbm_roofline"] < 1.05, f"[11f] HBM fraction {r['frac_hbm_roofline']}")
    return dict(r, phase2_us=phase2, traced_kernel_us=kernel_us, traced_calls=len(durs),
                warm_us=warm)


def manager_7b(torch, cfg, params, kernels, steps=3):
    """Phase 10o: GlobalOptimManager over phase 7's 7B QLoRA adapters (rank
    64 on all seven projections), the o_proj adapters overridden to 32-bit
    states: J launches once a step for the one 8-bit group configuration,
    the overridden and scalar leaves take the batched 32-bit update."""
    from bitsandbytes_sycl_tpu_torch import optim
    from bitsandbytes_sycl_tpu_torch.models.lora import ALL_TARGETS, init_lora, qlora_loss_fn

    lora = init_lora(cfg, seed=1, rank=64, alpha=16.0, targets=ALL_TARGETS)
    mgr = optim.GlobalOptimManager()
    mgr.register_module_override("o_proj", optim_bits=32)
    opt = mgr.build("adam", lora, optim_bits=8, learning_rate=2e-4)
    n8 = sum(p.numel() >= 4096 and "o_proj" not in path for path, p in mgr._paths(lora))
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(1, cfg.vocab_size, (4, 513), generator=gen, device="cuda")
    loss_fn = qlora_loss_fn(params, cfg)
    rows = []
    for i in range(steps):
        routes = dict(opt.route_leaves)
        lv, ms, counts, _ = qlora_step(torch, kernels, loss_fn, lora, tokens, opt)
        routes = {k: v - routes[k] for k, v in opt.route_leaves.items()}
        need(lv == lv and abs(lv) != float("inf"), f"[10o] step {i + 1}: loss {lv}")
        need(counts.get("optim8_2state") == 1 and routes["grouped"] == n8,
             f"[10o] step {i + 1}: {counts.get('optim8_2state')} launches of J for {routes}; expected"
             f" one launch for the {n8} 8-bit leaves of the one 8-bit group configuration")
        rows.append(dict(step=i + 1, loss=lv, **ms, leaves_by_route=routes,
                         launches={k: v for k, v in counts.items() if v}))
    wrong = [path for path, p in mgr._paths(lora) if path.endswith(("/A", "/B"))
             and (opt.state[p]["state1"].dtype == torch.float32) != ("o_proj" in path)]
    need(not wrong, f"[10o] the states of {wrong[:4]} have the other width")
    print(f"[10o] GlobalOptimManager on the 7B QLoRA adapters, o_proj overridden to 32-bit:"
          f" {steps} steps, losses {[round(r['loss'], 5) for r in rows]}, J once a step over"
          f" {n8} leaves; leaves by route {rows[-1]['leaves_by_route']}", flush=True)
    del opt, lora
    return dict(steps=rows, eight_bit_leaves=n8)


# --------------------------------------------------------------- phase 12
PHASE12_DIR = os.path.join(ROOT, "chiprun_out", "phase12")  # the ranks' logs and summaries
PHASE12_WORK = os.path.join(ROOT, "build", "phase12")  # the store and the ranks' tensors
TP_WORLD = 2
TP_CHILD_TIMEOUT_S = 600
TWO_RANKS = "two ranks time-sharing one H100 over gloo, not a multi-GPU figure"
# TP = 2 against one device, Llama-7B NF4 with W4A8 decode at 32 layers:
# each row-parallel rank quantizes its own activation slice (as the JAX
# package does) and the partial sums are rounded to bf16 before the
# all-reduce, so the logits move by up to 6.1% of the largest (an H100,
# tools/torch_tp_vs_one_device.py: 3.7% at 2 layers, 4.9% at 8; 2.3% at 32
# on the exact path). Tokens of the two may part only where phase 3's
# top-2 gap is within this limit; the TP runs among themselves keep phase
# 5's 5%.
TP_GAP = 0.10
TP_NEW_TOKENS = 16  # of phase 3's 32 a prompt, to keep phase 12 near two minutes


def sharded_a_12b(torch, layer):
    """Kernel A at the local shapes of a TP = 2 rank's layer (q_proj and
    gate_proj column shards, o_proj and down_proj retiled row shards) and
    4 rows, against its plain version within 1% of the largest output,
    with the lo plane's scales on the hi plane as the fault."""
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as mw

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name in ("q_proj", "gate_proj", "o_proj", "down_proj"):
        w = layer[name]
        N, K = w.shape
        x = torch.randn((4, K), generator=gen, device="cuda").to(torch.bfloat16)
        n0 = mw.w4a8_gemv.launches
        got, ref = mw.w4a8_gemv(x, w, None, torch.bfloat16), mw._w4a8_plain(x, w, None,
                                                                             torch.bfloat16)
        torch.cuda.synchronize()
        need(mw.w4a8_gemv.launches == n0 + 1, f"[12b] {name}: kernel A did not launch once")
        err, scale = max_err(torch, got, ref)
        tol = 1e-2 * scale
        need(err <= tol, f"[12b] A at the {name} shard N={N} K={K}: max err {err} > {tol}")
        w_bad = dataclasses.replace(w, absmax=w.absmax[1:].expand(2, -1, -1).contiguous())
        fault = faults_exceed(torch, f"[12b] A at the {name} shard", ref, [
            ("the lo plane's scales on the hi plane",
             lambda: mw._w4a8_plain(x, w_bad, None, torch.bfloat16))], tol)
        rows.append(dict(name=name, N=N, K=K, M=4, max_abs_err=err, tol=tol,
                         fault_over_tol=fault))
    return rows


def tp_step_counts(torch, cfg, params, prompts, kernels, paged, mesh, profile=False):
    """The kernel launches and all-reduces of one decode step of the TP
    engine with 4 requests in flight; with ``profile``, also the NCCL
    kernels the profiler saw in it."""
    import contextlib

    from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
    from bitsandbytes_sycl_tpu_torch.parallel.mesh import psum

    eng = InferenceEngine(cfg, params, EngineConfig(max_batch=4, paged=paged, max_new_tokens=8),
                          device="cuda", mesh=mesh)
    eng.add_requests(prompts[:4])
    torch.cuda.synchronize()
    reset_counts(kernels)
    psum.calls = 0
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) \
        if profile else contextlib.nullcontext()
    with prof:
        eng.step()
        torch.cuda.synchronize()
    out = dict(read_counts(kernels), all_reduces=psum.calls)
    if profile:
        out["nccl_kernels"] = sum(e.count for e in prof.key_averages() if "nccl" in e.key.lower())
    return out


def twelve_c_tokens(torch, vocab):
    """Two phase-3 prompts padded to 32 tokens, as phases 5 and 10 feed them."""
    return torch.tensor([p + [0] * (32 - len(p)) for p in prompts_from_seed(1, 2, vocab)])


def prefill_logits(torch, fwd, cfg, params, device, cache_cfg=None):
    """The last position's logits of twelve_c_tokens through ``fwd``."""
    return forward_steps(torch, fwd, cfg, params, twelve_c_tokens(torch, cfg.vocab_size), device,
                         steps=0, cache_cfg=cache_cfg)[0]


def tp_serve_12b(torch, kernels, mesh):
    """A rank of phase 12b: Llama-7B NF4 at full width and depth, TP = 2,
    phase 3's weights and prompts through the paged and the contiguous
    engine, TP_NEW_TOKENS a prompt (per-request logits of the paged run
    kept); kernel A at the
    rank's shapes against its plain version; the TP prefill logits of
    phase 5's two prompts."""
    import functools

    from bitsandbytes_sycl_tpu_torch.models.llama import LlamaConfig, init_params
    from bitsandbytes_sycl_tpu_torch.parallel import llama_forward_tp, shard_llama_params
    from bitsandbytes_sycl_tpu_torch.parallel.llama_tp import local_config
    from bitsandbytes_sycl_tpu_torch.parallel.mesh import psum

    cfg = LlamaConfig.llama7b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")  # phase 3's tree
    local = shard_llama_params(params, cfg, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out = {"init_shard_s": time.perf_counter() - t0,
           "local_gb": torch.cuda.memory_allocated() / 1e9,
           "a_checks": sharded_a_12b(torch, local["layers"][0]),
           "prefill_logits": prefill_logits(
               torch, functools.partial(llama_forward_tp, mesh=mesh, axis="model"), cfg, local,
               "cuda", local_config(cfg, TP_WORLD))}
    prompts = prompts_from_seed(0, 8, cfg.vocab_size)
    for mode, paged in (("paged", True), ("contiguous", False)):
        reset_counts(kernels)
        psum.calls = 0
        rec = {} if paged else None
        outs, wall, steps = serve(torch, cfg, local, prompts, TP_NEW_TOKENS, paged=paged,
                                  mesh=mesh, per_request=rec)
        counts = dict(read_counts(kernels), all_reduces=psum.calls)
        steps = sorted(steps)
        out[mode] = dict(outs=outs, logits=rec, wall_s=wall, decode_steps=len(steps),
                         decode_ms_per_step_median=steps[len(steps) // 2] * 1e3, launches=counts,
                         step_launches=tp_step_counts(torch, cfg, local, prompts, kernels, paged,
                                                      mesh))
    return out


def twelve_c_models(torch):
    """(key, config, init, seed, shard, TP forward) of phase 12c: 2 layers
    at the published widths."""
    from bitsandbytes_sycl_tpu_torch import models as M
    from bitsandbytes_sycl_tpu_torch import parallel as P

    llama = (P.shard_llama_params, P.llama_forward_tp)
    return [
        ("LLM.int8 Llama-7B", M.LlamaConfig.llama7b(quant="int8", num_layers=2), M.init_params,
         3) + llama,
        ("Mixtral-8x7B EP", M.MixtralConfig(num_layers=2), M.init_params, 4) + llama,
        ("GPT-J-6B", M.GPTJConfig(num_layers=2), M.init_gptj_params, 5, P.shard_gptj_params,
         P.gptj_forward_tp),
        ("OPT-6.7B", M.OPTConfig(num_layers=2, num_heads=32), M.init_opt_params, 6,
         P.shard_opt_params,
         P.opt_forward_tp),
        ("BLOOM-7B1", M.BloomConfig(num_layers=2), M.init_opt_params, 7, P.shard_opt_params,
         P.opt_forward_tp),
    ]


def close_logits(torch, label, got, want, rel_tol=4e-2, max_tol=5e-2, gap=5e-2):
    """Phase 5's limits by default: relative L2 <= 4%, max err <= 5% of the
    largest logit, and each row's greedy token under the gap rule."""
    need(torch.isfinite(got).all().item(), f"{label}: non-finite logits")
    rel = float((got - want).norm() / want.norm())
    err, mag = max_err(torch, got, want)
    need(rel <= rel_tol and err <= max_tol * mag,
         f"{label}: relative L2 {rel} (tol {rel_tol}), max err {err} (tol {max_tol * mag})")
    compared = greedy_agree([[int(w.argmax())] for w in want], [[w] for w in want],
                            [[int(g.argmax())] for g in got], label, rel=gap)
    return dict(rel_l2=rel, max_err=err, tol=max_tol * mag, tokens_compared_equal=compared)


RING_SHAPE = (1, 4096, 32, 128)  # S = 4096 at Llama-7B's heads, f32
RING_TOL = 1e-4  # of the largest output: f32 matmuls, card against CPU


def qlora_leaves_12c(torch, cfg, rank=64):
    """Phase 7b's 448 QLoRA leaves (A (64, K) and B (N, 64) of the seven
    projections of every layer), seeded, and one gradient each."""
    from bitsandbytes_sycl_tpu_torch.models.llama import _fp_layer_shapes

    gen = torch.Generator(device="cuda").manual_seed(21)
    shapes = []
    for _ in range(cfg.num_layers):
        for N, K in _fp_layer_shapes(cfg).values():
            shapes += [(rank, K), (N, rank)]
    ps = [torch.randn(s, generator=gen, device="cuda") * 0.02 for s in shapes]
    gs = [torch.randn(s, generator=gen, device="cuda") * 1e-3 for s in shapes]
    return ps, gs


def sharded_adamw_12c(torch, mesh, steps=2):
    """adamw8bit over the QLoRA leaf table with its states sharded over the
    2 ranks (mesh dim "data") against the unsharded optimizer in this
    process: every param and every state row bit for bit, one J launch a
    step."""
    from bitsandbytes_sycl_tpu_torch import optim
    from bitsandbytes_sycl_tpu_torch.models.llama import LlamaConfig
    from bitsandbytes_sycl_tpu_torch.ops.optim8 import optim8_2state

    ps, gs = qlora_leaves_12c(torch, LlamaConfig.llama7b())
    whole = [p.clone() for p in ps]
    sh = [p.clone() for p in ps]
    o1 = optim.adamw8bit(whole, 2e-4, weight_decay=0.0)
    o2 = optim.adamw8bit(sh, 2e-4, weight_decay=0.0, mesh=mesh, shard_axis="data")
    launches = []
    for _ in range(steps):
        for a, b, g in zip(whole, sh, gs):
            a.grad, b.grad = g, g.clone()
        o1.step()
        n0 = optim8_2state.launches
        o2.step()
        torch.cuda.synchronize()
        launches.append(optim8_2state.launches - n0)
    r = mesh.get_local_rank("data")
    for i, (a, b) in enumerate(zip(whole, sh)):
        need(bits_equal(torch, a, b), f"[12c] sharded adamw8bit: leaf {i}'s params differ")
        rows = a.shape[0] // TP_WORLD
        for name in ("state1", "state2"):
            need(torch.equal(o2.state[b][name], o1.state[a][name][r * rows:(r + 1) * rows]),
                 f"[12c] sharded adamw8bit: leaf {i}'s {name} codes differ from the unsharded")
    need(all(n == 1 for n in launches), f"[12c] sharded adamw8bit: J launches a step {launches}")
    return dict(leaves=len(ps), steps=steps, j_launches_per_step=launches,
                sharded_leaves=sum(o2.sharded(p) for p in sh),
                state_bytes_per_rank=sum(o2.state[b]["state1"].numel() * 2 for b in sh))


def tp_more_12c(torch, kernels, mesh):
    """A rank of phase 12c, each path on the card and the same path on the
    CPU (the plain versions, over the same gloo world), 2 layers at
    published widths: the TP forwards of twelve_c_models (a prefill of two
    prompts) under phase 5's limits, the pipeline (2 stages, 2
    microbatches), ring attention at S = 4096 within RING_TOL, and the
    sharded adamw8bit update bit for bit against the unsharded one."""
    import functools

    from bitsandbytes_sycl_tpu_torch import parallel as P
    from bitsandbytes_sycl_tpu_torch.models.llama import LlamaConfig, init_params
    from bitsandbytes_sycl_tpu_torch.parallel.llama_tp import local_config

    out = {}
    for key, cfg, init, seed, shard, fwd_tp in twelve_c_models(torch):
        t0 = time.perf_counter()
        local = shard(init(cfg, seed=seed, device="cuda"), cfg, mesh)
        gc.collect()
        fwd = functools.partial(fwd_tp, mesh=mesh, axis="model")
        kv = local_config(cfg, TP_WORLD)
        reset_counts(kernels)
        card = prefill_logits(torch, fwd, cfg, local, "cuda", kv)
        torch.cuda.synchronize()
        counts = read_counts(kernels)
        t1 = time.perf_counter()
        cpu = prefill_logits(torch, fwd, cfg, to_cuda(torch, local, "cpu"), "cpu", kv)
        row = close_logits(torch, f"[12c] {key} card vs CPU", card, cpu)
        out[key] = dict(row, launches=counts, card_s=t1 - t0, cpu_s=time.perf_counter() - t1)
        del local
        gc.collect()
        torch.cuda.empty_cache()
    # the pipeline: Llama-7B width, 2 layers, one a stage, 2 microbatches
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama7b(num_layers=2)
    stage_mesh = P.make_mesh({"stage": TP_WORLD})
    layers, rest = P.stack_stage_params(init_params(cfg, seed=8, device="cuda"), cfg, TP_WORLD,
                                        stage_mesh)
    gc.collect()
    toks = twelve_c_tokens(torch, cfg.vocab_size)
    reset_counts(kernels)
    card = P.llama_forward_pp(layers, rest, cfg, toks.cuda(), stage_mesh, n_micro=2)[:, -1]
    counts = read_counts(kernels)
    t1 = time.perf_counter()
    cpu = P.llama_forward_pp(to_cuda(torch, layers, "cpu"), to_cuda(torch, rest, "cpu"), cfg, toks,
                             stage_mesh, n_micro=2)[:, -1]
    out["pipeline 2 x 1 layer"] = dict(close_logits(torch, "[12c] pipeline card vs CPU",
                                                    card.float().cpu(), cpu),
                                       launches=counts, card_s=t1 - t0,
                                       cpu_s=time.perf_counter() - t1)
    del layers, rest
    gc.collect()
    torch.cuda.empty_cache()
    # ring attention over the 2 ranks: this rank's 2048 positions, f32
    t0 = time.perf_counter()
    sp_mesh = P.make_mesh({"sp": TP_WORLD})
    r, chunk = sp_mesh.get_local_rank("sp"), RING_SHAPE[1] // TP_WORLD
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = (torch.randn(RING_SHAPE, generator=gen, device="cuda")[:, r * chunk:(r + 1) * chunk]
               for _ in range(3))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    card = P.ring_attention(q, k, v, sp_mesh, axis="sp")
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t1
    cpu = P.ring_attention(q.cpu(), k.cpu(), v.cpu(), sp_mesh, axis="sp")
    err, mag = max_err(torch, card.cpu(), cpu)
    need(err <= RING_TOL * mag, f"[12c] ring attention card vs CPU: max err {err} > "
                                f"{RING_TOL * mag}")
    out["ring"] = dict(max_err=err, tol=RING_TOL * mag, ring_s=ring_s,
                       seconds=time.perf_counter() - t0)
    del q, k, v, card, cpu
    t0 = time.perf_counter()
    out["adamw8bit"] = sharded_adamw_12c(torch, P.make_mesh({"data": TP_WORLD}))
    out["adamw8bit"]["seconds"] = time.perf_counter() - t0
    return out


def tp_child_main(rank, world, out_dir) -> int:
    """One rank of phases 12b and 12c (``chip_smoke.py --tp-rank RANK WORLD
    DIR``): a gloo world of ``world`` processes on cuda:0, joined through
    DIR/store; the results go to DIR/rank<RANK>.pt (tensors) and, numbers
    only, to PHASE12_DIR/rank<RANK>.json, the log to the file the parent
    gave this process's output. Nothing is built here: the parent's phase
    1 built the kernels, which this process loads. Checks that fail raise,
    and the process exits non-zero."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from bitsandbytes_sycl_tpu_torch import parallel as P
    from bitsandbytes_sycl_tpu_torch.ops import KERNELS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
                            rank=rank, world_size=world)
    try:
        mesh = P.make_mesh({"model": world})
        t0 = time.perf_counter()
        res = {"12b": tp_serve_12b(torch, KERNELS, mesh)}
        res["12b"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["12c"] = tp_more_12c(torch, KERNELS, mesh)
        res["12c"]["seconds"] = time.perf_counter() - t0
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        with open(os.path.join(PHASE12_DIR, f"rank{rank}.json"), "w") as f:
            json.dump(res, f, indent=1, default=lambda o: None if isinstance(o, torch.Tensor)
                      else str(o))
    finally:
        dist.destroy_process_group()
    print(f"rank {rank}: done", flush=True)
    return 0


def nccl_world1_12a(torch, cfg, prompts, refs, kernels):
    """Phase 12a: NCCL at world size 1 in this process (FileStore): phase
    3's tree through shard_llama_params on make_mesh({"model": 1}), phase
    3's prompts through the paged and the contiguous TP engine; tokens
    equal to phases 3 and 3c bit for bit (the retile and the all-reduce
    are the identity at TP = 1) and A, C, D and H launches equal, and one
    decode step's all-reduces (2 a layer) and NCCL kernels counted. Also
    the single device's prefill logits of phase 5's two prompts, for 12b."""
    import torch.distributed as dist

    from bitsandbytes_sycl_tpu_torch.models.llama import init_params, llama_forward
    from bitsandbytes_sycl_tpu_torch.parallel import make_mesh, shard_llama_params
    from bitsandbytes_sycl_tpu_torch.parallel.mesh import psum

    os.makedirs(PHASE12_DIR, exist_ok=True)
    os.makedirs(PHASE12_WORK, exist_ok=True)
    store_path = os.path.join(PHASE12_WORK, "store_nccl")
    if os.path.exists(store_path):
        os.remove(store_path)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, 1), rank=0, world_size=1)
    stats = {}
    try:
        mesh = make_mesh({"model": 1})
        params = init_params(cfg, seed=0, device="cuda")
        stats["single_device_logits"] = prefill_logits(torch, llama_forward, cfg, params, "cuda")
        local = shard_llama_params(params, cfg, mesh)
        del params
        gc.collect()
        for mode, paged, ref_outs, ref_counts, attn in (
                ("paged", True, refs["paged_outs"], refs["paged_counts"], "paged_attn_int8"),
                ("contiguous", False, refs["contiguous_outs"], refs["contiguous_counts"],
                 "decode_attn_int8")):
            reset_counts(kernels)
            psum.calls = 0
            outs, wall, steps = serve(torch, cfg, local, prompts, 32, paged=paged, mesh=mesh)
            counts = read_counts(kernels)
            need(outs == ref_outs, f"[12a] NCCL world 1, {mode}: tokens differ from phase "
                                   f"{'3' if paged else '3c'}'s")
            for k in ("w4a8_gemv", "prefill_attn_int8", attn):
                need(counts[k] == ref_counts[k],
                     f"[12a] {mode}: {k} launched {counts[k]} times, phase "
                     f"{'3' if paged else '3c'} {ref_counts[k]}")
            step = tp_step_counts(torch, cfg, local, prompts, kernels, paged, mesh, profile=True)
            need(step["all_reduces"] == 2 * cfg.num_layers,
                 f"[12a] {mode}: {step['all_reduces']} all-reduces a decode step")
            nccl = step["nccl_kernels"]
            steps = sorted(steps)
            stats[mode] = dict(wall_s=wall, decode_steps=len(steps),
                               decode_ms_per_step_median=steps[len(steps) // 2] * 1e3,
                               launches=counts, all_reduces=psum.calls, step_launches=step)
            print(f"[12a] NCCL world 1, TP engine {mode}: {sum(map(len, outs))} tokens equal to"
                  f" phase {'3' if paged else '3c'}'s bit for bit, A/C/{attn[0].upper()} launches"
                  f" equal ({counts['w4a8_gemv']}/{counts['prefill_attn_int8']}/{counts[attn]});"
                  f" a decode step: {step['all_reduces']} all-reduces, {nccl} NCCL kernels"
                  f" (none: one rank), A {step['w4a8_gemv']}, {attn} {step[attn]}; median"
                  f" {stats[mode]['decode_ms_per_step_median']:.2f} ms/step", flush=True)
        del local
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return stats


def parallel_12(torch, cfg, prompts, refs, kernels):
    """Phase 12: 12a in this process, then 12b and 12c in a gloo world of
    two child processes on cuda:0 (spawned after phase 1 built the
    kernels, which they load). A child that fails or outlives
    TP_CHILD_TIMEOUT_S fails the phase."""
    stats, seconds = {}, {}
    t0 = time.perf_counter()
    stats["12a"] = nccl_world1_12a(torch, cfg, prompts, refs, kernels)
    one = stats["12a"].pop("single_device_logits")
    seconds["12a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in ["store"] + [f"rank{r}.pt" for r in range(TP_WORLD)]:
        if os.path.exists(os.path.join(PHASE12_WORK, name)):
            os.remove(os.path.join(PHASE12_WORK, name))
    logs = [os.path.join(PHASE12_DIR, f"rank{r}.log") for r in range(TP_WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="4")
    procs = []
    for r in range(TP_WORLD):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank",
                                           str(r), str(TP_WORLD), PHASE12_WORK], stdout=log,
                                          stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    try:
        rcs = [p.wait(timeout=max(1.0, t0 + TP_CHILD_TIMEOUT_S - time.perf_counter()))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = ""
    for r in range(TP_WORLD):
        with open(logs[r]) as log:
            tails += f"--- rank {r} ---\n" + log.read()[-3000:] + "\n"
    need(rcs is not None, f"[12] the ranks outlived {TP_CHILD_TIMEOUT_S} s:\n{tails}")
    need(rcs == [0] * TP_WORLD, f"[12] the ranks exited {rcs}:\n{tails}")
    res = [torch.load(os.path.join(PHASE12_WORK, f"rank{r}.pt"), weights_only=False)
           for r in range(TP_WORLD)]
    for name in ["store"] + [f"rank{r}.pt" for r in range(TP_WORLD)]:
        if os.path.exists(os.path.join(PHASE12_WORK, name)):
            os.remove(os.path.join(PHASE12_WORK, name))
    seconds["12bc_ranks"] = time.perf_counter() - t0
    # 12b: A at the shard shapes ran in each rank; the TP logits and tokens here
    b = [r["12b"] for r in res]
    need(all(torch.equal(r["prefill_logits"], b[0]["prefill_logits"]) for r in b),
         "[12b] the ranks' logits differ")
    envelope = close_logits(torch, "[12b] TP = 2 vs one device, 32 layers",
                            b[0]["prefill_logits"], one, rel_tol=TP_GAP, max_tol=TP_GAP,
                            gap=TP_GAP)
    stats["12b"] = {"ranks": [{k: v for k, v in r.items()
                               if k not in ("paged", "contiguous", "prefill_logits")} for r in b],
                    "tp_vs_one_device": envelope}
    print(f"[12b] TP = 2 Llama-7B NF4 prefill logits (32 layers, phase 5's prompts) against one"
          f" device: relative L2 {envelope['rel_l2']:.4f}, max err {envelope['max_err']:.4g} of"
          f" {envelope['tol'] / TP_GAP:.4g} (limit {TP_GAP:.0%} of the largest, W4A8 local"
          " activation scales in the row-parallel layers)", flush=True)
    for mode in ("paged", "contiguous"):
        need(all(r[mode]["outs"] == b[0][mode]["outs"] for r in b),
             f"[12b] {mode}: the ranks generated different tokens")
        compared = greedy_agree(refs["paged_outs"], refs["paged_logits"], b[0][mode]["outs"],
                                f"[12b] TP = 2 {mode} vs phase 3", rel=TP_GAP)
        among = None
        if mode == "contiguous":  # the two TP runs: phase 5's 5%, as 3c against 3
            among = greedy_agree(b[0]["paged"]["outs"], b[0]["paged"]["logits"],
                                 b[0][mode]["outs"], "[12b] TP = 2 contiguous vs TP paged")
        step = b[0][mode]["step_launches"]
        need(step["all_reduces"] == 2 * cfg.num_layers,
             f"[12b] {mode}: {step['all_reduces']} all-reduces a decode step")
        need(step["w4a8_gemv"] == step.get("w4a8_gemv.fused") == 7 * cfg.num_layers + 1,
             f"[12b] {mode}: kernel A launched {step['w4a8_gemv']} times a decode step")
        need_new_bodies(b[0][mode]["launches"], f"[12b] {mode}", decode=mode == "paged")
        stats["12b"][mode] = dict(tokens_compared_equal=compared, tokens_equal_to_tp_paged=among,
                                  **{k: [r[mode][k] for r in b] for k in (
                                      "wall_s", "decode_steps", "decode_ms_per_step_median",
                                      "launches", "step_launches")})
        routes = {k: v for k, v in b[0][mode]["launches"].items() if k.startswith("write_and")}
        print(f"[12b] TP = 2 Llama-7B NF4 {mode}, 32 layers: {sum(map(len, b[0][mode]['outs']))}"
              f" tokens, the same on both ranks, {compared} greedy tokens equal to phase 3's under"
              f" the {TP_GAP:.0%} gap rule" + ("" if among is None else
                                            f", {among} to the TP paged run's under 5%")
              + f"; a decode step per rank: {step['all_reduces']} all-reduces, A"
              f" {step['w4a8_gemv']} (fused {step['w4a8_gemv.fused']}), C"
              f" {step['prefill_attn_int8']}, D {step['paged_attn_int8']}, H"
              f" {step['decode_attn_int8']}; route counters {routes}; median ms/step per rank"
              f" {[round(r[mode]['decode_ms_per_step_median'], 2) for r in b]} ({TWO_RANKS})",
              flush=True)
    for r, rank in enumerate(b):
        print(f"[12b] rank {r}: A at its shard shapes within 1% of its plain version, the fault"
              f" outside: " + ", ".join(f"{a['name']} {a['N']}x{a['K']} err {a['max_abs_err']:.3g}"
                                        f" (tol {a['tol']:.3g}, fault {a['fault_over_tol']:.1f}x)"
                                        for a in rank["a_checks"])
              + f"; local weights {rank['local_gb']:.2f} GB, init and shard"
              f" {rank['init_shard_s']:.1f} s", flush=True)
    # 12c: every check ran in the ranks (card against the same path on the CPU)
    c = [r["12c"] for r in res]
    stats["12c"] = c
    for key, row in c[0].items():
        if key in ("seconds", "ring", "adamw8bit"):
            continue
        print(f"[12c] {key} (TP/EP/PP over 2 ranks), card vs CPU: relative L2"
              f" {row['rel_l2']:.3g} (tol 0.04), max err {row['max_err']:.4g} (tol"
              f" {row['tol']:.4g}); launches per rank"
              f" {dict((k, v) for k, v in row['launches'].items() if v)}; card"
              f" {row['card_s']:.1f} s, CPU {row['cpu_s']:.1f} s ({TWO_RANKS})", flush=True)
    ring = c[0]["ring"]
    print(f"[12c] ring attention, S = 4096, 32 heads over 2 ranks (f32): card vs CPU max err"
          f" {ring['max_err']:.3g} (tol {ring['tol']:.3g}); the card's ring"
          f" {[round(r['ring']['ring_s'], 3) for r in c]} s per rank ({TWO_RANKS})", flush=True)
    a = c[0]["adamw8bit"]
    print(f"[12c] sharded adamw8bit over the {a['leaves']}-leaf QLoRA table ({a['sharded_leaves']}"
          f" leaves sharded, {a['steps']} steps): params and J's codes bit for bit equal to the"
          f" unsharded update on each rank; J launches a step {a['j_launches_per_step']};"
          f" {a['state_bytes_per_rank'] / 1e6:.1f} MB of 8-bit states a rank", flush=True)
    stats["seconds"] = seconds
    return stats


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from bitsandbytes_sycl_tpu_torch.models.llama import LlamaConfig, init_params, llama_forward
        from bitsandbytes_sycl_tpu_torch.models.llama import init_kv_cache
        from bitsandbytes_sycl_tpu_torch.ops import KERNELS, _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script ({e})", file=sys.stderr)
        return 2
    need("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    phases = {}
    try:
        # 1. build (E's old bodies, timed beside its TMA body in phase 2, alongside)
        t0 = time.perf_counter()
        e_old = start_variant_build({"old": E_OLD_BODIES})
        secs = _build.build_all(verbose=True)
        phases["build_s"] = time.perf_counter() - t0
        card = gpu_line()
        print(f"[1] built {len(KERNELS)} kernels in {secs:.1f} s")
        print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

        # 2. kernels against their plain versions
        t0 = time.perf_counter()
        print("[2] kernels vs plain versions (cold L2, median of per-call CUDA-event times)")
        check_linears(torch, report)
        phases["kernels_linears_s"] = time.perf_counter() - t0
        # phase 11f, run here beside phase 2's times of A and before any
        # other profiler: a profiler started after others had stopped
        # caught none of A's launches in its window
        t1 = time.perf_counter()
        roofline = roofline_11(torch, report)
        phases["checkpoints_11f_s"] = time.perf_counter() - t1
        check_prefill_linears(torch, report)
        t1 = time.perf_counter()
        check_dequant4(torch, report, e_old()["old"])
        phases["dequant4_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        check_repeatable(torch, report)
        phases["kernels_repeatable_s"] = time.perf_counter() - t1
        check_routes(torch, report)
        check_prefill(torch, report)
        check_paged(torch, report)
        check_compressed(torch, report)
        check_kv4(torch, report)
        check_decode(torch, report)
        n_wide = check_wide_bodies(torch, report)
        print(f"[2] {n_wide} cases of C and H at head_dim 256 (and 384 to 1024) on their new"
              f" bodies: within 1%, the faults outside, 100 launches bit for bit", flush=True)
        check_int8(torch, report)
        t1 = time.perf_counter()
        n_edges = check_edges(torch)
        phases["kernels_edges_s"] = time.perf_counter() - t1
        print(f"[2] {n_edges} edge-case comparisons (odd rows, f32/bias, all B modes, ragged G"
              f" planes, W8A8 at few rows, C/D/H options, I at odd rows) ok")
        n_opt = check_optim8(torch, report)
        print(f"[7a] kernels J and K equal their plain version bit for bit in {n_opt} leaf"
              f" tables (every optimizer: the 448-leaf QLoRA table, a mixed table with ragged"
              f" leaves, 16.8M; NaN/Inf, zero block, stochastic rounding)", flush=True)
        n_br = check_optim8_branches(torch, report)
        print(f"[7a] J's and K's LUT codec ({n_br['lut']} tables), two-pass body"
              f" ({n_br['two_pass']}) and K's resident body ({n_br['resident']}) equal their"
              " plain version bit for bit", flush=True)
        phases["kernels_s"] = time.perf_counter() - t0

        # 3. serve Llama-7B through the paged engine
        t0 = time.perf_counter()
        cfg = LlamaConfig.llama7b()
        params = init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        phases["init_7b_s"] = time.perf_counter() - t0
        prompts = prompts_from_seed(0, 8, cfg.vocab_size)
        serve(torch, dataclasses.replace(cfg, num_layers=1),  # compile-free warm-up
              dict(params, layers=params["layers"][:1]), prompts[:1], 2)
        host = host_yardsticks(torch)
        reset_counts(KERNELS)
        rec_paged = {}
        outs, wall, steps = serve(torch, cfg, params, prompts, 32, per_request=rec_paged)
        counts = read_counts(KERNELS)
        phases["serve_7b_s"] = wall
        n_tok = sum(len(o) for o in outs)
        need(all(len(o) == 32 for o in outs), f"wrong output lengths {[len(o) for o in outs]}")
        need(all(0 <= t < cfg.vocab_size for o in outs for t in o), "token id out of range")
        steady = sorted(steps)[len(steps) // 2]
        serve_stats = dict(tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                           decode_steps=len(steps), decode_ms_per_step_median=steady * 1e3,
                           decode_ms_per_step_quartiles=[sorted(steps)[len(steps) // 4] * 1e3,
                                                         sorted(steps)[3 * len(steps) // 4] * 1e3],
                           launches=counts, host=host)
        print(f"[3] llama7b NF4 paged serve: {n_tok} tokens in {wall:.2f} s = "
              f"{n_tok / wall:.1f} tok/s; {len(steps)} decode steps, median "
              f"{steady * 1e3:.2f} ms/step (B<=4); launches {counts}", flush=True)
        for k in ("w4a8_gemv", "prefill_attn_int8", "paged_attn_int8"):
            need(counts[k] > 0, f"the serving path never launched {k}")
        need_new_bodies(counts, "7B paged serve")
        n_lin = 7 * cfg.num_layers + 1
        need(counts["w4a8_gemv.tc"] > 0 and counts["w4a8_gemv.tc"] % n_lin == 0,
             f"7B paged serve: {counts['w4a8_gemv.tc']} launches of A's tensor-core body, not"
             f" {n_lin} a prefill")
        print(f"[3] prefill batches of 32-128 rows: {counts['w4a8_gemv.tc']} launches of A, all on"
              f" its tensor-core body ({counts['w4a8_gemv.tc'] // n_lin} prefills x {n_lin});"
              f" decode {counts['w4a8_gemv.fused']} on its fused body", flush=True)
        main_counts = counts
        prof = profile_steps(torch, cfg, params, prompts)
        need_new_bodies(counts, "7B paged serve", per_step=prof["launches_per_step"])
        serve_stats["profile"] = prof
        busy = prof["device_busy_ms"]
        # the idle share is taken against the unprofiled median step
        serve_stats["device_idle_share"] = None if not busy else 1 - busy / (steady * 1e3)
        print(f"[3] profiled decode step (B=4): wall {prof['wall_ms']:.2f} ms under the profiler,"
              " device busy " + (f"{busy:.2f} ms of the {steady * 1e3:.2f} ms unprofiled step"
                                 f" (idle {serve_stats['device_idle_share']:.0%})"
                                 if busy else "not measured")
              + f"; attention per step (ms, launches) {prof['attention']}")
        for key, ms, cnt in prof["top"]:
            print(f"      {ms:8.3f} ms/step  {cnt:5d}x  {key[:90]}")
        print(f"[3] host: {prof['kernels_per_step']:.0f} kernels per step, "
              f"{steady * 1e3 / prof['kernels_per_step'] * 1e3:.1f} us of step per kernel; "
              f"yardsticks {json.dumps({k: round(v, 3) for k, v in host.items()})}")
        print("[3] host time per decode step under cProfile (tottime):")
        for key, ms, cnt in prof["host_top"]:
            print(f"      {ms:8.3f} ms/step  {cnt:6d}x  {key[:90]}")
        svh = prof["step_vs_host"]
        ratios = sorted(st / (prof["kernels_per_step"] * en * 1e-3) for st, en in svh["pairs"])
        print(f"[3] {len(svh['pairs'])} steps, each then the enqueue yardstick: step "
              f"{min(p[0] for p in svh['pairs']):.1f}-{max(p[0] for p in svh['pairs']):.1f} ms, "
              f"enqueue {min(p[1] for p in svh['pairs']):.2f}-{max(p[1] for p in svh['pairs']):.2f} us, "
              f"correlation {svh['corr']:.2f}; step / (kernels x enqueue) "
              f"{ratios[0]:.2f}-{ratios[-1]:.2f}")

        # 3c. the engine's default: the contiguous int8 cache (kernel H)
        t0 = time.perf_counter()
        contig_stats = serve_path(torch, "[3c] llama7b NF4 contiguous serve", cfg, params, prompts,
                                  KERNELS, ("w4a8_gemv", "prefill_attn_int8", "decode_attn_int8"),
                                  ref=(outs, rec_paged), host=True)
        per_step = contig_stats["profile"]["launches_per_step"]
        need(per_step.get("decode_attn_int8") == cfg.num_layers,
             f"contiguous decode: kernel H launched {per_step.get('decode_attn_int8')} times per step")
        phases["contiguous_s"] = time.perf_counter() - t0

        # 3e. the serving7b preset (NF4 bs 128) at 32 live rows: kernel A's
        # tensor-core body on every linear of every decode step
        serving7b_stats = serving7b_3e(torch, KERNELS)
        phases["serving7b_3e_s"] = serving7b_stats["seconds"]

        # 3b. long prompts at full 7B width and depth, then chunked prefill
        t0 = time.perf_counter()
        long_stats = serve_long(torch, cfg, params, KERNELS)
        long_counts = {r["label"]: r["launches"] for r in long_stats}
        chunk_stats = chunked_vs_whole(torch, cfg, params, KERNELS)
        phases["long_prompts_s"] = time.perf_counter() - t0

        # 4. the exact path (kernel B), 4 layers of the same weights
        t0 = time.perf_counter()
        cfg_x = dataclasses.replace(cfg, a8_decode=False, num_layers=4)
        params_x = dict(params, layers=params["layers"][:4])
        reset_counts(KERNELS)
        outs_x, wall_x, steps_x = serve(torch, cfg_x, params_x, prompts[:4], 8)
        counts_x = read_counts(KERNELS)
        need(counts_x["mm4_fused"] > 0, "the exact path never launched mm4_fused")
        need(all(len(o) == 8 for o in outs_x), "exact path: wrong output lengths")
        print(f"[4] a8_decode=False, 4 layers: {sum(map(len, outs_x))} tokens, median "
              f"{sorted(steps_x)[len(steps_x) // 2] * 1e3:.2f} ms/step; launches {counts_x}",
              flush=True)
        # four prompts of 257-512 tokens: 2048 rows, so every linear of the
        # prefill decodes its weight once (kernel E) and runs a dense matmul
        long4 = long_prompts(14, 4, 257, 512, cfg.vocab_size)
        reset_counts(KERNELS)
        outs_xl, wall_xl, _ = serve(torch, cfg_x, params_x, long4, 2)
        counts_xl = read_counts(KERNELS)
        n_linears = 7 * cfg_x.num_layers + 1
        need(counts_xl["dequantize_transposed"] == counts_xl["dequantize_transposed.tma"] == n_linears,
             f"exact path, 2048 rows: dequantize_transposed launched "
             f"{counts_xl['dequantize_transposed']} times"
             f" ({counts_xl['dequantize_transposed.tma']} on its TMA body), "
             f"not once per linear ({n_linears})")
        need(all(len(o) == 2 for o in outs_xl), "exact path, long prompts: wrong output lengths")
        phases["exact_path_s"] = time.perf_counter() - t0
        print(f"[4] a8_decode=False, 4 layers, 4 prompts of {[len(p) for p in long4]} tokens: "
              f"{wall_xl:.2f} s; launches {counts_xl}", flush=True)
        del params_x

        # 4b. w8a8_prefill: prefill on the transient int8 repack, both modes
        t0 = time.perf_counter()
        w8a8_stats = w8a8_prefill_batches(torch, cfg, params, KERNELS)
        phases["w8a8_prefill_s"] = time.perf_counter() - t0

        # 9. the rest of the serving engine at 7B width and depth: multi-LoRA,
        # the prefix cache, snapshots, the bf16 cache, PagedKVPool and
        # speculative decoding (its LLM.int8 target serves phase 6 too)
        gc.collect()
        torch.cuda.empty_cache()
        # the 2-layer CPU model (seed 1) of phases 9, 5 and 7c, built once
        p_cpu2 = init_params(dataclasses.replace(cfg, num_layers=2), seed=1, device="cpu")
        serving_stats, params8 = serving_engine_7b(torch, cfg, params, prompts, outs, KERNELS,
                                                   p_cpu2)
        phases["serving_engine_s"] = serving_stats["seconds"]["total"]
        gc.collect()
        torch.cuda.empty_cache()

        # 7b. QLoRA fine-tuning of Llama-7B on the same frozen NF4 base
        gc.collect()
        t0 = time.perf_counter()
        train_stats = qlora_7b(torch, cfg, params, KERNELS)
        phases["qlora_7b_s"] = time.perf_counter() - t0
        # 7d. the same setting through J's and K's new branches
        t0 = time.perf_counter()
        maps = state_maps()
        train_stats["branches"] = qlora_branches(torch, cfg, params, KERNELS, maps)
        phases["qlora_branches_s"] = time.perf_counter() - t0
        # 10o. GlobalOptimManager over the same adapters, one override to 32-bit
        t0 = time.perf_counter()
        train_stats["manager"] = manager_7b(torch, cfg, params, KERNELS)
        phases["manager_10o_s"] = time.perf_counter() - t0
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # 3d. the memory-lean NF4 configuration (compressed statistics, kv4
        # pages) at full width and depth, then card against CPU at 2 layers
        t0 = time.perf_counter()
        cfg_lean, lean_stats = serve_lean(torch, prompts, KERNELS)
        phases["lean_7b_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lean_stats["card_vs_cpu"] = lean_card_vs_cpu(torch, cfg_lean, KERNELS)
        phases["lean_card_vs_cpu_s"] = time.perf_counter() - t0

        # 5. card against CPU, 2 layers at 7B width
        t0 = time.perf_counter()
        cfg2 = dataclasses.replace(cfg, num_layers=2)
        p_cpu = p_cpu2
        p_gpu = to_cuda(torch, p_cpu)
        toks = torch.tensor([p + [0] * (32 - len(p)) for p in prompts_from_seed(1, 2, cfg.vocab_size)])
        lg_cpu, _ = llama_forward(p_cpu, cfg2, toks, init_kv_cache(cfg2, 2, "cpu"))
        lg_gpu, _ = llama_forward(p_gpu, cfg2, toks.cuda(), init_kv_cache(cfg2, 2, "cuda"))
        err, mag = max_err(torch, lg_gpu.cpu(), lg_cpu)
        rel = float((lg_gpu.cpu() - lg_cpu).norm() / lg_cpu.norm())
        # W4A8 requantizes every activation row on a grid of absmax / 127,
        # so a bf16 rounding that differs between two summation orders
        # flips some int8 codes and moves the logits (measured on an H100:
        # 2.27% relative L2 and 2.85% of the largest logit, two layers
        # deep): the limits of the CPU tests against the JAX package, which
        # see the same effect, 4% relative L2 and 5% of the largest logit
        tol = 5e-2 * mag
        need(torch.isfinite(lg_gpu).all().item(), "non-finite logits on the card")
        need(rel <= 4e-2, f"prefill logits card vs CPU: relative L2 error {rel} > 0.04")
        need(err <= tol, f"prefill logits card vs CPU: max err {err} > {tol}")
        rec_cpu, rec_gpu = {}, {}
        pr2 = prompts_from_seed(2, 2, cfg.vocab_size)
        out_cpu, _, _ = serve(torch, cfg2, p_cpu, pr2, 5, device="cpu", per_request=rec_cpu)
        out_gpu, _, _ = serve(torch, cfg2, p_gpu, pr2, 5, per_request=rec_gpu)
        checked = greedy_agree(out_cpu, rec_cpu, out_gpu, "card vs CPU")
        print(f"[5] 2-layer 7B-width card vs CPU: prefill logits relative L2 {rel:.3g} (tol 0.04),"
              f" max err {err:.4g} (tol {tol:.4g});"
              f" {checked} of 10 greedy tokens compared equal", flush=True)
        # two prompts of 512 tokens: 1024 rows, the grouped route (kernel G)
        toks = torch.tensor(long_prompts(15, 2, 512, 512, cfg.vocab_size))
        reset_counts(KERNELS)
        lg_gpu, _ = llama_forward(p_gpu, cfg2, toks.cuda(), init_kv_cache(cfg2, 2, "cuda"))
        need(read_counts(KERNELS)["w4a8_grouped"] == 7 * 2 + 1, "1024 rows did not take kernel G")
        lg_cpu, _ = llama_forward(p_cpu, cfg2, toks, init_kv_cache(cfg2, 2, "cpu"))
        err_l, mag_l = max_err(torch, lg_gpu.cpu(), lg_cpu)
        rel_l = float((lg_gpu.cpu() - lg_cpu).norm() / lg_cpu.norm())
        need(torch.isfinite(lg_gpu).all().item(), "non-finite logits on the card (T=512)")
        need(rel_l <= 4e-2, f"T=512 prefill logits card vs CPU: relative L2 error {rel_l} > 0.04")
        need(err_l <= 5e-2 * mag_l, f"T=512 prefill logits card vs CPU: max err {err_l} > {5e-2 * mag_l}")
        phases["cpu_vs_card_s"] = time.perf_counter() - t0
        print(f"[5] 2-layer 7B-width card vs CPU at Kb=2, T=512 (1024 rows, kernel G): relative L2"
              f" {rel_l:.3g} (tol 0.04), max err {err_l:.4g} (tol {5e-2 * mag_l:.4g})", flush=True)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()

        # 6. LLM.int8 Llama-7B (threshold 6, static outlier columns) through
        # the default engine, then card against CPU at 2 layers
        t0 = time.perf_counter()
        cfg8 = LlamaConfig.llama7b(quant="int8")  # params8: initialised in phase 9f
        int8_gb = sum(w["CB"].numel() for layer in params8["layers"] for w in layer.values()
                      if isinstance(w, dict)) / 1e9 + params8["lm_head"]["CB"].numel() / 1e9
        phases["init_int8_s"] = serving_stats["speculative"]["init_int8_s"]
        print(f"[6] LLM.int8 Llama-7B: {int8_gb:.2f} GB of int8 weights, initialised in"
              f" {phases['init_int8_s']:.1f} s", flush=True)
        t0 = time.perf_counter()
        int8_stats = serve_path(torch, "[6] llama7b LLM.int8 contiguous serve", cfg8, params8, prompts,
                                KERNELS, ("int8_matmul", "prefill_attn_int8", "decode_attn_int8"))
        int8_stats["int8_weight_gb"] = int8_gb
        per_step = int8_stats["profile"]["launches_per_step"]
        need(per_step.get("int8_matmul") == 7 * cfg8.num_layers + 1,
             f"LLM.int8 decode: kernel I launched {per_step.get('int8_matmul')} times per step")
        need(per_step.get("decode_attn_int8") == cfg8.num_layers,
             f"LLM.int8 decode: kernel H launched {per_step.get('decode_attn_int8')} times per step")
        del params8
        torch.cuda.empty_cache()
        int8_stats["card_vs_cpu"] = int8_card_vs_cpu(torch, cfg8, 3)
        phases["int8_s"] = time.perf_counter() - t0

        # 7c. QLoRA card against CPU, 2 layers at 7B width: adamw8bit, then
        # whole-leaf blocks and the LUT codec with the same maps on both sides
        t0 = time.perf_counter()
        from bitsandbytes_sycl_tpu_torch import optim

        p_cpu = p_cpu2
        first = {}
        train_stats["card_vs_cpu"] = qlora_card_vs_cpu(torch, cfg, KERNELS, p_cpu=p_cpu,
                                                       cpu_first=first)
        train_stats["card_vs_cpu_whole_leaf"] = qlora_card_vs_cpu(
            torch, cfg, KERNELS, ("w4a8_gemv", "optim8_2state.two_pass"), "[7c block_wise=False]",
            p_cpu=p_cpu, cpu_first=first,
            make_opt=lambda lv: optim.adamw8bit(lv, 2e-4, weight_decay=0.0, block_wise=False))
        train_stats["card_vs_cpu_lut"] = qlora_card_vs_cpu(
            torch, cfg, KERNELS, ("w4a8_gemv", "optim8_2state.lut"), "[7c LUT codec]",
            p_cpu=p_cpu, cpu_first=first,
            make_opt=lambda lv: LutOptimizer(torch, lv, "adam", 2e-4, maps))
        del p_cpu, p_cpu2
        phases["qlora_card_vs_cpu_s"] = time.perf_counter() - t0

        # 8. the library at Llama-7B width and depth: the docstring path,
        # replace_linear into LinearNF4, Linear8bitLt
        gc.collect()
        torch.cuda.empty_cache()
        library_stats = library_7b(torch, KERNELS, cfg)
        phases["library_7b_s"] = library_stats["seconds"]

        # 10. the other model families: the kernel checks of their shapes,
        # Mixtral-8x7B at full width and 16 layers, Qwen2-7B, GPT-J-6B and
        # BLOOM-7B1 at full width, eight more at 2 layers
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        family_stats = families_10(torch, prompts, KERNELS, report)
        phases["families_s"] = time.perf_counter() - t0
        phases.update({f"families_{k}_s": v for k, v in family_stats["seconds"].items()})

        # 11. HF checkpoints written here and loaded on the card (Llama-2-7B and
        # GPT-J-6B widths), save/load of quantized trees and optimizer states,
        # the host library, legacy and research ops, the roofline report
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ckpt_stats = checkpoints_11(torch, prompts, KERNELS, report,
                                    {"paged": main_counts, "contiguous": contig_stats["launches"]})
        ckpt_stats["roofline"] = roofline
        phases["checkpoints_s"] = time.perf_counter() - t0
        phases.update({f"checkpoints_{k}_s": v for k, v in ckpt_stats["seconds"].items()})

        # 12. parallel/ on torch.distributed: NCCL at world size 1 here, then
        # a gloo world of two processes on this card (TP, EP, PP, ring
        # attention, the sharded 8-bit update), against phases 3 and 3c
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        parallel_stats = parallel_12(torch, cfg, prompts, dict(
            paged_outs=outs, paged_logits=rec_paged, paged_counts=main_counts,
            contiguous_outs=contig_stats["outs"], contiguous_counts=contig_stats["launches"]),
            KERNELS)
        phases["parallel_s"] = time.perf_counter() - t0
        phases.update({f"parallel_{k}_s": v for k, v in parallel_stats["seconds"].items()})
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # each kernel with the path that launched it, and that path's count
    sources = {
        "w4a8_gemv": ("bitsandbytes_sycl_tpu/ops/matmul_w4a8.py:65", "7B decode (phase 3)",
                      main_counts["w4a8_gemv"]),
        "mm4_fused": ("bitsandbytes_sycl_tpu/ops/matmul_4bit.py:66",
                      "7B prefill, 256 rows (phase 3b)", long_counts["rows 256"]["mm4_fused"]),
        "prefill_attn_int8": ("bitsandbytes_sycl_tpu/ops/attention.py:356", "7B serve (phase 3)",
                              main_counts["prefill_attn_int8"]),
        "paged_attn_int8": ("bitsandbytes_sycl_tpu/ops/paged_attention.py:139",
                            "7B decode (phase 3)", main_counts["paged_attn_int8"]),
        "dequantize_transposed": ("bitsandbytes_sycl_tpu/ops/matmul_4bit.py:120",
                                  "7B prefill, 256 rows (phase 3b)",
                                  long_counts["rows 256"]["dequantize_transposed"]),
        "dequant_int8": ("bitsandbytes_sycl_tpu/ops/matmul_w4a8.py:244",
                         "7B prefill, 4096 rows (phase 3b)", long_counts["rows 4096"]["dequant_int8"]),
        "w4a8_grouped": ("bitsandbytes_sycl_tpu/ops/matmul_w4a8.py:343",
                         "7B prefill, 2048 rows (phase 3b)",
                         long_counts["rows 2048"]["w4a8_grouped"]),
        "decode_attn_int8": ("bitsandbytes_sycl_tpu/ops/attention.py:50",
                             "7B contiguous decode (phase 3c)",
                             contig_stats["launches"]["decode_attn_int8"]),
        "int8_matmul": ("bitsandbytes_sycl_tpu/ops/matmul_int8.py:42", "LLM.int8 7B serve (phase 6)",
                        int8_stats["launches"]["int8_matmul"]),
        "optim8_2state": ("bitsandbytes_sycl_tpu/ops/optim8.py:166",
                          "7B QLoRA, 4 adamw8bit steps (phase 7b)",
                          train_stats["launches"]["adamw8bit"]["optim8_2state"]),
        "optim8_1state": ("bitsandbytes_sycl_tpu/ops/optim8.py:206",
                          "7B QLoRA, 2 lion8bit steps (phase 7b)",
                          train_stats["launches"]["lion8bit"]["optim8_1state"]),
    }
    # launches per decode step, from the profiled steps of the path that launched each
    per_step = {**serve_stats["profile"]["launches_per_step"],
                "decode_attn_int8": contig_stats["profile"]["launches_per_step"]["decode_attn_int8"],
                "int8_matmul": int8_stats["profile"]["launches_per_step"]["int8_matmul"]}
    kernels = []
    # the launches of each body of B and G on those paths
    bodies = {"mm4_fused": {"tc": long_counts["rows 256"]["mm4_fused.tc"]},
              "w4a8_grouped": {"wgmma": long_counts["rows 2048"]["w4a8_grouped.wgmma"]},
              "prefill_attn_int8": {"tc": main_counts["prefill_attn_int8.tc"]},
              "paged_attn_int8": {"split": main_counts["paged_attn_int8.split"]},
              "w4a8_gemv": {"fused": main_counts["w4a8_gemv.fused"],
                            "tc": main_counts["w4a8_gemv.tc"],
                            "simt": main_counts["w4a8_gemv"] - main_counts["w4a8_gemv.fused"]
                            - main_counts["w4a8_gemv.tc"]},
              "decode_attn_int8": {"split": contig_stats["launches"]["decode_attn_int8.split"]},
              "dequant_int8": {"tiled": long_counts["rows 4096"]["dequant_int8.tiled"]},
              "dequantize_transposed": {
                  "tma": long_counts["rows 256"]["dequantize_transposed.tma"],
                  "unaligned": long_counts["rows 256"]["dequantize_transposed"]
                  - long_counts["rows 256"]["dequantize_transposed.tma"]}}
    # kernel A's tensor-core body on its phase 3e path (serving7b, 32 rows)
    sc3e = serving7b_stats["launches"]
    sources["w4a8_gemv (tc)"] = ("bitsandbytes_sycl_tpu/ops/matmul_w4a8.py:65",
                                 "serving7b decode at 32 rows (phase 3e)", sc3e["w4a8_gemv.tc"])
    bodies["w4a8_gemv (tc)"] = {"fused": sc3e["w4a8_gemv.fused"], "tc": sc3e["w4a8_gemv.tc"],
                                "simt": sc3e["w4a8_gemv"] - sc3e["w4a8_gemv.fused"]
                                - sc3e["w4a8_gemv.tc"]}
    per_step["w4a8_gemv (tc)"] = serving7b_stats["profile"]["launches_per_step"]["w4a8_gemv.tc"]
    # the branches of slice 10, each with its phase 3d path (the kernel's
    # source file is the base name's)
    lean_per = lean_stats["profile"]["launches_per_step"]
    lean_2048 = next(r for r in lean_stats["long"] if r["label"] == "rows 2048")["launches"]
    sources.update({
        "mm4_fused (compressed)": ("bitsandbytes_sycl_tpu/ops/matmul_4bit.py:66",
                                   "7B lean decode (phase 3d)",
                                   lean_stats["launches"]["mm4_fused.compressed"]),
        "dequantize_transposed (compressed)": ("bitsandbytes_sycl_tpu/ops/matmul_4bit.py:120",
                                               "7B lean prefill, 2048 rows (phase 3d)",
                                               lean_2048["dequantize_transposed.compressed"]),
        # f32 out: the exact-dequant backward of every QLoRA step
        "dequantize_transposed (f32 out)": ("bitsandbytes_sycl_tpu/ops/matmul_4bit.py:120",
                                            "7B QLoRA, 4 adamw8bit steps' backward (phase 7b)",
                                            train_stats["launches"]["adamw8bit"][
                                                "dequantize_transposed"]),
        "paged_attn_int8 (kv4)": ("bitsandbytes_sycl_tpu/ops/paged_attention.py:139",
                                  "7B lean decode (phase 3d)",
                                  lean_stats["launches"]["paged_attn_int8.kv4"]),
    })
    bodies["dequantize_transposed (compressed)"] = {
        "tma": lean_2048["dequantize_transposed.tma"],
        "unaligned": lean_2048["dequantize_transposed"] - lean_2048["dequantize_transposed.tma"]}
    per_step.update({"mm4_fused (compressed)": lean_per.get("mm4_fused.compressed", 0),
                     "paged_attn_int8 (kv4)": lean_per.get("paged_attn_int8.kv4", 0)})
    # J's and K's LUT codec and blocks past 2048 (J's two-pass body, K's
    # resident and two-pass bodies), each with its phase 7d run
    br = train_stats["branches"]["launches"]
    for kname, line, opt_name in (("optim8_2state", 166, "adam"), ("optim8_1state", 206, "lion")):
        sources.update({
            f"{kname} (lut)": (f"bitsandbytes_sycl_tpu/ops/optim8.py:{line}",
                               f"7B QLoRA, {opt_name} with table-coded states (phase 7d)",
                               br[f"{kname} (lut)"]),
            f"{kname} (two-pass)": (f"bitsandbytes_sycl_tpu/ops/optim8.py:{line}",
                                    f"7B QLoRA, {opt_name} with block_wise=False (phase 7d)"
                                    if kname == "optim8_2state" else
                                    "lion8bit(block_wise=False) of a 4096 x 4096 weight (phase 7d)",
                                    br[f"{kname} (two-pass)"]),
        })
    sources["optim8_1state (resident)"] = ("bitsandbytes_sycl_tpu/ops/optim8.py:206",
                                           "7B QLoRA, lion with block_wise=False (phase 7d)",
                                           br["optim8_1state (resident)"])
    # kernels H and D at Qwen2-7B's group of 7 (phase 10b)
    q10 = family_stats["10b"]
    sources.update({
        "decode_attn_int8 (rep 7)": ("bitsandbytes_sycl_tpu/ops/attention.py:50",
                                     "Qwen2-7B contiguous serve (phase 10b)",
                                     q10["contiguous"]["launches"]["decode_attn_int8"]),
        "paged_attn_int8 (rep 7)": ("bitsandbytes_sycl_tpu/ops/paged_attention.py:139",
                                    "Qwen2-7B paged serve (phase 10b)",
                                    q10["paged"]["launches"]["paged_attn_int8"]),
    })
    per_step.update({"decode_attn_int8 (rep 7)": q10["contiguous"]["step_launches"]["decode_attn_int8"],
                     "paged_attn_int8 (rep 7)": q10["paged"]["step_launches"]["paged_attn_int8"]})
    # C's tensor-core and H's split bodies at head_dim 256 (phase 10c, GPT-J-6B)
    g10 = family_stats["10c"]["contiguous"]
    sources.update({
        "prefill_attn_int8 (head_dim 256)": ("bitsandbytes_sycl_tpu/ops/attention.py:356",
                                             "GPT-J-6B contiguous serve (phase 10c)",
                                             g10["launches"]["prefill_attn_int8.tc"]),
        "decode_attn_int8 (head_dim 256)": ("bitsandbytes_sycl_tpu/ops/attention.py:50",
                                            "GPT-J-6B contiguous serve (phase 10c)",
                                            g10["launches"]["decode_attn_int8.split"]),
    })
    per_step.update({"decode_attn_int8 (head_dim 256)": g10["step_launches"]["decode_attn_int8.split"]})
    for name, (replaces, path, launches) in sources.items():
        r = report[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"bitsandbytes_sycl_tpu_torch/csrc/{name.split(' ')[0]}.cu",
            replaces=replaces, path=path, launches=launches, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], launches_per_decode_step=per_step.get(name, 0),
            **({"launches_by_body": bodies[name]} if name in bodies else {})))
    phases["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=report, serve=serve_stats, long_prompts=long_stats,
                       chunked=chunk_stats, contiguous=contig_stats, w8a8_prefill=w8a8_stats,
                       int8=int8_stats, qlora=train_stats, lean=lean_stats, library=library_stats,
                       serving7b=serving7b_stats,
                       serving=serving_stats, families=family_stats, checkpoints=ckpt_stats,
                       parallel=parallel_stats,
                       phases=phases), f,
                  indent=1, default=str)
    print(f"phases (s): {json.dumps({k: round(v, 2) for k, v in phases.items()})}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------------ probe
PROBE_PARTS = {  # the BNB_PROBE_* switches of the kernel sources and wgmma.cuh
    "mm4_fused": {"no TMA copies": ("BNB_PROBE_NO_COPY",), "no decode": ("BNB_PROBE_NO_DECODE",),
                  "no wgmma": ("BNB_PROBE_NO_MMA",)},
    "w4a8_grouped": {"no TMA copies": ("BNB_PROBE_NO_COPY",),
                     "no regrid": ("BNB_PROBE_NO_REGRID",), "no wgmma": ("BNB_PROBE_NO_MMA",)},
}
ATTN_PROBE_PARTS = {
    "prefill_attn_int8": {"no copies": ("BNB_PROBE_NO_COPY",),
                          "no conversion": ("BNB_PROBE_NO_DECODE",),
                          "no wgmma": ("BNB_PROBE_NO_MMA",), "no softmax": ("BNB_PROBE_NO_SOFTMAX",),
                          # the cluster body's exchange of S shares (D > 512)
                          "no exchange": ("BNB_PROBE_NO_EXCHANGE",)},
    "paged_attn_int8": {"no copies": ("BNB_PROBE_NO_COPY",), "no math": ("BNB_PROBE_NO_MATH",)},
}


def probe_attention(torch, out):
    """Where the time of C's tensor-core body and D's split body goes: each
    timed at the shapes of check_prefill and check_paged as built, and
    built with one part switched off (ATTN_PROBE_PARTS; those builds
    compute wrong results)."""
    from bitsandbytes_sycl_tpu_torch.ops import _build, attention, paged_attention

    built = _build.build_variants({(stem, part): (stem, macros)
                                   for stem, parts in ATTN_PROBE_PARTS.items()
                                   for part, macros in parts.items()})
    variants = {stem: {part: built[(stem, part)] for part in parts}
                for stem, parts in ATTN_PROBE_PARTS.items()}
    gen = torch.Generator(device="cuda").manual_seed(9)
    L, H, D, S = 2, 32, 128, 2048
    runs = []
    for B, T in ((4, 32), (2, 512)):
        q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        kq = torch.randint(-127, 128, (L, B, H, D, S), generator=gen, device="cuda", dtype=torch.int8)
        vq = torch.randint(-127, 128, (L, B, H, S, D), generator=gen, device="cuda", dtype=torch.int8)
        ks = torch.rand((L, B, H, S), generator=gen, device="cuda") + 1
        vs = torch.rand((L, B, H, S), generator=gen, device="cuda") + 0.5
        st = torch.zeros((B,), dtype=torch.int32, device="cuda")
        runs.append(("prefill_attn_int8", f"B={B} T={T}",
                     lambda q=q, kq=kq, ks=ks, vq=vq, vs=vs, st=st: attention.prefill_attn_int8(
                         q, kq, ks, vq, vs, 1, st, 0.01 / 127)))
        kd = (kq[1, :, :, :, :T].float() * (ks[1, :, :, None, :T] / 127)).permute(0, 1, 3, 2) \
            .contiguous().to(torch.bfloat16)
        vd = (vq[1, :, :, :T].float() * (vs[1, :, :, :T, None] / 127)).to(torch.bfloat16)
        qh = q.permute(0, 2, 1, 3).contiguous()
        for clean in (False, True):
            ms, name, _ = time_sdpa(torch, qh, kd, vd, flush_by_read=clean, is_causal=True)
            out["attention_parts"].append(dict(kernel="sdpa", shape=f"B={B} T={T}", part=name,
                                               clean_l2=clean, us=ms * 1e3))
            print(f"sdpa B={B} T={T}: {name}{', clean L2' if clean else ''} {ms * 1e3:.1f} us",
                  flush=True)
    # the wide instances: GPT-J-6B's head_dim 256 (two warpgroups) and 1024 (a
    # cluster of 8 CTAs), 4 kv heads of 4 q heads at 1024
    for Dw, B, Hq, Hkv, T in ((256, 2, 16, 16, 512), (1024, 4, 16, 4, 512)):
        q = torch.randn((B, T, Hq, Dw), generator=gen, device="cuda").to(torch.bfloat16)
        kq = torch.randint(-127, 128, (L, B, Hkv, Dw, S), generator=gen, device="cuda", dtype=torch.int8)
        vq = torch.randint(-127, 128, (L, B, Hkv, S, Dw), generator=gen, device="cuda", dtype=torch.int8)
        ks = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 1
        vs = torch.rand((L, B, Hkv, S), generator=gen, device="cuda") + 0.5
        st = torch.zeros((B,), dtype=torch.int32, device="cuda")
        runs.append(("prefill_attn_int8", f"D={Dw} B={B} T={T}",
                     lambda q=q, kq=kq, ks=ks, vq=vq, vs=vs, st=st, Dw=Dw: attention.prefill_attn_int8(
                         q, kq, ks, vq, vs, 1, st, (1.0 / Dw ** 0.5) / 127)))
    kp, kps, vp, vps, table, qd, new_kv = paged_inputs(torch, gen, L, 4, H, D, 128, 16)
    for label, lens_l in (("1 page", [40, 64, 17, 33]), ("16 pages", [2047, 1500, 900, 2000])):
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        runs.append(("paged_attn_int8", label, lambda lens=lens: paged_attention.paged_attn_int8(
            qd, kp, kps, vp, vps, 1, table, lens, 0.01 / 127, new_kv=new_kv)))
    # D's split counts at 16 pages with L2 clean
    from bitsandbytes_sycl_tpu_torch.ops.paged_attention import PagedPlan

    lens = torch.tensor([2047, 1500, 900, 2000], dtype=torch.int32, device="cuda")
    for nsplit in (1, 2, 3, 4, 8):
        us = time_cold(torch, lambda: paged_attention._paged_launch(
            qd, kp, kps, vp, vps, 1, table, lens, 0.01 / 127, new_kv, None, None, None,
            PagedPlan("split", nsplit)), iters=20, flush_by_read=True) * 1e3
        out["attention_parts"].append(dict(kernel="paged_attn_int8", shape="16 pages",
                                           part=f"nsplit={nsplit}, clean L2", us=us))
        print(f"paged_attn_int8 16 pages: nsplit={nsplit}, clean L2 {us:.1f} us", flush=True)
    for stem, label, run in runs:
        for part in ["real", "real, clean L2"] + list(ATTN_PROBE_PARTS[stem]):
            old = _build.use_library(stem, variants[stem][part]) if part in variants[stem] else None
            us = time_cold(torch, run, iters=20, flush_by_read=part == "real, clean L2") * 1e3
            if old is not None:
                _build.use_library(stem, old)
            out["attention_parts"].append(dict(kernel=stem, shape=label, part=part, us=us))
            print(f"{stem} {label}: {part:14s} {us:.1f} us", flush=True)


DECODE_PROBE_PARTS = {  # A's fused and H's split bodies: copies alone against math alone
    "w4a8_gemv": {"math alone (no copies)": ("BNB_PROBE_NO_COPY",),
                  "copies alone (no math)": ("BNB_PROBE_NO_MATH",),
                  "no row absmax or quantization": ("BNB_PROBE_NO_PROLOGUE",),
                  "no split merge": ("BNB_PROBE_NO_MERGE",),
                  "launch alone (all off)": ("BNB_PROBE_NO_COPY", "BNB_PROBE_NO_MATH",
                                             "BNB_PROBE_NO_PROLOGUE", "BNB_PROBE_NO_MERGE")},
    "decode_attn_int8": {"math alone (no copies)": ("BNB_PROBE_NO_COPY",),
                         "copies alone (no math)": ("BNB_PROBE_NO_MATH",),
                         "launch alone (copies and math off)": ("BNB_PROBE_NO_COPY",
                                                                "BNB_PROBE_NO_MATH")},
}


TC_PROBE_PARTS = {  # A's tensor-core body, one part switched off
    "no copies": ("BNB_PROBE_NO_COPY",),
    "no quantization launch": ("BNB_PROBE_NO_PROLOGUE",),
    "no decode": ("BNB_PROBE_NO_DECODE",),
    "no products": ("BNB_PROBE_NO_MMA",),
    "no folds": ("BNB_PROBE_NO_FOLD",),
    "launch alone (all off)": ("BNB_PROBE_NO_COPY", "BNB_PROBE_NO_PROLOGUE", "BNB_PROBE_NO_DECODE",
                               "BNB_PROBE_NO_MMA", "BNB_PROBE_NO_FOLD"),
}


def probe_tc(torch, out):
    """Where the time of A's tensor-core body goes, at 16, 32 and 128 rows
    (blocksize 64) and 32 rows (blocksize 128) of 4096 x 4096 and 32000 x
    4096: timed as built and built with one part switched off
    (TC_PROBE_PARTS; those builds compute wrong results), then at every
    split count of the 7B shapes' A_TC_CELLS rows."""
    from bitsandbytes_sycl_tpu_torch.ops import _build
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as mw
    from bitsandbytes_sycl_tpu_torch.ops.common import LaunchPlan, quantize_4bit_native, sm_count

    built = _build.build_variants({part: ("w4a8_gemv", macros)
                                   for part, macros in TC_PROBE_PARTS.items()})
    gen = torch.Generator(device="cuda").manual_seed(11)
    sms = sm_count(torch.device("cuda"))
    for N, K in SHAPES_7B:
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        for bs in sorted({b for b, _ in A_TC_CELLS if K % (2 * b) == 0}):
            w = quantize_4bit_native(W, bs, "nf4", absmax_dtype=torch.bfloat16)
            for M in [m for b, m in A_TC_CELLS if b == bs]:
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                plan = mw.gemv_plan(M, N, K, bs, sms)
                label = f"N={N} K={K} bs={bs} M={M}"
                if (N, K) in ((4096, 4096), (32000, 4096)) and (bs, M) in (
                        (64, 16), (64, 32), (64, 128), (128, 32)):
                    for part in ["real"] + list(TC_PROBE_PARTS):
                        old = _build.use_library("w4a8_gemv", built[part]) if part != "real" else None
                        us = time_cold(torch, lambda: mw._gemv_launch(
                            x, w, None, torch.bfloat16, plan), iters=20) * 1e3
                        if old is not None:
                            _build.use_library("w4a8_gemv", old)
                        out["tc_parts"].append(dict(shape=label, part=part, us=us))
                        print(f"w4a8_gemv tc {label}: {part:24s} {us:.1f} us", flush=True)
                steps, unit = -(-(K // 2) // 64), math.lcm(bs, 64) // 64
                seen = set()
                for ks in (1, 2, 3, 4, 6, 8, 12, 16, plan.ksplit):
                    per = unit * -(-(steps // unit) // ks)
                    p2 = LaunchPlan("tc", plan.bm, per, -(-steps // per), plan.bn)
                    if p2.ksplit in seen:
                        continue
                    seen.add(p2.ksplit)
                    us = time_cold(torch, lambda: mw._gemv_launch(x, w, None, torch.bfloat16, p2),
                                   iters=20) * 1e3
                    out["tc_splits"].append(dict(shape=label, plan=tuple(p2), picked=p2 == plan,
                                                 ctas=N // p2.bn * p2.ksplit * -(-M // p2.bm), us=us))
                    print(f"w4a8_gemv tc {label} {tuple(p2)}{' (picked)' if p2 == plan else ''}:"
                          f" {us:.1f} us", flush=True)
            del w
        del W


def probe_decode(torch, out):
    """Where the time of A's fused body and H's split body goes: each timed
    as built (cold L2 by write, and clean), and built with the copies or
    the math switched off (DECODE_PROBE_PARTS; those builds compute wrong
    results); then every split count of each at the shapes that fit its
    plan (A at 1, 4 and 8 rows of the four 7B shapes, H at B = 1, 2, 4, 8)."""
    from bitsandbytes_sycl_tpu_torch.ops import _build, attention
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as mw
    from bitsandbytes_sycl_tpu_torch.ops.common import LaunchPlan, quantize_4bit_native, sm_count

    built = _build.build_variants({(stem, part): (stem, macros)
                                   for stem, parts in DECODE_PROBE_PARTS.items()
                                   for part, macros in parts.items()})
    gen = torch.Generator(device="cuda").manual_seed(10)
    sms = sm_count(torch.device("cuda"))

    one = torch.zeros(1, device="cuda")
    floor = time_cold(torch, lambda: one.add_(1), iters=20) * 1e3
    out["decode_parts"].append(dict(kernel="one-element add_", part="floor", us=floor))
    print(f"time_cold of a one-element add_ (the timing floor): {floor:.1f} us", flush=True)

    def parts(stem, label, run):
        for part in ["real", "real, clean L2"] + list(DECODE_PROBE_PARTS[stem]):
            old = _build.use_library(stem, built[(stem, part)]) if part in DECODE_PROBE_PARTS[stem] \
                else None
            us = time_cold(torch, run, iters=20, flush_by_read=part == "real, clean L2") * 1e3
            if old is not None:
                _build.use_library(stem, old)
            out["decode_parts"].append(dict(kernel=stem, shape=label, part=part, us=us))
            print(f"{stem} {label}: {part:24s} {us:.1f} us", flush=True)

    for N, K in ((4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)):
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        w = quantize_4bit_native(W, 64, "nf4", absmax_dtype=torch.bfloat16)
        del W
        steps = K // 128
        for M in (1, 4, mw.GEMV_FUSED_MAX_M):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            plan = mw.gemv_plan(M, N, K, 64, sms)
            if M == 4:
                parts("w4a8_gemv", f"N={N} K={K} M={M}",
                      lambda: mw._gemv_launch(x, w, None, torch.bfloat16, plan))
            for ks in sorted({1, 2, 3, 4, 6, 8, plan.ksplit}):
                per = min(-(-steps // ks), mw._GEMV_X_BYTES // (plan.bm * 2 * 64))
                p2 = LaunchPlan("fused", plan.bm, per, -(-steps // per))
                us = time_cold(torch, lambda: mw._gemv_launch(x, w, None, torch.bfloat16, p2),
                               iters=20) * 1e3
                out["gemv_splits"].append(dict(N=N, K=K, M=M, plan=tuple(p2), picked=p2 == plan,
                                               ctas=N // 128 * p2.ksplit, us=us))
                print(f"w4a8_gemv N={N:5d} K={K:5d} M={M} {tuple(p2)}"
                      f"{' (picked)' if p2 == plan else ''}: {us:.1f} us", flush=True)
        del w
    L, H, D, S = 2, 32, 128, 2048
    for label, lens_l in (("B=4 full", [2047] * 4), ("B=4 short", [40, 64, 17, 33]),
                          ("B=1 full", [1900]), ("B=2 full", [2047, 1500]),
                          ("B=8 ragged", [1, 127, 128, 2047, 900, 1500, 33, 2000])):
        B = len(lens_l)
        kq = torch.randint(-127, 128, (L, B, H, D, S), generator=gen, device="cuda", dtype=torch.int8)
        vq = torch.randint(-127, 128, (L, B, H, S, D), generator=gen, device="cuda", dtype=torch.int8)
        ks = torch.rand((L, B, H, S), generator=gen, device="cuda") + 1
        vs = torch.rand((L, B, H, S), generator=gen, device="cuda") + 0.5
        q = torch.randn((B, H, 1, D), generator=gen, device="cuda").to(torch.bfloat16)
        nk = (torch.randint(-127, 128, (B, H, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, H), generator=gen, device="cuda") + 1,
              torch.randint(-127, 128, (B, H, D), generator=gen, device="cuda", dtype=torch.int8),
              torch.rand((B, H), generator=gen, device="cuda") + 0.5)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        plan = attention.decode_plan(B, H, S, D, 1, q.dtype, sms)
        if B == 4:
            parts("decode_attn_int8", label, lambda: attention.decode_attn_int8(
                q, kq, ks, vq, vs, 1, lens, 0.01 / 127, new_kv=nk))
        for ns in sorted({1, 2, 3, 4, 6, 8, plan.nsplit}):
            p2 = attention.DecodePlan("split", ns)
            us = time_cold(torch, lambda: attention._decode_launch(
                q, kq, ks, vq, vs, 1, lens, 0.01 / 127, nk, None, None, None, p2), iters=20) * 1e3
            out["decode_splits"].append(dict(label=label, B=B, nsplit=ns, picked=p2 == plan,
                                             ctas=B * H * ns, us=us))
            print(f"decode_attn_int8 {label} nsplit={ns}{' (picked)' if p2 == plan else ''}:"
                  f" {us:.1f} us", flush=True)
        del kq, vq


OPTIM_PROBE_PARTS = {  # J's and K's bodies: copies, math, encode, skeleton
    "copies alone (no math)": ("BNB_PROBE_NO_MATH",),
    "math alone (no copies)": ("BNB_PROBE_NO_COPY",),
    "encode alone (no copies, no update)": ("BNB_PROBE_NO_COPY", "BNB_PROBE_NO_UPDATE"),
    "launch skeleton (no copies, no math)": ("BNB_PROBE_NO_COPY", "BNB_PROBE_NO_MATH"),
    "two-pass: the first pass alone (J)": ("BNB_PROBE_PASS1_ONLY",),
}
K_RESIDENT_PROBE_PARTS = {  # K's resident body: its loads and updates alone; without the exchange
    "resident: updates alone, no codes, no exchange (K)": ("BNB_PROBE_SWEEP1_ONLY",),
    "resident: no exchange, each CTA's own maximum (K)": ("BNB_PROBE_NO_EXCHANGE",),
}


def probe_optim(torch, out):
    """Where the time of J's and K's leaf-table bodies goes: adam (J) and
    lion (K) at 16.8M parameters and over the 448-leaf QLoRA table, J's
    LUT codec (the quantile maps of phase 7d) and two-pass body (one block
    a leaf, a launch pair per leaf size) at the same sizes, and K's
    resident body (one block a leaf, one launch per leaf size) over the
    table, each launch timed as built (cold L2 by write, and clean) and
    built with parts switched off (OPTIM_PROBE_PARTS, and for K's resident
    body K_RESIDENT_PROBE_PARTS: its loads and updates alone, and its
    sweep without the cluster's exchange; those builds compute wrong
    results), then the dynamic body at 1-8 persistent CTAs per SM, then
    probe_resident (K's cluster sweep and its route against the two-pass
    body by table size). Launches go through ops/optim8._launch with the
    table checked once, so the times hold the leaf table's copy but not
    the host's checks."""
    from bitsandbytes_sycl_tpu_torch.ops import _build
    from bitsandbytes_sycl_tpu_torch.ops import optim8 as O
    from bitsandbytes_sycl_tpu_torch.ops.common import sm_count

    stems = ("optim8_2state", "optim8_1state")
    built = _build.build_variants({**{(stem, part): (stem, macros) for stem in stems
                                      for part, macros in OPTIM_PROBE_PARTS.items()},
                                   **{("optim8_1state", part): ("optim8_1state", macros)
                                      for part, macros in K_RESIDENT_PROBE_PARTS.items()}})
    gen = torch.Generator(device="cuda").manual_seed(12)
    sms = sm_count(torch.device("cuda"))
    one = torch.zeros(1, device="cuda")
    floor = time_cold(torch, lambda: one.add_(1), iters=20) * 1e3
    out["optim_parts"].append(dict(kernel="one-element add_", part="floor", us=floor))
    print(f"time_cold of a one-element add_ (the timing floor): {floor:.1f} us", flush=True)
    maps = state_maps()
    lut = tuple(O.lut_parts(m) for m in maps)
    for name, stem, branch in (("adam", "optim8_2state", "dynamic"), ("lion", "optim8_1state", "dynamic"),
                               ("adam", "optim8_2state", "lut"), ("adam", "optim8_2state", "two-pass"),
                               ("lion", "optim8_1state", "resident")):
        for label, sizes in (("16.8M", (16777216,)), ("QLoRA table", QLORA_LEAVES)):
            if branch == "resident" and label == "16.8M":  # past the resident capacity
                continue
            groups = [(sizes, 2048)] if branch in ("dynamic", "lut") else \
                [((n,) * sizes.count(n), n) for n in sorted(set(sizes))]
            launches = []
            for sz, bs in groups:
                leaves, scalars, rws, _ = optim8_table(torch, gen, name, sz, 3, False, len(sz) > 1, 1,
                                                       bs=bs)
                rws, _, table, _ = O._check_leaves(name, leaves, scalars, rws, bs)
                plan = O.leaf_plan(tuple(lf.p.numel() for lf in leaves), bs, sms,
                                   branch == "resident")
                launches.append([leaves, scalars, rws, table, plan, bs])
            nbytes = sum(optim8_bytes(name == "adam", sz, bs) for sz, bs in groups)
            qm = lut if branch == "lut" else None

            def run(launches=launches, qm=qm, plan=None):
                for _, scalars, rws, table, p, bs in launches:
                    O._launch(stem, name, table, scalars, rws, plan or p, bs, True, False,
                              torch.device("cuda"), qm)

            parts = K_RESIDENT_PROBE_PARTS if branch == "resident" else OPTIM_PROBE_PARTS
            for part in ["real", "real, clean L2"] + list(parts):
                old = _build.use_library(stem, built[(stem, part)]) if part in parts else None
                us = time_cold(torch, run, iters=20, flush_by_read=part == "real, clean L2",
                               spin_cycles=4_000_000) * 1e3
                if old is not None:
                    _build.use_library(stem, old)
                out["optim_parts"].append(dict(kernel=stem, branch=branch, shape=label, part=part,
                                               us=us, bound_us=nbytes / HBM_BYTES_PER_S * 1e6))
                print(f"{stem} {name} {branch} {label}: {part:38s} {us:8.1f} us"
                      f" ({nbytes / us / 1e6:.2f} TB/s of the update's bytes)", flush=True)
            if branch == "dynamic":
                plan = launches[0][4]
                for cps in (1, 2, 3, 4, 6, 8):
                    p2 = plan._replace(grid=min(plan.total, sms * cps))
                    us = time_cold(torch, lambda: run(plan=p2), iters=20,
                                   spin_cycles=4_000_000) * 1e3
                    out["optim_grids"].append(dict(kernel=stem, shape=label, ctas_per_sm=cps,
                                                   picked=p2 == plan, us=us))
                    print(f"{stem} {name} {label}: {cps} CTAs per SM"
                          f"{' (picked)' if p2 == plan else ''}: {us:.1f} us", flush=True)
            del launches
    probe_resident(torch, out, gen, sms)


def probe_resident(torch, out, gen, sms):
    """Kernel K's resident body (lion, dynamic maps, one block a leaf): its
    cluster size swept over the QLoRA table's two leaf sizes (352 blocks of
    262,144, 96 of 704,512), then its route against its two-pass body over
    tables of 1 to 64 blocks of each, beside the route the plan takes
    (optim8_route: resident from RESIDENT_MIN_RUN blocks a cluster)."""
    from bitsandbytes_sycl_tpu_torch.ops import optim8 as O

    def timed(leaves, scalars, rws, table, plan, bs):
        return time_cold(torch, lambda: O._launch("optim8_1state", "lion", table, scalars, rws, plan,
                                                  bs, True, False, torch.device("cuda")),
                         iters=20, spin_cycles=4_000_000) * 1e3

    def table_of(n, T):
        leaves, scalars, rws, _ = optim8_table(torch, gen, "lion", (n,) * T, 3, False, T > 1, 1, bs=n)
        rws, _, table, _ = O._check_leaves("lion", leaves, scalars, rws, n)
        return leaves, scalars, rws, table

    def resident_at(n, T, c):
        """K's resident plan of T blocks of n at clusters of c CTAs, whatever
        route the plan takes for the table."""
        plan = O.leaf_plan((n,) * T, n, sms, True)
        per_cta, smem = O.resident_slices(n, c, False)
        return plan._replace(route="resident", grid=min(T, max(1, sms // c)) * c, cluster=c,
                             per_cta=per_cta, smem=smem)

    for n, T in ((262144, 352), (704512, 96)):
        t = table_of(n, T)
        picked = O.resident_cluster(n, False)
        least = -(-n // O.resident_per_cta_max(False))
        for c in range(least, O.RESIDENT_CLUSTER_MAX + 1):
            us = timed(*t, resident_at(n, T, c), n)
            out["optim_clusters"].append(dict(n=n, blocks=T, cluster=c, picked=c == picked, us=us))
            print(f"optim8_1state resident {n} x{T}: cluster {c:2d}{' (picked)' if c == picked else ''}:"
                  f" {us:.1f} us", flush=True)
        del t
    for n, Ts in ((262144, (1, 4, 16, 32, 64)), (704512, (1, 4, 8, 16, 32))):
        for T in Ts:
            t = table_of(n, T)
            two = timed(*t, O.leaf_plan((n,) * T, n, sms), n)
            res = timed(*t, resident_at(n, T, O.resident_cluster(n, False)), n)
            route = O.leaf_plan((n,) * T, n, sms, True).route
            out["optim_routes"].append(dict(n=n, blocks=T, two_pass_us=two, resident_us=res,
                                            route=route))
            print(f"optim8_1state {n} x{T:3d}: two-pass {two:7.1f} us, resident {res:7.1f} us; the plan"
                  f" takes {route}", flush=True)
            del t


DEQUANT_PROBE_PARTS = {  # E's TMA body: copies, conversion or stores alone; the old bodies
    "copies alone (no conversion, no stores)": ("BNB_PROBE_NO_DECODE", "BNB_PROBE_NO_STORE"),
    "conversion alone (no copies, no stores)": ("BNB_PROBE_NO_COPY", "BNB_PROBE_NO_STORE"),
    "stores alone (no copies, no conversion)": ("BNB_PROBE_NO_COPY", "BNB_PROBE_NO_DECODE"),
    "launch skeleton (all off)": ("BNB_PROBE_NO_COPY", "BNB_PROBE_NO_DECODE", "BNB_PROBE_NO_STORE"),
    "old bodies": ("BNB_E_OLD_BODIES",),
}


def probe_dequant(torch, out):
    """Where the time of E's TMA body goes, at the four 7B shapes (nf4, bs
    64; raw bf16 and compressed scales; bf16 and f32 out): each timed as
    built (cold L2 by write, and clean), built with parts switched off
    (DEQUANT_PROBE_PARTS: copies alone, conversion alone, stores alone;
    those builds compute wrong results) and as the bodies it replaced; then,
    bf16 out, the plans around dequant4_plan's pick (tile rows and
    columns, ring stages, CTAs per SM)."""
    from bitsandbytes_sycl_tpu_torch.ops import _build
    from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit as m4
    from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native, sm_count

    stem = "dequantize_transposed"
    built = _build.build_variants({part: (stem, macros)
                                   for part, macros in DEQUANT_PROBE_PARTS.items()})
    gen = torch.Generator(device="cuda").manual_seed(14)
    sms = sm_count(torch.device("cuda"))
    one = torch.zeros(1, device="cuda")
    floor = time_cold(torch, lambda: one.add_(1), iters=20) * 1e3
    out["dequant_parts"].append(dict(kernel="one-element add_", part="floor", us=floor))
    print(f"time_cold of a one-element add_ (the timing floor): {floor:.1f} us", flush=True)
    for N, K in SHAPES_7B:
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        for fmt in ("bf16", "compressed"):
            plan = m4.dequant4_plan(N, K, 64, sms, fmt == "compressed")
            w = quantize_4bit_native(W, 64, "nf4", absmax_dtype=torch.bfloat16,
                                     compress_statistics=fmt == "compressed")
            for od in (torch.bfloat16, torch.float32):
                bound = e_bytes(N, K, 64, 2 if od == torch.bfloat16 else 4,
                                fmt == "compressed") / HBM_BYTES_PER_S * 1e6
                label = f"N={N} K={K} {str(od)[6:]} out, {fmt} scales"
                for part in ["real", "real, clean L2"] + list(DEQUANT_PROBE_PARTS):
                    old = _build.use_library(stem, built[part]) if part in DEQUANT_PROBE_PARTS \
                        else None
                    us = time_cold(torch, lambda: m4._dequant4_launch(w, od, plan), iters=20,
                                   flush_by_read=part == "real, clean L2") * 1e3
                    if old is not None:
                        _build.use_library(stem, old)
                    out["dequant_parts"].append(dict(kernel=stem, shape=label, part=part, us=us,
                                                     bound_us=bound))
                    print(f"{stem} {label}: {part:42s} {us:7.1f} us (bound {bound:.2f})",
                          flush=True)
                if od != torch.bfloat16:
                    continue
                comp = fmt == "compressed"
                for rows in (32, 64):
                    for cols in (128, 256):
                        for slots in (2, 3, 4, 6):
                            tiles = -(-N // cols) * (K // 2 // rows)
                            smem = m4.deq4_smem(rows, cols, slots, 64, comp)
                            if smem > 225 * 1024:
                                continue
                            for per_sm in (1, 2, 3, 4):
                                if per_sm * (smem + 1024) > 233472:
                                    continue
                                waves = -(-tiles // (per_sm * sms))
                                p2 = m4.Dequant4Plan("tma", rows, cols, slots, -(-tiles // waves))
                                us = time_cold(torch, lambda: m4._dequant4_launch(w, od, p2),
                                               iters=20) * 1e3
                                out["dequant_plans"].append(dict(
                                    N=N, K=K, scales=fmt, plan=tuple(p2), ctas_per_sm=per_sm,
                                    picked=p2 == plan, us=us, bound_us=bound))
                                print(f"{stem} N={N:5d} K={K:5d} {fmt} scales {tuple(p2)} ({per_sm} a"
                                      f" SM){' (picked)' if p2 == plan else ''}: {us:.1f} us",
                                      flush=True)
            del w
        del W


INT8_PROBE_PARTS = {  # F's tiled and I's wgmma bodies: copies, decode or products, skeleton
    "dequant_int8": {"copies alone (no decode)": ("BNB_PROBE_NO_DECODE",),
                     "decode alone (no copies)": ("BNB_PROBE_NO_COPY",),
                     "launch skeleton (no copies, no decode)": ("BNB_PROBE_NO_COPY",
                                                                "BNB_PROBE_NO_DECODE")},
    "int8_matmul": {"copies alone (no products, no quantization)": ("BNB_PROBE_NO_MMA",
                                                                    "BNB_PROBE_NO_QUANT"),
                    "products alone (no copies)": ("BNB_PROBE_NO_COPY",),
                    "no x quantization": ("BNB_PROBE_NO_QUANT",),
                    "no split merge": ("BNB_PROBE_NO_MERGE",),
                    "launch skeleton (all off)": ("BNB_PROBE_NO_COPY", "BNB_PROBE_NO_MMA",
                                                  "BNB_PROBE_NO_QUANT", "BNB_PROBE_NO_MERGE")},
}


def probe_int8(torch, out):
    """Where the time of F's tiled body and I's wgmma body goes, at the four
    7B shapes (F: nf4, bs 64; I: bf16 x at M = 4 and 128): each timed as
    built (cold L2 by write, and clean) and built with parts switched off
    (INT8_PROBE_PARTS; those builds compute wrong results); then I's K
    split counts around the plan's pick."""
    from bitsandbytes_sycl_tpu_torch import functional as F
    from bitsandbytes_sycl_tpu_torch.ops import _build
    from bitsandbytes_sycl_tpu_torch.ops import matmul_int8 as mi
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as mw
    from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native, sm_count

    built = _build.build_variants({(stem, part): (stem, macros)
                                   for stem, parts in INT8_PROBE_PARTS.items()
                                   for part, macros in parts.items()})
    gen = torch.Generator(device="cuda").manual_seed(13)
    sms = sm_count(torch.device("cuda"))
    one = torch.zeros(1, device="cuda")
    floor = time_cold(torch, lambda: one.add_(1), iters=20) * 1e3
    out["int8_parts"].append(dict(kernel="one-element add_", part="floor", us=floor))
    print(f"time_cold of a one-element add_ (the timing floor): {floor:.1f} us", flush=True)

    def parts(stem, label, run, bound_us):
        for part in ["real", "real, clean L2"] + list(INT8_PROBE_PARTS[stem]):
            old = _build.use_library(stem, built[(stem, part)]) if part in INT8_PROBE_PARTS[stem] \
                else None
            us = time_cold(torch, run, iters=20, flush_by_read=part == "real, clean L2") * 1e3
            if old is not None:
                _build.use_library(stem, old)
            out["int8_parts"].append(dict(kernel=stem, shape=label, part=part, us=us,
                                          bound_us=bound_us))
            print(f"{stem} {label}: {part:44s} {us:7.1f} us (bound {bound_us:.2f})", flush=True)

    for N, K in ((4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)):
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        w = quantize_4bit_native(W, 64, "nf4", absmax_dtype=torch.bfloat16)
        _, f = mw.col_grid(w)
        plan = mw.dequant8_plan(N, K, 64, sms)
        bound = (K // 2 * N + 2 * (K // 128) * N * 4 + K * N) / HBM_BYTES_PER_S * 1e6
        parts("dequant_int8", f"N={N} K={K}", lambda: mw._dequant8_launch(w, f, plan), bound)
        del w, f
        CB, SCB = F.int8_vectorwise_quant(W)
        del W
        for M in (4, 128):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            ra = x.float().abs().amax(dim=1)
            inv = 127.0 * F._safe_inv(ra)
            plan = mi.int8_plan(M, N, K, sms)
            bound = max((M * K * 2 + N * K + N * 4 + M * 4 + M * N * 2) / HBM_BYTES_PER_S,
                        2 * M * N * K / INT8_OPS_PER_S) * 1e6
            parts("int8_matmul", f"N={N} K={K} M={M}",
                  lambda: mi._int8_launch(x, inv, CB, SCB, None, torch.bfloat16, plan), bound)
            for ks in sorted({1, 2, 3, 4, 6, 8, 12, 16, plan.ksplit}):
                p2 = mi.int8_split_plan(M, N, K, ks, sms)
                us = time_cold(torch, lambda: mi._int8_launch(x, inv, CB, SCB, None, torch.bfloat16,
                                                              p2), iters=20) * 1e3
                out["int8_plans"].append(dict(kernel="int8_matmul", N=N, K=K, M=M, plan=tuple(p2),
                                              picked=p2 == plan, ctas=-(-N // 128) * p2.ksplit,
                                              us=us))
                print(f"int8_matmul N={N:5d} K={K:5d} M={M:3d} {tuple(p2)}"
                      f"{' (picked)' if p2 == plan else ''}: {us:.1f} us", flush=True)
        del CB, SCB


def time_decode_main(root=None, repeats=2) -> int:
    """Phase 3's 7B NF4 decode step through the package under ``root``
    (default: beside this script): phase 3's weights (seed 0), prompts and
    warm-up, then ``repeats`` generate() runs through the paged and the
    contiguous engine each, with the host yardsticks read before each run.
    To compare two commits on one card, unpack the other one (``git
    archive``) into a directory that .gitignore lists and run, in one call,
    ``--time-decode DIR``, ``--time-decode``, ``--time-decode``,
    ``--time-decode DIR``. Lines go to stdout and are appended to
    chiprun_out/time_decode.jsonl."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --time-decode: no CUDA device", file=sys.stderr)
        return 2
    pkg_root = os.path.abspath(root or ROOT)
    sys.path.insert(0, pkg_root)
    from bitsandbytes_sycl_tpu_torch.models import llama
    from bitsandbytes_sycl_tpu_torch.ops import _build

    need(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(llama.__file__)))) == pkg_root,
         f"--time-decode: imported {llama.__file__}, not the package under {pkg_root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    card = gpu_line()
    label = os.path.relpath(pkg_root, ROOT)
    cfg = llama.LlamaConfig.llama7b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    prompts = prompts_from_seed(0, 8, cfg.vocab_size)
    serve(torch, dataclasses.replace(cfg, num_layers=1),  # compile-free warm-up
          dict(params, layers=params["layers"][:1]), prompts[:1], 2)
    rows = []
    for _ in range(repeats):
        for paged in (True, False):
            host = host_yardsticks(torch)
            outs, wall, steps = serve(torch, cfg, params, prompts, 32, paged=paged)
            need(all(len(o) == 32 for o in outs), f"--time-decode: output lengths {[len(o) for o in outs]}")
            steps = sorted(steps)
            ms = [steps[len(steps) * i // 4] * 1e3 for i in (1, 2, 3)]
            row = dict(paged=paged, steps=len(steps), median_ms=ms[1], quartiles_ms=[ms[0], ms[2]],
                       wall_s=wall, host=host)
            rows.append(row)
            print(f"decode step ({label}, {'paged' if paged else 'contiguous'}): median {ms[1]:.2f} ms"
                  f" ({ms[0]:.2f}-{ms[2]:.2f}) over {len(steps)} steps; python loop"
                  f" {host['python_loop_ms']:.2f} ms, enqueue {host['enqueue_us']:.2f} us", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "time_decode.jsonl"), "a") as f:
        f.write(json.dumps(dict(package=label, card=card, rows=rows)) + "\n")
    print(card)
    return 0


def time_i_main(root=None) -> int:
    """Kernel I's cold times through ``ops.matmul_int8.int8_matmul`` of the
    package under ``root`` (default: beside this script), bf16 x and
    output, no bias, at M = 4, 32 and 128 of the four 7B shapes, timed as
    check_int8 times them. To compare the kernel of two commits on one
    card, unpack the other one (``git archive``) into a directory that
    .gitignore lists and run, in one call, ``--time-i DIR``, ``--time-i``,
    ``--time-i``, ``--time-i DIR``. Lines go to stdout and are appended to
    chiprun_out/time_i.jsonl."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --time-i: no CUDA device", file=sys.stderr)
        return 2
    pkg_root = os.path.abspath(root or ROOT)
    sys.path.insert(0, pkg_root)
    from bitsandbytes_sycl_tpu_torch import functional as F
    from bitsandbytes_sycl_tpu_torch.ops import _build
    from bitsandbytes_sycl_tpu_torch.ops import matmul_int8 as mi

    need(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(mi.__file__)))) == pkg_root,
         f"--time-i: imported {mi.__file__}, not the package under {pkg_root}")
    _build.build_all()
    card = gpu_line()
    label = os.path.relpath(pkg_root, ROOT)
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for N, K in ((4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)):
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        CB, SCB = F.int8_vectorwise_quant(W)
        del W
        for M in (4, 32, 128):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            inv = 127.0 * F._safe_inv(x.float().abs().amax(dim=1))
            us = time_cold(torch, lambda: mi.int8_matmul(x, inv, CB, SCB, None, torch.bfloat16)) * 1e3
            rows.append(dict(N=N, K=K, M=M, us=us))
            print(f"int8_matmul ({label}) N={N:5d} K={K:5d} M={M:3d}: {us:.1f} us", flush=True)
        del CB, SCB
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "time_i.jsonl"), "a") as f:
        f.write(json.dumps(dict(package=label, card=card, rows=rows)) + "\n")
    print(card)
    return 0


def time_optim_main(root=None) -> int:
    """Kernels J and K through ``ops.optim8`` of the package under ``root``
    (default: beside this script), cold L2: the dynamic one-pass body, the
    LUT codec (phase 7d's quantile maps) and the blocks past 2048 (one
    block a leaf: J's two-pass body, K's on the route its plan takes, the
    resident body where the package has one), each at 16.8M parameters
    and over the 448-leaf QLoRA table, the blocks past 2048 also at one
    leaf of 262,144 and of 704,512. Each update goes through
    ``optim8_update``, so each package takes its own route. To
    compare two commits on one card, unpack the other one (``git archive``)
    into a directory that .gitignore lists and run, in one call,
    ``--time-optim DIR``, ``--time-optim``, ``--time-optim``,
    ``--time-optim DIR``. Lines go to stdout and are appended to
    chiprun_out/time_optim.jsonl."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --time-optim: no CUDA device", file=sys.stderr)
        return 2
    pkg_root = os.path.abspath(root or ROOT)
    sys.path.insert(0, pkg_root)
    from bitsandbytes_sycl_tpu_torch.ops import _build
    from bitsandbytes_sycl_tpu_torch.ops import optim8 as O

    need(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(O.__file__)))) == pkg_root,
         f"--time-optim: imported {O.__file__}, not the package under {pkg_root}")
    _build.build_all()
    card = gpu_line()
    label = os.path.relpath(pkg_root, ROOT)
    gen = torch.Generator(device="cuda").manual_seed(12)
    maps = state_maps()
    rows = []
    for name, stem in (("adam", "optim8_2state"), ("lion", "optim8_1state")):
        for branch in ("dynamic", "lut", "blocks>2048"):
            shapes = [("16.8M", (16777216,)), ("QLoRA table", QLORA_LEAVES)]
            if branch == "blocks>2048":
                shapes += [(str(n), (n,)) for n in (262144, 704512)]
            for shape, sizes in shapes:
                groups = [(sizes, 2048)] if branch != "blocks>2048" else \
                    [((n,) * sizes.count(n), n) for n in sorted(set(sizes))]
                qm = (maps if name == "adam" else (maps[0], None)) if branch == "lut" else None
                launches = [optim8_table(torch, gen, name, sz, 3, False, len(sz) > 1, 1, bs=bs)[:3]
                            + (bs,) for sz, bs in groups]

                def run(launches=launches, qm=qm, name=name):
                    for leaves, scalars, rws, bs in launches:
                        O.optim8_update(name, leaves, scalars, rws, blocksize=bs, apply_delta=True,
                                        qmaps=qm)

                us = time_cold(torch, run, iters=20, spin_cycles=20_000_000) * 1e3
                bound = sum(optim8_bytes(name == "adam", sz, bs) for sz, bs in groups) \
                    / HBM_BYTES_PER_S * 1e6
                rows.append(dict(kernel=stem, branch=branch, shape=shape, us=us, bound_us=bound))
                print(f"{stem} ({label}) {branch:8s} {shape:11s}: {us:.1f} us (bound {bound:.2f})",
                      flush=True)
                del launches
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "time_optim.jsonl"), "a") as f:
        f.write(json.dumps(dict(package=label, card=card, rows=rows)) + "\n")
    print(card)
    return 0


def probe_candidates(kernel, M, N, K, bs=64):
    """The launch plans near the ones mm4_plan / grouped_plan can pick:
    every tile (B) and 1-6 K splits on whole quantization blocks."""
    from bitsandbytes_sycl_tpu_torch.ops.common import LaunchPlan

    rows, tiles = (32, ((64, 128), (128, 128), (128, 256), (256, 128))) if kernel == "B" \
        else (64, ((256, 128),))
    steps, unit = K // 2 // rows, max(1, bs // rows)
    plans = []
    for bm, bn in tiles:
        if N % bn:
            continue
        for ks in range(1, 7):
            per = -(-(-(-steps // ks)) // unit) * unit
            p = LaunchPlan("tc" if kernel == "B" else "wgmma", bm, per, -(-steps // per), bn)
            if p not in plans:
                plans.append(p)
    return plans


def probe_fit(rows, tiles, sms):
    """The plan model's constants fitted to timed plans: for each tile its
    CTA time per K step, and the fixed and per-partial-element costs of a
    K split, so that waves * per * step_us + [split] * (split_us + ksplit
    * tiles * bm * bn * elem_us) matches each plan's time with the least
    squared relative error (non-negative least squares)."""
    import numpy as np
    from scipy.optimize import nnls

    keys = list(tiles)
    A, y = [], []
    for r in rows:
        bm, bn, per, ks = r["plan"][1], r["plan"][4], r["plan"][2], r["plan"][3]
        n_tiles = -(-r["M"] // bm) * (r["N"] // bn)
        waves = -(-(n_tiles * ks) // (sms * tiles[(bm, bn)]))
        a = [0.0] * (len(keys) + 2)
        a[keys.index((bm, bn))] = waves * per
        if ks > 1:
            a[-2], a[-1] = 1.0, ks * n_tiles * bm * bn
        A.append([v / r["us"] for v in a])
        y.append(1.0)
    scale = np.array([1.0] * (len(keys) + 1) + [1e-6])  # elem_us in units of 1e-6 us
    coef, _ = nnls(np.array(A) * scale, np.array(y))
    coef = coef * scale
    return {str(k): float(c) for k, c in zip(keys, coef)}, float(coef[-2]), float(coef[-1])


def probe_main(only=None) -> int:
    """Where the time of kernels B (its tensor-core body) and G (its wgmma
    body) goes, on one card. (1) Times every plan of probe_candidates at
    the four 7B shapes, B at 256 and 1024 rows and G at 512 and 2048,
    beside torch.matmul in bf16; fits the plan model's constants to those
    times (probe_fit) and, for each case, compares the plan the fitted
    model picks, and the plan the package picks now, with the fastest one
    timed. (2) Times B and G at 4096 x 4096 built with one part switched
    off (PROBE_PARTS): a part whose removal saves little is not what
    bounds the kernel; those builds compute wrong results. (0) First, the
    same for C's tensor-core and D's split bodies (probe_attention), for
    A's fused and H's split bodies (probe_decode), for J's and K's
    leaf-table bodies and J's LUT and two-pass branches (probe_optim), for
    F's tiled and I's wgmma bodies (probe_int8), for E's TMA body
    (probe_dequant) and for A's tensor-core body (probe_tc); with ``only``
    ("attention", "decode", "optim", "int8", "dequant" or "tc") that one
    alone. Lines go to stdout and
    chiprun_out/probe.json."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bitsandbytes_sycl_tpu_torch.ops import _build
    from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit as m4
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as mw
    from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native, sm_count

    t0 = time.perf_counter()
    _build.build_all()
    attention_only = only is not None
    variants = {} if attention_only else _build.build_variants(
        {(stem, part): (stem, macros) for stem, parts in PROBE_PARTS.items()
         for part, macros in parts.items()})
    card = gpu_line()
    print(f"{card}; built in {time.perf_counter() - t0:.1f} s", flush=True)
    sms = sm_count(torch.device("cuda"))
    out = dict(card=card, sms=sms, plans=[], parts=[], fit={}, picks=[], attention_parts=[],
               decode_parts=[], gemv_splits=[], decode_splits=[], optim_parts=[], optim_grids=[],
               optim_clusters=[], optim_routes=[], int8_parts=[], int8_plans=[], dequant_parts=[],
               dequant_plans=[], tc_parts=[], tc_splits=[])
    if only in (None, "attention"):
        probe_attention(torch, out)
    if only in (None, "decode"):
        probe_decode(torch, out)
    if only in (None, "optim"):
        probe_optim(torch, out)
    if only in (None, "int8"):
        probe_int8(torch, out)
    if only in (None, "dequant"):
        probe_dequant(torch, out)
    if only in (None, "tc"):
        probe_tc(torch, out)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for N, K in ([] if attention_only else [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]):
        W = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        w = quantize_4bit_native(W, 64, "nf4", absmax_dtype=torch.bfloat16)
        Wd = W.to(torch.bfloat16)
        del W
        for kern, Ms in (("B", (256, 1024)), ("G", (512, 2048))):
            for M in Ms:
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                lib_us = time_cold(torch, lambda: torch.matmul(x, Wd.T)) * 1e3
                if kern == "B":
                    chosen = m4.mm4_plan(M, N, K, 64, torch.bfloat16, sms)
                    run = lambda p: m4._mm4_launch(x, w, None, m4._MODE_BF16_TABLE, p)  # noqa: E731
                else:
                    chosen = mw.grouped_plan(M, N, K, 64, sms)
                    run = lambda p: mw._grouped_launch(x, w, None, torch.bfloat16, p)  # noqa: E731
                case = dict(kernel=kern, N=N, K=K, M=M, chosen=tuple(chosen), library_us=lib_us,
                            plans=[])
                for p in probe_candidates(kern, M, N, K):
                    us = time_cold(torch, lambda: run(p), iters=10) * 1e3
                    row = dict(kernel=kern, N=N, K=K, M=M, plan=tuple(p), us=us)
                    case["plans"].append(row)
                    out["plans"].append(row)
                    print(f"{kern} N={N:5d} K={K:5d} M={M:4d} {tuple(p)}"
                          f"{' (picked)' if p == chosen else ''}: {us:.1f} us"
                          f" (bf16 matmul {lib_us:.1f} us)", flush=True)
                cases.append(case)
                if (N, K) == (4096, 4096):
                    stem = "mm4_fused" if kern == "B" else "w4a8_grouped"
                    for part in ["real"] + list(PROBE_PARTS[stem]):
                        old = _build.use_library(stem, variants[(stem, part)]) if part != "real" \
                            else None
                        us = time_cold(torch, lambda: run(chosen), iters=10) * 1e3
                        if old is not None:
                            _build.use_library(stem, old)
                        out["parts"].append(dict(kernel=kern, M=M, part=part, us=us))
                        print(f"{kern} 4096 x 4096 M={M} {tuple(chosen)}: {part:14s} {us:.1f} us",
                              flush=True)
        del w, Wd
    for kern, tiles in (() if attention_only else
                        (("B", {k: v[0] for k, v in m4._MM4_TILES.items()}), ("G", {(256, 128): 1}))):
        rows = [r for r in out["plans"] if r["kernel"] == kern]
        step_us, split_us, elem_us = probe_fit(rows, tiles, sms)
        out["fit"][kern] = dict(step_us=step_us, split_us=split_us, elem_us=elem_us)
        print(f"{kern} fit: step_us {json.dumps({k: round(v, 3) for k, v in step_us.items()})},"
              f" split_us {split_us:.3f}, elem_us {elem_us:.3e}", flush=True)
        for case in [c for c in cases if c["kernel"] == kern]:
            def est(p):
                n_tiles = -(-case["M"] // p[1]) * (case["N"] // p[4])
                waves = -(-(n_tiles * p[3]) // (sms * tiles[(p[1], p[4])]))
                return waves * p[2] * step_us[str((p[1], p[4]))] + (
                    split_us + p[3] * n_tiles * p[1] * p[4] * elem_us if p[3] > 1 else 0.0)
            us = {r["plan"]: r["us"] for r in case["plans"]}
            best = min(us, key=us.get)
            model = min(us, key=lambda p: (est(p), p[3]))
            pick = dict(kernel=kern, N=case["N"], K=case["K"], M=case["M"], best=best,
                        best_us=us[best], fitted_pick=model, fitted_us=us[model],
                        fitted_est_us=est(model), package_pick=case["chosen"],
                        package_us=us.get(case["chosen"]), library_us=case["library_us"])
            out["picks"].append(pick)
            print(f"{kern} N={case['N']:5d} K={case['K']:5d} M={case['M']:4d}: fastest {best}"
                  f" {us[best]:.1f} us; fitted model picks {model} {us[model]:.1f} us"
                  f" (est {est(model):.1f}); package picks {case['chosen']} "
                  + (f"{us[case['chosen']]:.1f} us" if case["chosen"] in us else "(not timed)"),
                  flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(card)
    return 0


def phase12_main() -> int:
    """Phase 12 alone (``chip_smoke.py --phase12``): the build, phase 3's
    paged and phase 3c's contiguous serves for the references (no
    profile), then phase 12."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bitsandbytes_sycl_tpu_torch.models.llama import LlamaConfig, init_params
    from bitsandbytes_sycl_tpu_torch.ops import KERNELS, _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        print(f"[1] built {len(KERNELS)} kernels in {_build.build_all():.1f} s; {gpu_line()};"
              f" torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        cfg = LlamaConfig.llama7b()
        params = init_params(cfg, seed=0, device="cuda")
        prompts = prompts_from_seed(0, 8, cfg.vocab_size)
        refs = {"paged_logits": {}}
        for mode, paged in (("paged", True), ("contiguous", False)):
            reset_counts(KERNELS)
            refs[f"{mode}_outs"], wall, _ = serve(
                torch, cfg, params, prompts, 32, paged=paged,
                per_request=refs["paged_logits"] if paged else None)
            refs[f"{mode}_counts"] = read_counts(KERNELS)
            print(f"[3{'' if paged else 'c'}] reference serve {mode}: {wall:.2f} s", flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        stats = parallel_12(torch, cfg, prompts, refs, KERNELS)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    stats["seconds"]["parallel"] = time.perf_counter() - t0
    stats["seconds"]["total"] = time.perf_counter() - t_start
    os.makedirs(PHASE12_DIR, exist_ok=True)
    with open(os.path.join(PHASE12_DIR, "phase12.json"), "w") as f:
        json.dump(stats, f, indent=1, default=str)
    print(f"phase 12 seconds: {json.dumps({k: round(v, 2) for k, v in stats['seconds'].items()})}")
    print(gpu_line())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_child_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--phase12"]:
        sys.exit(phase12_main())
    if sys.argv[1:2] == ["--load-rss"]:
        sys.exit(load_rss_main(sys.argv[2]))
    if sys.argv[1:2] == ["--time-decode"]:
        sys.exit(time_decode_main(sys.argv[2] if len(sys.argv) > 2 else None))
    if sys.argv[1:2] == ["--time-i"]:
        sys.exit(time_i_main(sys.argv[2] if len(sys.argv) > 2 else None))
    if sys.argv[1:2] == ["--time-optim"]:
        sys.exit(time_optim_main(sys.argv[2] if len(sys.argv) > 2 else None))
    if sys.argv[1:2] == ["--probe"]:
        sys.exit(probe_main(only=sys.argv[2] if sys.argv[2:3] in (["attention"], ["decode"], ["optim"],
                                                                ["int8"], ["dequant"], ["tc"])
                            else None))
    sys.exit(main())
