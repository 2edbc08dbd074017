"""The options of the port's LlamaConfig that other model families set
(Gemma, Qwen2, Mistral) against the JAX package, on the tiny config of
test_torch_llama_engine.py (head_dim = 128, so the kernels' shapes hold):
prefill logits with the int8 cache and without one, and one paged decode
step. The JAX package attends through its Pallas kernels here, in
interpret mode, as it does on a TPU.

Tolerance, as in test_torch_llama_engine.py: last-bit differences (a KV
code one step apart, a bf16 rounding) are amplified by this random tiny
model, most by W4A8's per-row requantization of every activation; logits
agree within 5% of the largest and 4% in relative L2 (measured: at most
3.8% and 2.2%, in the prefill with the cache; the decode step from the
same pool agrees bit for bit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu.engine.paged import init_page_pool as j_pool
from bitsandbytes_sycl_tpu.engine.paged import paged_ingest as j_ingest
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu_torch.convert import params_from_jax
from bitsandbytes_sycl_tpu_torch.engine.paged import init_page_pool as t_pool
from bitsandbytes_sycl_tpu_torch.engine.paged import paged_ingest as t_ingest
from bitsandbytes_sycl_tpu_torch.models import llama as TL

LOGIT_TOL = 5e-2  # of the largest |logit|
LOGIT_REL_L2 = 4e-2
SHAPE = dict(hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)

OPTIONS = {
    "scale_embeddings": dict(scale_embeddings=True),
    "norm_offset": dict(norm_offset=True),
    "sandwich_norms": dict(sandwich_norms=True),
    "gelu_tanh": dict(mlp_act="gelu_tanh"),
    "attn_bias": dict(attn_bias=True),
    "query_scale": dict(query_scale=32.0),
    "attn_logit_softcap": dict(attn_logit_softcap=0.5),
    "final_logit_softcap": dict(final_logit_softcap=2.0),
    "sliding_window": dict(sliding_window=8),
    "sliding_alternating": dict(sliding_window=8, sliding_alternating=True),
}


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale, (np.abs(got - want).max(), scale)
    assert np.linalg.norm(got - want) <= LOGIT_REL_L2 * np.linalg.norm(want)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(monkeypatch, name):
    monkeypatch.setattr(JL, "_use_fused_decode_attn", lambda cfg: True)
    kw = OPTIONS[name]
    jc, tc = JL.LlamaConfig.tiny(**SHAPE, **kw), TL.LlamaConfig.tiny(**SHAPE, **kw)
    jp = JL.init_params(jc, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    B, T = 2, 32
    toks = np.random.default_rng(7).integers(0, 256, (B, T)).astype(np.int32)

    # no cache: the same attention code in both packages
    want, _ = JL.llama_forward(jp, jc, jnp.asarray(toks))
    got, _ = TL.llama_forward(tp, tc, torch.from_numpy(toks))
    _close_logits(got.numpy(), want)

    # prefill into the contiguous int8 cache (the port's kernel C path)
    want, jcache = JL.llama_forward(jp, jc, jnp.asarray(toks), JL.init_kv_cache(jc, B))
    got, tcache = TL.llama_forward(tp, tc, torch.from_numpy(toks), TL.init_kv_cache(tc, B, "cpu"))
    _close_logits(got.numpy(), want)

    # one decode step over pages holding the JAX package's prefill cache
    # (the port's kernel D path): row b's tokens in page 1 + b
    page_ids = np.asarray([[1, 3], [2, 4]], np.int32)
    used, valid = np.asarray([1, 1], np.int32), np.asarray([True, True])
    scratch = {k: np.asarray(v) for k, v in jcache.items()}
    jpool = j_ingest(j_pool(jc, 5, 128), {k: jnp.asarray(v) for k, v in scratch.items()},
                     jnp.asarray(page_ids), jnp.asarray(used), jnp.asarray(valid))
    tpool = t_ingest(t_pool(tc, 5, 128, "cpu"), {k: torch.from_numpy(v.copy()) for k, v in scratch.items()},
                     page_ids, used, valid)
    table = np.asarray([[1, 1], [2, 2]], np.int32)  # unused entries repeat the last page
    tok, pos = np.asarray([[3], [5]], np.int32), np.full((B, 1), T, np.int32)
    wp, wo = table[:, 0].copy(), np.full((B,), T, np.int32)
    jcache = dict(jpool, page_table=jnp.asarray(table), write_page=jnp.asarray(wp),
                  write_off=jnp.asarray(wo))
    tcache = dict(tpool, page_table=torch.from_numpy(table), write_page=torch.from_numpy(wp),
                  write_off=torch.from_numpy(wo))
    want, _ = JL.llama_forward(jp, dataclasses.replace(jc, pages_hint=1), jnp.asarray(tok),
                               jcache, jnp.asarray(pos))
    got, _ = TL.llama_forward(tp, tc, torch.from_numpy(tok), tcache, torch.from_numpy(pos))
    _close_logits(got.numpy(), want)
