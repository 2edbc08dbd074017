"""The algebra of kernel D's split body on the CPU: per-split softmax
states (m, l, acc), with weight 0 on masked tokens, merged in split order
and with the step's new_kv token folded in last (``_split_merge_plain``),
against the one-shot plain version ``_paged_plain`` at 1, 2 and k splits.
f32 sums over <= 48 tokens in two orders: within 1e-5."""

import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu_torch.ops.paged_attention import _paged_plain


def _split_merge_plain(q4, kp, ks, vp, vs, li, page_table, lengths, new_kv, scale, window,
                       softcap, alibi, nsplit: int):
    """Kernel D's split body restated in PyTorch: split z takes the pages
    [z u / nsplit, (z + 1) u / nsplit) of a row's u = max(ceil(len / P), 1)
    used pages and keeps (m, l, acc) with weight 0 on masked tokens (an
    empty split: m = -1e30, l = 0, acc = 0); the splits merge in order,
    then new_kv folds in as one more online-softmax step."""
    B, Hkv, rep, D = q4.shape
    P = vs.shape[3]
    MAXP = page_table.shape[1]
    pt = page_table.long()
    S = MAXP * P
    k = kp[li][pt].permute(0, 2, 1, 3, 4).reshape(B, Hkv, S, D).float()
    v = vp[li][pt].permute(0, 2, 1, 3, 4).reshape(B, Hkv, S, D).float()
    ksg = ks[li][pt].permute(0, 2, 1, 3).reshape(B, Hkv, 1, S).float()
    vsg = vs[li][pt].permute(0, 2, 1, 3).reshape(B, Hkv, 1, S).float()
    qf = q4.float()
    sc = torch.einsum("bhrd,bhsd->bhrs", qf, k) * (ksg * scale)
    lens = lengths.long().reshape(B, 1, 1, 1)
    pos = torch.arange(S).reshape(1, 1, 1, S)
    qpos = lens if new_kv is not None else lens - 1
    if alibi is not None:
        sc = sc + alibi.float().reshape(1, Hkv, rep, 1) * (pos - qpos).float()
    if softcap is not None:
        sc = softcap * torch.tanh(sc * np.float32(1.0 / softcap))
    valid = pos < lens
    if window is not None:
        valid = valid & (pos >= qpos + 1 - window)
    wv = vsg * np.float32(1.0 / 127.0)
    used = ((lens + P - 1) // P).clamp(1, MAXP)
    page = pos // P
    ms, ls, accs = [], [], []
    for z in range(nsplit):
        vz = valid & (page >= z * used // nsplit) & (page < (z + 1) * used // nsplit)
        m = torch.where(vz, sc, torch.full_like(sc, -1e30)).amax(dim=-1, keepdim=True)
        w = torch.where(vz, torch.exp(sc - m), torch.zeros_like(sc))
        ms.append(m)
        ls.append(w.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhrs,bhsd->bhrd", w * wv, v))
    M = ms[0]
    for m in ms[1:]:
        M = torch.maximum(M, m)
    L_ = torch.zeros_like(M)
    A = torch.zeros_like(accs[0])
    for m, l, a in zip(ms, ls, accs):
        f = torch.exp(m - M)
        L_ = L_ + l * f
        A = A + a * f
    if new_kv is not None:
        kn, ksn, vn, vsn = new_kv
        sn = (qf * kn.float()[:, :, None, :]).sum(dim=-1, keepdim=True)
        sn = sn * (ksn.float()[:, :, None, None] * scale)
        if softcap is not None:
            sn = softcap * torch.tanh(sn * np.float32(1.0 / softcap))
        m2 = torch.maximum(M, sn)
        alpha = torch.exp(M - m2)
        w_new = torch.exp(sn - m2)
        l2 = L_ * alpha + w_new
        wv_new = w_new * (vsn.float()[:, :, None, None] * np.float32(1.0 / 127.0))
        o = (A * alpha + wv_new * vn.float()[:, :, None, :]) / l2
    else:
        o = A * torch.where(lens > 0, 1.0 / L_, torch.zeros_like(L_))
    return o.to(q4.dtype)

L, B, HKV, D, P, MAXP = 2, 4, 2, 16, 8, 6
SCALE = 0.02


def _pool(seed, rep):
    rng = np.random.default_rng(seed)
    NP = B * MAXP + 1
    kp = torch.from_numpy(rng.integers(-127, 128, (L, NP, HKV, P, D)).astype(np.int8))
    vp = torch.from_numpy(rng.integers(-127, 128, (L, NP, HKV, P, D)).astype(np.int8))
    # k scales give O(1) scores: q ~ N(0, 1), codes uniform in +-127
    ks = torch.from_numpy(rng.uniform(0.5, 1.5, (L, NP, HKV, P)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.5, 2.0, (L, NP, HKV, P)).astype(np.float32))
    table = torch.from_numpy((rng.permutation(NP - 1)[: B * MAXP] + 1).reshape(B, MAXP).astype(np.int32))
    q = torch.from_numpy(rng.normal(size=(B, HKV, rep, D)).astype(np.float32))
    new_kv = (torch.from_numpy(rng.integers(-127, 128, (B, HKV, D)).astype(np.int8)),
              torch.from_numpy(rng.uniform(0.5, 1.5, (B, HKV)).astype(np.float32)),
              torch.from_numpy(rng.integers(-127, 128, (B, HKV, D)).astype(np.int8)),
              torch.from_numpy(rng.uniform(0.5, 2.0, (B, HKV)).astype(np.float32)))
    alibi = torch.from_numpy(rng.uniform(0.0, 0.1, (HKV * rep,)).astype(np.float32))
    return q, kp, ks, vp, vs, table, new_kv, alibi


# lengths: len 0 (no valid token), one token, rows with fewer used pages
# than splits (some splits empty), rows whose shares cross pages, the whole
# table
LENS = [[0, 1, 7, 48], [9, 17, 25, 40], [16, 0, 33, 47]]


@pytest.mark.parametrize("nsplit", [1, 2, 3, MAXP], ids=lambda n: f"splits{n}")
@pytest.mark.parametrize("new", [False, True], ids=["no_new_kv", "new_kv"])
@pytest.mark.parametrize("opt", [dict(), dict(window=10), dict(softcap=3.0), dict(alibi=True)],
                         ids=["plain", "window", "softcap", "alibi"])
@pytest.mark.parametrize("rep", [1, 2])
def test_split_merge_matches_plain(nsplit, new, opt, rep):
    q, kp, ks, vp, vs, table, new_kv, slopes = _pool(7 + rep, rep)
    nk = new_kv if new else None
    window, softcap = opt.get("window"), opt.get("softcap")
    alibi = slopes if opt.get("alibi") else None
    for lens_l in LENS:
        lens = torch.tensor(lens_l, dtype=torch.int32)
        for li in range(L):
            want = _paged_plain(q, kp, ks, vp, vs, li, table, lens, nk, SCALE, window, softcap, alibi)
            got = _split_merge_plain(q, kp, ks, vp, vs, li, table, lens, nk, SCALE, window, softcap,
                                     alibi, nsplit)
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            if not new:  # len == 0 without new_kv: zeros
                assert (got[lens == 0] == 0).all()


def test_window_crossing_a_split_drops_the_early_split():
    """A window that starts inside split 1 leaves split 0 with no valid
    token: its partial must weigh nothing, whatever its keys."""
    q, kp, ks, vp, vs, table, new_kv, _ = _pool(3, 2)
    # 4 used pages in every row (25-32 tokens), so 2 splits take pages 0-1
    # and 2-3; the windows start at tokens 17-24, inside split 1
    lens = torch.tensor([25, 28, 30, 32], dtype=torch.int32)
    want = _paged_plain(q, kp, ks, vp, vs, 1, table, lens, new_kv, SCALE, 8, None, None)
    got = _split_merge_plain(q, kp, ks, vp, vs, 1, table, lens, new_kv, SCALE, 8, None, None, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # split 0 (pages 0-1, tokens 0-15) garbled: the answer must not move
    kp2 = kp.clone()
    kp2[1][table[:, :2].long()] = 127
    got2 = _split_merge_plain(q, kp2, ks, vp, vs, 1, table, lens, new_kv, SCALE, 8, None, None, 2)
    assert torch.equal(got2, got)
