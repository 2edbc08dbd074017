"""The algebra of kernel H's split body on the CPU: the row's used span
[lo, len) cut into tiles, each split's equal share of the tiles kept as a
softmax state (m, l, acc) with weight 0 on masked positions, the splits
merged in order and the step's new_kv token folded in last
(``_split_merge_plain``), against the one-shot plain version
``_decode_plain`` at 1, 2 and k splits. f32 sums over <= 44 positions in
two orders: within 1e-5, as for kernel D's split body."""

import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu_torch.ops.attention import _decode_plain


def _split_merge_plain(q4, kq, ks, vq, vs, li, lengths, new_kv, scale, window, softcap, alibi,
                       nsplit: int, tile: int):
    """Kernel H's split body restated in PyTorch: with end = min(len, S),
    qpos = len (new_kv given) or len - 1 and lo = max(0, qpos + 1 - window)
    (0 without a window), the n tiles of ``tile`` positions from tile
    min(lo, end) // tile to the one holding end - 1 go in equal shares to
    the splits, split z taking [t + z n // nsplit, t + (z + 1) n //
    nsplit); each keeps (m, l, acc) with weight 0 on masked positions (an
    empty share: m = -1e30, l = 0, acc = 0); the splits merge in order,
    then new_kv folds in as one more online-softmax step."""
    B, Hkv, rep, D = q4.shape
    S = vq.shape[3]
    qf = q4.float()
    sc = (qf @ kq[li].float()) * (ks[li].float()[:, :, None, :] * scale)  # (B, Hkv, rep, S)
    lens = lengths.long().reshape(B, 1, 1, 1)
    pos = torch.arange(S).reshape(1, 1, 1, S)
    qpos = lens if new_kv is not None else lens - 1
    if alibi is not None:
        sc = sc + alibi.float().reshape(1, Hkv, rep, 1) * (pos - qpos).float()
    if softcap is not None:
        sc = softcap * torch.tanh(sc * np.float32(1.0 / softcap))
    end = lens.clamp(0, S)
    lo = (qpos + 1 - window).clamp(min=0) if window is not None else torch.zeros_like(lens)
    valid = (pos >= lo) & (pos < end)
    t_lo = torch.minimum(lo, end) // tile
    nt = (end + tile - 1) // tile - t_lo
    tpos = pos // tile
    v = vq[li].float()  # (B, Hkv, S, D)
    wv = vs[li].float()[:, :, None, :] * np.float32(1.0 / 127.0)
    ms, ls, accs = [], [], []
    for z in range(nsplit):
        vz = valid & (tpos >= t_lo + z * nt // nsplit) & (tpos < t_lo + (z + 1) * nt // nsplit)
        m = torch.where(vz, sc, torch.full_like(sc, -1e30)).amax(dim=-1, keepdim=True)
        w = torch.where(vz, torch.exp(sc - m), torch.zeros_like(sc))
        ms.append(m)
        ls.append(w.sum(dim=-1, keepdim=True))
        accs.append((w * wv) @ v)
    M = ms[0]
    for m in ms[1:]:
        M = torch.maximum(M, m)
    L_ = torch.zeros_like(M)
    A = torch.zeros_like(accs[0])
    for m, l, a in zip(ms, ls, accs):
        f = torch.exp(m - M)
        L_ = L_ + l * f
        A = A + a * f
    if new_kv is None:
        return (A * torch.where(lens > 0, 1.0 / L_, torch.zeros_like(L_))).to(q4.dtype)
    kn, ksn, vn, vsn = new_kv
    sn = (qf * kn.float()[:, :, None, :]).sum(dim=-1, keepdim=True)
    sn = sn * (ksn.float()[:, :, None, None] * scale)
    if softcap is not None:
        sn = softcap * torch.tanh(sn * np.float32(1.0 / softcap))
    m2 = torch.maximum(M, sn)
    alpha = torch.exp(M - m2)
    w_new = torch.exp(sn - m2)
    inv = 1.0 / (L_ * alpha + w_new)
    vsn_c = vsn.float()[:, :, None, None] * np.float32(1.0 / 127.0)
    return (A * alpha * inv + (w_new * inv * vsn_c) * vn.float()[:, :, None, :]).to(q4.dtype)


L, B, HKV, D, S, TILE = 2, 4, 2, 16, 44, 8  # the last tile runs past S, as S % 128 != 0 does
SCALE = 0.02


def _cache(seed, rep):
    rng = np.random.default_rng(seed)
    kq = torch.from_numpy(rng.integers(-127, 128, (L, B, HKV, D, S)).astype(np.int8))
    vq = torch.from_numpy(rng.integers(-127, 128, (L, B, HKV, S, D)).astype(np.int8))
    # k scales give O(1) scores: q ~ N(0, 1), codes uniform in +-127
    ks = torch.from_numpy(rng.uniform(0.5, 1.5, (L, B, HKV, S)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.5, 2.0, (L, B, HKV, S)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(B, HKV, rep, D)).astype(np.float32))
    new_kv = (torch.from_numpy(rng.integers(-127, 128, (B, HKV, D)).astype(np.int8)),
              torch.from_numpy(rng.uniform(0.5, 1.5, (B, HKV)).astype(np.float32)),
              torch.from_numpy(rng.integers(-127, 128, (B, HKV, D)).astype(np.int8)),
              torch.from_numpy(rng.uniform(0.5, 2.0, (B, HKV)).astype(np.float32)))
    alibi = torch.from_numpy(rng.uniform(0.0, 0.1, (HKV * rep,)).astype(np.float32))
    return q, kq, ks, vq, vs, new_kv, alibi


# lengths: len 0 (no valid position), one position, rows with fewer tiles
# than splits (empty shares), shares that cross tiles, the whole cache
LENS = [[0, 1, 7, 44], [9, 17, 25, 40], [16, 0, 33, 43]]


@pytest.mark.parametrize("nsplit", [1, 2, 3, 6], ids=lambda n: f"splits{n}")
@pytest.mark.parametrize("new", [False, True], ids=["no_new_kv", "new_kv"])
@pytest.mark.parametrize("opt", [dict(), dict(window=10), dict(softcap=3.0), dict(alibi=True)],
                         ids=["plain", "window", "softcap", "alibi"])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_split_merge_matches_plain(nsplit, new, opt, rep):
    q, kq, ks, vq, vs, new_kv, slopes = _cache(11 + rep, rep)
    nk = new_kv if new else None
    window, softcap = opt.get("window"), opt.get("softcap")
    alibi = slopes if opt.get("alibi") else None
    for lens_l in LENS:
        lens = torch.tensor(lens_l, dtype=torch.int32)
        for li in range(L):
            want = _decode_plain(q, kq, ks, vq, vs, li, lens, nk, SCALE, window, softcap, alibi)
            got = _split_merge_plain(q, kq, ks, vq, vs, li, lens, nk, SCALE, window, softcap, alibi,
                                     nsplit, TILE)
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            if not new:  # len == 0 without new_kv: zeros
                assert (got[lens == 0] == 0).all()


def test_window_start_skips_the_tiles_before_it():
    """A window whose first position lies in tile 2 starts the split shares
    there: garbled keys before the window must not move the answer, and 2
    splits then share only the tiles the window covers."""
    q, kq, ks, vq, vs, new_kv, _ = _cache(5, 2)
    lens = torch.tensor([40, 38, 43, 44], dtype=torch.int32)  # qpos 40..44 with new_kv
    want = _decode_plain(q, kq, ks, vq, vs, 1, lens, new_kv, SCALE, 20, None, None)
    got = _split_merge_plain(q, kq, ks, vq, vs, 1, lens, new_kv, SCALE, 20, None, None, 2, TILE)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    kq2 = kq.clone()
    kq2[1, :, :, :, :16] = 127  # positions 0-15, before every row's window (lo >= 19)
    got2 = _split_merge_plain(q, kq2, ks, vq, vs, 1, lens, new_kv, SCALE, 20, None, None, 2, TILE)
    assert torch.equal(got2, got)
