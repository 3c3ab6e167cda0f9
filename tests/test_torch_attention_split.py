"""The arithmetic around the redesigned attention kernels, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py); what
surrounds them is held here:

* ``ops.decode_split_plan``, the split of the decode kernels' KV axis:
  every key covered exactly once by whole 32-key tiles, no empty split,
  and about one block an SM where the cache is long enough;
* the log-sum-exp merge the decode kernels do in their last block: the
  plain version over each planned chunk (the other keys masked), merged,
  equals one unsplit call within 1e-6 in fp32, in the dense and the paged
  layout, with wholly masked chunks and rows with no valid key;
* the numerics of the bf16 prefill body on the tensor cores, emulated in
  fp32: 64-key tiles, the online softmax in log2 units, and P entering
  P V as two bf16 parts (hi + lo); held to the windowed prefill's
  2e-3 + 1e-2 |want| limit against the plain version.

    python tests/test_torch_attention_split.py

prints the emulation's worst error over that limit at recurrentgemma-9b's
windowed prefill geometry for one batch row (16 heads over 2304 positions,
head_dim 256, window 2048), with P as one rounded bf16 operand and as
hi + lo.
"""
import math

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro_torch.kernels import ops, ref

NEG_BIG = -3.0e38


# -- the split plan ----------------------------------------------------------


def _lengths():
    return sorted(set(range(1, 300)) | set(range(300, 4097, 37)) | {2047, 2048, 2049, 4096})


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("g", [1, 8, 16])
@pytest.mark.parametrize("bhkv", [1, 2, 4, 8, 16, 32, 64])
def test_decode_split_plan(sms, g, bhkv):
    """b * hkv from 1 to 64 (as b = bhkv over one KV head and over two),
    S from 1 to 4096."""
    for b, hkv in ((bhkv, 1), (max(1, bhkv // 2), min(2, bhkv))):
        groups = b * hkv * -(-g // ops.DECODE_ROWS)
        target = sms
        for S in _lengths():
            chunk, splits = ops.decode_split_plan(b, g * hkv, hkv, S, sms)
            assert chunk > 0 and chunk % ops.DECODE_TILE == 0
            starts = [z * chunk for z in range(splits)]
            assert starts[-1] < S <= splits * chunk            # covered, no empty split
            covered = np.zeros(S, dtype=int)
            for z0 in starts:
                covered[z0:z0 + chunk] += 1
            assert (covered == 1).all()
            tiles = -(-S // ops.DECODE_TILE)
            blocks = groups * splits
            assert splits <= tiles
            # about one block an SM: never past the target by a whole
            # unsplit grid, and at least half of it where S allows
            assert splits == 1 or blocks < target + groups
            assert blocks >= min(target, groups * tiles) / 2


def test_decode_split_plan_main_shapes():
    """recurrentgemma-9b's ring (b 4, 16 q heads over 1 KV head, 2048
    entries): more than 100 blocks on 132 SMs, each warp of a block one
    32-key tile; a batch that fills the card by itself is not split."""
    chunk, splits = ops.decode_split_plan(4, 16, 1, 2048, 132)
    assert 4 * 2 * splits > 100 and (chunk, splits) == (128, 16)
    assert ops.decode_split_plan(64, 64, 8, 512, 132)[1] == 1


# -- the merge of the splits -------------------------------------------------


def _merge(parts):
    """The last block's merge: M = max m_z; weights exp(m_z - M) (zero for
    an empty split); a row with no valid key in any split gives m = -inf,
    l = 0, acc = 0."""
    ms = torch.stack([p[0] for p in parts])
    ls = torch.stack([p[1] for p in parts])
    accs = torch.stack([p[2] for p in parts])
    M = ms.amax(dim=0)
    live = M > NEG_BIG / 2
    w = torch.where(live, torch.exp(ms - torch.where(live, M, torch.zeros_like(M))),
                    torch.zeros_like(ms))
    L = (w * ls).sum(0)
    A = (w[..., None] * accs).sum(0)
    return torch.where(live, M, torch.full_like(M, float("-inf"))), L, A


def _chunks(S, chunk, splits):
    key = torch.arange(S)
    return [(key >= z * chunk) & (key < (z + 1) * chunk) for z in range(splits)]


def _assert_merge(parts, whole):
    """m within 1e-6, l within 1e-6 of itself and the output acc / l within
    1e-6 (the sums run over the keys in another order); a row with no valid
    key is exactly (-inf, 0, 0) in both."""
    m, l, acc = _merge(parts)
    m2, l2, acc2 = whole
    dead = torch.isneginf(m2)
    assert torch.equal(torch.isneginf(m), dead)
    assert not l[dead].any() and not acc[dead].any() and not l2[dead].any()
    live = ~dead
    torch.testing.assert_close(m[live], m2[live], atol=1e-6, rtol=0)
    torch.testing.assert_close(l[live], l2[live], atol=0, rtol=1e-6)
    torch.testing.assert_close((acc / l[..., None])[live], (acc2 / l2[..., None])[live],
                               atol=1e-6, rtol=0)
    return m


@pytest.mark.parametrize("b,hq,hkv,S,sms", [(2, 4, 1, 300, 8), (3, 8, 2, 97, 24), (2, 16, 1, 2048, 132)])
def test_decode_split_merge_dense(b, hq, hkv, S, sms):
    rng = np.random.default_rng(S + hq)
    hd = 16
    q = torch.from_numpy(rng.standard_normal((b, hq, 1, hd), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, S, hd), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, S, hd), dtype=np.float32))
    chunk, splits = ops.decode_split_plan(b, hq, hkv, S, sms)
    assert splits > 2
    valid = torch.from_numpy(rng.random((b, S)) < 0.7)
    valid[0, :chunk] = False                    # a wholly masked chunk
    valid[0, (splits - 1) * chunk:] = False     # and the last, short one
    valid[-1] = False                           # a row with no valid key
    scale = hd ** -0.5
    parts = [ref.decode_attention_ref(q, k, v, valid & c, scale) for c in _chunks(S, chunk, splits)]
    whole = ref.decode_attention_ref(q, k, v, valid, scale)
    m = _assert_merge(parts, whole)
    assert torch.isneginf(m[-1]).all() and torch.isfinite(m[0]).all()


@pytest.mark.parametrize("bs,nbps,sms", [(16, 19, 32), (8, 40, 32)])
def test_decode_split_merge_paged(bs, nbps, sms):
    """Through shuffled tables with null entries: chunks over unallocated
    blocks are empty and merge as nothing."""
    rng = np.random.default_rng(bs * nbps)
    b, hq, hkv, hd = 3, 8, 2, 16
    nb = b * nbps + 1
    q = torch.from_numpy(rng.standard_normal((b, hq, 1, hd), dtype=np.float32))
    kp = torch.from_numpy(rng.standard_normal((nb, hkv, bs, hd), dtype=np.float32))
    vp = torch.from_numpy(rng.standard_normal((nb, hkv, bs, hd), dtype=np.float32))
    bt = torch.from_numpy((rng.permutation(nb - 1)[:b * nbps] + 1).reshape(b, nbps).astype(np.int32))
    S = nbps * bs
    lens = torch.tensor([S // 3, S - 5, 0])       # the last slot has no valid key
    bt[0, -(-int(lens[0]) // bs):] = 0            # unallocated tail: the null block
    valid = torch.arange(S)[None, :] < lens[:, None]
    chunk, splits = ops.decode_split_plan(b, hq, hkv, S, sms)
    assert splits > 2 and chunk * (splits - 1) >= lens[0]   # slot 0 has dead splits
    scale = hd ** -0.5
    parts = [ref.paged_decode_attention_ref(q, kp, vp, bt, valid & c, scale)
             for c in _chunks(S, chunk, splits)]
    m = _assert_merge(parts, ref.paged_decode_attention_ref(q, kp, vp, bt, valid, scale))
    assert torch.isneginf(m[-1]).all()


# -- the bf16 prefill body's numerics, emulated --------------------------------


def emulate_mma_prefill(q, k, v, q_pos, scale, window=0, hi_lo=True, bk=64):
    """The tensor-core body's arithmetic in fp32 on bf16-valued inputs: per
    64-key tile the scores in log2 units, the running max over the tile,
    p = exp2(s - m) (masked: exactly 0), l summing the fp32 p, and P V with
    P rounded to bf16 (``hi_lo``: as bf16 hi + bf16 lo).  One KV head;
    q (hq, Sq, hd), k/v (Sk, hd), q_pos (Sq,) -> (hq, Sq, hd) bf16."""
    sl2 = scale * math.log2(math.e)
    hq, sq, _ = q.shape
    sk = k.shape[0]
    j = torch.arange(sk)
    ok = (j[None, :] <= q_pos[:, None]) & (q_pos[:, None] >= 0)
    if window > 0:
        ok &= j[None, :] > q_pos[:, None] - window
    s2 = torch.einsum("hqd,kd->hqk", q, k) * sl2
    m = torch.full((hq, sq), NEG_BIG)
    l = torch.zeros(hq, sq)
    o = torch.zeros(hq, sq, q.shape[-1])
    for t0 in range(0, sk, bk):
        okt = ok[:, t0:t0 + bk]
        st = torch.where(okt, s2[:, :, t0:t0 + bk], torch.tensor(NEG_BIG))
        mx = torch.maximum(m, st.amax(-1))
        c = torch.exp2(m - mx)
        p = torch.where(okt, torch.exp2(st - mx[..., None]), torch.zeros(()))
        l = l * c + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi @ v[t0:t0 + bk]
        if hi_lo:
            pv = pv + (p - hi).bfloat16().float() @ v[t0:t0 + bk]
        o = o * c[..., None] + pv
        m = mx
    return (o / l.clamp(min=1e-30)[..., None]).bfloat16()


def _window_case(hq, sq, hd, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(hq, sq, hd, generator=g).bfloat16().float()
    k = torch.randn(sq, hd, generator=g).bfloat16().float()
    v = torch.randn(sq, hd, generator=g).bfloat16().float()
    return q, k, v, torch.arange(sq)


def worst_over_limit(hq, sq, hd, window, hi_lo, seed=7):
    """max |got - want| / (2e-3 + 1e-2 |want|) of the emulated body against
    the plain version (bf16 output), over a fresh windowed prefill."""
    q, k, v, q_pos = _window_case(hq, sq, hd, seed)
    scale = hd ** -0.5
    got = emulate_mma_prefill(q, k, v, q_pos, scale, window, hi_lo).float()
    want = ref.flash_prefill_ref(q[None].bfloat16(), k[None, None].bfloat16(),
                                 v[None, None].bfloat16(), q_pos[None].int(), scale,
                                 window)[0].float()
    return ((got - want).abs() / (2e-3 + 1e-2 * want.abs())).max().item()


@pytest.mark.parametrize("hq,sq,hd,window", [(4, 200, 64, 64), (2, 300, 256, 128),
                                             (16, 80, 128, 0)])
def test_emulated_mma_prefill_within_window_limit(hq, sq, hd, window):
    """hi + lo P holds the windowed prefill's per-element limit with room,
    and no worse than a single rounded P does."""
    split = worst_over_limit(hq, sq, hd, window, hi_lo=True)
    single = worst_over_limit(hq, sq, hd, window, hi_lo=False)
    assert split < 0.8 and split <= single


def test_emulated_mma_prefill_pad_rows_are_zero():
    q, k, v, q_pos = _window_case(2, 70, 64, 3)
    q_pos = q_pos.clone()
    q_pos[-5:] = -1
    out = emulate_mma_prefill(q, k, v, q_pos, 0.125)
    assert not out[:, -5:].float().any()


if __name__ == "__main__":
    for hi_lo in (False, True):
        r = worst_over_limit(16, 2304, 256, 2048, hi_lo)
        print(f"P as {'bf16 hi + lo' if hi_lo else 'one bf16'}: worst |got - want| / "
              f"(2e-3 + 1e-2 |want|) = {r:.3f}")
