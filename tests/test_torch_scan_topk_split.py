"""The arithmetic of the redesigned lru_scan and top-k kernels, on the CPU.

Both kernels run only on the card (tests/test_torch_cuda.py); their order
of work is emulated here, step for step:

* lru_scan (csrc/lru_scan.cu) at ``ops.lru_tile_plan``'s C and G: each
  tile's G segments scanned from zero into (prod a, h), the carry passed
  through the segments in order, each segment rescanned from its carry,
  every product and sum rounded on its own in fp32.  Held against an fp64
  scan of the same inputs: its worst error may be at most 4x the plain
  fp32 version's, or 1e-5 of the largest |h|, whichever is larger, with
  random decays and with slow ones (a in [0.9, 0.999], the range a trained
  RG-LRU's decays take), over recurrentgemma-9b's 2304-step wave prefill;
* top-k (csrc/topk.cu): the 64-bit keys (value key above the index's
  complement; NaN above +inf, -0 = +0), ``ops.topk_chunk_plan``, each
  chunk's radix select digit by digit down to at most max(k, RANK_MIN)
  keys (RANK_MIN 128, read from the source), their ranks, the last
  block's merge, on ties that span chunk edges, -inf,
  NaN, rows of NaN and of -inf, chunks shorter than k, k 1, 40 and 256:
  bit-equal to ``ref.topk_ref``, whatever the chunking.

    python tests/test_torch_scan_topk_split.py

prints the scan emulation's errors against fp64 beside the plain version's
over recurrentgemma-9b's wave prefill, 4 rows of 2304 steps (512 of its
4096 channels: rows and channels are independent scans).
"""
import re

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro_torch.kernels import build, ops, ref

SMS = 132

# -- lru_scan -------------------------------------------------------------------


def tiled_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, C: int, G: int):
    """The kernel's order of work in fp32: tiles of C steps, G segments of
    C / G steps a tile (steps past the end are a = 1, b = -0: h exactly).
    The final state is the state of the last step, rescanned by the
    segment that holds it."""
    a, b = a.float(), b.float()
    B, S, W = a.shape
    L, nt = C // G, -(-S // C)
    pad = nt * C - S
    ap = torch.cat([a, torch.ones(B, pad, W)], 1).reshape(B, nt, G, L, W)
    bp = torch.cat([b, torch.full((B, pad, W), -0.0)], 1).reshape(B, nt, G, L, W)
    p, h = torch.ones(B, nt, G, W), torch.zeros(B, nt, G, W)
    for u in range(L):                      # 1. every segment from zero
        h = ap[:, :, :, u] * h + bp[:, :, :, u]
        p = p * ap[:, :, :, u]
    hs = torch.empty(B, nt, G, L, W)
    carry = h0.float()
    for i in range(nt):
        c, cin = carry, [carry]             # 2. the carries, in segment order
        for j in range(G - 1):
            c = p[:, i, j] * c + h[:, i, j]
            cin.append(c)
        hh = torch.stack(cin, 1)
        for u in range(L):                  # 3. each segment from its carry
            hh = ap[:, i, :, u] * hh + bp[:, i, :, u]
            hs[:, i, :, u] = hh
        carry = hh[:, G - 1]
    hs = hs.reshape(B, nt * C, W)[:, :S]
    return hs, hs[:, -1].clone()


def lru_inputs(shape, decay: str, seed: int):
    """a, b, h0 of an RG-LRU scan: a = sigmoid(normal) (random weights) or
    uniform in [0.9, 0.999] (slow decay), b = sqrt(1 - a^2) x as the RG-LRU
    block normalises its input."""
    rng = np.random.default_rng(seed)
    B, S, W = shape
    if decay == "random":
        a = 1 / (1 + np.exp(-rng.standard_normal(shape)))
    else:
        a = rng.uniform(0.9, 0.999, shape)
    b = np.sqrt(1 - a * a) * rng.standard_normal(shape)
    return (torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32)),
            torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32)))


def scan_errors(a, b, h0, C, G) -> dict:
    """Worst |error| against fp64 (states and final state) of the plain
    version and of the tiled order, and the limit the tiled one must keep
    (``ref.lru_scan_limit``, the card's check)."""
    lim = ref.lru_scan_limit(a, b, h0)
    hs, hT = tiled_scan(a, b, h0, C, G)
    tiled = max((hs.double() - lim["want"]).abs().max().item(),
                (hT.double() - lim["want_T"]).abs().max().item())
    return {"plain": lim["plain"], "tiled": tiled, "limit": lim["limit"]}


@pytest.mark.parametrize("decay", ["random", "slow"])
@pytest.mark.parametrize("shape", [(2, 2304, 128), (1, 2048, 64)])
def test_tiled_scan_within_the_fp64_limit(shape, decay):
    C, G, _ = ops.lru_tile_plan()
    a, b, h0 = lru_inputs(shape, decay, seed=shape[1] + len(decay))
    e = scan_errors(a, b, h0, C, G)
    assert e["tiled"] <= e["limit"], e


@pytest.mark.parametrize("b,s,w", [(1, 1, 64), (3, 37, 20), (2, 300, 33), (1, 129, 8)])
def test_tiled_scan_ragged_sequences(b, s, w):
    """A sequence shorter than a tile or one step past it: every state
    within the limit and the plain version's 1e-5."""
    C, G, _ = ops.lru_tile_plan()
    a, x, h0 = lru_inputs((b, s, w), "slow", seed=s)
    hs, hT = tiled_scan(a, x, h0, C, G)
    assert hs.shape == (b, s, w)
    e = scan_errors(a, x, h0, C, G)
    assert e["tiled"] <= e["limit"], e
    plain, _ = ref.lru_scan_ref(a, x, h0)
    torch.testing.assert_close(hs, plain, atol=1e-5, rtol=1e-5)


def test_tiled_scan_first_segment_repeats_the_plain_version():
    """Segment 0 of the first tile starts from h0 itself: its states are
    the plain version's bits; only later segments' carries combine apart."""
    C, G, _ = ops.lru_tile_plan()
    a, b, h0 = lru_inputs((2, C, 16), "random", seed=3)
    hs, _ = tiled_scan(a, b, h0, C, G)
    plain, _ = ref.lru_scan_ref(a, b, h0)
    assert torch.equal(hs[:, :C // G], plain[:, :C // G])


def test_lru_tile_plan_is_built_and_fixed():
    """The plan is the tile the source builds (its constants C, G, D), a
    whole number of segments whose stages fit the shared memory, and takes
    no shape: a row's bits are the same at any batch."""
    C, G, D = ops.lru_tile_plan()
    src = (build.CSRC / "lru_scan.cu").read_text()
    built = re.search(r"constexpr int C = (\d+), G = (\d+), D = (\d+);", src).groups()
    assert (C, G, D) == tuple(map(int, built))
    assert C % G == 0 and D >= 2 and D * 2 * C * 32 * 4 <= 227 * 1024


# -- top-k ----------------------------------------------------------------------


def order_keys(x: np.ndarray) -> np.ndarray:
    """csrc/topk.cu's order_key of fp32 values: uint32, larger = better,
    NaN (any sign) the largest, -0 equal to +0."""
    u = np.where(x == 0, np.float32(0), x).astype(np.float32).view(np.uint32).astype(np.uint64)
    k = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(np.isnan(x), 0xFFFFFFFF, k).astype(np.uint64)


def full_keys(x: np.ndarray, lo: int) -> np.ndarray:
    idx = np.arange(lo, lo + len(x), dtype=np.uint64)
    return order_keys(x) << np.uint64(32) | (~idx & np.uint64(0xFFFFFFFF))


# csrc/topk.cu: keys ranked without narrowing them first
RANK_MIN = int(re.search(r"constexpr int RANK_MIN = (\d+);",
                         (build.CSRC / "topk.cu").read_text()).group(1))


def select_k(keys: np.ndarray, k: int):
    """The kernel's radix select: the keys at or above the k-th largest
    key's prefix once they are at most max(k, RANK_MIN) (all keys if there
    are that few), and the digit passes it took."""
    cap = max(k, RANK_MIN)
    if len(keys) <= cap:
        return keys, 0
    prefix, k_rem, sh, passes = 0, k, 64, 0
    while True:
        sh -= 8
        passes += 1
        above = np.uint64(sh + 8)
        at = keys if sh == 56 else keys[(keys >> above) == np.uint64(prefix >> (sh + 8))]
        hist = np.bincount(((at >> np.uint64(sh)) & np.uint64(0xFF)).astype(np.int64),
                           minlength=256)
        incl = np.cumsum(hist[::-1])[::-1]          # keys at digit >= d
        d = int(np.nonzero(incl >= k_rem)[0].max())
        k_rem -= int(incl[d] - hist[d])
        prefix |= d << sh
        if k - k_rem + hist[d] <= cap or sh == 0:
            break
    kept = keys[(keys >> np.uint64(sh)) >= np.uint64(prefix >> sh)]
    assert k <= len(kept) <= cap
    return kept, passes


def ranked(kept: np.ndarray, k: int) -> np.ndarray:
    """The kernel's emit_ranked: key of rank r (the number of kept keys
    above it) to slot r, for r < k; slots no key reaches stay 0 (empty)."""
    out = np.zeros(k, np.uint64)
    for key in kept:
        r = int((kept > key).sum())
        if r < k:
            out[r] = key
    return out


def emulate_topk(x: np.ndarray, k: int, chunk: int):
    """One launch of csrc/topk.cu, row by row: each chunk's k best by rank
    (or its largest key at k = 1) in chunk order, then the last block's
    select and ranks over them; values re-read from x."""
    rows, n = x.shape
    vals, idx = np.empty((rows, k), np.float32), np.empty((rows, k), np.int32)
    for r in range(rows):
        cand = []
        for lo in range(0, n, chunk):
            keys = full_keys(x[r, lo:lo + chunk], lo)
            cand.append(keys.max(keepdims=True) if k == 1 else ranked(select_k(keys, k)[0], k))
        cand = np.concatenate(cand)
        best = cand.max(keepdims=True) if k == 1 else ranked(select_k(cand, k)[0], k)
        i = (~best & np.uint64(0xFFFFFFFF)).astype(np.int64)
        vals[r], idx[r] = x[r, i], i
    return vals, idx


def tricky_rows(rows: int, n: int, chunk: int, seed: int) -> np.ndarray:
    """Row 0 all NaN; row 1 small integers (ties everywhere) with a run of
    the maximum across a chunk edge and -0 beside +0; row 2 normal values
    with NaN on either side of a chunk edge and a few -inf; row 3 all
    -inf but two; the rest normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    x[0] = np.nan
    x[1] = rng.integers(-2, 3, n)
    edge = min(chunk, n - 1)
    x[1, max(0, edge - 20):edge + 20] = 7
    x[1, 5], x[1, 6] = -0.0, 0.0
    x[2, [edge - 1, edge, n - 1]] = np.nan
    x[2, 10:40] = -np.inf
    x[3] = -np.inf
    x[3, [n // 2, n - 3]] = [1.0, np.nan]
    return x


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32)


@pytest.mark.parametrize("k", [1, 40, 256])
@pytest.mark.parametrize("rows,n", [(4, 64000), (4, 3914), (5, 9001), (4, 256000)])
def test_topk_emulation_equals_the_plain_version(rows, n, k):
    """The plan's chunks, each chunk's select and the merge give the plain
    version's values (bit for bit: NaN payloads, -0) and indices; (4, 3914)
    ends in a chunk shorter than k = 256, so the merge sees empty keys."""
    chunk, n_chunks = ops.topk_chunk_plan(rows, n, k, SMS)
    x = tricky_rows(rows, n, chunk, seed=n + k)
    vals, idx = emulate_topk(x, k, chunk)
    rv, ri = ref.topk_ref(torch.from_numpy(x), k)
    np.testing.assert_array_equal(vals.view(np.int32), _bits(rv))
    np.testing.assert_array_equal(idx, ri.numpy())
    np.testing.assert_array_equal(idx[0], np.arange(k))        # all NaN: by index
    assert np.isnan(vals[0]).all() and idx[2, 0] == chunk - 1


@pytest.mark.parametrize("chunk", [256, 1024, 4096])
def test_topk_result_does_not_depend_on_the_chunking(chunk):
    """Unique keys: every chunking selects the same set and order."""
    x = tricky_rows(4, 9000, 512, seed=1)
    for k in (1, 40):
        vals, idx = emulate_topk(x, k, chunk)
        want_v, want_i = emulate_topk(x, k, 9000)
        np.testing.assert_array_equal(vals.view(np.int32), want_v.view(np.int32))
        np.testing.assert_array_equal(idx, want_i)


def test_order_keys_order_every_float():
    """Key order is value order: -inf < negatives < -0 = +0 < positives <
    +inf < NaN of either sign, and no element's key is 0 (the empty slot)."""
    x = np.array([-np.inf, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, 3e38, np.inf, np.nan,
                  -np.nan], np.float32)
    keys = order_keys(x)
    assert (np.diff(keys[:4].astype(np.int64)) > 0).all() and keys[4] == keys[5]
    assert (np.diff(keys[5:11].astype(np.int64)) > 0).all() and keys[10] == keys[11]
    assert keys.min() > 0


def test_radix_select_stops_early_on_distinct_values():
    """Random logits narrow to RANK_MIN keys in a digit or two (the kernel's
    cost at k = 40); equal values run down to the index bits."""
    rng = np.random.default_rng(0)
    keys = full_keys(rng.standard_normal(1920).astype(np.float32), 0)
    kept, passes = select_k(keys, 40)
    assert passes <= 2 and set(np.sort(keys)[-40:]) <= set(kept)
    kept, passes = select_k(full_keys(np.zeros(1920, np.float32), 0), 40)
    assert passes == 8 and len(kept) == 40


def test_ranks_put_every_key_in_place():
    """Unique keys land in descending order; repeated empty keys (0) rank
    at or past k and are never emitted."""
    rng = np.random.default_rng(1)
    for k in (2, 3, 40, 256):
        keys = rng.integers(1, 2**63, k + 30, dtype=np.uint64)
        np.testing.assert_array_equal(ranked(keys, k), np.sort(keys)[::-1][:k])
        with_empty = np.concatenate([keys[:k], np.zeros(9, np.uint64)])
        np.testing.assert_array_equal(ranked(with_empty, k), np.sort(keys[:k])[::-1])


@pytest.mark.parametrize("rows,n", [(4, 64000), (4, 256000), (1, 64000), (4, 152064),
                                    (64, 64000), (300, 500), (2, 300)])
def test_topk_chunk_plan(rows, n):
    """Chunks of 256..4096 elements, whole warps, covering the row, none
    empty; the row's candidates fit the merge's registers unless the chunks
    are already at their widest; rows * chunks >= the SMs wherever chunks
    of at least 256 and the merge allow it; yi-9b's (4, 64000) cuts into
    33 chunks or more of at most 2048 (k < 256)."""
    for k in (1, 40, 256):
        chunk, n_chunks = ops.topk_chunk_plan(rows, n, k, SMS)
        assert chunk % 32 == 0 and ops.TOPK_MIN_CHUNK <= chunk <= ops.TOPK_MAX_CHUNK
        assert (n_chunks - 1) * chunk < n <= n_chunks * chunk
        fits = n_chunks * k <= ops.TOPK_MAX_MERGE
        assert fits or chunk == ops.TOPK_MAX_CHUNK
        if n >= SMS * ops.TOPK_MIN_CHUNK // rows:
            merge_bound = -(-n // (ops.TOPK_MAX_MERGE // k) // 32) * 32
            assert rows * n_chunks >= SMS or chunk in (ops.TOPK_MAX_CHUNK, merge_bound)
        if (rows, n) == (4, 64000) and k < 256:
            assert n_chunks >= 33 and chunk <= 2048


if __name__ == "__main__":
    C, G, _ = ops.lru_tile_plan()
    for decay in ("random", "slow"):
        a, b, h0 = lru_inputs((4, 2304, 512), decay, seed=0)
        print(decay, f"C {C} G {G}", scan_errors(a, b, h0, C, G))
