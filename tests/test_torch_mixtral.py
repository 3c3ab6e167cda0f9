"""mixtral-8x7b (MoE over a sliding-window ring) against the JAX package on
the same weights: the config, its capability record and refusals; the ring
chunk writer (a chunk into a wrapped slot ring attends the pre-write ring
beside the fresh K/V, then writes), bf16 and int8, against the reference's
branch; the ring's position rows after a chunk and a verify rewind; logits
past the ring's wrap in bf16, int8 and int4 weights; a sequence admitted
in chunks (of a mixed step's and a verify step's widths) into a ring that
wraps, over bf16 and int8 K/V.  Greedy streams through the scheduler are
held in tests/test_torch_mixtral_serve.py, with the helpers here.

Config: ``mixtral-8x7b.reduced()`` (2 ``local_attn`` layers, window 64,
d 256, 4 q heads over 4 KV heads of 64, 4 experts of 128, top 2, vocab
512), the reference built as tests/test_torch_model.py builds it, on its
pure-JAX path.

Tolerances: logits 5e-2, the port replaying the reference's expert choices
where a router near-tie (< 1e-2 in probability) ranks them apart; the ring
chunk's attention output (one layer's fused out-projection, bf16, values up
to ~5) 2e-2 + 1e-2 relative, a bf16 ulp; the written K/V at exactly the
reference's entries, each within one rounding of the K/V projection (a
bf16 ulp, an int8 step; fewer than 0.1 % differ), the rest untouched;
position rows exactly.
"""
import contextlib
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_threads  # noqa: F401
from repro import compat
from repro.configs import get_config as jget_config
from repro.core.capabilities import ArchCapabilities as JArchCapabilities
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.common import Dist as JDist
from repro.models.common import ShardPlan as JShardPlan
from repro.runtime import kvcache as jkvcache
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.core.capabilities import ArchCapabilities
from repro_torch.models import attention as attn
from repro_torch.models import model as TM
from repro_torch.models import moe
from repro_torch.models.common import rope_tables
from repro_torch.runtime import kvcache
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import ContinuousScheduler, PagedContinuousScheduler
from test_torch_model import assert_logits_match, jax_engine

ARCH, MAX_LEN, TOL, CHUNK, SPEC_K = "mixtral-8x7b", 128, 5e-2, 16, 4
# a router near-tie: the port's k-th best expert and the reference's other
# choice lie within this much probability (chip_smoke.py's ROUTER_TIE)
ROUTER_TIE = 1e-2

_ENGINES = {}


def engines(mode="none", kv_quant=False):
    """(JAX engine, its numpy tree, port engine) on the same weights, built
    once per module and setting."""
    key = (mode, kv_quant)
    if key not in _ENGINES:
        jeng, tree = jax_engine(jget_config(ARCH).reduced(), MAX_LEN, weight_quant=mode,
                                kv_quant=kv_quant)
        cfg = get_config(ARCH).reduced()
        teng = Engine(cfg, parallel=ParallelConfig(weight_quant=mode, kv_quant=kv_quant),
                      sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                      params=bridge.params_from_jax(tree, cfg, device="cpu"), device="cpu")
        _ENGINES[key] = jeng, tree, teng
    return _ENGINES[key]


def requests(vocab, n=3, seed=0, budget=(30, 44)):
    """Prompts of 34..64 tokens (every one in several chunks of 16; the
    window caps them at 64), budgets long enough that each slot decodes and
    verifies past the ring's 64 + spec_k entries; arrivals every 2 steps."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(34, 65))).astype(np.int32),
             int(rng.integers(*budget)), None, 2 * i) for i in range(n)]


# ---------------------------------------------------------------------------
# Config, capabilities, refusals
# ---------------------------------------------------------------------------


def test_config_and_capabilities_equal_jax():
    for reduce in (False, True):
        tcfg, jcfg = get_config(ARCH), jget_config(ARCH)
        if reduce:
            tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
        for f in dataclasses.fields(tcfg):
            t, j = getattr(tcfg, f.name), getattr(jcfg, f.name)
            assert (dataclasses.asdict(t) == dataclasses.asdict(j)
                    if dataclasses.is_dataclass(t) else t == j), f.name
        assert tcfg.param_count() == jcfg.param_count()
        caps = ArchCapabilities.from_config(tcfg)
        assert dataclasses.asdict(caps) == dataclasses.asdict(JArchCapabilities.from_config(jcfg))
    assert get_config(ARCH).param_count() == 46_702_526_464
    assert caps.max_prompt == 64 and caps.blockers == {"paged": "ring", "disagg": "ring"}


def test_served_at_tp1_refused_where_the_reference_refuses():
    """tp 1, 2, 4 and 8 in bf16, int8 or int4 weights over dense or int8
    K/V; the packed weight file at tp>1 is refused by name, and the paged
    pool by the capability record, as the JAX scheduler refuses it."""
    cfg = get_config(ARCH)
    for mode in ("none", "int8", "int4"):
        for kvq in (False, True):
            for tp in (1, 2, 4, 8):
                TM.check_supported(cfg, ParallelConfig(tp=tp, weight_quant=mode, kv_quant=kvq))
    with pytest.raises(NotImplementedError, match="wq_cache at tp>1"):
        TM.check_supported(cfg, ParallelConfig(tp=2, weight_quant="int4"), wq_cache="x.npz")
    _, _, teng = engines()
    with pytest.raises(ValueError, match="does not support paged KV: blocked by the "
                                         "sliding-window ring"):
        PagedContinuousScheduler(teng, n_slots=2)
    with pytest.raises(ValueError, match="longer-than-window"):
        ContinuousScheduler(teng, n_slots=2).submit(np.zeros(65, np.int32), 4)


# ---------------------------------------------------------------------------
# The ring chunk writer, position rows
# ---------------------------------------------------------------------------


def _ring_state(cfg, S, totals, kv_quant, rng):
    """A slot ring per row after ``totals[r]`` tokens (the reference's ring
    position rows), its entries random: bf16 K/V, or int8 values with
    positive bf16 scales."""
    b, h, hd = len(totals), cfg.n_kv_heads, cfg.resolved_head_dim
    pos = kvcache.position_rows(torch.tensor(totals, dtype=torch.int32), S, ring=True)
    if kv_quant:
        c = {k: torch.from_numpy(rng.integers(-127, 128, (b, h, S, hd)).astype(np.int8))
             for k in ("k", "v")}
        c.update({k: torch.from_numpy(rng.uniform(0.005, 0.05, (b, h, S)).astype(np.float32))
                  .bfloat16() for k in ("k_scale", "v_scale")})
    else:
        c = {k: torch.randn((b, h, S, hd), generator=torch.Generator().manual_seed(i)).bfloat16()
             for i, k in enumerate(("k", "v"))}
    c["pos"] = pos
    return c


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_ring_chunk_writer_equals_jax(kv_quant):
    """Four slots whose 68-entry rings hold 150, 100, 69 and 40 tokens take a
    chunk of 16 at their frontiers (9 and 3 real tokens on two of them): the
    attention output, the written K/V (int8 values and scales), the
    untouched rest and the position stripe equal the reference's ring
    branch (``attention.py:949-992`` there)."""
    _, tree, teng = engines()
    cfg = teng.cfg
    jcfg = jget_config(ARCH).reduced()
    S, C = cfg.window + SPEC_K, CHUNK
    totals, lens = [150, 100, 69, 40], [16, 9, 16, 3]
    rng = np.random.default_rng(3)
    state = _ring_state(cfg, S, totals, kv_quant, rng)
    x = torch.randn((4, C, cfg.d_model), generator=torch.Generator().manual_seed(7)).bfloat16()
    positions = torch.tensor(totals)[:, None] + torch.arange(C)[None, :]
    lmask = torch.arange(C)[None, :] < torch.tensor(lens)[:, None]

    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["groups"][0]["sub0"]["mixer"])
    jcache = {k: jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy(),
                             dtype=jnp.bfloat16 if v.dtype == torch.bfloat16 else None)
              for k, v in state.items()}
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jout, jnew = jax.jit(lambda p, x, c: jattn.gqa_forward(
        p, x, jnp.asarray(positions.numpy(), jnp.int32), jcfg, JShardPlan.make(jcfg, 1),
        JDist(), kind="local_attn", cache=c, length_mask=jnp.asarray(lmask.numpy())))(
            jp, jx, jcache)

    caches = {k: (v[None] if k != "pos" else v).clone() for k, v in state.items()}
    slots = torch.arange(4)
    step = TM._kv_step(caches, 4, C, positions, cur_pos=None, slots=slots, block_tables=None,
                       chunk_writes=attn.chunk_writes(np.arange(4), np.array(totals), C, S, "cpu",
                                                      ring=True, lens=np.array(lens)),
                       window=cfg.window, length_mask=lmask)
    if kv_quant:
        step.quant_dst = attn.quant_targets(4, C, "cpu", targets=step.targets, src=step.src)
    with torch.inference_mode():
        out = attn.gqa_forward(teng.params["layers"][0], x, cfg,
                               rope=rope_tables(positions, cfg.resolved_head_dim,
                                                cfg.rope_theta),
                               step=step, layer=0, window=cfg.window)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), atol=2e-2,
                               rtol=1e-2)
    # the same entries written (the chunk's real tokens at p % S), each
    # within one rounding of the K/V projection (one bf16 ulp; an int8 step)
    fresh = ((torch.arange(S)[None, :] - torch.tensor(totals)[:, None]) % S
             < torch.tensor(lens)[:, None])[:, None]                  # (b, 1, S)
    for key in ("k", "v", "k_scale", "v_scale") if kv_quant else ("k", "v"):
        mine, ref_, old = caches[key][0].float(), torch.from_numpy(
            np.asarray(jnew[key], np.float32)), state[key].float()
        at = fresh if mine.dim() == 3 else fresh[..., None]
        assert torch.equal(torch.where(at, 0, mine), torch.where(at, 0, old)), key
        assert torch.equal(torch.where(at, 0, ref_), torch.where(at, 0, old)), key
        tol = 1.0 if key in ("k", "v") and kv_quant else 0.0
        np.testing.assert_allclose(mine.numpy(), ref_.numpy(), rtol=2 ** -7, atol=tol,
                                   err_msg=key)
        assert (torch.where(at, mine, 0) != torch.where(at, ref_, 0)).float().mean() < 1e-3
    np.testing.assert_array_equal(caches["pos"].numpy(), np.asarray(jnew["pos"]))

def test_ring_position_rows_equal_jax():
    """``set_slot_positions`` after a chunk and ``rewind_slots`` after a
    verify step write the reference's ring rows
    (``kvcache.py:263-268`` there) over the 68-entry slot ring, wrapped or
    not, and the identity rows without ``ring``."""
    jeng, _, teng = engines()
    totals = np.array([0, 1, 63, 64, 68, 69, 150, 200], np.int32)
    jc = jeng.init_slot_caches(len(totals), ring_slack=SPEC_K)
    groups = jtfm.build_groups(jeng.cfg)
    want = np.asarray(jkvcache.set_slot_positions(jc, groups, jnp.asarray(totals),
                                                  window=jeng.cfg.window)[0]["sub0"]["pos"])
    want = want[0] if want.ndim == 3 else want
    caches = teng.init_slot_caches(len(totals), ring_slack=SPEC_K)
    kvcache.set_slot_positions(caches, totals, np.ones(len(totals), bool), ring=True)
    np.testing.assert_array_equal(caches["pos"].numpy(), want)
    caches["pos"].fill_(-1)
    kvcache.rewind_slots(caches, torch.arange(len(totals)), torch.from_numpy(totals), ring=True)
    np.testing.assert_array_equal(caches["pos"].numpy(), want)
    ident = np.asarray(jkvcache.set_slot_positions(jc, groups, jnp.asarray(totals))[0]
                       ["sub0"]["pos"])
    kvcache.set_slot_positions(caches, totals, np.ones(len(totals), bool))
    np.testing.assert_array_equal(caches["pos"].numpy(), ident[0] if ident.ndim == 3 else ident)


# ---------------------------------------------------------------------------
# Logits, streams
# ---------------------------------------------------------------------------


# the reference's routes, appended by _logged_route's callback in call order
_ROUTE_LOG: list = []
_ROUTE = jmoe.route


def _logged_route(router_w, x, m):
    out = _ROUTE(router_w, x, m)
    jax.debug.callback(lambda e: _ROUTE_LOG.append(np.asarray(e)), out[0])
    return out


@contextlib.contextmanager
def jax_routes(monkeypatch):
    """Inside, the reference's MoE layers log their top experts
    (``repro.models.moe.route``, through a debug callback, in call order;
    trace the reference's forwards inside).  Yields ``replay(call,
    routes=None)``: run a port forward with the experts the reference chose
    since the last replay (or ``routes``, one (T, k) array per MoE call,
    whose rows from ``real[call]`` on are chunk padding and go uncertified)
    as ``moe.ROUTE_REPLAY``, certify every token the port's own router ranks
    apart (its k-th probability less that of the reference's other choice,
    below ROUTER_TIE: a router near-tie, which a one-ulp difference upstream
    flips), and return the call's result.  ``replay.log`` holds the
    reference's routes not yet replayed; ``replay.ties`` the margins of the
    tokens replayed apart."""
    log = _ROUTE_LOG
    log.clear()
    monkeypatch.setattr(jmoe, "route", _logged_route)

    def replay(call, routes=None, real=None):
        jax.effects_barrier()
        routes = list(log) if routes is None else routes
        log.clear()
        monkeypatch.setattr(moe, "ROUTE_REPLAY", [torch.from_numpy(np.asarray(e, np.int64))
                                                  for e in routes])
        monkeypatch.setattr(moe, "LOG", [])
        out = call()
        for i, rec in enumerate(moe.LOG):
            n = None if real is None else real[i]
            probs, chosen = rec["probs"][:n], rec["top_e"][:n]
            own = torch.topk(probs, chosen.shape[1]).indices
            for t in torch.nonzero((own.sort(1).values != chosen.sort(1).values).any(1))[:, 0]:
                other = [e for e in chosen[t].tolist() if e not in own[t].tolist()]
                margin = float(probs[t, own[t]].min() - probs[t, other].min())
                assert margin < ROUTER_TIE, (int(t), margin)
                replay.ties.append(margin)
        assert not moe.ROUTE_REPLAY
        monkeypatch.setattr(moe, "ROUTE_REPLAY", None)
        monkeypatch.setattr(moe, "LOG", None)
        return out

    replay.log, replay.ties = log, []
    yield replay


_JAX_FORWARD = {}


def _jax_logits(jeng, seq: np.ndarray) -> np.ndarray:
    """The reference's prefill forward of one sequence into its wave cache
    (over an int8 cache it attends the dequantized K/V), traced inside
    ``jax_routes`` (its MoE layers log their routes) -> its logits (s, V)."""
    if id(jeng) not in _JAX_FORWARD:
        sm = partial(compat.shard_map, mesh=jeng.mesh, check_vma=False)
        cspec = jkvcache.cache_pspecs(jeng.ctx, kv_seq_shard=False)
        _JAX_FORWARD[id(jeng)] = jax.jit(sm(
            lambda p, t, c: JM.forward(p, t, jeng.ctx, caches=c, seq_sharded=True)[0],
            in_specs=(JM.param_specs(jeng.ctx), JP("data", None), cspec),
            out_specs=JP("data", None, None)))
    assert jmoe.route is _logged_route
    fwd = _JAX_FORWARD[id(jeng)]
    return np.asarray(fwd(jeng.params, jnp.asarray(seq)[None], jeng.init_caches(1)))[0]


def _port_chunked_logits(teng, seq: np.ndarray, chunk: int) -> np.ndarray:
    """The port's logits (s, V) of ``seq`` admitted in chunks of ``chunk``
    into a fresh slot ring, as the mixed step admits it (or a verify step
    of width ``chunk`` reads and writes it)."""
    caches = teng.init_slot_caches(1, ring_slack=SPEC_K)
    S, n = caches["pos"].shape[1], len(seq)
    out = []
    with torch.inference_mode():
        for off in range(0, n, chunk):
            c = min(chunk, n - off)
            tok = np.zeros(chunk, np.int64)
            tok[:c] = seq[off:off + c]
            logits = teng.forward(
                torch.from_numpy(tok)[None], caches=caches, start_pos=torch.tensor([off]),
                slots=torch.tensor([0]), length_mask=torch.arange(chunk)[None] < c,
                chunk_writes=attn.chunk_writes(np.array([0]), np.array([off]), chunk, S, "cpu",
                                               ring=True, lens=np.array([c])))
            kvcache.set_slot_positions(caches, [off + c], [True], ring=True)
            out.append(logits[0, :c].numpy())
    return np.concatenate(out)


def chunk_routes(layers, n: int, chunk: int):
    """The reference's routes of one whole forward (one (n, k) array per
    MoE layer) -> those of the chunks of ``chunk`` that cover it, in call
    order, each padded to the chunk, and the real rows of each."""
    k = layers[0].shape[1]
    pieces, real = [], []
    for off in range(0, n, chunk):
        for r in layers:
            piece = np.zeros((chunk, k), np.int64) + np.arange(k)
            piece[:min(chunk, n - off)] = r[off:off + chunk]
            pieces.append(piece)
            real.append(min(chunk, n - off))
    return pieces, real


def routed_logits(jeng, teng, seq, chunks, monkeypatch):
    """One sequence through the reference's prefill forward and through the
    port's, whole (chunk 0) or in each chunk width of ``chunks``, the port
    routing as the reference routed (``jax_routes``, near-ties
    certified) -> (the reference's logits, the port's per chunk width,
    the near-tie margins replayed)."""
    n, k = len(seq), teng.cfg.moe.top_k
    out = {}
    with jax_routes(monkeypatch) as replay:
        want = _jax_logits(jeng, seq)
        jax.effects_barrier()
        layers = [np.asarray(r).reshape(n, k) for r in replay.log]
        for c in chunks:
            if c == 0:
                out[c] = replay(lambda: teng.forward(torch.from_numpy(seq)[None].long(),
                                                     caches=teng.init_caches(1))[0].numpy(),
                                routes=layers)
            else:
                pieces, real = chunk_routes(layers, n, c)
                out[c] = replay(lambda: _port_chunked_logits(teng, seq, c), routes=pieces,
                                real=real)
    return want, out, replay.ties


def router_parting(jeng, teng, monkeypatch, chunk=CHUNK):
    """``assert_streams_match``'s ``certify`` for MoE streams.  Teacher-forced
    along prompt + the reference's tokens, the port (its whole-prompt
    forward, and chunks of ``chunk`` into a slot ring), routing as the
    reference's forward routed (``jax_routes``), lies within TOL of the
    reference's logits there; and the parting is a near-tie of either kind:
    the port's token lies within TOL of the top of the reference's logits
    (chip_smoke.py's certification of a parting against the plain
    versions), or the port's own router ranked some token's experts apart
    from the reference's (a router near-tie, each within ROUTER_TIE)."""

    def certify(prompt, tokens, token):
        seq = np.concatenate([prompt, np.asarray(tokens, np.int32)]).astype(np.int32)
        want, got, ties = routed_logits(jeng, teng, seq, (0, chunk), monkeypatch)
        err = max(np.abs(g[-1] - want[-1]).max() for g in got.values())
        slack = np.inf if token is None else want[-1].max() - want[-1][token]
        return bool(err <= TOL and (slack < TOL or ties))

    return certify


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
def test_weight_bytes_equal_jax(mode):
    """``decode_weight_bytes`` counts the weights as the reference does: the
    expert blocks as einsum sites served by ``to_dense``, at full width
    (int4: ~24 GB of packed weights and scales, 23.5 GB of them experts)."""
    jeng, _, teng = engines(mode)
    par = ParallelConfig(weight_quant=mode)
    assert TM.decode_weight_bytes(teng.cfg, par) == JM.decode_weight_bytes(jeng.ctx)
    full = TM.decode_weight_bytes(get_config(ARCH), par)
    if mode == "int4":
        assert (full["swept"], full["quantized_ref_einsum"]) == (24_017_592_320, 23_530_045_440)


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
def test_logits_past_the_wrap_match_jax(mode, monkeypatch):
    """A 72-token prompt into the 64-entry wave ring (its last 64 kept) and
    8 teacher-forced decode steps: logits within 5e-2 of the reference's,
    the port routing as the reference routed (each token it would rank
    apart a certified router near-tie, ``jax_routes``)."""
    jeng, _, teng = engines(mode)
    with jax_routes(monkeypatch) as replay:
        assert_logits_match(jeng, teng.cfg, teng.params, plen=72, max_len=MAX_LEN,
                            port=replay)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_chunks_past_the_wrap_match_jax(kv_quant, monkeypatch):
    """A 110-token sequence admitted in chunks of 16 (the mixed step's) and
    of 5 (a verify step's width) into a 68-entry slot ring, which wraps
    after 68 tokens: every position's logits within 5e-2 of the
    reference's prefill forward, and of the port's whole-prompt forward,
    all routing as the reference routed."""
    jeng, _, teng = engines(kv_quant=kv_quant)
    seq = np.random.default_rng(21).integers(0, teng.cfg.vocab_size, 110).astype(np.int32)
    want, got, _ = routed_logits(jeng, teng, seq, (0, CHUNK, SPEC_K + 1), monkeypatch)
    for c, logits in got.items():
        np.testing.assert_allclose(logits, want, atol=TOL, rtol=TOL, err_msg=f"chunk {c}")
