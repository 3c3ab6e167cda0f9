"""The port's async HTTP frontend end to end: ``repro_torch.launch.frontend``'s
asyncio server in-process over the reduced engine with the overlapped loop
on, its tokens held against the JAX scheduler's for the same prompts.

tests/test_frontend.py's cases: /v1/completions unary and SSE streaming
(the same tokens), a stop token's finish reason, concurrent streaming
clients, validation errors and 404, /health, bounded-queue shedding (429
with Retry-After) and graceful drain (an in-flight stream served to the
end, then no listener).  Clients are plain ``http.client`` calls from
worker threads while the server runs its own event loop thread: the
cross-thread path production traffic takes.  Last, the CLI: ``python -m
repro_torch.launch.frontend --device cpu`` serves a request and drains on
SIGINT.
"""
import asyncio
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

import torch_threads  # noqa: F401
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro_torch.launch.frontend import EngineService, HttpFrontend
from repro_torch.runtime.scheduler import ContinuousScheduler
from torch_control_plane import assert_same_streams, make_engines, run_sched

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def engines():
    return make_engines(overlap_decode=True)


@contextmanager
def serving(engine, n_slots=2, max_pending=8):
    sched = ContinuousScheduler(engine, n_slots=n_slots, block_steps=2)
    service = EngineService(sched, max_pending=max_pending, idle_wait_s=0.002)
    frontend = HttpFrontend(service, port=0)
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(frontend.start())
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    deadline = time.monotonic() + 30
    while frontend._server is None:
        assert time.monotonic() < deadline, "server failed to start"
        time.sleep(0.01)
    try:
        yield frontend, sched
    finally:
        asyncio.run_coroutine_threadsafe(frontend.stop(), loop).result(timeout=120)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()


def post(port, body, timeout=120):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request("POST", "/v1/completions", json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, dict(r.getheaders()), r.read()


def sse_tokens(raw: bytes):
    toks, finish, done = [], None, False
    for ev in raw.decode().split("\n\n"):
        if not ev.startswith("data: "):
            continue
        payload = ev[len("data: "):]
        if payload == "[DONE]":
            done = True
            continue
        choice = json.loads(payload)["choices"][0]
        toks += choice["token_ids"]
        finish = choice.get("finish_reason", finish)
    return toks, finish, done


def prompt_for(cfg, seed, n=8):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n).tolist()


def jax_tokens(engines, prompts, max_new, eos_id=None):
    """The JAX scheduler's streams for ``prompts``, held against the port
    scheduler's (certified near-ties aside); -> the port's token lists."""
    jeng, teng = engines
    reqs = [(np.asarray(p, np.int32), max_new, eos_id, 0) for p in prompts]
    ref = run_sched(JContinuousScheduler(jeng, n_slots=2, block_steps=2), reqs)[0]
    port = run_sched(ContinuousScheduler(teng, n_slots=2, block_steps=2), reqs)[0]
    assert_same_streams(teng, port, ref, jeng=jeng)
    return [port[i].output.tolist() for i in range(len(prompts))]


def test_unary_and_stream_identical(engines):
    teng = engines[1]
    with serving(teng) as (fe, sched):
        body = {"prompt": prompt_for(teng.cfg, 0), "max_tokens": 6}
        st, _, data = post(fe.port, body)
        assert st == 200
        resp = json.loads(data)
        choice = resp["choices"][0]
        assert len(choice["token_ids"]) == 6 and choice["finish_reason"] == "length"
        assert resp["usage"]["completion_tokens"] == 6
        st, _, raw = post(fe.port, dict(body, stream=True))
        assert st == 200
        toks, finish, done = sse_tokens(raw)
        assert toks == choice["token_ids"] and finish == "length" and done
        assert sched.stats["landings"] > 0        # the overlapped loop served it
    assert toks == jax_tokens(engines, [body["prompt"]], 6)[0]


def test_stop_token_finish_reason(engines):
    teng = engines[1]
    with serving(teng) as (fe, _):
        body = {"prompt": prompt_for(teng.cfg, 1), "max_tokens": 12}
        toks = json.loads(post(fe.port, body)[2])["choices"][0]["token_ids"]
        body["stop_token_id"] = toks[2]           # a token the stream emits
        st, _, data = post(fe.port, body)
        assert st == 200
        choice = json.loads(data)["choices"][0]
        assert choice["finish_reason"] == "stop"
        assert choice["token_ids"] == toks[:len(choice["token_ids"])]
        assert choice["token_ids"][-1] == toks[2]
    assert choice["token_ids"] == jax_tokens(engines, [body["prompt"]], 12, toks[2])[0]


def test_concurrent_streaming_clients(engines):
    teng = engines[1]
    with serving(teng, n_slots=2, max_pending=8) as (fe, sched):
        bodies = [{"prompt": prompt_for(teng.cfg, 10 + i), "max_tokens": 5, "stream": True}
                  for i in range(4)]
        with ThreadPoolExecutor(4) as pool:
            results = list(pool.map(lambda b: post(fe.port, b), bodies))
        streamed = []
        for st, _, raw in results:
            assert st == 200
            toks, finish, done = sse_tokens(raw)
            assert len(toks) == 5 and finish == "length" and done
            streamed.append(toks)
        assert len(sched.done) == 4
        by_prompt = {tuple(r.prompt.tolist()): r.output.tolist() for r in sched.done}
        for body, toks in zip(bodies, streamed):
            assert by_prompt[tuple(body["prompt"])] == toks     # the scheduler's tokens
    assert streamed == jax_tokens(engines, [b["prompt"] for b in bodies], 5)


def test_validation_errors(engines):
    with serving(engines[1]) as (fe, _):
        st, _, data = post(fe.port, {"prompt": [1], "max_tokens": 4})
        assert st == 400
        assert json.loads(data)["error"]["type"] == "invalid_request_error"
        assert post(fe.port, {"max_tokens": 4})[0] == 400
        assert post(fe.port, {"prompt": ["a", "b"], "max_tokens": 4})[0] == 400
        assert post(fe.port, {"prompt": [1, 2], "max_tokens": 4, "priority": "vip"})[0] == 400
        c = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
        c.request("GET", "/nope")
        assert c.getresponse().status == 404


def test_health(engines):
    with serving(engines[1]) as (fe, _):
        c = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
        c.request("GET", "/health")
        r = c.getresponse()
        assert r.status == 200
        h = json.loads(r.read())
        assert h["status"] == "ok" and h["shed_requests"] == 0
        assert h["arch"] == engines[1].cfg.name and h["overload"]["level"] == 0
        assert h["capabilities"]["yi-9b"]["paths"]["paged"]["supported"]


def test_overload_sheds_with_429(engines):
    teng = engines[1]
    with serving(teng, n_slots=2, max_pending=2) as (fe, sched):
        bodies = [{"prompt": prompt_for(teng.cfg, 20 + i), "max_tokens": 8} for i in range(6)]
        with ThreadPoolExecutor(6) as pool:
            results = list(pool.map(lambda b: post(fe.port, b), bodies))
        shed = sum(st == 429 for st, _, _ in results)
        assert shed >= 1, "6 concurrent requests against 2 pending must shed"
        served = []
        for body, (st, headers, data) in zip(bodies, results):
            if st == 429:
                assert headers.get("Retry-After") == "1"
                assert json.loads(data)["error"]["type"] == "overloaded_error"
            else:
                assert st == 200
                served.append((body["prompt"], json.loads(data)["choices"][0]["token_ids"]))
                assert len(served[-1][1]) == 8
        assert sched.stats["shed_requests"] == shed and len(sched.done) == 6 - shed
    assert [t for _, t in served] == jax_tokens(engines, [p for p, _ in served], 8)


def test_graceful_drain(engines):
    teng = engines[1]
    pool = ThreadPoolExecutor(1)
    body = {"prompt": prompt_for(teng.cfg, 30), "max_tokens": 8, "stream": True}
    with serving(teng) as (fe, _):
        port = fe.port
        fut = pool.submit(post, port, body)
        time.sleep(0.3)           # the request is in flight when the drain begins
    st, _, raw = fut.result(timeout=120)
    pool.shutdown()
    assert st == 200
    toks, finish, done = sse_tokens(raw)
    assert len(toks) == 8 and finish == "length" and done
    with pytest.raises(OSError):
        post(port, {"prompt": [1, 2], "max_tokens": 1}, timeout=5)


def test_frontend_cli_serves_and_drains():
    """``python -m repro_torch.launch.frontend --device cpu``: a completion
    over HTTP, then SIGINT drains and exits."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.frontend", "--device", "cpu", "--top-k", "1",
         "--scheduler", "paged", "--overlap", "--slots", "2", "--max-len", "64", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving" not in line:
            assert time.monotonic() < deadline and proc.poll() is None, line
            line = proc.stdout.readline()
        assert "overlapped" in line
        port = int(line.rsplit(":", 1)[1].split("/")[0])
        st, _, data = post(port, {"prompt": [5, 6, 7, 8], "max_tokens": 4})
        assert st == 200 and len(json.loads(data)["choices"][0]["token_ids"]) == 4
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "draining" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
