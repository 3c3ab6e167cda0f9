"""Async serving frontend: an OpenAI-compatible HTTP server over the slot
engine — ``python -m repro_torch.launch.frontend --arch yi-9b --port 8080``
(the port's copy of ``repro.launch.frontend``; on the card unless
``--device cpu`` is given).

Two pieces, both stdlib-only:

``EngineService`` — bridges concurrent clients to the single-threaded
scheduler.  The scheduler loop runs on ONE worker thread, the only thread
that launches kernels, on the CUDA stream current where the service was
made (torch's current stream is per thread, and the kernels' split
workspaces assume one stream); clients
enqueue requests through a bounded inbox and receive tokens through
per-request asyncio queues fed by the scheduler's ``on_token`` callback
(``call_soon_threadsafe`` hops them onto the event loop).  The worker
drives ``scheduler.serve_step()`` — one admit → step → retire round per
iteration — so new requests are admitted in-flight between engine rounds,
and with ``--overlap`` each round dispatches decode block N+1 while block
N's tokens are still device futures.

**Overload shedding**: when inbox + live requests reach ``max_pending``,
new submissions are rejected up front with HTTP 429 + ``Retry-After``
(counted in ``scheduler.stats["shed_requests"]``) instead of growing an
unbounded queue — a shed request never touches the scheduler, so it can
never corrupt slot state.  Shedding is CLASS-AWARE: requests carry a
``priority`` (``interactive`` | ``standard`` | ``batch``, default
standard); at capacity a newcomer displaces a strictly lower-class entry
still waiting in the inbox (the victim gets the 429) before the newcomer
itself is shed, ``--pending-reserve`` holds back inbox headroom only
interactive may use, the 429 ``Retry-After`` hint scales per class
(batch backs off longest), and while the scheduler's degradation ladder
is shedding batch (level 1+), batch submissions are rejected at the door.
**Graceful drain**: shutdown stops accepting (503), serves every admitted
request to completion, then exits.

**Over a world of ranks** (``--tp``/``--dp`` > 1, ``--scheduler disagg``
among them) every rank builds its engine and scheduler; world rank 0 runs
``HttpFrontend`` and ``EngineService`` as above, and every other rank
runs ``follow``: one ``serve_step`` per round of rank 0's, each taking
the round record that rank 0 broadcasts (``runtime/control.py``: the
requests accepted since the last round, the deadlines that passed, the
ladder's ITL signal, the door sheds), so that every rank serves the same
requests in lockstep.  ``/health`` and its watchdog read rank 0.  The
drain (SIGINT to the process group, which only rank 0 heeds) ends with a
stop record that ends every rank, and then every rank checks that all
served the same streams and outcomes (``Engine.check_replicated``).

The API accepts token-id prompts (this repo has no tokenizer):

    POST /v1/completions
    {"prompt": [1, 2, 3], "max_tokens": 16, "stream": true,
     "stop_token_id": 5, "priority": "interactive"}

Responses follow the completions shape with ``token_ids`` in each choice;
streaming uses SSE (``data: {...}\\n\\n`` chunks, then ``data: [DONE]``).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import signal
import threading
import time
from typing import List, Optional

import numpy as np

import torch

from repro_torch.runtime.scheduler import PRIORITY_CLASSES, PRIORITY_RANK

_DONE = object()

_CAP_MATRIX = None


def _capability_matrix():
    """JSON capability matrix for /health (computed once: the registry
    derives from static configs, it cannot change while serving)."""
    global _CAP_MATRIX
    if _CAP_MATRIX is None:
        from repro_torch.core.capabilities import as_dict
        _CAP_MATRIX = as_dict()
    return _CAP_MATRIX

# Retry-After scale per class: latency classes retry soonest, batch backs
# off longest (it is also the first class the degradation ladder sheds).
# standard stays at 1x so the default-class backoff hint is unchanged.
CLASS_RETRY_SCALE = {"interactive": 1, "standard": 1, "batch": 4}


class TokenStream:
    """Per-request token channel from the scheduler thread to one client
    coroutine.  Created on the event loop; pushed from the worker thread."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._q: "asyncio.Queue" = asyncio.Queue()
        self.request = None          # set at finish (the retired Request)
        self.error: Optional[str] = None
        self.error_status = "400 Bad Request"
        self.error_type = "invalid_request_error"
        self.priority = "standard"

    # -- worker-thread side ------------------------------------------------
    def push(self, tok: int) -> None:
        self._loop.call_soon_threadsafe(self._q.put_nowait, tok)

    def finish(self, request) -> None:
        self.request = request
        self._loop.call_soon_threadsafe(self._q.put_nowait, _DONE)

    def fail(self, msg: str, status: str = "400 Bad Request",
             err_type: str = "invalid_request_error") -> None:
        self.error = msg
        self.error_status = status
        self.error_type = err_type
        self._loop.call_soon_threadsafe(self._q.put_nowait, _DONE)

    # -- client-coroutine side ---------------------------------------------
    async def next_token(self):
        """The next token id, or None when the request finished/failed."""
        item = await self._q.get()
        return None if item is _DONE else item


class EngineService:
    """Owns the scheduler worker thread and the client-facing submit path."""

    def __init__(self, scheduler, max_pending: int = 64,
                 idle_wait_s: float = 0.02, watchdog_s: float = 0.0,
                 pending_reserve: int = 0):
        self.sched = scheduler
        self.max_pending = max_pending
        # inbox headroom only interactive-class submissions may use: the
        # effective bound for standard/batch is max_pending - reserve
        self.pending_reserve = max(0, int(pending_reserve))
        self.idle_wait_s = idle_wait_s
        # scheduler watchdog: with live work in the engine and no host-
        # visible output for > watchdog_s, the node reports itself wedged —
        # /health flips to 503 and new submissions are rejected, so a load
        # balancer ejects the node instead of hanging connections on it.
        # 0 disables.
        self.watchdog_s = watchdog_s
        self._lock = threading.Lock()
        self._inbox: List = []
        self._streams = {}
        self._live = 0               # submitted (inbox or in-engine), unfinished
        self._draining = False
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.failure: Optional[BaseException] = None    # what ended the worker, if it raised
        # the stream the worker launches on: the one current here
        dev = scheduler.engine.device
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        scheduler.stats.setdefault("shed_requests", 0)
        prev_tok, prev_fin = scheduler.on_token, scheduler.on_finish

        def on_token(rid: int, tok: int) -> None:
            if prev_tok is not None:
                prev_tok(rid, tok)
            s = self._streams.get(rid)
            if s is not None:
                s.push(int(tok))

        def on_finish(req) -> None:
            if prev_fin is not None:
                prev_fin(req)
            s = self._streams.pop(req.rid, None)
            if s is None:
                return      # not a client's: a fault plan's burst request
            with self._lock:
                self._live -= 1
            s.finish(req)

        scheduler.on_token = on_token
        scheduler.on_finish = on_finish

    # -- client side (event loop) ------------------------------------------
    def pending(self) -> int:
        with self._lock:
            return self._live + len(self._inbox)

    def wedged(self) -> bool:
        """Watchdog verdict: live work in the engine, but no host-visible
        engine output for longer than ``watchdog_s`` (idle engines never
        trip — the liveness clock only matters while work is in flight)."""
        if not self.watchdog_s:
            return False
        with self._lock:
            live = self._live
        return live > 0 and self.sched.liveness_age() > self.watchdog_s

    def _count_shed(self, priority: str) -> None:
        """Shed accounting (lock held): the global counter plus the
        per-class bucket the scheduler's ``request_summary`` reads (on
        every rank of a world, through the next round record)."""
        self.sched.note_door_shed(priority)

    def try_submit(self, prompt, max_new: int, eos_id: Optional[int],
                   stream: TokenStream,
                   deadline_s: Optional[float] = None,
                   priority: str = "standard") -> str:
        """Returns "ok", "shed" (bounded-queue overload), "draining", or
        "wedged" (watchdog tripped — the engine stopped making progress).

        Class-aware shedding, lowest class first: while the scheduler's
        degradation ladder sheds batch, batch is rejected at the door; a
        non-interactive submission is shed once the inbox reserve is
        reached; and at full capacity a newcomer displaces a strictly
        LOWER-class entry still waiting in the inbox (the latest-submitted
        entry of the worst class — its stream fails with a 429) before the
        newcomer itself is shed."""
        if self.wedged():
            return "wedged"
        rank = PRIORITY_RANK[priority]
        with self._lock:
            if self._draining:
                return "draining"
            if (priority == "batch" and self.sched.overload_level() >= 1):
                self._count_shed(priority)
                return "shed"
            cap = (self.max_pending if priority == "interactive"
                   else self.max_pending - self.pending_reserve)
            if self._live >= cap:
                victim = None
                if self._live >= self.max_pending:
                    worst = max((PRIORITY_RANK[e[5]] for e in self._inbox),
                                default=-1)
                    if worst > rank:
                        victim = next(e for e in reversed(self._inbox)
                                      if PRIORITY_RANK[e[5]] == worst)
                if victim is None:
                    self._count_shed(priority)
                    return "shed"
                self._inbox.remove(victim)
                self._live -= 1
                self._count_shed(victim[5])
                victim[4].fail(
                    "server overloaded: displaced by a higher-priority "
                    "request", status="429 Too Many Requests",
                    err_type="overloaded_error")
            self._inbox.append((prompt, max_new, eos_id, deadline_s, stream,
                                priority))
            self._live += 1
        self._wake.set()
        return "ok"

    # -- worker side --------------------------------------------------------
    def _worker(self) -> None:
        try:
            if self._stream is None:
                self._serve_loop()
            else:
                with torch.cuda.stream(self._stream):
                    self._serve_loop()
            # a world of ranks: the stop record ends the followers, then
            # every rank checks that all served the same streams
            self.sched.stop_followers()
            self.sched.engine.check_replicated(self.sched.done, self.sched.control_counters())
        except BaseException as e:
            self.failure = e
            raise

    def _serve_loop(self) -> None:
        while True:
            with self._lock:
                batch, self._inbox = self._inbox, []
            for prompt, max_new, eos_id, deadline_s, stream, priority \
                    in batch:
                try:
                    # arrival_step = now on the virtual clock: immediately
                    # admissible, ordering decided by the scheduler
                    rid = self.sched.submit(
                        np.asarray(prompt, np.int32), max_new, eos_id=eos_id,
                        arrival_step=self.sched.step_count,
                        deadline_s=deadline_s, priority=priority)
                except ValueError as e:
                    with self._lock:
                        self._live -= 1
                    stream.fail(str(e))
                    continue
                # in a world of ranks the request reached rank 0 only: the
                # next round's record carries it to the other ranks
                self.sched.announce_submit(rid)
                self._streams[rid] = stream
            progressed = self.sched.serve_step()
            if progressed:
                continue
            with self._lock:
                idle = not self._inbox
                stop = self._draining and idle and self._live == 0
            if stop:
                return
            if idle:
                self._wake.wait(self.idle_wait_s)
                self._wake.clear()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="engine-service")
        self._thread.start()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: reject new work, serve everything admitted,
        join the worker.  Returns True if the worker exited in time."""
        with self._lock:
            self._draining = True
        self._wake.set()
        if self._thread is None:
            return True
        self._thread.join(timeout)
        if self.failure is not None:
            raise RuntimeError("the engine service's worker failed") from self.failure
        return not self._thread.is_alive()


class HttpFrontend:
    """Minimal asyncio HTTP/1.1 server exposing the service.  One route
    family, no dependencies: POST /v1/completions (+ GET /health)."""

    MAX_BODY = 8 << 20

    def __init__(self, service: EngineService, host: str = "127.0.0.1",
                 port: int = 8080, retry_after_s: int = 1):
        self.service = service
        self.host = host
        self.port = port
        self.retry_after_s = retry_after_s
        self._server: Optional[asyncio.AbstractServer] = None
        self._next_id = 0
        self._conns = 0

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        self.service.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        """Graceful drain: stop accepting, serve every admitted request to
        completion, and let in-flight responses finish writing."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await asyncio.get_running_loop().run_in_executor(
            None, self.service.drain)
        while self._conns:
            await asyncio.sleep(0.01)

    # -- plumbing -----------------------------------------------------------
    @staticmethod
    async def _read_request(reader):
        head = await reader.readuntil(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        method, path, _ = lines[0].split(" ", 2)
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        clen = int(headers.get("content-length", "0"))
        if clen > HttpFrontend.MAX_BODY:
            raise ValueError("body too large")
        body = await reader.readexactly(clen) if clen else b""
        return method, path, headers, body

    @staticmethod
    def _respond(writer, status: str, payload: dict,
                 extra_headers: str = "") -> None:
        body = json.dumps(payload).encode()
        writer.write(
            f"HTTP/1.1 {status}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n"
            f"{extra_headers}\r\n".encode() + body)

    async def _handle(self, reader, writer) -> None:
        self._conns += 1
        try:
            try:
                method, path, _, body = await self._read_request(reader)
            except (asyncio.IncompleteReadError, ValueError,
                    asyncio.LimitOverrunError):
                return
            if method == "GET" and path in ("/health", "/v1/health"):
                # liveness-aware health: a load balancer ejects on 503.
                # last_step_age_s is seconds since engine outputs last
                # became host-visible — the scheduler watchdog signal
                svc = self.service
                wedged = svc.wedged()
                with svc._lock:
                    inbox_depth = len(svc._inbox)
                    draining = svc._draining
                payload = {
                    "status": ("wedged" if wedged
                               else "draining" if draining else "ok"),
                    "pending": svc.pending(),
                    "inbox_depth": inbox_depth,
                    "draining": draining,
                    "last_step_age_s": round(svc.sched.liveness_age(), 3),
                    "watchdog_s": svc.watchdog_s,
                    "shed_requests": svc.sched.stats["shed_requests"],
                    "quarantined": svc.sched.stats.get("quarantined", 0),
                    "timeouts": svc.sched.stats.get("timeouts", 0),
                    # per-class served/shed/timeout/error counters and the
                    # degradation-ladder state (level 0 = normal)
                    "classes": svc.sched.stats.get("classes", {}),
                    "overload": (
                        svc.sched.overload_ctl.summary()
                        if getattr(svc.sched, "overload_ctl", None)
                        is not None
                        else {"level": svc.sched.overload_level(),
                              "level_name": "normal"}),
                    # the registered capability matrix (same table as
                    # serve.py --list-archs), plus which arch this server
                    # is actually running
                    "arch": svc.sched.engine.cfg.name,
                    "capabilities": _capability_matrix(),
                }
                self._respond(writer,
                              "503 Service Unavailable" if wedged
                              else "200 OK", payload)
            elif method == "POST" and path == "/v1/completions":
                await self._completions(writer, body)
            else:
                self._respond(writer, "404 Not Found",
                              {"error": {"message": f"no route {path}"}})
            await writer.drain()
        finally:
            self._conns -= 1
            writer.close()

    # -- the route ----------------------------------------------------------
    async def _completions(self, writer, body: bytes) -> None:
        try:
            req = json.loads(body or b"{}")
            prompt = req["prompt"]
            if not (isinstance(prompt, list) and len(prompt) >= 2
                    and all(isinstance(t, int) for t in prompt)):
                raise ValueError(
                    "prompt must be a list of >= 2 token ids "
                    "(this engine serves token ids; there is no tokenizer)")
            max_new = int(req.get("max_tokens", 16))
            if max_new < 1:
                raise ValueError("max_tokens must be >= 1")
            eos_id = req.get("stop_token_id")
            eos_id = None if eos_id is None else int(eos_id)
            # per-request deadline: the scheduler retires the request with
            # finish_reason "timeout" once max_time seconds elapse
            max_time = req.get("max_time")
            max_time = None if max_time is None else float(max_time)
            if max_time is not None and max_time <= 0:
                raise ValueError("max_time must be > 0 seconds")
            do_stream = bool(req.get("stream", False))
            priority = str(req.get("priority", "standard"))
            if priority not in PRIORITY_RANK:
                raise ValueError(
                    f"unknown priority class {priority!r}; expected one "
                    f"of {PRIORITY_CLASSES}")
        except (KeyError, TypeError, ValueError) as e:
            self._respond(writer, "400 Bad Request",
                          {"error": {"message": str(e),
                                     "type": "invalid_request_error"}})
            return
        stream = TokenStream(asyncio.get_running_loop())
        stream.priority = priority
        verdict = self.service.try_submit(prompt, max_new, eos_id, stream,
                                          deadline_s=max_time,
                                          priority=priority)
        if verdict == "wedged":
            # scheduler watchdog tripped: the engine stopped producing
            # output with work in flight — fail fast so the load balancer
            # routes around this node instead of hanging the connection
            self._respond(writer, "503 Service Unavailable",
                          {"error": {"message": "engine is not making "
                                                "progress (watchdog)",
                                     "type": "unavailable_error"}})
            return
        if verdict == "shed":
            # bounded-queue overload shedding: reject BEFORE the scheduler
            # ever sees the request, with a per-class client backoff hint
            # (batch clients are told to back off longest)
            retry = self.retry_after_s * CLASS_RETRY_SCALE[priority]
            self._respond(
                writer, "429 Too Many Requests",
                {"error": {"message": "server overloaded, retry later",
                           "type": "overloaded_error"}},
                extra_headers=f"Retry-After: {retry}\r\n")
            return
        if verdict == "draining":
            self._respond(writer, "503 Service Unavailable",
                          {"error": {"message": "server is draining",
                                     "type": "unavailable_error"}})
            return
        self._next_id += 1
        cid = f"cmpl-{self._next_id}"
        if do_stream:
            await self._stream_response(writer, cid, eos_id, stream)
        else:
            await self._unary_response(writer, cid, eos_id, stream)

    @staticmethod
    def _finish_reason(toks: List[int], eos_id: Optional[int],
                       stream: Optional[TokenStream] = None) -> str:
        # the retired Request's own verdict wins (it distinguishes "error"
        # and "timeout" retirements from natural stop/length); the token
        # heuristic is the fallback for failed submissions
        if (stream is not None and stream.request is not None
                and stream.request.finish_reason):
            return stream.request.finish_reason
        return ("stop" if eos_id is not None and toks and toks[-1] == eos_id
                else "length")

    async def _unary_response(self, writer, cid, eos_id, stream) -> None:
        toks: List[int] = []
        while True:
            t = await stream.next_token()
            if t is None:
                break
            toks.append(t)
        if stream.error is not None:
            # the stream carries its own verdict: validation failures stay
            # 400, priority displacement surfaces as 429 with the same
            # per-class Retry-After hint the door-shed path uses
            extra = ""
            if stream.error_status.startswith("429"):
                retry = (self.retry_after_s
                         * CLASS_RETRY_SCALE.get(stream.priority, 1))
                extra = f"Retry-After: {retry}\r\n"
            self._respond(writer, stream.error_status,
                          {"error": {"message": stream.error,
                                     "type": stream.error_type}},
                          extra_headers=extra)
            return
        self._respond(writer, "200 OK", {
            "id": cid, "object": "text_completion", "model": "repro_torch",
            "created": int(time.time()),
            "choices": [{"index": 0, "token_ids": toks, "text": "",
                         "finish_reason":
                             self._finish_reason(toks, eos_id, stream)}],
            "usage": {"completion_tokens": len(toks)}})

    async def _stream_response(self, writer, cid, eos_id, stream) -> None:
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n")
        toks: List[int] = []
        while True:
            t = await stream.next_token()
            if t is None:
                break
            toks.append(t)
            chunk = {"id": cid, "object": "text_completion.chunk",
                     "choices": [{"index": 0, "token_ids": [t], "text": ""}]}
            writer.write(f"data: {json.dumps(chunk)}\n\n".encode())
            try:
                await writer.drain()
            except ConnectionError:
                return                # client went away; engine finishes solo
        if stream.error is not None:
            writer.write(
                f"data: {json.dumps({'error': stream.error})}\n\n".encode())
        else:
            final = {"id": cid, "object": "text_completion.chunk",
                     "choices": [{"index": 0, "token_ids": [], "text": "",
                                  "finish_reason":
                                      self._finish_reason(toks, eos_id,
                                                          stream)}]}
            writer.write(f"data: {json.dumps(final)}\n\n".encode())
        writer.write(b"data: [DONE]\n\n")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def follow(sched) -> None:
    """A follower rank's serving loop (world rank > 0): one round per round
    of world rank 0's, each applying rank 0's round record, until the
    stop record; then the check that every rank served the same streams."""
    while not sched.control_stopped:
        sched.serve_step()
    sched.engine.check_replicated(sched.done, sched.control_counters())


def main(argv=None):
    """Serve over HTTP until SIGINT, then drain; -> the frontend, or over
    more than one rank each rank's summary."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as M
    from repro_torch.models.common import Dist
    ap = serve_mod.build_parser(argparse.ArgumentParser(
        description="OpenAI-compatible async serving frontend"))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 picks an ephemeral port (printed at startup)")
    ap.add_argument("--max-pending", type=int, default=64,
                    help="bounded request queue: submissions beyond this "
                         "many live requests are shed with HTTP 429")
    ap.add_argument("--watchdog-s", type=float, default=30.0,
                    help="scheduler watchdog: with live work and no engine "
                         "output for this many seconds, /health turns 503 "
                         "and new submissions are rejected (0 disables)")
    ap.add_argument("--pending-reserve", type=int, default=0,
                    help="slots of the pending queue held back for "
                         "interactive-class requests (non-interactive "
                         "submissions shed this much earlier)")
    args = ap.parse_args(argv)
    if args.scheduler == "wave":
        ap.error("the frontend needs a continuous scheduler "
                 "(--scheduler continuous|paged|disagg)")
    if args.tp == 1 and args.dp == 1:
        return _serve_rank(Dist(), None, args)
    M.check_supported(get_config(args.arch), serve_mod.engine_parallel(args),
                      wq_cache=args.wq_cache)
    mesh.check_backend(args.dp * args.tp, args.dist_backend, args.device)
    if args.device == "cuda":
        from repro_torch.kernels import build
        build.build_all()          # once, before the ranks load the libraries
    # SIGINT to the process group drains rank 0, which then stops the
    # others: this process and the followers ignore it
    prev = signal.signal(signal.SIGINT, signal.SIG_IGN)
    try:
        return mesh.spawn(_serve_rank, args.tp, args, backend=args.dist_backend,
                          device=args.device, dp=args.dp)
    finally:
        signal.signal(signal.SIGINT, prev)


def _serve_rank(dist, device, args):
    """One rank of the frontend (the only one at tp = dp = 1): world rank
    0 serves HTTP, every other rank follows its round records."""
    from repro_torch.launch import serve as serve_mod
    eng = serve_mod.build_engine(args, dist, device)
    sched = serve_mod.make_scheduler(eng, args)
    if dist.world_rank != 0:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        follow(sched)
        return {"world_rank": dist.world_rank, "requests": len(sched.done),
                "counters": sched.control_counters()}
    if dist.world > 1:
        signal.signal(signal.SIGINT, signal.default_int_handler)
    service = EngineService(sched, max_pending=args.max_pending,
                            watchdog_s=args.watchdog_s,
                            pending_reserve=args.pending_reserve)
    frontend = HttpFrontend(service, host=args.host, port=args.port)
    world = (f", tp={dist.tp}" + (f", dp={dist.dp}" if dist.dp > 1 else "")
             if dist.world > 1 else "")

    async def amain():
        await frontend.start()
        print(f"serving {eng.cfg.name} ({args.scheduler}"
              f"{', overlapped' if sched.overlap else ''}{world}) on "
              f"http://{frontend.host}:{frontend.port}/v1/completions",
              flush=True)
        await frontend.serve_forever()

    # SIGINT cancels the serving task and asyncio.run raises
    # KeyboardInterrupt; then serve every admitted request to completion
    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        pass
    print("draining...", flush=True)
    service.drain()
    if dist.world > 1:
        return {"world_rank": 0, "requests": len(sched.done),
                "counters": sched.control_counters()}
    return frontend


if __name__ == "__main__":
    main()
