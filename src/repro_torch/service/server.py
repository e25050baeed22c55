"""Scheduler daemon: JSON-lines-over-TCP front end (stdlib asyncio only).

The port's copy of the reference's ``service/server.py``, with the same ops
and the same wire format.  Protocol — one JSON object per line in each
direction:

    -> {"id": 7, "op": "submit", "tenant": "ml-infra",
        "job": {"model": "resnet50", "num_gpus": 16, "num_iters": 4000}}
    <- {"id": 7, "ok": true, "result": {"job_id": 42, "admitted": true,
        "placed": true, "gpus": [...], ...}}

Errors never tear the connection: a malformed or rejected request gets
``{"ok": false, "error": "..."}`` and the session continues.  Requests on
one connection are handled in order.  Every request (its JSON decoding
included) runs on one thread the service owns, in request order, so every
mutation and every solve happens on that thread and no locking exists
anywhere in the service.  The port has no ``try``: an op's exception is
read from the future that ran it.  An ``Exception`` becomes the ``ok:
false`` answer; a ``KeyboardInterrupt`` or ``SystemExit`` is raised again.

Operations (``op``):

==========  =============================================================
``submit``  admit + enqueue a job at virtual time ``t`` (default: now);
            placement happens immediately when capacity allows
``place``   pure query: where would this job go right now (no commit)
``whatif``  digital-twin prediction (see :mod:`repro_torch.service.twin`)
``admit``   dry-run admission decision for (tenant, num_gpus)
``stats``   live counters: clock, version, occupancy, tenants, twin cache
``event``   ingest a churn event (preempt / fail / recover / resize)
``advance`` move the virtual clock, returning completions on the way
``drain``   run every pending completion
``shutdown`` acknowledge, then stop the server loop cleanly
==========  =============================================================

This daemon schedules *training jobs onto the cluster*; it is unrelated
to ``repro_torch.launch.serve``, which decodes trained models for
inference.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from ..core.events import ClusterEvent
from .state import LiveCluster
from .twin import DigitalTwin

__all__ = ["SchedulerService", "serve", "run_server", "ServerThread"]


class SchedulerService:
    """Protocol dispatcher over one LiveCluster + DigitalTwin.

    ``handle`` is a plain synchronous function ``dict -> dict`` — the TCP
    layer below is a thin shell around it, and tests can drive the full
    protocol without sockets.  Each request runs on the service's one op
    thread (:attr:`ops`); :meth:`close` ends that thread and the live
    cluster's log."""

    def __init__(self, live: LiveCluster, twin: Optional[DigitalTwin] = None):
        self.live = live
        self.twin = twin or DigitalTwin(live)
        self.requests = 0
        self.errors = 0
        self.shutdown_requested = False
        self._started = time.perf_counter()
        self.ops = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="schedd-op")

    def close(self) -> None:
        self.ops.shutdown(wait=True)
        self.live.close()

    # -- request plumbing ---------------------------------------------------
    def _dispatch(self, req) -> Dict:
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
        op = req.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if op is None or fn is None:
            raise ValueError(f"unknown op {op!r}")
        return fn(req)

    def handle(self, req: Dict) -> Dict:
        rid = req.get("id") if isinstance(req, dict) else None
        self.requests += 1
        fut = self.ops.submit(self._dispatch, req)
        e = fut.exception()
        if e is None:
            resp = {"ok": True, "result": fut.result()}
        elif isinstance(e, Exception):
            self.errors += 1
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        else:
            raise e
        if rid is not None:
            resp["id"] = rid
        return resp

    def handle_line(self, line: bytes) -> Dict:
        """One wire line: decoded on the op thread, then :meth:`handle`d.
        A line that is not JSON gets ``bad JSON: <decoder message>`` and
        does not count as a request, as in the reference."""
        fut = self.ops.submit(json.loads, line)
        e = fut.exception()
        if e is None:
            return self.handle(fut.result())
        if isinstance(e, json.JSONDecodeError):
            return {"ok": False, "error": f"bad JSON: {e}"}
        raise e

    @staticmethod
    def _job_fields(req: Dict) -> Dict:
        job = req.get("job")
        if not isinstance(job, dict) or "model" not in job \
                or "num_gpus" not in job or "num_iters" not in job:
            raise ValueError("request needs a job object with at least "
                             "model / num_gpus / num_iters")
        return job

    # -- operations ---------------------------------------------------------
    def _op_submit(self, req: Dict) -> Dict:
        f = self._job_fields(req)
        job = self.live.new_job(
            model=f["model"], num_gpus=int(f["num_gpus"]),
            num_iters=int(f["num_iters"]),
            batch_size=f.get("batch_size"),
            arrival=req.get("t"),
            allreduce_algo=f.get("allreduce_algo", "ring"),
            deadline=f.get("deadline"))
        return self.live.submit(job, tenant=req.get("tenant", "default"))

    def _op_place(self, req: Dict) -> Dict:
        f = self._job_fields(req)
        probe = self.live.new_job(
            model=f["model"], num_gpus=int(f["num_gpus"]),
            num_iters=int(f["num_iters"]),
            batch_size=f.get("batch_size"),
            allreduce_algo=f.get("allreduce_algo", "ring"))
        return self.live.probe_place(probe)

    def _op_whatif(self, req: Dict) -> Dict:
        f = self._job_fields(req)
        return self.twin.whatif(
            model=f["model"], num_gpus=int(f["num_gpus"]),
            num_iters=int(f["num_iters"]),
            batch_size=f.get("batch_size"),
            allreduce_algo=f.get("allreduce_algo", "ring"),
            strategies=req.get("strategies"),
            horizon=req.get("horizon"))

    def _op_admit(self, req: Dict) -> Dict:
        ok, reason = self.live.admission(req.get("tenant", "default"),
                                         int(req.get("num_gpus", 0)))
        return {"admit": ok, "reason": reason}

    def _op_stats(self, req: Dict) -> Dict:
        out = self.live.stats()
        out["twin"] = self.twin.stats()
        out["requests"] = self.requests
        out["errors"] = self.errors
        out["uptime_s"] = round(time.perf_counter() - self._started, 3)
        return out

    def _op_event(self, req: Dict) -> Dict:
        ev = req.get("event")
        if not isinstance(ev, dict):
            raise ValueError("event op needs an event object "
                             "(ClusterEvent fields)")
        return self.live.ingest(ClusterEvent.from_json(ev))

    def _op_advance(self, req: Dict) -> Dict:
        done = self.live.advance(float(req["t"]))
        return {"t": self.live.now,
                "completed": [[jid, tf] for jid, tf in done]}

    def _op_drain(self, req: Dict) -> Dict:
        done = self.live.drain_all()
        return {"t": self.live.now,
                "completed": [[jid, tf] for jid, tf in done]}

    def _op_shutdown(self, req: Dict) -> Dict:
        self.shutdown_requested = True
        return {"stopping": True}


# ---------------------------------------------------------------------------
# asyncio shell
# ---------------------------------------------------------------------------

async def _settled(aw) -> Tuple[object, bool]:
    """Await ``aw`` as a task: ``(result, True)``, or ``(None, False)`` when
    it raised a ``ConnectionError`` / ``OSError`` (the peer went away).
    Any other exception is raised again."""
    task = asyncio.ensure_future(aw)
    await asyncio.wait([task])
    e = task.exception()
    if e is None:
        return task.result(), True
    if isinstance(e, (ConnectionError, OSError)):
        return None, False
    raise e


async def _close_writer(writer: asyncio.StreamWriter) -> None:
    writer.close()
    await _settled(writer.wait_closed())


async def serve(service: SchedulerService, host: str = "127.0.0.1",
                port: int = 0, ready=None) -> None:
    """Run the TCP front end until a client requests ``shutdown``.

    ``ready(port)`` is called once the socket is listening (port 0 binds an
    ephemeral port — tests and ``chip_smoke.py`` use that to avoid
    collisions)."""
    stop = asyncio.Event()

    async def on_connection(reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        async with contextlib.AsyncExitStack() as stack:
            stack.push_async_callback(_close_writer, writer)
            while True:
                line, alive = await _settled(reader.readline())
                if not alive or not line:
                    break
                resp = service.handle_line(line)
                writer.write((json.dumps(resp, sort_keys=True)
                              + "\n").encode())
                _, alive = await _settled(writer.drain())
                if not alive:
                    break
                if service.shutdown_requested:
                    stop.set()
                    break

    server = await asyncio.start_server(on_connection, host, port)
    bound = server.sockets[0].getsockname()[1]
    if ready is not None:
        ready(bound)
    async with contextlib.AsyncExitStack() as stack:
        # run in reverse: close the listener, wait for it, close the service
        stack.callback(service.close)
        stack.push_async_callback(server.wait_closed)
        stack.callback(server.close)
        await stop.wait()


def run_server(service: SchedulerService, host: str = "127.0.0.1",
               port: int = 0, ready=None) -> None:
    """Blocking entry point (the ``schedd serve`` CLI)."""
    asyncio.run(serve(service, host, port, ready=ready))


class ServerThread:
    """Daemon-thread harness around :func:`serve` for tests and
    ``chip_smoke.py``: start, read the bound port, drive it with clients,
    stop via the ``shutdown`` op."""

    def __init__(self, service: SchedulerService, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self.host = host
        self._ready = threading.Event()
        self.port: Optional[int] = None

        def _ready_cb(bound: int) -> None:
            self.port = bound
            self._ready.set()

        self.thread = threading.Thread(
            target=run_server, args=(service, host, port),
            kwargs={"ready": _ready_cb}, daemon=True)

    def start(self, timeout: float = 10.0) -> Tuple[str, int]:
        self.thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("scheduler service did not come up "
                               f"within {timeout}s")
        return self.host, self.port

    def join(self, timeout: float = 10.0) -> None:
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError("scheduler service did not shut down "
                               f"within {timeout}s")
