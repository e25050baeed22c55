"""Clients for the scheduler daemon's JSON-lines protocol.

The port's copy of the reference's ``service/client.py``.
:class:`SchedClient` is the blocking, socket-per-client convenience used
by the CLI (``repro_torch.launch.schedd submit|whatif``), ``chip_smoke.py``
and tests.  :class:`AsyncSchedClient` is the asyncio variant a load test
fans out by the hundred.  Both speak the exact wire format of
:mod:`repro_torch.service.server` and raise :class:`ServiceError` when the
daemon answers ``ok: false`` — transport problems surface as the usual
``OSError`` family instead, so callers can tell "the request was bad"
from "the daemon is gone".
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import socket
from typing import Dict, Optional, Sequence

__all__ = ["ServiceError", "SchedClient", "AsyncSchedClient"]


class ServiceError(RuntimeError):
    """The daemon rejected a request (``ok: false``)."""


def _job_payload(model: str, num_gpus: int, num_iters: int,
                 batch_size: Optional[int] = None,
                 allreduce_algo: str = "ring",
                 deadline: Optional[float] = None) -> Dict:
    job = {"model": model, "num_gpus": num_gpus, "num_iters": num_iters,
           "allreduce_algo": allreduce_algo}
    if batch_size is not None:
        job["batch_size"] = batch_size
    if deadline is not None:
        job["deadline"] = deadline
    return job


class SchedClient:
    """Blocking JSON-lines client (one TCP connection, requests in
    order)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 60.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._fh = self._sock.makefile("rwb")
        self._next_id = 0

    # -- wire ---------------------------------------------------------------
    def call(self, op: str, **params) -> Dict:
        self._next_id += 1
        req = {"id": self._next_id, "op": op, **params}
        self._fh.write((json.dumps(req) + "\n").encode())
        self._fh.flush()
        line = self._fh.readline()
        if not line:
            raise ConnectionError("scheduler service closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise ServiceError(resp.get("error", "unknown service error"))
        return resp["result"]

    # -- operations ---------------------------------------------------------
    def submit(self, model: str, num_gpus: int, num_iters: int,
               batch_size: Optional[int] = None, tenant: str = "default",
               t: Optional[float] = None, allreduce_algo: str = "ring",
               deadline: Optional[float] = None) -> Dict:
        params = {"tenant": tenant,
                  "job": _job_payload(model, num_gpus, num_iters,
                                      batch_size, allreduce_algo, deadline)}
        if t is not None:
            params["t"] = t
        return self.call("submit", **params)

    def place(self, model: str, num_gpus: int, num_iters: int,
              batch_size: Optional[int] = None,
              allreduce_algo: str = "ring") -> Dict:
        return self.call("place", job=_job_payload(
            model, num_gpus, num_iters, batch_size, allreduce_algo))

    def whatif(self, model: str, num_gpus: int, num_iters: int,
               batch_size: Optional[int] = None,
               strategies: Optional[Sequence[str]] = None,
               horizon: Optional[float] = None,
               allreduce_algo: str = "ring") -> Dict:
        params = {"job": _job_payload(model, num_gpus, num_iters,
                                      batch_size, allreduce_algo)}
        if strategies is not None:
            params["strategies"] = list(strategies)
        if horizon is not None:
            params["horizon"] = horizon
        return self.call("whatif", **params)

    def admit(self, tenant: str, num_gpus: int) -> Dict:
        return self.call("admit", tenant=tenant, num_gpus=num_gpus)

    def stats(self) -> Dict:
        return self.call("stats")

    def event(self, ev: Dict) -> Dict:
        return self.call("event", event=ev)

    def advance(self, t: float) -> Dict:
        return self.call("advance", t=t)

    def drain(self) -> Dict:
        return self.call("drain")

    def shutdown(self) -> Dict:
        return self.call("shutdown")

    def close(self) -> None:
        with contextlib.ExitStack() as stack:
            stack.callback(self._sock.close)   # runs even if the file raises
            self._fh.close()

    def __enter__(self) -> "SchedClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncSchedClient:
    """asyncio JSON-lines client — a load test opens hundreds of these
    concurrently against one daemon."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._next_id = 0

    @classmethod
    async def connect(cls, host: str = "127.0.0.1",
                      port: int = 0) -> "AsyncSchedClient":
        reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer)

    async def call(self, op: str, **params) -> Dict:
        self._next_id += 1
        req = {"id": self._next_id, "op": op, **params}
        self._writer.write((json.dumps(req) + "\n").encode())
        await self._writer.drain()
        line = await self._reader.readline()
        if not line:
            raise ConnectionError("scheduler service closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise ServiceError(resp.get("error", "unknown service error"))
        return resp["result"]

    async def place(self, model: str, num_gpus: int, num_iters: int,
                    batch_size: Optional[int] = None) -> Dict:
        return await self.call("place", job=_job_payload(
            model, num_gpus, num_iters, batch_size))

    async def whatif(self, model: str, num_gpus: int, num_iters: int,
                     strategies: Optional[Sequence[str]] = None,
                     horizon: Optional[float] = None) -> Dict:
        params = {"job": _job_payload(model, num_gpus, num_iters)}
        if strategies is not None:
            params["strategies"] = list(strategies)
        if horizon is not None:
            params["horizon"] = horizon
        return await self.call("whatif", **params)

    async def stats(self) -> Dict:
        return await self.call("stats")

    async def admit(self, tenant: str, num_gpus: int) -> Dict:
        return await self.call("admit", tenant=tenant, num_gpus=num_gpus)

    async def close(self) -> None:
        """Close the connection; a peer that is already gone
        (``ConnectionError`` / ``OSError`` while waiting for the close) is
        not an error, anything else is raised."""
        self._writer.close()
        task = asyncio.ensure_future(self._writer.wait_closed())
        await asyncio.wait([task])
        e = task.exception()
        if e is not None and not isinstance(e, (ConnectionError, OSError)):
            raise e
