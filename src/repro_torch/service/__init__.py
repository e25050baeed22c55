"""Online scheduler service with a what-if digital twin.

The port's copy of the reference's ``repro.service``.  The long-lived
counterpart of the offline campaigns: a daemon that admits and places
training jobs online over live fabric state, with a forked "digital twin"
answering what-if queries before anything is committed.  Every rate
resolution — the live engine's and each twin fork's — runs on the live
cluster's device (``LiveCluster(..., device=)``, default ``"cuda"``: the
segment-max kernel).

  state   — LiveCluster: incremental v2-engine driver + durable event log
            (bit-identical to offline simulate(), crash-replayable)
  twin    — DigitalTwin: copy-on-fork what-if predictions, memoised by
            fabric version
  server  — JSON-lines-over-TCP daemon (asyncio, stdlib only); every op
            runs on one thread the service owns
  client  — blocking + asyncio protocol clients

CLI: ``python -m repro_torch.launch.schedd serve|submit|whatif|replay``.
Not to be confused with ``repro_torch.serve`` (inference decoding).
"""

from .state import (LiveCluster, RecordingSimulator, ServiceLog,
                    drain_completions, job_from_json, job_to_json,
                    replay_trace, service_schema)
from .twin import DigitalTwin
from .server import SchedulerService, ServerThread, run_server, serve
from .client import AsyncSchedClient, SchedClient, ServiceError

__all__ = [
    "LiveCluster", "RecordingSimulator", "ServiceLog", "drain_completions",
    "job_from_json", "job_to_json", "replay_trace", "service_schema",
    "DigitalTwin", "SchedulerService", "ServerThread", "run_server",
    "serve", "AsyncSchedClient", "SchedClient", "ServiceError",
]
