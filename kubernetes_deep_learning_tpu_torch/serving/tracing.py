"""Cross-tier request tracing: one id from client edge to model server.

The port's copy of the JAX package's ``serving/tracing.py``.  Every
request carries an ``X-Request-Id``: the gateway accepts a client-supplied
id or mints one and forwards it to the model tier, and both tiers echo it
in the response and stamp it on their log lines -- so one ``kubectl logs``
grep over both pods reconstructs a request's path.

The request id doubles as the Dapper-style **trace id** (utils.trace): each
tier records per-request spans keyed by it, the active span id crosses the
tier boundary in ``X-Kdlt-Parent-Span``, and ``/debug/trace/<rid>`` serves
the waterfall.  This module re-exports the propagation constants so serving
code has one import site for the whole trace surface.

Ids are sanitized to a conservative charset before logging or forwarding:
a client-chosen id must not be able to inject log lines or header structure.

``KDLT_LOG_FORMAT=json`` switches log_request to one JSON object per line
(machine-parseable structured logs for k8s log pipelines); the default
stays the human ``[rid=...]`` format.
"""

from __future__ import annotations

import json
import os
import random
import re
import time

from kubernetes_deep_learning_tpu_torch.utils.trace import (  # noqa: F401 - re-exports
    GRPC_PARENT_SPAN_KEY,
    PARENT_SPAN_HEADER,
    TRACE_HEADER,
    ensure_span_id,
)

REQUEST_ID_HEADER = "X-Request-Id"
GRPC_METADATA_KEY = "x-request-id"  # gRPC metadata keys are lowercase

LOG_FORMAT_ENV = "KDLT_LOG_FORMAT"

_RID_SAFE_RE = re.compile(r"[^A-Za-z0-9_.\-]")


def ensure_request_id(raw: str | None) -> str:
    """Sanitized client-supplied id, or a fresh 16-hex-char one (from the
    process's PRNG, which the OS seeds: no entropy read per request)."""
    if raw:
        rid = _RID_SAFE_RE.sub("", raw)[:64]
        if rid:
            return rid
    return f"{random.getrandbits(64):016x}"


def log_json() -> bool:
    return os.environ.get(LOG_FORMAT_ENV, "").strip().lower() == "json"


def log_request(
    tier: str,
    rid: str,
    *,
    status: int | str,
    t0: float,
    span_id: str | None = None,
    **fields,
) -> None:
    """One stdout line per request, kubectl-logs-greppable by rid.

    ``fields`` are extra key=value pairs (model name, batch size, ...).
    Values are str()'d in the default format; callers pass only values
    they control.  With ``KDLT_LOG_FORMAT=json`` the line is one JSON
    object carrying the same data plus the trace/span ids, so a log
    pipeline can join log lines to ``/debug/trace/<rid>`` waterfalls
    without parsing the human format.
    """
    dur_ms = (time.perf_counter() - t0) * 1e3
    if log_json():
        rec = {
            "rid": rid,
            "trace_id": rid,  # the request id IS the trace id
            "tier": tier,
            "status": status,
            "dur_ms": round(dur_ms, 1),
        }
        if span_id:
            rec["span_id"] = span_id
        rec.update(fields)
        print(json.dumps(rec, default=str), flush=True)
        return
    extra = "".join(f" {k}={v}" for k, v in fields.items())
    print(f"[rid={rid}] {tier} status={status} dur_ms={dur_ms:.1f}{extra}", flush=True)
