"""The generative serving lane: request handling for token streams.

The port of the JAX package's ``serving/generate.py``: the transport-facing
half of the decode subsystem (``runtime.decode`` is the device half).  It
parses /generate bodies, submits them to the continuous-batching
scheduler, frames the token events as Server-Sent Events, and closes the
loop on per-token SLOs: every finished generation lands in the SAME
``SloEngine`` the image path feeds, with TTFT/TPOT budget violations
counted as deadline-exceeded outcomes.  (The JAX lane's brownout shed of
best-effort generations comes with the brownout ladder, ROADMAP A12b.)

Streamed responses are iterators of SSE frames, never complete bodies,
which is why the gateway's response cache refuses ``text/event-stream``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import Counter, deque

from kubernetes_deep_learning_tpu_torch.runtime.decode import (
    FINISH_DEADLINE,
    DecodeEngine,
    DecodeScheduler,
    decode_tokens,
)
from kubernetes_deep_learning_tpu_torch.runtime.errors import QueueFull
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib
from kubernetes_deep_learning_tpu_torch.utils import trace as trace_lib

# The lane's switch and identity: KDLT_DECODE=1 turns the lane on in the
# model-server CLI; the model name keys the seeded weights, the metrics
# label and the :generate route.
DECODE_ENV = "KDLT_DECODE"
DECODE_MODEL_ENV = "KDLT_DECODE_MODEL"
DEFAULT_DECODE_MODEL = "gen-default"

# Per-token SLO budgets: a generation whose TTFT or TPOT lands over budget
# is deadline-exceeded for SLO purposes even though its stream completed.
TTFT_BUDGET_ENV = "KDLT_DECODE_TTFT_MS"
TPOT_BUDGET_ENV = "KDLT_DECODE_TPOT_MS"
DEFAULT_TTFT_BUDGET_MS = 5_000.0
DEFAULT_TPOT_BUDGET_MS = 1_000.0

MAX_GENERATE_BODY_BYTES = 1 << 20  # prompts are text; 1 MiB is generous


def decode_enabled(explicit: bool | None = None) -> bool:
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(DECODE_ENV, "").strip() == "1"


def decode_model() -> str:
    """The lane's model name: ``$KDLT_DECODE_MODEL`` or gen-default."""
    return os.environ.get(DECODE_MODEL_ENV, "").strip() or DEFAULT_DECODE_MODEL


def _env_ms(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw.strip() else default
    except ValueError:
        return default


def ttft_budget_ms() -> float:
    return _env_ms(TTFT_BUDGET_ENV, DEFAULT_TTFT_BUDGET_MS)


def tpot_budget_ms() -> float:
    return _env_ms(TPOT_BUDGET_ENV, DEFAULT_TPOT_BUDGET_MS)


def _percentiles_ms(values: list[float]) -> dict:
    if not values:
        return {}
    xs = sorted(values)

    def pick(q: float) -> float:
        return round(xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3, 3)

    return {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99)}


class GenerateLane:
    """One generative model behind the :generate route.

    Owns the DecodeEngine + DecodeScheduler pair and translates between
    transport requests and token streams.  ``handle_generate`` returns
    ``(status, payload, content_type, extra_headers)``, where a 200 streamed
    payload is an ITERATOR of SSE frames (the transports chunk it onto the
    wire) and everything else is complete bytes.
    """

    def __init__(
        self,
        model: str | None = None,
        *,
        registry: metrics_lib.Registry | None = None,
        slo=None,
        tracer=None,
        recorder=None,
        continuous: bool = True,
        engine: DecodeEngine | None = None,
        engine_kwargs: dict | None = None,
        queue_cap: int | None = None,
    ):
        """``engine_kwargs`` go to the ``DecodeEngine`` this builds
        (``device`` among them; "cuda" by default), unless ``engine`` is
        given."""
        self.model = model or decode_model()
        self.engine = engine or DecodeEngine(self.model, **(engine_kwargs or {}))
        self.slo = slo
        self.tracer = tracer
        self.scheduler = DecodeScheduler(
            self.engine, continuous=continuous, registry=registry, recorder=recorder,
            tracer=tracer, queue_cap=queue_cap)
        self.scheduler.start()
        self._recent_lock = threading.Lock()
        self._recent: deque = deque(maxlen=512)  # (ttft_s, tpot_s | None)
        self._finish_reasons: Counter = Counter()

    def warmup(self) -> dict:
        """Run the decode ladder once (on the card: capture its graphs)."""
        return self.engine.warmup()

    def close(self) -> None:
        """Stop the scheduler (queued and live generations finish
        "cancelled"), then give the engine's device memory back."""
        self.scheduler.close()
        self.engine.close()

    # --- request handling ---------------------------------------------------

    def handle_generate(self, body: bytes, rid: str = "", deadline=None,
                        priority: str | None = None):
        """One /generate request -> (status, payload, ctype, extra_headers).

        400 for a malformed body or a prompt that cannot fit the context;
        503 (QueueFull) when the admission queue is at capacity, both
        recorded against the lane's SLO.  A 200 with ``stream`` is an SSE
        frame iterator; without, a complete JSON body.
        """
        t0 = time.perf_counter()

        def reject(status: int, err: Exception):
            if self.slo is not None:
                self.slo.record(self.model, status, time.perf_counter() - t0,
                                deadline_exceeded=False)
            return status, json.dumps({"error": str(err)}).encode(), \
                protocol.JSON_CONTENT_TYPE, {}

        try:
            req = protocol.decode_generate_request(body)
        except ValueError as e:
            return reject(400, e)
        try:
            gen = self.scheduler.submit(req["prompt"], req["max_new_tokens"], rid=rid,
                                        priority=priority, deadline=deadline)
        except ValueError as e:
            return reject(400, e)
        except QueueFull as e:
            return reject(503, e)
        if req["stream"]:
            return 200, self._sse_stream(gen, t0), protocol.EVENT_STREAM_CONTENT_TYPE, \
                {"Cache-Control": "no-store"}
        # Non-streamed: drain inline and answer with one JSON document.
        for _ in gen.iter_events():
            pass
        self._finish(gen, t0)
        return 200, json.dumps({
            "text": decode_tokens(gen.tokens),
            "tokens": len(gen.tokens),
            "ttft_ms": round((gen.ttft_s() or 0.0) * 1e3, 3),
            "tpot_ms": round((gen.tpot_s() or 0.0) * 1e3, 3),
            "finish_reason": gen.finish_reason,
        }).encode(), protocol.JSON_CONTENT_TYPE, {}

    def _sse_stream(self, gen, t0: float):
        """The streamed response: one SSE frame per token, a terminal done
        frame with the per-token numbers, SLO and trace accounting in the
        finally (which runs on a client disconnect too: GeneratorExit
        cancels the generation, so the decode loop stops spending steps on
        a gone client)."""
        stream_start = trace_lib.now_s()
        try:
            for ev in gen.iter_events():
                if ev[0] == "token":
                    _, idx, tok, text = ev
                    yield protocol.sse_token_event(idx, tok, text)
                else:
                    yield protocol.sse_done_event(
                        tokens=len(gen.tokens), ttft_ms=(gen.ttft_s() or 0.0) * 1e3,
                        tpot_ms=(gen.tpot_s() or 0.0) * 1e3, finish_reason=ev[1],
                        text=decode_tokens(gen.tokens))
        finally:
            if not gen.done:
                gen.cancel()
            if self.tracer is not None and gen.rid:
                self.tracer.record(gen.rid, trace_lib.SPAN_DECODE_STREAM, stream_start,
                                   trace_lib.now_s() - stream_start, tokens=len(gen.tokens),
                                   finish=gen.finish_reason or "cancelled")
            self._finish(gen, t0)

    def _finish(self, gen, t0: float, status: int = 200) -> None:
        """Per-token SLO closure: the outcome lands in the shared SloEngine
        with TTFT/TPOT budget violations (and mid-stream deadline expiries)
        counted as deadline-exceeded."""
        dt = time.perf_counter() - t0
        ttft, tpot = gen.ttft_s(), gen.tpot_s()
        violated = gen.finish_reason == FINISH_DEADLINE
        if ttft is not None and ttft * 1e3 > ttft_budget_ms():
            violated = True
        if tpot is not None and tpot * 1e3 > tpot_budget_ms():
            violated = True
        if self.slo is not None:
            self.slo.record(self.model, status, dt, deadline_exceeded=violated)
        with self._recent_lock:
            if ttft is not None:
                self._recent.append((ttft, tpot))
            self._finish_reasons[gen.finish_reason or "cancelled"] += 1

    # --- observability ------------------------------------------------------

    def debug_payload(self) -> dict:
        """The /debug/slo "decode" section: per-token latency percentiles
        over the recent window, budgets, and live occupancy (what
        kdlt-torch-client --slo renders as its decode table)."""
        with self._recent_lock:
            recent = list(self._recent)
            reasons = dict(self._finish_reasons)
        return {
            "model": self.model,
            "budgets_ms": {"ttft": ttft_budget_ms(), "tpot": tpot_budget_ms()},
            "window": {
                "generations": len(recent),
                "ttft_ms": _percentiles_ms([r[0] for r in recent]),
                "tpot_ms": _percentiles_ms([r[1] for r in recent if r[1] is not None]),
            },
            "finish_reasons": reasons,
            "occupancy": {
                "active_slots": self.engine.active_slots,
                "max_slots": self.engine.max_slots,
                "queue_depth": self.scheduler.queue_depth,
                "pages_in_use": self.engine.pages_in_use,
                "pages_total": self.engine.num_pages - 1,
            },
            "continuous": self.scheduler.continuous,
        }
