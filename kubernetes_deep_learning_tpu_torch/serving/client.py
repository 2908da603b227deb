"""Client library + smoke-test CLI: the reference ``test.py`` equivalent
(the port of ``serving/client.py``).

Reference behavior (reference test.py:1-16): POST a JSON body with an image
URL to the gateway and print the score dict.  The CLI does exactly that; the
library adds a direct model-server client for programmatic use.  It speaks
HTTP through ``http.client`` (the card's machine has no ``requests``): an
HTTP error status raises :class:`HTTPError`, a refused or reset connection
a ``ConnectionError`` or an ``http.client.HTTPException``.

The generative lane's client half: ``generate_stream`` (``--stream
PROMPT``, ``--max-new-tokens``) reads the gateway's ``/generate`` SSE frames
one by one as they arrive, and ``render_decode_slo`` draws the per-token
view of ``/debug/slo`` (``--slo``).  The brownout view (``fetch_brownout``,
``render_classes``: ``/debug/brownout``, which the port's gateway does not
serve) waits for the brownout ladder, ROADMAP A12b.
"""

from __future__ import annotations

import argparse
import http.client
import json
import random
import sys
import time
import urllib.parse
import uuid

import numpy as np

from kubernetes_deep_learning_tpu_torch.serving import protocol

# The reference's canonical test image (reference test.py:4).
DEFAULT_IMAGE_URL = "http://bit.ly/mlbookcamp-pants"

# Retry budget for 503 shed responses: the server's Retry-After is honored
# but never beyond this cap (a confused server must not park the client),
# and jitter decorrelates a thundering herd of retriers.
RETRY_AFTER_CAP_S = 5.0
DEFAULT_RETRY_BACKOFF_S = 0.05

# A refused, reset or half-answered connection: the request never completed
# on the serving path, so resending is safe.
CONNECTION_ERRORS = (ConnectionError, http.client.HTTPException)


class HTTPError(RuntimeError):
    """A reply with an error status (4xx/5xx)."""

    def __init__(self, status: int, body: bytes, url: str):
        super().__init__(f"{status} error for {url}: {body[:200]!r}")
        self.status = status
        self.body = body


class Response:
    """One HTTP reply: status, headers (case-insensitive) and body."""

    def __init__(self, status: int, headers: http.client.HTTPMessage, body: bytes, url: str):
        self.status_code = status
        self.headers = headers
        self.content = body
        self.url = url

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HTTPError(self.status_code, self.content, self.url)

    def json(self):
        return json.loads(self.content)


def request(method: str, url: str, body: bytes | None = None, headers: dict | None = None,
            timeout: float = 30.0) -> Response:
    """One request on a connection of its own."""
    parts = urllib.parse.urlsplit(url)
    conn_cls = (http.client.HTTPSConnection if parts.scheme == "https"
                else http.client.HTTPConnection)
    conn = conn_cls(parts.hostname, parts.port, timeout=timeout)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return Response(r.status, r.headers, r.read(), url)
    finally:
        conn.close()


def _get_json(url: str, timeout: float):
    r = request("GET", url, timeout=timeout)
    r.raise_for_status()
    return r.json()


def predict_url(
    gateway_url: str,
    image_url: str,
    timeout: float = 30.0,
    retries: int = 2,
    deadline_ms: float | None = None,
    stats: dict | None = None,
    model: str | None = None,
    cache_bust: str | None = None,
    priority: str | None = None,
) -> dict:
    """POST {"url": ...} to the gateway's /predict (reference test.py:15).

    A 503 is the serving tiers' explicit transient shed signal (admission
    queue full, draining replica, open circuit breaker), so instead of
    raising immediately the client retries up to ``retries`` times, sleeping
    for the server's ``Retry-After`` hint (capped, jittered) -- but never
    past its own ``timeout`` budget.  Connection-level failures (refused,
    reset mid-response -- a gateway replica dying under the request) share
    the same jittered, deadline-bounded retry budget: the request never
    reached/completed on the serving path, so resending is safe and usually
    lands on a healthy replica.  ``deadline_ms`` states an end-to-end
    deadline budget via the X-Request-Deadline-Ms header; the serving path
    then derives every queue wait and upstream timeout from what remains.

    ``stats``, if given, collects retry accounting under distinct labels:
    ``retried_shed`` (503 + Retry-After) vs ``retried_connect`` (connect/
    reset) -- the CLI prints them separately so an operator can tell
    overload from instability at a glance.

    ``model`` routes to a non-default served model: the request goes to
    ``/predict/<model>`` AND carries the X-Kdlt-Model header (path wins at
    the gateway; the header survives path-rewriting proxies).  None keeps
    the exact default-model wire shape -- bare ``/predict``, no model
    header.

    ``cache_bust`` salts the gateway's content-addressed response cache
    via the X-Kdlt-Cache-Bust header so a load test can deliberately opt
    out of cached answers.  The gateway's cache disposition for the served
    request (hit | miss | coalesced, from the X-Kdlt-Cache response
    header) lands in ``stats["cache"]``.

    ``priority`` states the request's class (interactive | batch |
    best-effort) via the X-Kdlt-Priority header.
    """
    from kubernetes_deep_learning_tpu_torch.serving.admission import DEADLINE_HEADER
    from kubernetes_deep_learning_tpu_torch.serving.tracing import (
        REQUEST_ID_HEADER,
        TRACE_HEADER,
    )

    if stats is None:
        stats = {}
    stats.setdefault("retried_shed", 0)
    stats.setdefault("retried_connect", 0)
    headers = {"Content-Type": "application/json"}
    if deadline_ms is not None:
        headers[DEADLINE_HEADER] = f"{float(deadline_ms):.1f}"
    path = "/predict"
    if model is not None:
        path = f"/predict/{model}"
        headers[protocol.MODEL_HEADER] = model
    if cache_bust is not None:
        headers[protocol.CACHE_BUST_HEADER] = cache_bust
    if priority is not None:
        headers[protocol.PRIORITY_HEADER] = priority
    body = json.dumps({"url": image_url}).encode()
    t0 = time.monotonic()
    for attempt in range(retries + 1):
        try:
            r = request("POST", f"{gateway_url}{path}", body, headers, timeout)
        except CONNECTION_ERRORS:
            # Refused/reset: the same bounded, jittered backoff as a shed,
            # labeled distinctly (this is instability, not overload).
            if attempt >= retries:
                raise
            delay = DEFAULT_RETRY_BACKOFF_S
            delay += random.uniform(0.0, delay * 0.25 + 0.01)
            if time.monotonic() - t0 + delay > timeout:
                raise
            stats["retried_connect"] += 1
            time.sleep(delay)
            continue
        if r.status_code != 503 or attempt >= retries:
            r.raise_for_status()
            # The served request's trace handles: the echoed request id
            # (= trace id, the /debug/trace/<rid> key) and this tier's
            # span summary header -- the CLI's --trace mode uses both.
            stats["request_id"] = r.headers.get(REQUEST_ID_HEADER, "")
            stats["trace_summary"] = r.headers.get(TRACE_HEADER, "")
            stats["cache"] = r.headers.get(protocol.CACHE_STATUS_HEADER, "")
            return r.json()
        try:
            retry_after = float(r.headers.get("Retry-After", ""))
        except (TypeError, ValueError):
            retry_after = DEFAULT_RETRY_BACKOFF_S
        delay = min(max(retry_after, 0.0), RETRY_AFTER_CAP_S)
        delay += random.uniform(0.0, delay * 0.25 + 0.01)  # decorrelate herds
        if time.monotonic() - t0 + delay > timeout:
            r.raise_for_status()  # out of budget: surface the 503
        stats["retried_shed"] += 1
        time.sleep(delay)
    raise AssertionError("unreachable")  # loop always returns or raises


def fetch_trace(gateway_url: str, rid: str, timeout: float = 5.0) -> list[dict]:
    """GET the merged cross-tier waterfall for a served request.

    The gateway's /debug/trace/<rid> already merges the model tier's spans
    in (it knows the replica list), so one call yields the full timeline.
    Returns the span dicts; raises for HTTP errors (404 = trace evicted
    from the ring buffer or id never seen).
    """
    return _get_json(f"{gateway_url}/debug/trace/{rid}", timeout)["spans"]


def fetch_slo(gateway_url: str, timeout: float = 5.0) -> dict:
    """GET the gateway's merged /debug/slo view (its own client-observed
    accounting plus every model-tier replica's, summed per model)."""
    return _get_json(f"{gateway_url}/debug/slo", timeout)


def fetch_debug_index(gateway_url: str, timeout: float = 5.0) -> dict:
    """GET the gateway's /debug/ index: every diagnostic route it serves
    with a one-line description, so an operator can discover the rest."""
    return _get_json(f"{gateway_url}/debug/", timeout)


def render_debug_index(payload: dict) -> str:
    """ASCII footer listing the tier's diagnostic surface."""
    lines = [f"debug index ({payload.get('tier', '?')} tier):"]
    for route, desc in sorted((payload.get("routes") or {}).items()):
        lines.append(f"  {route:<28s} {desc}")
    return "\n".join(lines)


def fetch_bucket_audit(gateway_url: str, timeout: float = 5.0) -> dict:
    """GET the gateway's /debug/profile?audit=buckets view: every replica's
    per-bucket padding-waste ratio and compiled FLOPs/img."""
    return _get_json(f"{gateway_url}/debug/profile?audit=buckets", timeout)


def render_bucket_audit(payload: dict) -> str:
    """ASCII rendering of the merged bucket audit: one row per (replica,
    model, bucket) -- how much of each compiled program's work is padding,
    and what a real image costs in it."""
    lines = [
        "bucket audit (padding waste = padded slots / bucket capacity):",
        f"{'replica':<22s} {'model':<14s} {'bucket':>6s} {'batches':>8s} "
        f"{'mean_n':>7s} {'waste':>7s} {'gflops/img':>11s}",
    ]
    for host, body in sorted((payload.get("replicas") or {}).items()):
        if not isinstance(body, dict) or "error" in body:
            err = body.get("error") if isinstance(body, dict) else body
            lines.append(f"{host:<22s} # unreachable: {err}")
            continue
        for model, audit in sorted((body.get("models") or {}).items()):
            for bucket, row in sorted(
                (audit.get("buckets") or {}).items(), key=lambda kv: int(kv[0])
            ):
                flops = row.get("flops_per_image")
                gflops = f"{flops / 1e9:>11.3f}" if flops else f"{'-':>11s}"
                lines.append(
                    f"{host:<22s} {model:<14s} {int(bucket):>6d} "
                    f"{int(row.get('batches', 0)):>8d} "
                    f"{(row.get('mean_admitted') or 0.0):>7.1f} "
                    f"{(row.get('padding_waste_ratio') or 0.0):>7.2%} {gflops}"
                )
    return "\n".join(lines)


def fetch_pool(gateway_url: str, timeout: float = 5.0) -> dict:
    """GET the gateway's /debug/pool view: membership, per-replica
    health/quarantine/drain state, picks, and the latency EWMA driving
    power-of-two-choices selection."""
    return _get_json(f"{gateway_url}/debug/pool", timeout)


def render_pool(payload: dict) -> str:
    """ASCII rendering of a /debug/pool payload: one row per replica --
    how a scale event rebalances traffic, watched live."""
    lines = [
        f"pool: {payload.get('members', 0)} members, "
        f"{payload.get('joins', 0)} joins, {payload.get('leaves', 0)} "
        f"leaves (resolve every {payload.get('resolve_interval_s', 0)}s)"
    ]
    lines.append(
        f"{'replica':<28s} {'state':<12s} {'picks':>8s} {'ewma_ms':>9s}"
    )
    for row in payload.get("replicas", []):
        state = (
            "quarantined" if row.get("quarantined")
            else "draining" if row.get("draining")
            else "up" if row.get("healthy")
            else "DOWN"
        )
        ewma = row.get("ewma_ms")
        ewma_s = f"{ewma:>9.2f}" if ewma is not None else f"{'-':>9s}"
        lines.append(
            f"{row.get('host', '?'):<28s} {state:<12s} "
            f"{row.get('picks', 0):>8d} {ewma_s}"
        )
    return "\n".join(lines)


def render_slo(payload: dict) -> str:
    """ASCII rendering of a /debug/slo payload: one row per (view, model,
    window), burn rate front and center."""
    if not payload.get("enabled", False):
        return "SLO engine disabled on this tier (KDLT_SLO=0 / --no-slo)"
    target = payload.get("target")
    lines = [
        f"SLO target {target:.4g} (tier {payload.get('tier', '?')}; "
        f"burn 1.0 = sustainable, >1 = eating error budget)"
    ]
    header = (
        f"{'view':<10s} {'model':<24s} {'win':<4s} {'requests':>8s} "
        f"{'goodput':>8s} {'burn':>8s} {'shed%':>7s} {'err%':>7s}"
    )
    lines.append(header)
    for view in ("gateway", "merged"):
        models = payload.get(view) or {}
        for model in sorted(models):
            for window, row in models[model].items():
                counted = row.get("total", 0) - row.get("client", 0)
                lines.append(
                    f"{view:<10s} {model:<24s} {window:<4s} {counted:>8d} "
                    f"{row.get('goodput_ratio', 0.0):>8.4f} "
                    f"{row.get('burn_rate', 0.0):>8.2f} "
                    f"{row.get('shed_ratio', 0.0) * 100:>6.2f}% "
                    f"{row.get('error_ratio', 0.0) * 100:>6.2f}%"
                )
    return "\n".join(lines)


def generate_stream(
    gateway_url: str,
    prompt: str,
    max_new_tokens: int = 16,
    model: str | None = None,
    deadline_ms: float | None = None,
    priority: str | None = None,
    timeout: float = 120.0,
    stats: dict | None = None,
):
    """POST /generate and yield each SSE event dict AS IT ARRIVES.

    One dict a token (index, token id, text); the terminal event carries
    ``done: true`` and the server-measured TTFT/TPOT of the generation.
    ``model`` routes to a non-default decode model (``/generate/<model>``);
    ``deadline_ms`` and ``priority`` propagate as for /predict (a deadline
    that expires mid-stream ends it with finish_reason "deadline").
    Closing the generator early closes the connection, which cancels the
    generation down to its decode slot.  ``timeout`` bounds each read.

    No retries: a generation is not idempotent the way a predict is, so
    the retry decision belongs to the caller.
    """
    from kubernetes_deep_learning_tpu_torch.serving.admission import DEADLINE_HEADER
    from kubernetes_deep_learning_tpu_torch.serving.tracing import REQUEST_ID_HEADER

    if stats is None:
        stats = {}
    headers = {"Content-Type": "application/json"}
    if deadline_ms is not None:
        headers[DEADLINE_HEADER] = f"{float(deadline_ms):.1f}"
    if priority is not None:
        headers[protocol.PRIORITY_HEADER] = priority
    url = f"{gateway_url}{'/generate' if model is None else f'/generate/{model}'}"
    parts = urllib.parse.urlsplit(url)
    conn_cls = (http.client.HTTPSConnection if parts.scheme == "https"
                else http.client.HTTPConnection)
    conn = conn_cls(parts.hostname, parts.port, timeout=timeout)
    try:
        body = json.dumps({"prompt": prompt, "max_new_tokens": max_new_tokens}).encode()
        conn.request("POST", parts.path, body=body, headers=headers)
        r = conn.getresponse()
        stats["request_id"] = r.headers.get(REQUEST_ID_HEADER, "")
        if r.status >= 400:
            raise HTTPError(r.status, r.read(), url)
        buf = b""
        while chunk := r.read1(65536):
            buf += chunk
            # Incremental SSE framing: complete ``data: ...\n\n`` frames
            # yield at once; a partial tail waits for its next chunk.
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                frame = frame.strip()
                if not frame.startswith(b"data:"):
                    continue
                try:
                    yield json.loads(frame[len(b"data:"):].strip())
                except ValueError:
                    continue
    finally:
        conn.close()


def _fmt_ms(value) -> str:
    return f"{value:>8.2f}" if isinstance(value, (int, float)) else f"{'-':>8s}"


def render_decode_slo(payload: dict) -> str:
    """ASCII rendering of the fleet's per-token decode view: one row per
    replica carrying /debug/slo's ``decode`` section (TTFT/TPOT window
    percentiles against the lane's budgets, slot and KV-page occupancy).
    Takes the gateway's merged payload (rows keyed by replica host) or one
    model server's own /debug/slo."""
    replicas = payload.get("replicas")
    if not isinstance(replicas, dict):
        replicas = {"local": payload}
    rows = [
        (host, body["decode"])
        for host, body in sorted(replicas.items())
        if isinstance(body, dict) and isinstance(body.get("decode"), dict)
    ]
    if not rows:
        return ("no decode lane on any replica "
                "(start model servers with --decode / KDLT_DECODE=1)")
    lines = [
        "decode lane (per-token SLOs; ms; window = recent generations):",
        f"{'replica':<22s} {'model':<14s} {'gens':>5s} {'ttft50':>8s} "
        f"{'ttft99':>8s} {'tpot50':>8s} {'tpot99':>8s} {'slots':>7s} "
        f"{'pages':>9s} {'queue':>5s}",
    ]
    for host, dec in rows:
        w = dec.get("window") or {}
        ttft = w.get("ttft_ms") or {}
        tpot = w.get("tpot_ms") or {}
        occ = dec.get("occupancy") or {}
        lines.append(
            f"{host:<22s} {dec.get('model', '?'):<14s} "
            f"{int(w.get('generations', 0)):>5d} "
            f"{_fmt_ms(ttft.get('p50'))} {_fmt_ms(ttft.get('p99'))} "
            f"{_fmt_ms(tpot.get('p50'))} {_fmt_ms(tpot.get('p99'))} "
            f"{occ.get('active_slots', 0):>3d}/{occ.get('max_slots', 0):<3d} "
            f"{occ.get('pages_in_use', 0):>4d}/{occ.get('pages_total', 0):<4d} "
            f"{int(occ.get('queue_depth', 0)):>5d}"
        )
        budgets = dec.get("budgets_ms") or {}
        if budgets:
            reasons = ", ".join(f"{k}={v}" for k, v in
                                sorted((dec.get("finish_reasons") or {}).items()))
            lines.append(
                f"{'':<22s} # budgets: ttft <= {budgets.get('ttft', 0):g} ms, "
                f"tpot <= {budgets.get('tpot', 0):g} ms; finish reasons: " + (reasons or "-"))
    return "\n".join(lines)


def predict_images(
    server_url: str, model: str, images: np.ndarray, timeout: float = 30.0
) -> tuple[np.ndarray, list[str]]:
    """Send a uint8 image batch straight to the model server (no gateway)."""
    r = request("POST", f"{server_url}/v1/models/{model}:predict",
                protocol.encode_predict_request(images),
                {"Content-Type": protocol.MSGPACK_CONTENT_TYPE}, timeout)
    r.raise_for_status()
    return protocol.decode_predict_response(r.content, r.headers.get("Content-Type", ""))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="gateway smoke test (test.py equivalent; the "
                                "PyTorch port's)")
    p.add_argument("--gateway", default="http://localhost:9696")
    p.add_argument("--image-url", default=DEFAULT_IMAGE_URL)
    p.add_argument(
        "--model", default=None,
        help="route to this served model (/predict/<model> + X-Kdlt-Model "
        "header); default: the gateway's default model, bare /predict",
    )
    p.add_argument(
        "--deadline-ms", type=float, default=None,
        help="end-to-end deadline budget propagated via X-Request-Deadline-Ms",
    )
    p.add_argument(
        "--retries", type=int, default=2,
        help="bounded retries on 503 shed responses (honors Retry-After)",
    )
    p.add_argument(
        "--priority", default=None, choices=list(protocol.PRIORITY_CLASSES),
        help="the request's priority class (X-Kdlt-Priority header); default: interactive",
    )
    p.add_argument(
        "--cache-bust", action="store_true",
        help="salt the gateway's content-addressed response cache with a "
        "random X-Kdlt-Cache-Bust header so this request deliberately "
        "bypasses cached answers (load-test opt-out; identical salts "
        "would still coalesce)",
    )
    p.add_argument(
        "--stats", action="store_true",
        help="after the prediction, print a per-request stats table (the "
        "gateway's cache disposition and the retry counters), one "
        "row per upstream replica from /debug/pool (state, picks, "
        "latency EWMA), and the fleet bucket-shape audit from "
        "/debug/profile?audit=buckets (padding waste, FLOPs/img)",
    )
    p.add_argument(
        "--trace", action="store_true",
        help="after the prediction, fetch /debug/trace/<rid> from the "
        "gateway (which merges the model tier's spans in) and render the "
        "request's cross-tier span waterfall",
    )
    p.add_argument(
        "--slo", action="store_true",
        help="INSTEAD of predicting: fetch the gateway's /debug/slo (its "
        "client-observed view merged with every model-tier replica's) and "
        "render per-model goodput + 5m/1h burn rates, plus the per-token "
        "decode view (TTFT/TPOT percentiles) for replicas running the "
        "generative lane",
    )
    p.add_argument(
        "--stream", default=None, metavar="PROMPT",
        help="INSTEAD of predicting: stream a generation for PROMPT from the "
        "gateway's /generate route, printing each token as it arrives plus the "
        "server-measured TTFT/TPOT from the done event; --model routes to a "
        "non-default decode model",
    )
    p.add_argument(
        "--max-new-tokens", type=int, default=16,
        help="generation length cap for --stream (the server also stops at EOS "
        "or the propagated deadline)",
    )
    args = p.parse_args(argv)
    if args.slo:
        payload = fetch_slo(args.gateway)
        print(render_slo(payload))
        print(render_decode_slo(payload))
        return 0
    if args.stream is not None:
        return _stream_main(args)
    stats: dict = {}
    scores = predict_url(
        args.gateway, args.image_url,
        retries=args.retries, deadline_ms=args.deadline_ms, stats=stats,
        model=args.model,
        cache_bust=uuid.uuid4().hex if args.cache_bust else None,
        priority=args.priority,
    )
    print(json.dumps(scores, indent=2))
    if args.stats:
        # One row per accounting dimension; "cache" is the gateway's
        # disposition header (hit = served without admission/upstream/
        # device work, coalesced = rode another request's flight, empty =
        # cache disabled on the gateway).
        rows = [
            ("cache", stats.get("cache") or "-"),
            ("retried_shed", str(stats.get("retried_shed", 0))),
            ("retried_connect", str(stats.get("retried_connect", 0))),
            ("request_id", stats.get("request_id") or "-"),
        ]
        print(f"{'stat':<16s} value", file=sys.stderr)
        for name, value in rows:
            print(f"{name:<16s} {value}", file=sys.stderr)
        # Per-replica rows from /debug/pool: picks + latency EWMA, so an
        # operator can watch a scale event rebalance traffic.
        try:
            print(render_pool(fetch_pool(args.gateway)), file=sys.stderr)
        except Exception as e:  # noqa: BLE001 - diagnostics only
            print(f"# pool fetch failed: {e}", file=sys.stderr)
        # Per-bucket rows from /debug/profile?audit=buckets: padding waste
        # and FLOPs/img per bucket graph, fleet-wide -- whether the bucket
        # ladder fits the traffic shape.
        try:
            print(render_bucket_audit(fetch_bucket_audit(args.gateway)),
                  file=sys.stderr)
        except Exception as e:  # noqa: BLE001 - diagnostics only
            print(f"# bucket audit fetch failed: {e}", file=sys.stderr)
        # The /debug/ index footer: what else the gateway can tell you
        # (incidents, traces, SLO) without memorizing routes.
        try:
            print(render_debug_index(fetch_debug_index(args.gateway)),
                  file=sys.stderr)
        except Exception as e:  # noqa: BLE001 - diagnostics only
            print(f"# debug index fetch failed: {e}", file=sys.stderr)
    if args.trace:
        from kubernetes_deep_learning_tpu_torch.utils.trace import render_waterfall

        rid = stats.get("request_id", "")
        if not rid:
            print("# no X-Request-Id on the response; cannot fetch the trace",
                  file=sys.stderr)
        else:
            try:
                spans = fetch_trace(args.gateway, rid)
            except Exception as e:  # noqa: BLE001 - diagnostics only
                print(f"# trace fetch failed: {e}", file=sys.stderr)
            else:
                print(render_waterfall(spans), file=sys.stderr)
    if stats.get("retried_shed") or stats.get("retried_connect"):
        # Distinct labels: shed retries mean overload (the tier said wait),
        # connect retries mean instability (a replica dropped the request).
        print(
            f"# retried: {stats['retried_shed']} shed (503/Retry-After), "
            f"{stats['retried_connect']} connect/reset",
            file=sys.stderr,
        )
    return 0


def _stream_main(args) -> int:
    """--stream: the tokens as they arrive on stdout, the done event's
    numbers on stderr; 1 when the stream ended without a done event or
    past its deadline."""
    stats: dict = {}
    done = None
    for ev in generate_stream(args.gateway, args.stream, max_new_tokens=args.max_new_tokens,
                              model=args.model, deadline_ms=args.deadline_ms,
                              priority=args.priority, stats=stats):
        if ev.get("done"):
            done = ev
            continue
        sys.stdout.write(ev.get("text", ""))
        sys.stdout.flush()
    print()
    if done is None:
        print("# stream ended without a done event (connection lost mid-generation)",
              file=sys.stderr)
        return 1
    tpot = done.get("tpot_ms")
    print(f"# {done.get('tokens', 0)} tokens, ttft {done.get('ttft_ms', 0):.1f} ms, "
          f"tpot {tpot if tpot is not None else float('nan'):.2f} ms, "
          f"finish={done.get('finish_reason', '?')}, "
          f"request_id={stats.get('request_id') or '-'}", file=sys.stderr)
    if args.stats:
        # The fleet's per-token SLO posture right after this stream.
        try:
            print(render_decode_slo(fetch_slo(args.gateway)), file=sys.stderr)
        except Exception as e:  # noqa: BLE001 - diagnostics only
            print(f"# decode slo fetch failed: {e}", file=sys.stderr)
    return 0 if done.get("finish_reason") != "deadline" else 1


if __name__ == "__main__":
    sys.exit(main())
