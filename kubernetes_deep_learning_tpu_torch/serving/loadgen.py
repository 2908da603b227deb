"""HTTP load generator for the model server's tensor wire: closed or open loop.

Closed loop (``--clients``/``--requests``)::

    python -m kubernetes_deep_learning_tpu_torch.serving.loadgen \\
        --url http://127.0.0.1:8500/v1/models/clothing-model:predict \\
        --images images.npy --clients 32 --requests 25 --out result.npz

Each of ``clients`` threads holds one kept-alive connection and sends
``requests`` one-image msgpack ``:predict`` calls back to back; request j
of client c carries image ``c * requests + j`` of the uint8 (N, H, W, C)
array in ``images``, so every request has its own image.  ``--out``
receives an ``.npz`` with the logits of every reply (row k for image k),
each request's latency in ms, its HTTP status, and the wall time from the
first request to the last reply.  ``--images-per-request M`` sends M
images a request instead (request k carries images ``k * M`` to
``k * M + M - 1``), and its logits row holds M rows.  ``--duration S``
(or ``--stop-file F``) instead keeps each client sending until S seconds
have passed (or F exists), up to ``requests`` each, request k carrying
image ``k % N``; the ``.npz`` then also holds each request's image, its
send and reply time (``time.time()``) and the reply's
``X-Kdlt-Artifact-Hash``, and status 0 marks a request never sent.

Open loop (``--rate``), with the semantics of the JAX bench's overload
A/B::

    python -m kubernetes_deep_learning_tpu_torch.serving.loadgen --url URL \\
        --images images.npy --rate 1700 --duration 8 --deadline-ms 600 \\
        --processes 4 --connections 128 --out result.npz

Request k is scheduled at ``k / rate`` seconds after the start, for
``duration`` seconds, whatever the replies do; it carries image
``k % N`` and an ``X-Request-Deadline-Ms`` header, and its latency is
measured from its SCHEDULED send time, so a backlog (at the server or in
the client's connections) counts against it as a real caller would feel
it.  With ``--images-per-request M`` request k carries the M images of
group ``k % (N // M)`` (``image`` is the group's first image).  Separate
runs (one a model, say) share one schedule through ``--start-at`` (a
``time.time()``).  ``connections`` kept-alive connections a process take the requests
in schedule order; ``--processes`` runs that many processes (each takes
every P-th request) when one cannot offer the rate.  A request not sent
by ``grace`` seconds after the window, or not answered within ``timeout``
seconds, counts as unsent (status 0) or lost (-1).  The ``.npz`` holds per
request its image, scheduled and actual send time, latency, status, shed
reason (the JSON error body's ``shed_reason``, or "overloaded"/"error"),
``Retry-After`` and logits; ``summarize`` turns it into the offered rate
achieved, goodput (completions inside their deadline per second), p50
and p99 of the in-deadline completions and the replies by status and
shed reason, which ``main`` prints as one JSON line.

Through a gateway (``--image-urls``, closed loop)::

    python -m kubernetes_deep_learning_tpu_torch.serving.loadgen \
        --url http://127.0.0.1:9696/predict --image-urls urls.txt \
        --clients 16 --requests 24 --out result.npz

Request k POSTs the reference's ``{"url": ...}`` JSON with line
``k % N`` of ``urls.txt``; its reply's ``{label: score}`` values fill row k
of ``logits``, and ``cache`` holds its ``X-Kdlt-Cache`` disposition.

Run it as a process of its own, so that it does not share the server's
interpreter lock.  Imports numpy and the standard library only.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
from typing import Sequence

import numpy as np

from kubernetes_deep_learning_tpu_torch.serving import protocol


def _logits_array(logits: list, per_request: int) -> np.ndarray:
    """The replies' logits as one float32 array, NaN where a request got
    none: (n, classes), or (n, per_request, classes)."""
    width = max((row.shape[-1] for row in logits if row is not None), default=0)
    shape = (len(logits), width) if per_request == 1 else (len(logits), per_request, width)
    out = np.full(shape, np.nan, np.float32)
    for k, row in enumerate(logits):
        if row is not None:
            out[k] = row
    return out


def run(url: str, images: np.ndarray, clients: int, requests: int,
        per_request: int = 1, duration_s: float | None = None,
        stop_file: str | None = None) -> dict:
    """Drive the load; returns logits (N, classes) -- (N, per_request,
    classes) with more than one image a request --, lat_ms (N,), status (N,)
    and wall_s for the N = clients * requests requests, request k carrying
    images ``k * per_request`` onwards.  With ``duration_s`` or
    ``stop_file`` (one image a request) each client stops early once the
    time is up or the file exists, request k carries image ``k % len(images)``,
    and the result adds image, sent_at, done_at and artifact_hash."""
    parts = urllib.parse.urlsplit(url)
    n = clients * requests
    m = per_request
    timed = duration_s is not None or stop_file is not None
    if timed and m != 1:
        raise ValueError("a timed closed loop sends one image a request")
    if not timed and len(images) < n * m:
        raise ValueError(f"{clients} x {requests} requests of {m} need {n * m} images, "
                         f"got {len(images)}")
    headers = {"Content-Type": protocol.MSGPACK_CONTENT_TYPE}
    logits: list = [None] * n
    lat_ms = np.zeros(n)
    status = np.zeros(n, np.int32)
    sent_at = np.full(n, np.nan)
    done_at = np.full(n, np.nan)
    artifact = np.full(n, "", dtype="U64")
    image = np.arange(n) % len(images) if timed else np.arange(n)
    start = threading.Barrier(clients + 1)
    errors: list[BaseException] = []
    end_at = [float("inf")]

    def over() -> bool:
        return time.time() > end_at[0] or (stop_file is not None and os.path.exists(stop_file))

    def client(c: int) -> None:
        ks = range(c * requests, (c + 1) * requests)
        bodies = ({} if timed else
                  {k: protocol.encode_predict_request(images[k * m : (k + 1) * m]) for k in ks})
        conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=300)
        try:
            conn.connect()
            start.wait()
            for k in ks:
                if timed and over():
                    break
                body = (protocol.encode_predict_request(images[image[k] : image[k] + 1])
                        if timed else bodies[k])
                sent_at[k] = time.time()
                t0 = time.perf_counter()
                conn.request("POST", parts.path, body, headers)
                resp = conn.getresponse()
                reply = resp.read()
                lat_ms[k] = (time.perf_counter() - t0) * 1e3
                done_at[k] = time.time()
                status[k] = resp.status
                artifact[k] = resp.getheader(protocol.ARTIFACT_HASH_HEADER, "")
                if resp.status == 200:
                    rows = protocol.decode_predict_response(
                        reply, resp.getheader("Content-Type", ""))[0]
                    logits[k] = rows[0] if m == 1 else rows
        except BaseException as e:  # noqa: BLE001 - reported by run()
            errors.append(e)
            start.abort()
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    try:
        start.wait()
    except threading.BrokenBarrierError:
        pass
    if duration_s is not None:
        end_at[0] = time.time() + duration_s
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} load client(s) failed") from errors[0]
    out = dict(logits=_logits_array(logits, m), lat_ms=lat_ms, status=status, wall_s=wall_s)
    if timed:
        out.update(image=image, sent_at=sent_at, done_at=done_at, artifact_hash=artifact)
    return out


def run_urls(url: str, image_urls: Sequence[str], clients: int, requests: int) -> dict:
    """The closed loop through a gateway's ``/predict``: logits (N, classes)
    from each reply's scores, lat_ms, status, cache (the ``X-Kdlt-Cache``
    disposition) and wall_s for the N = clients * requests requests,
    request k asking for ``image_urls[k % len(image_urls)]``."""
    parts = urllib.parse.urlsplit(url)
    n = clients * requests
    logits: list = [None] * n
    lat_ms = np.zeros(n)
    status = np.zeros(n, np.int32)
    cache = np.full(n, "", dtype="U16")
    start = threading.Barrier(clients + 1)
    errors: list[BaseException] = []

    def client(c: int) -> None:
        conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=300)
        try:
            conn.connect()
            start.wait()
            for k in range(c * requests, (c + 1) * requests):
                body = json.dumps({"url": image_urls[k % len(image_urls)]}).encode()
                t0 = time.perf_counter()
                conn.request("POST", parts.path, body,
                             {"Content-Type": protocol.JSON_CONTENT_TYPE})
                resp = conn.getresponse()
                reply = resp.read()
                lat_ms[k] = (time.perf_counter() - t0) * 1e3
                status[k] = resp.status
                cache[k] = resp.getheader(protocol.CACHE_STATUS_HEADER, "")
                if resp.status == 200:
                    logits[k] = np.asarray(list(json.loads(reply).values()), np.float32)
        except BaseException as e:  # noqa: BLE001 - reported by run_urls()
            errors.append(e)
            start.abort()
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    try:
        start.wait()
    except threading.BrokenBarrierError:
        pass
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} load client(s) failed") from errors[0]
    return dict(logits=_logits_array(logits, 1), lat_ms=lat_ms, status=status, cache=cache,
                wall_s=wall_s)


DEADLINE_HEADER = "X-Request-Deadline-Ms"  # serving.admission's, spelled here


def _reply_reason(status: int, body: bytes) -> tuple[str, bool]:
    """(shed reason, whether an error body is JSON ``{"error": ...}``)."""
    if status == 200:
        return "", True
    try:
        obj = json.loads(body)
    except ValueError:
        return "error", False
    if not isinstance(obj, dict) or "error" not in obj:
        return "error", False
    return obj.get("shed_reason") or ("overloaded" if status == 503 else "error"), True


def run_open(url: str, images: np.ndarray, rate: float, duration_s: float,
             deadline_ms: float, connections: int = 64, part: tuple[int, int] = (0, 1),
             start_at: float | None = None, grace_s: float | None = None,
             timeout_s: float | None = None, per_request: int = 1) -> dict:
    """Open-loop load: request k at ``start + k / rate`` for ``duration_s``,
    of which this process sends those with ``k % parts == index``
    (``part = (index, parts)``), each carrying ``per_request`` images.
    ``start_at`` is a ``time.time()`` shared by every part (default: half a
    second from now).  Returns per-request arrays (see the module's
    docstring) and the run's settings."""
    index, parts = part
    parts_ = urllib.parse.urlsplit(url)
    n_all = int(duration_s * rate)
    ks = np.arange(index, n_all, parts)
    n = len(ks)
    deadline_s = deadline_ms / 1e3
    grace_s = max(2.0, 4 * deadline_s) if grace_s is None else grace_s
    timeout_s = max(2.0, 4 * deadline_s) if timeout_s is None else timeout_s
    headers = {"Content-Type": protocol.MSGPACK_CONTENT_TYPE,
               DEADLINE_HEADER: f"{deadline_ms:.1f}"}
    m = per_request
    groups = len(images) // m
    if not groups:
        raise ValueError(f"requests of {m} images need {m} images, got {len(images)}")
    bodies = [protocol.encode_predict_request(images[g * m : (g + 1) * m])
              for g in range(groups)]
    group = ks % groups
    image = group * m
    sched = ks / rate
    sent = np.full(n, np.nan)
    lat_ms = np.full(n, np.nan)
    status = np.zeros(n, np.int32)
    reason = np.full(n, "", dtype="U24")
    retry_after = np.full(n, np.nan)
    json_body = np.zeros(n, bool)
    logits: list = [None] * n
    start_at = time.time() + 0.5 if start_at is None else start_at
    t_base = time.monotonic() + (start_at - time.time())
    end_by = t_base + duration_s + grace_s
    lock = threading.Lock()
    nxt = [0]

    def worker() -> None:
        conn = None
        while True:
            with lock:
                j = nxt[0]
                nxt[0] += 1
            if j >= n:
                break
            at = t_base + sched[j]
            delay = at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            t_send = time.monotonic()
            if t_send > end_by:
                continue  # never sent: status stays 0
            sent[j] = t_send - t_base
            try:
                if conn is None:
                    conn = http.client.HTTPConnection(parts_.hostname, parts_.port,
                                                      timeout=timeout_s)
                conn.request("POST", parts_.path, bodies[group[j]], headers)
                resp = conn.getresponse()
                reply = resp.read()
            except (OSError, http.client.HTTPException):
                status[j], reason[j] = -1, "lost"
                lat_ms[j] = (time.monotonic() - at) * 1e3
                if conn is not None:
                    conn.close()
                conn = None
                continue
            lat_ms[j] = (time.monotonic() - at) * 1e3  # from the SCHEDULED send
            status[j] = resp.status
            reason[j], json_body[j] = _reply_reason(resp.status, reply)
            hint = resp.getheader("Retry-After")
            if hint is not None:
                retry_after[j] = float(hint)
            if resp.status == 200:
                rows = protocol.decode_predict_response(
                    reply, resp.getheader("Content-Type", ""))[0]
                logits[j] = rows[0] if m == 1 else rows
            if resp.getheader("Connection", "").lower() == "close":
                conn.close()
                conn = None
        if conn is not None:
            conn.close()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(connections)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return dict(k=ks, image=image, sched_s=sched, sent_s=sent, lat_ms=lat_ms, status=status,
                reason=reason, retry_after_s=retry_after, json_body=json_body,
                logits=_logits_array(logits, m),
                rate=np.float64(rate), duration_s=np.float64(duration_s),
                deadline_ms=np.float64(deadline_ms))


def merge(results: Sequence[dict]) -> dict:
    """The parts of one open-loop run, in request order (a part that got no
    logits back has zero-width logits: widened with NaN)."""
    width = max(r["logits"].shape[-1] for r in results)
    results = [{**r, "logits": np.pad(
        r["logits"], [(0, 0)] * (r["logits"].ndim - 1) + [(0, width - r["logits"].shape[-1])],
        constant_values=np.nan)} for r in results]
    order = np.argsort(np.concatenate([r["k"] for r in results]))
    out = {key: np.concatenate([r[key] for r in results])[order]
           for key in results[0] if np.ndim(results[0][key])}
    out.update({key: results[0][key] for key in results[0] if not np.ndim(results[0][key])})
    return out


def summarize(res: dict) -> dict:
    """An open-loop run's end-to-end numbers: the offered rate achieved
    (requests sent over the time from the schedule's start to one schedule
    step past the last send: the target rate when every send is on time),
    goodput (200s within their deadline per second of the window),
    p50/p99 of those in-deadline completions, and the replies by status
    and by shed reason."""
    status, lat = res["status"], res["lat_ms"]
    sent = status != 0
    window = float(np.nanmax(res["sent_s"])) + 1.0 / float(res["rate"]) if sent.any() else 0.0
    ok = lat[status == 200]
    good = ok[ok <= float(res["deadline_ms"])]
    pct = lambda q: float(np.percentile(good, q)) if len(good) else None  # noqa: E731
    codes, counts = np.unique(status, return_counts=True)
    reasons, rcounts = np.unique(res["reason"][sent & (status != 200)], return_counts=True)
    return {
        "rate_target": float(res["rate"]), "duration_s": float(res["duration_s"]),
        "deadline_ms": float(res["deadline_ms"]), "requests": int(len(status)),
        "sent": int(sent.sum()),
        "offered_rps": float(sent.sum() / window) if sent.any() else 0.0,
        "goodput_rps": len(good) / float(res["duration_s"]),
        "completed_200": int(len(ok)), "in_deadline": int(len(good)),
        "p50_in_deadline_ms": pct(50), "p99_in_deadline_ms": pct(99),
        "status": {str(int(c)): int(m) for c, m in zip(codes, counts)},
        "shed": {str(r): int(m) for r, m in zip(reasons, rcounts)},
    }


def _run_parts(args) -> dict:
    """``--processes`` > 1: one child process a part, on one schedule."""
    start_at = (time.time() + 1.0 + 0.2 * args.processes if args.start_at is None
                else args.start_at)
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"part{i}.npz") for i in range(args.processes)]
        base = [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.loadgen",
                "--url", args.url, "--images", args.images, "--rate", str(args.rate),
                "--duration", str(args.duration), "--deadline-ms", str(args.deadline_ms),
                "--connections", str(args.connections), "--start-at", repr(start_at),
                "--images-per-request", str(args.images_per_request)]
        procs = [subprocess.Popen([*base, "--part", f"{i}/{args.processes}", "--out", out])
                 for i, out in enumerate(outs)]
        codes = [p.wait() for p in procs]
        if any(codes):
            raise RuntimeError(f"load processes exited {codes}")
        parts = []
        for out in outs:
            with np.load(out) as z:
                parts.append({k: z[k] for k in z.files})
    return merge(parts)


def main(argv: Sequence[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=":predict load over kept-alive connections, "
                                "closed loop (--clients) or open loop (--rate)")
    p.add_argument("--url", required=True,
                   help="the model's :predict URL (a gateway's /predict with --image-urls)")
    p.add_argument("--images", default=None, help=".npy of uint8 (N, H, W, C) images")
    p.add_argument("--image-urls", default=None,
                   help="closed loop through a gateway: a file of image URLs, one a line")
    p.add_argument("--clients", type=int, default=32)
    p.add_argument("--requests", type=int, default=25, help="requests per client")
    p.add_argument("--rate", type=float, default=0.0,
                   help="open loop: requests per second (0 = closed loop)")
    p.add_argument("--duration", type=float, default=None,
                   help="seconds of sends (open loop: default 8; closed loop: until the "
                   "clients' requests are sent)")
    p.add_argument("--stop-file", default=None,
                   help="closed loop: stop sending once this file exists")
    p.add_argument("--deadline-ms", type=float, default=600.0,
                   help="open loop: every request's X-Request-Deadline-Ms")
    p.add_argument("--connections", type=int, default=64,
                   help="open loop: kept-alive connections a process")
    p.add_argument("--processes", type=int, default=1, help="open loop: load processes")
    p.add_argument("--images-per-request", type=int, default=1,
                   help="images each request carries")
    p.add_argument("--part", default="0/1", help=argparse.SUPPRESS)
    p.add_argument("--start-at", type=float, default=None,
                   help="open loop: the schedule's start as a time.time() (runs of several "
                   "models share one); default about a second from now")
    p.add_argument("--out", required=True, help=".npz to write the results to")
    args = p.parse_args(argv)
    if args.image_urls is not None:
        with open(args.image_urls) as f:
            urls = [line.strip() for line in f if line.strip()]
        np.savez(args.out, **run_urls(args.url, urls, args.clients, args.requests))
        return
    if args.images is None:
        p.error("--images is required without --image-urls")
    if args.rate <= 0:
        images = np.load(args.images, mmap_mode="r")
        np.savez(args.out, **run(args.url, images, args.clients, args.requests,
                                 args.images_per_request, args.duration, args.stop_file))
        return
    if args.duration is None:
        args.duration = 8.0
    if args.processes > 1:
        res = _run_parts(args)
    else:
        index, parts = (int(x) for x in args.part.split("/"))
        res = run_open(args.url, np.load(args.images), args.rate, args.duration,
                       args.deadline_ms, args.connections, (index, parts), args.start_at,
                       per_request=args.images_per_request)
    np.savez(args.out, **res)
    if args.part == "0/1":  # the whole run, not one part of it
        print(json.dumps(summarize(res)), flush=True)


if __name__ == "__main__":
    main()
