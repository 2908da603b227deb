"""Closed-loop HTTP load generator for the model server's tensor wire.

    python -m kubernetes_deep_learning_tpu_torch.serving.loadgen \\
        --url http://127.0.0.1:8500/v1/models/clothing-model:predict \\
        --images images.npy --clients 32 --requests 25 --out result.npz

Each of ``clients`` threads holds one kept-alive connection and sends
``requests`` one-image msgpack ``:predict`` calls back to back; request j
of client c carries image ``c * requests + j`` of the uint8 (N, H, W, C)
array in ``images``, so every request has its own image.  Run it as a
process of its own, so that it does not share the server's interpreter
lock.  ``--out`` receives an ``.npz`` with the logits of every reply (row
k for image k), each request's latency in ms, its HTTP status, and the
wall time from the first request to the last reply.  Imports numpy and
the standard library only.
"""

from __future__ import annotations

import argparse
import http.client
import threading
import time
import urllib.parse
from typing import Sequence

import numpy as np

from kubernetes_deep_learning_tpu_torch.serving import protocol


def run(url: str, images: np.ndarray, clients: int, requests: int) -> dict:
    """Drive the load; returns logits (N, classes), lat_ms (N,), status (N,)
    and wall_s for the N = clients * requests first images."""
    parts = urllib.parse.urlsplit(url)
    n = clients * requests
    if len(images) < n:
        raise ValueError(f"{clients} x {requests} requests need {n} images, got {len(images)}")
    headers = {"Content-Type": protocol.MSGPACK_CONTENT_TYPE}
    logits: list = [None] * n
    lat_ms = np.zeros(n)
    status = np.zeros(n, np.int32)
    start = threading.Barrier(clients + 1)
    errors: list[BaseException] = []

    def client(c: int) -> None:
        ks = range(c * requests, (c + 1) * requests)
        bodies = [protocol.encode_predict_request(images[k : k + 1]) for k in ks]
        conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=300)
        try:
            conn.connect()
            start.wait()
            for k, body in zip(ks, bodies):
                t0 = time.perf_counter()
                conn.request("POST", parts.path, body, headers)
                resp = conn.getresponse()
                reply = resp.read()
                lat_ms[k] = (time.perf_counter() - t0) * 1e3
                status[k] = resp.status
                if resp.status == 200:
                    logits[k] = protocol.decode_predict_response(
                        reply, resp.getheader("Content-Type", ""))[0][0]
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
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} load client(s) failed") from errors[0]
    width = max((len(row) for row in logits if row is not None), default=0)
    out = np.full((n, width), np.nan, np.float32)
    for k, row in enumerate(logits):
        if row is not None:
            out[k] = row
    return dict(logits=out, lat_ms=lat_ms, status=status, wall_s=wall_s)


def main(argv: Sequence[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="closed-loop :predict load over kept-alive connections")
    p.add_argument("--url", required=True, help="the model's :predict URL")
    p.add_argument("--images", required=True, help=".npy of uint8 (N, H, W, C) images")
    p.add_argument("--clients", type=int, default=32)
    p.add_argument("--requests", type=int, default=25, help="requests per client")
    p.add_argument("--out", required=True, help=".npz to write the results to")
    args = p.parse_args(argv)
    images = np.load(args.images, mmap_mode="r")
    np.savez(args.out, **run(args.url, images, args.clients, args.requests))


if __name__ == "__main__":
    main()
