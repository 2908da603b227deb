#!/usr/bin/env python3
"""The JAX package's two host-path A/Bs, run on the port's copies with its stub engine.

    python3 host_ab.py [--arm overload|multimodel|both]

Neither needs a card: the port's ``runtime.stub.StubEngine`` stands in for
the device with a sleep of known length, so each A/B measures a serving
policy of the port's own (its admission controller, its scheduler, its
model server) in isolation from the card's host-bound regime.  The
workloads, their defaults and the pass criteria are the JAX package's
(``bench.py::bench_overload_ab`` and ``bench_multimodel_ab``):

- ``overload``: a real ``ModelServer`` over a stub whose predict sleeps
  100 ms a batch (buckets 1-2: 20 img/s of capacity) takes single-image
  msgpack requests at 2x that, open loop, for 8 s, each with a 600 ms
  ``X-Request-Deadline-Ms``; once with admission on, once off.  It passes
  when goodput (in-deadline completions a second) with admission is at
  least goodput without, and the in-deadline p99 with admission is lower;
- ``multimodel``: two stub models on one ``UnifiedScheduler`` and its one
  dispatcher, a heavy one (120 ms a batch, buckets 1-4, 2x overloaded,
  2000 ms deadlines) and a light one (5 ms a batch, 40 rps, 300 ms
  deadlines), for 6 s under ``weighted_deadline`` and then ``fifo``.  It
  passes when the worst model's in-deadline goodput under
  ``weighted_deadline`` is at least 1.2x that under ``fifo`` and the heavy
  model keeps at least 0.8x of its ``fifo`` goodput.

Latency is measured from each request's scheduled send (open loop).  The
HTTP client is ``serving.upstream.HttpClient`` (``http.client``; the card's
machine has no ``requests``).  Prints one JSON line per A/B, then a summary
line ``{"overload": {"ok": ...}, "multimodel": {"ok": ...}}``; exits 0 when
every A/B run passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def overload_ab(duration_s=8.0, device_ms=100.0, deadline_ms=600.0, rate_x=2.0,
                buckets=(1, 2), max_delay_ms=2.0) -> tuple[dict, bool]:
    """JAX's ``bench_overload_ab`` on the port's server and admission."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.runtime.stub import StubEngine
    from kubernetes_deep_learning_tpu_torch.serving import protocol
    from kubernetes_deep_learning_tpu_torch.serving.admission import DEADLINE_HEADER
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer
    from kubernetes_deep_learning_tpu_torch.serving.upstream import HttpClient

    spec = ModelSpec(name="overload-stub", family="xception", input_shape=(32, 32, 3),
                     labels=("a", "b", "c"))
    buckets = tuple(sorted(buckets))
    capacity_rps = buckets[-1] / (device_ms / 1e3)
    offered_rps = rate_x * capacity_rps
    deadline_s = deadline_ms / 1e3
    n_requests = int(duration_s * offered_rps)
    img = np.random.default_rng(0).integers(0, 256, size=(1, *spec.input_shape), dtype=np.uint8)
    body = protocol.encode_predict_request(img)
    _log(f"overload A/B: stub capacity {capacity_rps:.0f} img/s, offered {offered_rps:.0f} "
         f"req/s x {duration_s}s = {n_requests} requests, deadline {deadline_ms:.0f}ms")

    def run_arm(admission_on: bool) -> dict:
        root = tempfile.mkdtemp(prefix="kdlt-overload-")
        art.save_artifact(art.version_dir(root, spec.name, 1), spec, {"params": {}}, {})
        server = ModelServer(
            root, port=0, buckets=buckets, max_delay_ms=max_delay_ms, host="127.0.0.1",
            device="cpu", admission=admission_on,
            engine_factory=lambda a, **kw: StubEngine(a, device_ms_per_batch=device_ms, **kw))
        server.warmup()
        server.start()
        url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"
        headers = {"Content-Type": protocol.MSGPACK_CONTENT_TYPE,
                   DEADLINE_HEADER: f"{deadline_ms:.1f}"}
        client = HttpClient(pool_size=1024)
        results: list = [None] * n_requests

        def fire(i: int, at: float) -> None:
            delay = at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            try:
                status = client.post(url, data=body, headers=headers, timeout=30.0).status_code
            except Exception:  # noqa: BLE001 - a failed request is a data point
                status = -1
            results[i] = (time.monotonic() - at, status)  # from the SCHEDULED send

        t_base = time.monotonic() + 0.25
        threads = [threading.Thread(target=fire, args=(i, t_base + i / offered_rps), daemon=True)
                   for i in range(n_requests)]
        for t in threads:
            t.start()
        end_by = t_base + duration_s + max(2.0, 4 * deadline_s)
        for t in threads:
            t.join(timeout=max(0.0, end_by - time.monotonic()))
        slo_view = None
        try:
            slo = client.get(f"http://127.0.0.1:{server.port}/debug/slo", timeout=5.0).json()
            slo_view = (slo.get("models") or {}).get(spec.name)
        except Exception:  # noqa: BLE001 - diagnostics only
            pass
        server.shutdown()
        for t in threads:
            t.join(timeout=10.0)
        client.close()
        done = [r for r in results if r is not None]
        ok_lat = sorted(lat for lat, status in done if status == 200)
        in_deadline = [lat for lat in ok_lat if lat <= deadline_s]

        def pct(xs, q):
            return round(float(np.percentile(xs, q)) * 1e3, 1) if xs else float("inf")

        arm = {
            "offered_rps": round(offered_rps, 1),
            "completed_200": len(ok_lat),
            "shed_5xx": sum(1 for _, status in done if status in (503, 504)),
            "unresolved": n_requests - len(done),
            "goodput_rps": round(len(in_deadline) / duration_s, 2),
            "p99_in_deadline_ms": pct(in_deadline, 99),
            "p50_in_deadline_ms": pct(in_deadline, 50),
            "p99_all_completions_ms": pct(ok_lat, 99),
            "slo_view": slo_view,
        }
        _log(f"  admission={'on ' if admission_on else 'off'}: goodput {arm['goodput_rps']}/s, "
             f"{arm['completed_200']} x 200, {arm['shed_5xx']} shed, in-deadline p99 "
             f"{arm['p99_in_deadline_ms']} ms")
        return arm

    arm_on = run_arm(True)
    arm_off = run_arm(False)
    ok = (arm_on["goodput_rps"] >= arm_off["goodput_rps"]
          and arm_on["p99_in_deadline_ms"] < arm_off["p99_in_deadline_ms"])
    ratio = arm_on["goodput_rps"] / max(arm_off["goodput_rps"], 1e-9)
    return {"ab": "overload", "ok": ok, "goodput_ratio": round(ratio, 3),
            "capacity_rps": round(capacity_rps, 1), "deadline_ms": deadline_ms,
            "rate_x": rate_x, "arms": {"admission": arm_on, "baseline": arm_off}}, ok


def multimodel_ab(duration_s=6.0, heavy_device_ms=120.0, light_device_ms=5.0,
                  heavy_deadline_ms=2000.0, light_deadline_ms=300.0, rate_x=2.0,
                  light_rps=40.0, buckets=(1, 2, 4)) -> tuple[dict, bool]:
    """JAX's ``bench_multimodel_ab`` on the port's scheduler."""
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.runtime.scheduler import UnifiedScheduler
    from kubernetes_deep_learning_tpu_torch.runtime.stub import StubEngine
    from kubernetes_deep_learning_tpu_torch.serving.admission import Deadline
    from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

    class _Artifact:
        def __init__(self, spec):
            self.spec = spec

    buckets = tuple(sorted(buckets))
    shape = (32, 32, 3)
    heavy = ModelSpec(name="mm-heavy", family="xception", input_shape=shape,
                      labels=("a", "b", "c"))
    light = ModelSpec(name="mm-light", family="xception", input_shape=shape, labels=("x", "y"))
    heavy_capacity = buckets[-1] / (heavy_device_ms / 1e3)
    plans = {heavy.name: (rate_x * heavy_capacity, heavy_deadline_ms, heavy_device_ms),
             light.name: (light_rps, light_deadline_ms, light_device_ms)}
    img = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    _log(f"multimodel A/B: heavy capacity {heavy_capacity:.0f} img/s, offered "
         f"{plans[heavy.name][0]:.0f} rps @ {heavy_deadline_ms:.0f}ms; light {light_rps:.0f} "
         f"rps @ {light_deadline_ms:.0f}ms; {duration_s}s per arm")

    def run_arm(policy: str) -> dict:
        engines = {s.name: StubEngine(_Artifact(s), buckets=buckets, async_device=True,
                                      device_ms_per_batch=plans[s.name][2])
                   for s in (heavy, light)}
        sched = UnifiedScheduler(registry=metrics_lib.Registry(), policy=policy, weights={})
        for name, engine in engines.items():
            sched.register(name, engine, max_delay_ms=2.0)
        results: dict[str, list] = {name: [] for name in plans}
        lock = threading.Lock()
        threads = []
        t_base = time.monotonic() + 0.25

        def fire(name: str, at: float, deadline_s: float) -> None:
            delay = at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            try:
                sched.submit(name, img, deadline=Deadline(deadline_s)).result(
                    timeout=deadline_s * 4 + 2.0)
                ok = True
            except Exception:  # noqa: BLE001 - a shed or a timeout is a data point
                ok = False
            with lock:
                results[name].append((time.monotonic() - at, ok))

        for name, (rps, deadline_ms, _dev) in plans.items():
            for i in range(int(duration_s * rps)):
                threads.append(threading.Thread(
                    target=fire, args=(name, t_base + i / rps, deadline_ms / 1e3), daemon=True))
        for t in threads:
            t.start()
        end_by = t_base + duration_s + max(2.0, 4 * heavy_deadline_ms / 1e3)
        for t in threads:
            t.join(timeout=max(0.0, end_by - time.monotonic()))
        sched.close(drain=False)
        for e in engines.values():
            e.close()
        arm: dict = {"policy": policy, "models": {}}
        worst = None
        for name, (rps, deadline_ms, _dev) in plans.items():
            offered = int(duration_s * rps)
            done = results[name]
            in_deadline = sum(1 for lat, ok in done if ok and lat <= deadline_ms / 1e3)
            frac = in_deadline / max(offered, 1)
            arm["models"][name] = {"offered": offered,
                                   "completed": sum(1 for _, ok in done if ok),
                                   "in_deadline": in_deadline, "goodput_frac": round(frac, 3),
                                   "goodput_rps": round(in_deadline / duration_s, 2)}
            worst = frac if worst is None else min(worst, frac)
        arm["worst_model_goodput_frac"] = round(worst or 0.0, 3)
        _log(f"  policy={policy:17s}: worst-model goodput {arm['worst_model_goodput_frac']:.3f} "
             + " ".join(f"{n}={m['goodput_frac']:.3f}" for n, m in arm["models"].items()))
        return arm

    weighted = run_arm("weighted_deadline")
    fifo = run_arm("fifo")
    ratio = weighted["worst_model_goodput_frac"] / max(fifo["worst_model_goodput_frac"], 1e-9)
    ok = (ratio >= 1.2 and weighted["models"][heavy.name]["goodput_frac"]
          >= 0.8 * fifo["models"][heavy.name]["goodput_frac"])
    return {"ab": "multimodel", "ok": ok, "worst_model_ratio": round(ratio, 3),
            "arms": {"weighted_deadline": weighted, "fifo": fifo}}, ok


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arm", choices=("overload", "multimodel", "both"), default="both")
    args = p.parse_args(argv)
    summary = {}
    if args.arm in ("overload", "both"):
        out, ok = overload_ab()
        print(json.dumps(out), flush=True)
        summary["overload"] = {"ok": ok, "goodput_ratio": out["goodput_ratio"]}
    if args.arm in ("multimodel", "both"):
        out, ok = multimodel_ab()
        print(json.dumps(out), flush=True)
        summary["multimodel"] = {"ok": ok, "worst_model_ratio": out["worst_model_ratio"]}
    summary["cores"] = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else None
    print(json.dumps(summary), flush=True)
    return 0 if all(v["ok"] for k, v in summary.items() if k != "cores") else 1


if __name__ == "__main__":
    sys.exit(main())
