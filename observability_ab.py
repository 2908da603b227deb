#!/usr/bin/env python3
"""The observability layer's cost on one-image serving: parent against change, on one GPU.

    python3 observability_ab.py --parent DIR [--rounds 5] [--requests 100]

``DIR`` holds a checkout of a tree without the layer (for instance
``git archive <commit> | tar -x -C .scratch/parent``).  Three servers of
``clothing-model`` (299 px, buckets 1-32, depth 2, the scheduler's lane,
random weights from seed 0) run at once, each in a process of its own:
the parent's; this tree's; and this tree's with the layer switched off by
patching ("bare": no spans recorded, no per-reply accounting, no trace
headers, no device timing events, ``KDLT_MFU=0``).  In each round, in
alternating order, the load generator (``serving/loadgen.py``) drives
each server with 32 closed-loop clients of ``--requests`` one-image
msgpack requests.  Prints one JSON line per run (img/s, p50, p99), then
the medians and each round's ratio to the parent, then the card's name
and power limit.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

ARMS = (("parent", "full"), ("change", "full"), ("change", "bare"))
CLIENTS = 32
BUCKETS = (1, 2, 4, 8, 16, 32)


def _bare() -> None:
    """Switch this tree's observability layer off in this process."""
    os.environ["KDLT_MFU"] = "0"
    import torch

    from kubernetes_deep_learning_tpu_torch.ops import _counts
    from kubernetes_deep_learning_tpu_torch.runtime import engine as engine_lib
    from kubernetes_deep_learning_tpu_torch.runtime import scheduler as scheduler_lib
    from kubernetes_deep_learning_tpu_torch.serving import model_server
    from kubernetes_deep_learning_tpu_torch.utils import trace as trace_lib

    def replay(self, slot, n, staged=False):  # the replay without its timing event
        g = self._graph(self.bucket_for(n), staged)
        bucket = g.static_in.shape[0]
        slot.array[n:bucket] = 0
        g.static_in.copy_(slot.host[:bucket], non_blocking=True)
        slot.copied.record(torch.cuda.current_stream(self.device))
        g.graph.replay()
        _counts.credit(g.launches)
        return self._handle(g.static_out)

    submit = scheduler_lib.UnifiedScheduler.submit

    def untraced(self, model, image, deadline=None, trace=None, priority=None):
        return submit(self, model, image, deadline, None, priority)

    def finish(self):
        if self.ticket is not None:
            self.ticket.release()

    engine_lib.InferenceEngine._replay = replay
    scheduler_lib.UnifiedScheduler.submit = untraced
    trace_lib.Tracer.record = lambda self, *args, **kwargs: None
    trace_lib.Tracer.record_spans = lambda self, *args, **kwargs: None
    model_server._Exchange.finish = finish
    model_server._Exchange.reply_headers = lambda self: {}


def _serve(tree: str, variant: str, port_file: str) -> None:
    """Serve from ``tree`` until terminated; the port goes to ``port_file``."""
    sys.path.insert(0, os.path.abspath(tree))
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL
    from kubernetes_deep_learning_tpu_torch.ops import _build
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    _build.load()
    if variant == "bare":
        _bare()
    root = tempfile.mkdtemp()
    art.save_artifact(art.version_dir(root, CLOTHING_MODEL.name, 1), CLOTHING_MODEL,
                      init_variables(CLOTHING_MODEL, seed=0), {"compute_dtype": "bfloat16"})
    server = ModelServer(root, port=0, buckets=BUCKETS, device="cuda")
    server.start()
    server.warmup()
    with open(port_file + ".tmp", "w") as f:
        f.write(str(server.port))
    os.rename(port_file + ".tmp", port_file)
    while True:  # SIGTERM ends the process
        time.sleep(3600)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the tree without the layer")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--requests", type=int, default=100, help="requests per client and run")
    ap.add_argument("--serve", nargs=3, metavar=("TREE", "VARIANT", "PORT_FILE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.serve:
        _serve(*args.serve)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("observability_ab: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if not args.parent or not os.path.isdir(args.parent):
        ap.error("--parent must name a checkout")
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(args.parent), "change": here}
    tmp = tempfile.mkdtemp()
    procs, port_files = [], []
    for i, (tree, variant) in enumerate(ARMS):
        port_files.append(os.path.join(tmp, f"port{i}"))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--serve",
                                       trees[tree], variant, port_files[-1]]))
    rows = []
    try:
        deadline = time.time() + 900
        while not all(os.path.exists(p) for p in port_files):
            if time.time() > deadline or any(p.poll() is not None for p in procs):
                print("observability_ab: a server did not start", file=sys.stderr)
                return 1
            time.sleep(0.5)
        ports = [int(open(p).read()) for p in port_files]
        n = CLIENTS * args.requests
        images = os.path.join(tmp, "images.npy")
        np.save(images, np.random.default_rng(0).integers(0, 256, (n, 299, 299, 3), np.uint8))
        for rnd in range(args.rounds):
            order = range(len(ARMS)) if rnd % 2 == 0 else reversed(range(len(ARMS)))
            for i in order:
                out = os.path.join(tmp, "run.npz")
                subprocess.run(
                    [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.loadgen",
                     "--url", f"http://127.0.0.1:{ports[i]}/v1/models/clothing-model:predict",
                     "--images", images, "--clients", str(CLIENTS), "--requests",
                     str(args.requests), "--out", out], check=True, capture_output=True, cwd=here)
                with np.load(out) as z:
                    if (z["status"] != 200).any():
                        print(f"observability_ab: {ARMS[i]} answered "
                              f"{sorted(set(z['status'].tolist()))}", file=sys.stderr)
                        return 1
                    rows.append(dict(arm="/".join(ARMS[i]), round=rnd,
                                     img_per_s=n / float(z["wall_s"]),
                                     p50_ms=float(np.percentile(z["lat_ms"], 50)),
                                     p99_ms=float(np.percentile(z["lat_ms"], 99))))
                print(json.dumps(rows[-1]), flush=True)
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
    arms = ["/".join(a) for a in ARMS]
    medians = {a: {k: float(np.median([r[k] for r in rows if r["arm"] == a]))
                   for k in ("img_per_s", "p50_ms", "p99_ms")} for a in arms}
    ratios = {a: [round(next(r["img_per_s"] for r in rows if r["arm"] == a and r["round"] == k)
                        / next(r["img_per_s"] for r in rows if r["arm"] == arms[0]
                               and r["round"] == k), 3) for k in range(args.rounds)]
              for a in arms[1:]}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"medians": medians, "img_per_s_vs_parent_by_round": ratios, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
