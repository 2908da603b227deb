#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Uses torch, numpy and the standard library only (no JAX, no msgpack, no
flax).  Phases, each of which fails the run (non-zero exit) on error:

1. card: prints ``nvidia-smi``'s name and power limit;
2. build: compiles the port's CUDA kernels from this checkout's sources;
3. kernels: runs each kernel at the main path's shapes (batch 16 of the
   299-px clothing model) against its plain PyTorch version (relative max
   error < 2e-2: bf16 rounding, summed in another order) and times kernel,
   plain version and a library yardstick (depthwise ``conv2d`` + ``matmul``
   + affine: cuDNN/cuBLAS, used nowhere in the port) with CUDA events;
4. server: writes a ``clothing-model`` artifact with random weights from
   ``--seed`` (flax layout, the port's own msgpack writer), starts the
   port's model server on an ephemeral port with buckets (1, 4, 16), warms
   it and sends JSON ``:predict`` requests of 1, 3 and 16 images.  It checks
   the shapes, that the logits are finite, that they agree with the same
   server's exact float32 graph, and that the requests went through the
   kernels (8 middle-block and 2 exit-chain launches per forward);
5. timing: img/s and p50 per bucket through the engine;
6. with ``--profile``: a ``torch.profiler`` trace of a few bucket-16
   forwards, printed as device time by kernel and the device's busy share.

The last two lines are a JSON ``kernels`` record and the device record.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

# H100 SXM dense peaks (NVIDIA data sheet) for the bound: bf16 tensor cores,
# f32 on the CUDA cores (the depthwise taps), HBM3.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 2e-2  # relative max error, kernel vs its plain version
MODEL_TOL = 5e-2   # relative max error, bf16 fused path vs exact f32 graph
BUCKETS = (1, 4, 16)
REQUESTS = (1, 3, 16)
ITERS = 20  # timed repetitions per kernel and per bucket
SOURCE = "kubernetes_deep_learning_tpu_torch/ops/csrc/fused_sepconv.cu"


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _stage_work(m: int, c_in: int, c_out: int) -> tuple[int, int, int]:
    """(bf16 GEMM FLOPs, f32 depthwise FLOPs, weight bytes) of one stage."""
    return 2 * m * c_in * c_out, 2 * 9 * m * c_in, 9 * c_in * 4 + c_in * c_out * 2 + 2 * c_out * 4


def _bound(m: int, widths: list[tuple[int, int]]) -> tuple[float, str]:
    """Least time (ms) for the call: each input read once, output written once."""
    gemm = dw = wbytes = 0
    for c_in, c_out in widths:
        g, d, b = _stage_work(m, c_in, c_out)
        gemm, dw, wbytes = gemm + g, dw + d, wbytes + b
    act = m * widths[0][0] * 2 + m * widths[-1][1] * 2
    t_bytes = (act + wbytes) / PEAK_BYTES
    t_ops = gemm / PEAK_BF16 + dw / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def _library_stage(y, s):
    """cuDNN depthwise + cuBLAS GEMM + affine: the yardstick, not the port."""
    if s["pre_relu"]:
        y = torch.relu(y)
    c = y.shape[-1]
    w = s["dw"].permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16)
    d = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2), w, None, 1, 1, 1, c).permute(0, 2, 3, 1)
    z = torch.matmul(d, s["pw"]).float() * s["scale"] + s["shift"]
    if s["post_relu"]:
        z = torch.relu(z)
    return z.to(torch.bfloat16)


def _kernel_phase(params, iters: int, gen: torch.Generator) -> list[dict]:
    from kubernetes_deep_learning_tpu_torch import weights
    from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv as ops

    dev = "cuda"
    p = {k: v.to(dev) for k, v in params.items()}
    batch = 16
    blocks = [
        dict(name="fused_sepconv_block", replaces="kubernetes_deep_learning_tpu/ops/fused_sepconv.py:192",
             calls=[((batch, 19, 19, 728), weights.middle_block_weights(p, "block5"))]),
        dict(name="fused_sepconv_chain", replaces="kubernetes_deep_learning_tpu/ops/fused_sepconv.py:307",
             calls=[
                 ((batch, 19, 19, 728), [weights.sepconv_stage_weights(
                     p, f"block13_sepconv{j}", f"block13_sepconv{j}_bn", True, False) for j in (1, 2)]),
                 ((batch, 10, 10, 1024), [weights.sepconv_stage_weights(
                     p, f"block14_sepconv{j}", f"block14_sepconv{j}_bn", False, True) for j in (1, 2)]),
             ]),
    ]
    records = []
    for k in blocks:
        rec = dict(name=k["name"], route="cuda", source=SOURCE, replaces=k["replaces"],
                   max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   library_ms=0.0, tol_rel=KERNEL_TOL, shapes=[])
        bound_t = {"bytes": 0.0, "operations": 0.0}
        for shape, w in k["calls"]:
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            if k["name"] == "fused_sepconv_block":
                stages = [dict(dw=w[0][i], pw=w[1][i], scale=w[2][i], shift=w[3][i],
                               pre_relu=True, post_relu=False) for i in range(3)]
                kernel = lambda x=x, w=w: ops.fused_sepconv_block(x, *w)  # noqa: E731
                plain = lambda x=x, w=w: ops.sepconv_block_reference(x, *w)  # noqa: E731

                def library(x=x, stages=stages):
                    y = x
                    for s in stages:
                        y = _library_stage(y, s)
                    return x + y
            else:
                stages = w
                kernel = lambda x=x, w=w: ops.fused_sepconv_chain(x, w)  # noqa: E731
                plain = lambda x=x, w=w: ops.sepconv_chain_reference(x, w)  # noqa: E731

                def library(x=x, stages=stages):
                    y = x
                    for s in stages:
                        y = _library_stage(y, s)
                    return y
            got = kernel().float()
            torch.cuda.synchronize()
            want = plain().float()
            if not torch.isfinite(got).all():
                _fail(f"{k['name']} at {shape}: non-finite output")
            err = (got - want).abs().max().item()
            rel = err / (want.abs().max().item() + 1e-6)
            if rel > KERNEL_TOL:
                _fail(f"{k['name']} at {shape}: relative error {rel:.3e} > {KERNEL_TOL}")
            m = shape[0] * shape[1] * shape[2]
            widths = [(s["pw"].shape[0], s["pw"].shape[1]) for s in stages]
            b_ms, b_by = _bound(m, widths)
            bound_t[b_by] += b_ms
            t = dict(shape=list(shape), widths=widths, max_abs_err=err, max_rel_err=rel,
                     ms=_time_ms(kernel, iters), plain_ms=_time_ms(plain, max(3, iters // 4)),
                     library_ms=_time_ms(library, iters), bound_ms=b_ms, bound_by=b_by)
            print("kernel-check", k["name"], json.dumps(t), flush=True)
            rec["shapes"].append(list(shape))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["max_rel_err"] = max(rec["max_rel_err"], rel)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                rec[key] += t[key]
        rec["bound_by"] = max(bound_t, key=bound_t.get)
        rec["per"] = ("one call" if len(k["calls"]) == 1
                      else "the calls of one forward, summed")
        records.append(rec)
    return records


def _post_json(url: str, images: np.ndarray) -> tuple[dict, float]:
    body = json.dumps({"instances": images.tolist()}).encode()
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        out = json.loads(r.read())
    return out, (time.perf_counter() - t0) * 1e3


def _profile(engine, imgs: np.ndarray, steps: int = 5) -> None:
    """Device time by kernel over ``steps`` engine predicts of ``imgs``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.predict(imgs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (the CPU ops' totals would count each kernel twice).
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print("profile:", json.dumps({
        "batch": len(imgs), "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": device_ms / steps,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
    }), flush=True)
    for e in rows[:12]:
        print("profile-kernel:", json.dumps({
            "name": e.key[:90], "calls_per_step": e.count / steps,
            "device_ms_per_step": e.self_device_time_total / 1e3 / steps,
            "share": e.self_device_time_total / 1e3 / device_ms if device_ms else None,
        }), flush=True)


def _server_phase(spec, variables, seed: int, iters: int,
                  profile: bool) -> tuple[dict, list[dict]]:
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv as ops
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    if spec.preprocessing != "tf":
        _fail(f"the exact-path check normalizes in 'tf' mode, not {spec.preprocessing!r}")
    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory() as root:
        art.save_artifact(art.version_dir(root, spec.name, 1), spec, variables,
                          {"compute_dtype": "bfloat16"})
        server = ModelServer(root, port=0, buckets=BUCKETS, device="cuda")
        try:
            server.start()
            engine = server.engines[spec.name]
            if not engine.fast:
                _fail("the server did not engage the fused fast path")
            t0 = time.perf_counter()
            server.warmup()
            warm_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"
            batches = [rng.integers(0, 256, (n, *spec.input_shape), np.uint8) for n in REQUESTS]

            # --- the main path: HTTP -> engine -> fused forward -> kernels ---
            ops.reset_launch_counts()
            replies = [_post_json(url, imgs) for imgs in batches]
            launches = ops.launch_counts()

            want = {"fused_sepconv_block": 8 * len(REQUESTS), "fused_sepconv_chain": 2 * len(REQUESTS)}
            if launches != want:
                _fail(f"kernel launches {launches} != {want} for {len(REQUESTS)} forwards")
            worst = 0.0
            for imgs, (out, _ms) in zip(batches, replies):
                preds = out["predictions"]
                got = np.asarray([[p[label] for label in spec.labels] for p in preds], np.float32)
                if got.shape != (len(imgs), spec.num_classes):
                    _fail(f"logits shape {got.shape} for a batch of {len(imgs)}")
                if not np.isfinite(got).all():
                    _fail("non-finite logits")
                exact = engine.predict((imgs.astype(np.float32) / 127.5 - 1.0).astype(np.float32))
                rel = float(np.abs(got - exact).max() / (np.abs(exact).max() + 1e-6))
                worst = max(worst, rel)
            if worst > MODEL_TOL:
                _fail(f"fast path vs exact f32 graph: relative error {worst:.3e} > {MODEL_TOL}")

            buckets = []
            for b in BUCKETS:
                imgs = rng.integers(0, 256, (b, *spec.input_shape), np.uint8)
                for _ in range(2):
                    engine.predict(imgs)
                lat = []
                for _ in range(iters):
                    t0 = time.perf_counter()
                    engine.predict(imgs)  # ends in a device sync (event + copy)
                    lat.append((time.perf_counter() - t0) * 1e3)
                buckets.append(dict(bucket=b, p50_ms=float(np.median(lat)),
                                    img_per_s=b * len(lat) / (sum(lat) / 1e3)))
            if profile:
                _profile(engine, imgs)
        finally:
            server.shutdown()
    summary = dict(warmup_s=warm_s, launches=launches, fast_vs_exact_rel=worst,
                   tol_rel=MODEL_TOL,
                   request_ms={str(len(i)): ms for i, (_, ms) in zip(batches, replies)})
    return summary, buckets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace bucket-16 forwards with torch.profiler")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.ops import _build
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    variables = init_variables(CLOTHING_MODEL, seed=args.seed)
    kernels = _kernel_phase(from_jax_variables(variables), ITERS, gen)

    summary, buckets = _server_phase(CLOTHING_MODEL, variables, args.seed, ITERS,
                                     args.profile)
    for k in kernels:
        k["launches"] = summary["launches"][k["name"]]
    print("server:", json.dumps(summary), flush=True)
    for b in buckets:
        print("bucket:", json.dumps({**b, "card": smi}), flush=True)

    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
