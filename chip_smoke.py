#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Uses torch, numpy and the standard library only (no JAX, no msgpack, no
flax).  Phases, each of which fails the run (non-zero exit) on error:

1. card: prints ``nvidia-smi``'s name and power limit;
2. build: compiles the port's CUDA kernels (every ``ops/csrc/*.cu``, one
   nvcc each, in parallel) from this checkout's sources;
3. Xception kernels: K1 and K2 at the main path's shapes (batch 16 of the
   299-px clothing model) against their plain PyTorch versions (relative
   max error < 2e-2: bf16 rounding, summed in another order); times
   kernel, plain version and a library yardstick (depthwise ``conv2d`` +
   ``matmul`` + affine: cuDNN/cuBLAS, used nowhere in the port) with CUDA
   events;
4. Xception server: writes a ``clothing-model`` artifact with random
   weights from ``--seed`` (flax layout, the port's own msgpack writer),
   starts the port's model server with buckets (1, 4, 16), warms it and
   sends JSON ``:predict`` requests of 1, 3 and 16 images.  It checks the
   shapes, finite logits, agreement with the same server's exact float32
   graph, that the engine took the fused fast path, and that the requests
   went through the kernels (8 K1 and 2 K2 launches per forward); then
   img/s and p50 per bucket;
5. attention kernel: K3 at ViT-B/16-384's shape (16, 12, 576, 64) in bf16
   and in f32 (the exact graph's), and at small ragged, causal, fully
   masked (all 0) and other head-dim cases, against its plain version
   (relative max error < 2e-2 bf16, < 1e-4 f32); times kernel, plain
   version and ``scaled_dot_product_attention`` (the yardstick, used
   nowhere in the port) and prints the bound;
6. ViT server: a ``vit-b16-384`` artifact (ViT-B/16 at 384 px: 576 tokens,
   the flash route) served the same way over the msgpack wire.  ViT has no
   fused fast path (its kernel sits inside its attention); the requests
   must launch K3 12 times per forward, and the bf16 logits must agree
   with the exact f32 graph (relative < 5e-2); then img/s and p50;
7. routing: one predict of the registered ``vit-b16-imagenet`` (256 px,
   256 tokens) must take the einsum route: zero K3 launches;
8. with ``--profile``: a ``torch.profiler`` trace of a few bucket-16
   forwards of each model, printed as device time by kernel and the
   device's busy share.

The last two lines are a JSON ``kernels`` record and the device record.
"""

from __future__ import annotations

import argparse
import functools
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
# exp2 on the special-function units: 16 per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput); the rate is this times the SMs times the card's max SM clock.
SFU_EXP_PER_CLOCK_SM = 16
KERNEL_TOL = 2e-2  # relative max error, bf16 kernel vs its plain version
F32_KERNEL_TOL = 1e-4  # the same for the f32 attention kernel
MODEL_TOL = 5e-2   # relative max error, bf16 serving path vs exact f32 graph
BUCKETS = (1, 4, 16)
REQUESTS = (1, 3, 16)
ITERS = 20  # timed repetitions per kernel and per bucket
_CSRC = "kubernetes_deep_learning_tpu_torch/ops/csrc/"
SOURCES = {
    "fused_sepconv_block": _CSRC + "fused_sepconv.cu",
    "fused_sepconv_chain": _CSRC + "fused_sepconv.cu",
    "flash_attention": _CSRC + "flash_attention.cu",
}
# ViT-B/16 at its published fine-tuning resolution: 24 x 24 = 576 tokens.
VIT_384_KW = dict(name="vit-b16-384", family="vit-b16", input_shape=(384, 384, 3),
                  preprocessing="tf",
                  description="ViT-B/16 ImageNet classifier at 384 px (flash attention)")


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
        rec = dict(name=k["name"], route="cuda", source=SOURCES[k["name"]], replaces=k["replaces"],
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


def _rel(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / (want.float().abs().max().item() + 1e-6)


def _attention_bound(bh: int, sq: int, sk: int, d: int, elem: int, peak_flops: float,
                     exp_rate: float) -> tuple[float, str, dict]:
    """Least time (ms) for one non-causal call: q, k, v read once and o
    written once; QK^T and PV products; one exponential per score."""
    t = {"bytes": elem * bh * d * (2 * sq + 2 * sk) / PEAK_BYTES,
         "products": 4 * bh * sq * sk * d / peak_flops,
         "exp": bh * sq * sk / exp_rate}
    top = max(t, key=t.get)
    return t[top] * 1e3, ("bytes" if top == "bytes" else "operations"), {
        k: v * 1e3 for k, v in t.items()}


def _attention_phase(iters: int, gen: torch.Generator, exp_rate: float) -> dict:
    """K3 against its plain version; the record for the ``kernels`` line."""
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (B, H, Sq, Sk, D), dtype, flash_attention keywords, timed
        ((16, 12, 576, 576, 64), bf16, {}, True),   # the main path: ViT-B/16-384, batch 16
        ((16, 12, 576, 576, 64), f32, {}, True),    # the exact f32 graph's calls
        ((2, 3, 200, 330, 64), bf16, dict(causal=True, k_offset=-64), False),
        ((2, 3, 128, 128, 64), bf16, dict(causal=True, k_offset=10_000), False),  # all 0
        ((2, 3, 128, 128, 64), f32, dict(causal=True, k_offset=10_000), False),
        ((1, 4, 300, 300, 32), bf16, dict(causal=True), False),
        ((1, 2, 257, 257, 128), bf16, dict(kv_len=200), False),
        ((1, 2, 250, 190, 64), f32, dict(causal=True, k_offset=-30), False),
    ]
    rec = dict(name="flash_attention", route="cuda", source=SOURCES["flash_attention"],
               replaces="kubernetes_deep_learning_tpu/ops/attention.py:342",
               max_abs_err=0.0, max_rel_err=0.0, tol_rel=KERNEL_TOL, f32_tol_rel=F32_KERNEL_TOL,
               per="one call at (16, 12, 576, 64) bf16; errors: max over the checked cases")
    for (b, h, sq, sk, d), dtype, kw, timed in cases:
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        kernel = functools.partial(attn.flash_attention, q, k, v, **kw)
        plain = functools.partial(attn.flash_attention_reference, q, k, v, **kw)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        tol = KERNEL_TOL if dtype == bf16 else F32_KERNEL_TOL
        shape = dict(q=[b, h, sq, d], sk=sk, dtype=str(dtype).removeprefix("torch."), **kw)
        if not torch.isfinite(got).all():
            _fail(f"flash_attention {shape}: non-finite output")
        if kw.get("k_offset") == 10_000:
            if got.any() or want.any():
                _fail(f"flash_attention {shape}: a fully masked row is not exactly 0")
            err, rel = 0.0, 0.0
        else:
            err, rel = _rel(got, want)
            if rel > tol:
                _fail(f"flash_attention {shape}: relative error {rel:.3e} > {tol}")
        t = dict(shape, max_abs_err=err, max_rel_err=rel, tol_rel=tol)
        if timed:
            peak = PEAK_BF16 if dtype == bf16 else PEAK_F32
            b_ms, b_by, terms = _attention_bound(b * h, sq, sk, d, q.element_size(), peak,
                                                 exp_rate)
            t.update(ms=_time_ms(kernel, iters), plain_ms=_time_ms(plain, max(3, iters // 4)),
                     library_ms=_time_ms(lambda q=q, k=k, v=v: sdpa(q, k, v), iters),
                     bound_ms=b_ms, bound_by=b_by, bound_terms_ms=terms)
            if dtype == bf16:
                rec.update({key: t[key] for key in
                            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        print("kernel-check flash_attention", json.dumps(t), flush=True)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["max_rel_err"] = max(rec["max_rel_err"], rel)
    return rec


def _post(url: str, images: np.ndarray, wire: str) -> tuple[np.ndarray, list, float]:
    """One ``:predict``; returns (logits, labels, ms)."""
    from kubernetes_deep_learning_tpu_torch.serving import protocol

    if wire == "json":
        body = json.dumps({"instances": images.tolist()}).encode()
        ctype = protocol.JSON_CONTENT_TYPE
    else:
        body, ctype = protocol.encode_predict_request(images), protocol.MSGPACK_CONTENT_TYPE
    req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        reply, reply_type = r.read(), r.headers.get("Content-Type", "")
    ms = (time.perf_counter() - t0) * 1e3
    logits, labels = protocol.decode_predict_response(reply, reply_type)
    return logits, labels, ms


def _profile(model: str, engine, imgs: np.ndarray, steps: int = 5) -> None:
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
        "model": model, "batch": len(imgs), "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": device_ms / steps,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
    }), flush=True)
    for e in rows[:12]:
        print("profile-kernel:", json.dumps({
            "model": model, "name": e.key[:90], "calls_per_step": e.count / steps,
            "device_ms_per_step": e.self_device_time_total / 1e3 / steps,
            "share": e.self_device_time_total / 1e3 / device_ms if device_ms else None,
        }), flush=True)


def _server_phase(spec, variables, seed: int, iters: int, profile: bool, *, counter,
                  per_forward: dict, fast: bool, wire: str) -> tuple[dict, list[dict]]:
    """Serve ``spec`` through the port's model server on the card; the
    requests must launch ``per_forward`` kernels (``counter``'s counts) per
    forward, and the engine must (not) take the fused fast path."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
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
            if engine.fast != fast:
                _fail(f"{spec.name}: engine.fast is {engine.fast}, expected {fast}")
            t0 = time.perf_counter()
            server.warmup()
            warm_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"
            batches = [rng.integers(0, 256, (n, *spec.input_shape), np.uint8) for n in REQUESTS]

            # --- the main path: HTTP -> engine -> forward -> kernels ---
            counter.reset_launch_counts()
            replies = [_post(url, imgs, wire) for imgs in batches]
            launches = counter.launch_counts()

            want = {name: n * len(REQUESTS) for name, n in per_forward.items()}
            if launches != want:
                _fail(f"{spec.name}: kernel launches {launches} != {want} "
                      f"for {len(REQUESTS)} forwards")
            worst = 0.0
            for imgs, (got, labels, _ms) in zip(batches, replies):
                if got.shape != (len(imgs), spec.num_classes) or labels != list(spec.labels):
                    _fail(f"{spec.name}: logits shape {got.shape} for a batch of {len(imgs)}")
                if not np.isfinite(got).all():
                    _fail(f"{spec.name}: non-finite logits")
                exact = engine.predict((imgs.astype(np.float32) / 127.5 - 1.0).astype(np.float32))
                rel = float(np.abs(got - exact).max() / (np.abs(exact).max() + 1e-6))
                worst = max(worst, rel)
            if worst > MODEL_TOL:
                _fail(f"{spec.name}: bf16 path vs exact f32 graph: relative error "
                      f"{worst:.3e} > {MODEL_TOL}")

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
                buckets.append(dict(model=spec.name, bucket=b, p50_ms=float(np.median(lat)),
                                    img_per_s=b * len(lat) / (sum(lat) / 1e3)))
            if profile:
                _profile(spec.name, engine, imgs)
        finally:
            server.shutdown()
    summary = dict(model=spec.name, wire=wire, fast=fast, warmup_s=warm_s, launches=launches,
                   bf16_vs_exact_rel=worst, tol_rel=MODEL_TOL,
                   request_ms={str(len(i)): ms for i, (_, _, ms) in zip(batches, replies)})
    return summary, buckets


def _routing_phase(seed: int) -> dict:
    """The registered 256-px ViT-B/16 (256 tokens) on the card: the einsum
    route, so no K3 launch."""
    from kubernetes_deep_learning_tpu_torch.export.artifact import ModelArtifact
    from kubernetes_deep_learning_tpu_torch.modelspec import VIT_B16_IMAGENET as spec
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.models.vit import VIT_CONFIGS
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    engine = InferenceEngine(
        ModelArtifact(spec, init_variables(spec, seed=seed), {"compute_dtype": "bfloat16"}),
        buckets=(1,), device="cuda")
    engine.warmup()
    imgs = np.random.default_rng(seed + 2).integers(0, 256, (1, *spec.input_shape), np.uint8)
    attn.reset_launch_counts()
    logits = engine.predict(imgs)
    launches = attn.launch_counts()["flash_attention"]
    if logits.shape != (1, spec.num_classes) or not np.isfinite(logits).all():
        _fail(f"{spec.name}: bad logits {logits.shape}")
    if launches != 0:
        _fail(f"{spec.name} (256 tokens) launched flash attention {launches} times, expected 0")
    patch = VIT_CONFIGS[spec.family].patch
    return dict(model=spec.name, tokens=(spec.input_shape[0] // patch) ** 2,
                flash_attention_launches=launches)


def _card(query: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace bucket-16 forwards with torch.profiler")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from kubernetes_deep_learning_tpu_torch.modelspec import (
        CLOTHING_MODEL,
        VIT_B16_IMAGENET,
        ModelSpec,
    )
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.models.vit import VIT_CONFIGS
    from kubernetes_deep_learning_tpu_torch.ops import _build
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn
    from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

    smi = _card("name,power.limit")
    print(f"card: {smi}", flush=True)
    sm_mhz = float(_card("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_rate = SFU_EXP_PER_CLOCK_SM * sms * sm_mhz * 1e6
    print("card:", json.dumps({"sms": sms, "max_sm_clock_mhz": sm_mhz,
                               "sfu_exp_per_s": exp_rate}), flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    entry = ""
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill stores" in line:
            print(f"build: {entry}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    # --- Xception clothing-model: K1, K2 and its server ---
    variables = init_variables(CLOTHING_MODEL, seed=args.seed)
    kernels = _kernel_phase(from_jax_variables(variables), ITERS, gen)
    summary, buckets = _server_phase(
        CLOTHING_MODEL, variables, args.seed, ITERS, args.profile, counter=fused_sepconv,
        per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2}, fast=True, wire="json")
    del variables
    for k in kernels:
        k["launches"] = summary["launches"][k["name"]]
    print("server:", json.dumps(summary), flush=True)
    for b in buckets:
        print("bucket:", json.dumps({**b, "card": smi}), flush=True)

    # --- ViT-B/16 at 384 px: K3 and its server; the 256-px routing check ---
    k3 = _attention_phase(ITERS, gen, exp_rate)
    vit = ModelSpec(labels=VIT_B16_IMAGENET.labels, **VIT_384_KW)
    summary, buckets = _server_phase(
        vit, init_variables(vit, seed=args.seed), args.seed, ITERS, args.profile,
        counter=attn, per_forward={"flash_attention": VIT_CONFIGS[vit.family].depth}, fast=False,
        wire="msgpack")
    k3["launches"] = summary["launches"]["flash_attention"]
    kernels.append(k3)
    print("server:", json.dumps(summary), flush=True)
    for b in buckets:
        print("bucket:", json.dumps({**b, "card": smi}), flush=True)
    print("routing:", json.dumps(_routing_phase(args.seed)), flush=True)

    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
