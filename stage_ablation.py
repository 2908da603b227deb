#!/usr/bin/env python3
"""Where the stage kernel's time goes, on one NVIDIA GPU.

    python3 stage_ablation.py

Builds ``ops/csrc/fused_sepconv.cu`` as it is and two ablations of it, each
into its own library with ``nvcc`` (in parallel): ``no_panel`` skips the
depthwise arithmetic (the input is still staged; the panel holds whatever
shared memory held) and ``no_mma`` skips the wgmma instructions (the weights
still stream).  Times one launch of each at every shape of
``chip_smoke.STAGE_SHAPES`` with CUDA events and prints one JSON line per
shape: milliseconds per variant, and the whole kernel's relative error
against the plain version.  The ablations compute wrong results by design;
only their times mean anything.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import sys
import tempfile

import torch

ITERS = 20
_MMA = re.compile(r"wgmma_m64n64k16\(acc, smem_desc\([^;]*\);", re.S)
_PANEL = ("if (tid < CONSUMERS) panel_chunk(p, xs + buf * xs_bytes, panel + kc * CHUNK_BYTES, "
          "kc, ph, pw);")


def _variants(src: str) -> dict[str, str]:
    if not _MMA.search(src) or _PANEL not in src:
        raise SystemExit("stage_ablation: the kernel source no longer has the ablated lines")
    return {"kernel": src, "no_panel": src.replace(_PANEL, ""), "no_mma": _MMA.sub(";", src)}


def _compile_variants(variants: dict[str, str], out_dir: str) -> dict[str, ctypes.CDLL]:
    from kubernetes_deep_learning_tpu_torch.ops import _build

    procs = {}
    for name, src in variants.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = _build._start([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, cu])
    _build._run(list(procs.values()))
    libs = {}
    for name in variants:
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.kdlt_sepconv_stage.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_ablation: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from chip_smoke import STAGE_SHAPES, _card
    from kubernetes_deep_learning_tpu_torch.ops import _build
    from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv as ops

    card = _card("name,power.limit")
    print(f"card: {card}", flush=True)
    with open(os.path.join(_build.CSRC_DIR, "fused_sepconv.cu")) as f:
        variants = _variants(f.read())
    with tempfile.TemporaryDirectory() as out_dir:
        libs = _compile_variants(variants, out_dir)
        torch.backends.cuda.matmul.allow_tf32 = False
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        for name, b, hw, c_in, c_out, pre, post in STAGE_SHAPES:
            def t(shape, std=1.0):
                return torch.randn(shape, generator=gen, device="cuda") * std

            x = t((b, hw, hw, c_in)).to(torch.bfloat16)
            dw, pw = t((3, 3, c_in), 0.2), (t((c_in, c_out), c_in ** -0.5)).to(torch.bfloat16)
            scale, shift = t((c_out,), 0.1) + 1.0, t((c_out,), 0.1)
            out = torch.empty((b, hw, hw, c_out), dtype=torch.bfloat16, device="cuda")
            row = dict(name=name, m=b * hw * hw, c_in=c_in, c_out=c_out, card=card)
            for variant, lib in libs.items():
                def call(lib=lib):
                    code = lib.kdlt_sepconv_stage(
                        x.data_ptr(), dw.data_ptr(), pw.data_ptr(), scale.data_ptr(),
                        shift.data_ptr(), None, out.data_ptr(), b, hw, hw, c_in, c_out,
                        int(pre), int(post), stream)
                    if code:
                        raise SystemExit(f"stage_ablation: {variant} launch failed ({code})")

                for _ in range(3):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(ITERS):
                    call()
                end.record()
                torch.cuda.synchronize()
                row[f"{variant}_ms"] = start.elapsed_time(end) / ITERS
                if variant == "kernel":
                    want = ops.stage_reference(x, dw, pw, scale, shift, pre, post).float()
                    err = (out.float() - want).abs().max() / want.abs().max()
                    row["max_rel_err"] = err.item()
            print("ablation", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
