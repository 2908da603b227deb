#!/usr/bin/env python3
"""Where the entry-segment kernel's (K5's) time goes, on one NVIDIA GPU.

    python3 entry_ablation.py

Builds ``ops/csrc/fused_entry.cu`` as it is and ablations of it, each into
its own library with ``nvcc`` (in parallel):

- ``no_x_loads``: the im2col copies read nothing (zero fill only);
- ``no_dw``: both depthwise passes skip their taps (panels of zeros);
- ``no_wgmma``: every GEMM issues no wgmma (zero accumulators);
- ``no_pool_res``: no output row is pooled or stored and no residual is
  computed.

At Xception's entry geometry (149x149x32 -> 74x74x128) at batches 16 and 1
it times the kernel and each ablation by CUDA-graph replay, then the
kernel at every segment length R (output rows a work unit) beside the
launcher's own choice, and prints one JSON line per batch with the card's
name and power limit and the kernel's relative error against the plain
version.  The ablations compute wrong results by design; only their times
mean anything.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import sys
import tempfile

import numpy as np
import torch

ITERS = 20
BATCHES = (16, 1)
ROWS = (1, 2, 3, 4, 5, 7, 10, 13, 15, 19, 25, 37, 74)  # segment lengths timed at batch 16
_X_OK = ("            const bool ok =\n"
         "                (unsigned)(kb + dh) < (unsigned)p.H && (unsigned)(xc0 + dwc) < "
         "(unsigned)p.W;\n")
_DW_TAPS = "  for (int a = 0; a < 3; ++a) {\n"
_WGMMA = "  for (int ks = 0; ks < ksteps; ++ks)\n"
_EMIT = "        const bool emit = first && k > D0;"
_RESIDUAL = "        const bool residual = (k & 1) == 0 && k >= 2 * i0 && k < 2 * i1;"


def _variants(src: str) -> dict[str, str]:
    """name -> source."""
    for line in (_X_OK, _DW_TAPS, _WGMMA, _EMIT, _RESIDUAL):
        if src.count(line) != 1:
            raise SystemExit("entry_ablation: the kernel source no longer has the ablated lines")
    return {
        "kernel": src,
        "no_x_loads": src.replace(_X_OK, "            const bool ok = false;\n"),
        "no_dw": src.replace(_DW_TAPS, _DW_TAPS.replace("a < 3", "a < 0")),
        "no_wgmma": src.replace(_WGMMA, _WGMMA.replace("ks < ksteps", "ks < 0")),
        "no_pool_res": src.replace(_EMIT, "        const bool emit = false;").replace(
            _RESIDUAL, "        const bool residual = false;"),
    }


def _compile_variants(variants: dict[str, str], out_dir: str) -> dict[str, ctypes.CDLL]:
    from kubernetes_deep_learning_tpu_torch.ops import _build

    procs = {}
    for name, src in variants.items():
        # Beside the kernel's own sources, so that it finds hopper.cuh.
        cu = os.path.join(_build.CSRC_DIR, f".ablation_{os.getpid()}_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (cu, _build._start([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                                          cu]))
    try:
        _build._run([proc for _, proc in procs.values()])
    finally:
        for cu, _ in procs.values():
            os.remove(cu)
    libs = {}
    for name in variants:
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.kdlt_entry_block.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.kdlt_entry_block_rows.argtypes = [ctypes.c_int] * 3
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("entry_ablation: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from chip_smoke import _card, _graph_ms
    from kubernetes_deep_learning_tpu_torch.ops import _build
    from kubernetes_deep_learning_tpu_torch.ops import fused_entry as ops

    card = _card("name,power.limit")
    print(f"card: {card}", flush=True)
    with open(os.path.join(_build.CSRC_DIR, "fused_entry.cu")) as f:
        variants = _variants(f.read())
    rng = np.random.default_rng(0)

    def t(shape, std=1.0, dtype=torch.float32):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)).to(dtype).cuda()

    h, c_in, c_b, c_out, bf = 149, 32, 64, 128, torch.bfloat16
    w = dict(
        conv2=t((9 * c_in, c_b), (9 * c_in) ** -0.5, bf), conv2_s=t((c_b,), 0.1) + 1.0,
        conv2_b=t((c_b,), 0.1), res=t((c_b, c_out), c_b ** -0.5, bf),
        res_s=t((c_out,), 0.1) + 1.0, res_b=t((c_out,), 0.1), dw1=t((3, 3, c_b), 0.2),
        pw1=t((c_b, c_out), c_b ** -0.5, bf), bn1_s=t((c_out,), 0.1) + 1.0,
        bn1_b=t((c_out,), 0.1), dw2=t((3, 3, c_out), 0.2),
        pw2=t((c_out, c_out), c_out ** -0.5, bf), bn2_s=t((c_out,), 0.1) + 1.0,
        bn2_b=t((c_out,), 0.1))
    with tempfile.TemporaryDirectory() as out_dir:
        libs = _compile_variants(variants, out_dir)
        for b in BATCHES:
            x = t((b, h, h, c_in), 1.0, bf)
            out = torch.empty((b, (h - 1) // 2, (h - 1) // 2, c_out), dtype=bf, device="cuda")

            def call(lib, rows=0):
                code = lib.kdlt_entry_block(
                    x.data_ptr(), *(w[k].data_ptr() for k in ops.WEIGHT_KEYS), out.data_ptr(),
                    b, h, h, c_in, c_b, c_out, rows, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise SystemExit(f"entry_ablation: launch failed ({code})")

            kernel = libs["kernel"]
            row = dict(batch=b, shape=[h, h, c_in, c_b, c_out], card=card,
                       rows=kernel.kdlt_entry_block_rows(b, h, h))
            call(kernel)
            want = ops.entry_block_reference(x, w).float()
            row["max_rel_err"] = ((out.float() - want).abs().max() / want.abs().max()).item()
            for name, lib in libs.items():
                row[f"{name}_ms"] = _graph_ms(functools.partial(call, lib), ITERS)
            if b == BATCHES[0]:
                row["by_rows_ms"] = {r: _graph_ms(functools.partial(call, kernel, r), ITERS)
                                     for r in ROWS}
            print("ablation", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
