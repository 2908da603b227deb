#!/usr/bin/env python3
"""Where the MBConv kernel's (K4's) time goes, on one NVIDIA GPU.

    python3 mbconv_ablation.py

Builds ``ops/csrc/fused_mbconv.cu`` as it is and ablations of it, each into
its own library with ``nvcc`` (in parallel):

- launch 1 (expand + depthwise): ``no_load`` starts no TMA load and waits
  for none (the GEMM reads whatever shared memory held); ``no_expand_silu``
  leaves the silu out of the expand epilogue; ``no_dw`` skips the depthwise
  taps; ``no_dw_silu`` leaves the silu out of the depthwise epilogue;
- launch 3 (projection): ``split1``, ``split2`` and ``split4`` force 1, 2
  or 4 warpgroups on a K split, where the kernel picks one by its model.

At every fused block shape of a bucket-16 EfficientNet-B3 forward (300 px)
it times each launch of the kernel alone by CUDA-graph replay, and each
ablation's own launch, and prints one JSON line per shape with the card's
name and power limit, and the whole kernel's relative error against the
plain version.  The ablations compute wrong results by design; only their
times mean anything.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile

import numpy as np
import torch

ITERS = 20
_LOAD_START = ("        mbar_expect_tx(bar, (two ? 3 : 2) * BOX_BYTES);\n"
               "        tma_load(dst + 2 * BOX_BYTES, &ew_map, c0, kc * 64, bar);\n"
               "        tma_load(dst, &x_map, kc * 64, pix0 + 2 * pair * 64, bar);\n"
               "        if (two) tma_load(dst + BOX_BYTES, &x_map, kc * 64, "
               "pix0 + (2 * pair + 1) * 64, bar);\n")
_LOAD_WAIT = "      mbar_wait(smem_u32(&full_bar[slot]), (i / p.stages) & 1);\n"
_EXPAND_SILU = ("              v = __floats2bfloat162_rn(silu(affine(acc[4 * j + 2 * h], "
                "ex_s[j].x, ex_b[j].x)),\n                                        "
                "silu(affine(acc[4 * j + 2 * h + 1], ex_s[j].y, ex_b[j].y)));")
_DW_TAPS = "    for (int i = 0; i < KS; ++i) {\n      const unsigned char* src"
_DW_SILU = ("        const __nv_bfloat162 out = __floats2bfloat162_rn(silu(affine(acc[o].x, sc.x, "
            "sh.x)),\n                                                         "
            "silu(affine(acc[o].y, sc.y, sh.y)));")
_SPLITS = "  for (int ks = 1, i = 0; ks <= std::min(PJ_STAGES, p.k_chunks); ks *= 2, ++i) {"
LAUNCHES = {"expand_dw": 1, "se": 2, "project": 4}  # the kernel's ``phases`` bits


def _variants(src: str) -> dict[str, tuple[str, str]]:
    """name -> (source, the launch whose time it changes)."""
    for line in (_LOAD_START, _LOAD_WAIT, _EXPAND_SILU, _DW_TAPS, _DW_SILU, _SPLITS):
        if line not in src:
            raise SystemExit("mbconv_ablation: the kernel source no longer has the ablated lines")

    def split(ks: int) -> str:
        i = {1: 0, 2: 1, 4: 2}[ks]
        return src.replace(_SPLITS, f"  for (int ks = {ks}, i = {i}; ks <= {ks}; ks *= 2, ++i) {{")

    return {
        "kernel": (src, ""),
        "no_load": (src.replace(_LOAD_START, "").replace(_LOAD_WAIT, ""), "expand_dw"),
        "no_expand_silu": (src.replace(_EXPAND_SILU, _EXPAND_SILU.replace("silu(", "(")),
                           "expand_dw"),
        "no_dw": (src.replace(_DW_TAPS, _DW_TAPS.replace("i < KS", "i < 0")), "expand_dw"),
        "no_dw_silu": (src.replace(_DW_SILU, _DW_SILU.replace("silu(", "(")), "expand_dw"),
        **{f"split{ks}": (split(ks), "project") for ks in (1, 2, 4)},
    }


def _compile_variants(variants: dict[str, tuple[str, str]], out_dir: str) -> dict[str, ctypes.CDLL]:
    from kubernetes_deep_learning_tpu_torch.ops import _build

    procs = {}
    for name, (src, _) in variants.items():
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
        lib.kdlt_mbconv_block.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def _b3_shapes() -> list[tuple]:
    """(h, c_in, c_mid, c_out, k, residual, calls) of B3's fused blocks at 300 px."""
    from kubernetes_deep_learning_tpu_torch.models.efficientnet import block_plan, round_filters
    from kubernetes_deep_learning_tpu_torch.models.efficientnet_fast import block_routes

    shapes: dict[tuple, int] = {}
    for r in block_routes(block_plan(1.2, 1.4), 150, 150, round_filters(32, 1.2)):
        if r.fused:
            key = (r.h, r.c_in, r.c_in * r.expand, r.features, r.kernel, r.residual)
            shapes[key] = shapes.get(key, 0) + 1
    return [(*key, calls) for key, calls in shapes.items()]


def main() -> int:
    if not torch.cuda.is_available():
        print("mbconv_ablation: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from chip_smoke import _card, _graph_ms
    from kubernetes_deep_learning_tpu_torch.models.efficientnet import se_features
    from kubernetes_deep_learning_tpu_torch.ops import _build
    from kubernetes_deep_learning_tpu_torch.ops import fused_mbconv as ops

    card = _card("name,power.limit")
    print(f"card: {card}", flush=True)
    with open(os.path.join(_build.CSRC_DIR, "fused_mbconv.cu")) as f:
        variants = _variants(f.read())
    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def t(shape, std=1.0, dtype=torch.float32):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)).to(dtype).cuda()

    with tempfile.TemporaryDirectory() as out_dir:
        libs = _compile_variants(variants, out_dir)
        for h, c_in, c_mid, c_out, k, residual, calls in _b3_shapes():
            b, s, bf = 16, se_features(c_in), torch.bfloat16
            w = dict(
                expand_w=t((c_in, c_mid), c_in ** -0.5, bf), expand_s=t((c_mid,), 0.1) + 1.0,
                expand_b=t((c_mid,), 0.1), dw=t((k, k, c_mid), 1.0 / k),
                dw_s=t((c_mid,), 0.1) + 1.0, dw_b=t((c_mid,), 0.1),
                se_r_w=t((c_mid, s), c_mid ** -0.5, bf), se_r_b=t((s,), 0.1),
                se_e_w=t((s, c_mid), s ** -0.5, bf), se_e_b=t((c_mid,), 0.1),
                proj_w=t((c_mid, c_out), c_mid ** -0.5, bf), proj_s=t((c_out,), 0.1) + 1.0,
                proj_b=t((c_out,), 0.1))
            x = t((b, h, h, c_in), 1.0, bf)
            y_dw = torch.empty((b, h, h, c_mid), dtype=bf, device="cuda")
            sums = torch.empty((b, h, c_mid), device="cuda")
            gate = torch.empty((b, c_mid), device="cuda")
            out = torch.empty((b, h, h, c_out), dtype=bf, device="cuda")
            row = dict(hw=h, widths=[c_in, c_mid, c_out], k=k, batch=b, calls_per_forward=calls,
                       card=card)
            for name, lib in libs.items():
                def call(phases, lib=lib, name=name):
                    code = lib.kdlt_mbconv_block(
                        x.data_ptr(), *(w[key].data_ptr() for key in ops._ORDER),
                        y_dw.data_ptr(), sums.data_ptr(), gate.data_ptr(), out.data_ptr(),
                        b, h, h, c_in, c_mid, c_out, s, k, sms, int(residual), phases,
                        torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise SystemExit(f"mbconv_ablation: {name} launch failed ({code})")

                launch = variants[name][1]
                if name == "kernel":
                    call(7)
                    want = ops.mbconv_block_reference(x, w, residual).float()
                    row["max_rel_err"] = ((out.float() - want).abs().max()
                                          / want.abs().max()).item()
                    for part, bit in LAUNCHES.items():
                        row[f"kernel_{part}_ms"] = _graph_ms(lambda bit=bit: call(bit), ITERS)
                else:
                    call(7)  # the scratch as the launch finds it in the block
                    row[f"{name}_{launch}_ms"] = _graph_ms(
                        lambda bit=LAUNCHES[launch]: call(bit), ITERS)
            print("ablation", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
