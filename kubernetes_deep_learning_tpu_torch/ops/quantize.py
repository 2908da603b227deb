"""int8 quantization for serving artifacts: weight-only and calibrated w8a8.

The port of ``ops/quantize.py``, with its names, constants, environment
knobs and wire keys, so an artifact either package writes serves in both.
Two schemes, tagged in ``metadata["quantization"]``:

**``int8-weight-only``**: every conv/dense kernel of at least ``min_size``
elements (outside the ``head``) is stored as symmetric per-output-channel
int8 (scale = max|w| / 127).  The port dequantizes once, at load
(``dequantize_variables_host``: ``q.astype(f32) * scale``, the JAX
package's f32 product bit for bit) and serves the float forward, the fused
path on the card; the int8 weights do not stay resident (ROADMAP A8b).

**``int8-w8a8``**: calibration (:func:`calibrate_activation_scales`) runs
representative uint8 images through the exact float32 graph and records,
per quantized layer, a static per-tensor activation scale from a
percentile of |input|; it is stored beside the weight leaf.  The w8a8
forward (:func:`build_w8a8_forward`) runs every calibrated conv as int8 x
int8 -> int32 on the hand-written CUDA kernels of ``ops.int8`` (Q1 for
dense convs, Q2 for 3x3 and 5x5 depthwise), each fusing the quantize-in
``clamp(round(x / s_act), -127, 127)`` and the requantize-out ``acc *
(s_act * s_w)``; BatchNorm, residuals, pooling and the head stay float32.
The engine gates it at warmup against the weight-only forward
($KDLT_QUANT_TOL, top-1 agreement) and serves weight-only when it fails.

Wire format: each quantized kernel leaf is a dict in the same tree
position, ``{"_q8": int8, "_q8_scale": f32[out]}``, plus ``"_q8_act_scale":
f32[]`` once calibrated.

Module paths: every family calls its convolutions through their modules
(``models.layers.Conv2dNHWC``) and ViT its MLP through ``models.layers.Dense``,
so a flax module path such as ``("block5_sepconv1", "pointwise")`` names the
port module ``block5_sepconv1.pointwise``.  Calibration hooks the modules
JAX's interceptor sees (``nn.Conv`` and ``nn.Dense``: ``Conv2dNHWC`` and
``Dense``); the w8a8 forward replaces each calibrated convolution.  A
quantized kernel of any other module (ViT's ``DenseGeneral`` attention
projections) makes :func:`build_w8a8_forward` raise a ``ValueError``: the
JAX package's w8a8 program fails on the same layer, so such an artifact
serves in neither package (its float and weight-only versions do).
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import numpy as np

QUANT_KEY = "_q8"
SCALE_KEY = "_q8_scale"
ACT_SCALE_KEY = "_q8_act_scale"
SCHEME = "int8-weight-only"
SCHEME_W8A8 = "int8-w8a8"
SCHEMES = (SCHEME, SCHEME_W8A8)

# The warmup tolerance gate (runtime.engine._run_quant_gate): max-abs logit
# drift of the w8a8 program vs the weight-only float reference, relative to
# the reference's max-abs logit, must stay within $KDLT_QUANT_TOL, AND
# top-1 agreement must reach GATE_TOP1.  Failing either refuses w8a8.
QUANT_TOL_ENV = "KDLT_QUANT_TOL"
DEFAULT_QUANT_TOL = 0.1
GATE_TOP1 = 0.99

# Operator scheme override: "auto" serves what the artifact says (gated);
# "weight-only" refuses int8 activations fleet-wide without re-exporting.
QUANT_SCHEME_ENV = "KDLT_QUANT_SCHEME"

# Calibration defaults: the percentile clip trades worst-case outlier
# coverage for resolution everywhere else; 99.9 is the classic
# post-training default.
DEFAULT_CALIB_PERCENTILE = 99.9
DEFAULT_CALIB_IMAGES = 32
# Scale floor: a layer whose calibration stream is identically zero must
# still get a finite, positive scale.
SCALE_FLOOR = 1e-6

# Leaves eligible for quantization: conv/dense kernels.
_KERNEL_NAMES = ("kernel",)

def resolve_quant_tol(explicit: float | None = None) -> float:
    """Explicit arg > $KDLT_QUANT_TOL > 0.1 (relative max-abs logit drift)."""
    if explicit is not None:
        return float(explicit)
    raw = os.environ.get(QUANT_TOL_ENV, "")
    try:
        return float(raw) if raw.strip() else DEFAULT_QUANT_TOL
    except ValueError:
        return DEFAULT_QUANT_TOL


def resolve_scheme_override(explicit: str | None = None) -> str:
    """$KDLT_QUANT_SCHEME: "auto" (default) or "weight-only" (refuse w8a8)."""
    raw = (explicit if explicit is not None
           else os.environ.get(QUANT_SCHEME_ENV, "")).strip().lower()
    return "weight-only" if raw in ("weight-only", "weight_only", "w8") else "auto"


def is_quantized_leaf(v: Any) -> bool:
    return isinstance(v, dict) and QUANT_KEY in v and SCALE_KEY in v


def quantize_variables(
    variables: Any, min_size: int = 4096, skip: tuple[str, ...] = ("head",)
) -> Any:
    """float tree -> tree with int8-quantized kernel leaves.

    ``min_size``: kernels smaller than this many elements stay float;
    ``skip``: subtree names left untouched (the classifier head).  Scales
    are per OUTPUT channel (last axis), symmetric; an all-zero channel gets
    scale 1 to avoid 0/0.
    """

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k in skip:
                out[k] = v
                continue
            if (
                k in _KERNEL_NAMES
                and hasattr(v, "ndim")
                and v.ndim >= 2
                and v.size >= min_size
            ):
                w = np.asarray(v, np.float32)
                absmax = np.abs(w).max(axis=tuple(range(w.ndim - 1)))
                scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
                q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
                out[k] = {QUANT_KEY: q, SCALE_KEY: scale}
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return walk(variables)


def dequantize_variables_host(variables: Any) -> Any:
    """Quantized tree -> float32 tree, on the host: ``q.astype(f32) *
    scale``, the JAX package's dequantization bit for bit."""

    def walk(tree):
        if is_quantized_leaf(tree):
            return np.asarray(tree[QUANT_KEY], np.float32) * np.asarray(
                tree[SCALE_KEY], np.float32
            )
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree

    return walk(variables)


def is_quantized(variables: Any) -> bool:
    found = False

    def walk(tree):
        nonlocal found
        if is_quantized_leaf(tree):
            found = True
            return
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)

    walk(variables)
    return found


def quantized_leaves(variables: Any) -> dict[tuple, dict]:
    """{module path -> its quantized kernel leaf} of a tree (``params``'s,
    when the tree has the collection)."""
    out: dict[tuple, dict] = {}

    def walk(tree, path):
        if is_quantized_leaf(tree):
            out[path[:-1]] = tree  # the path ends with the kernel's name
            return
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))

    params = variables.get("params", variables) if isinstance(variables, dict) else variables
    walk(params, ())
    return out


# --- activation calibration (the w8a8 half) ---------------------------------


def clip_scale(abs_values, percentile: float = DEFAULT_CALIB_PERCENTILE) -> np.float32:
    """One layer's static activation scale from observed |activation|
    samples: the ``percentile`` (100 = absmax) floored at SCALE_FLOOR, over
    127."""
    a = np.asarray(abs_values, np.float32).ravel()
    amax = float(np.percentile(a, percentile)) if a.size else 0.0
    return np.float32(max(amax, SCALE_FLOOR) / 127.0)


def _percentile(a, percentile: float) -> float:
    """``np.percentile(a, percentile)`` (numpy's "linear" method) of a flat
    float32 tensor, with the two order statistics it needs found on the
    tensor's device (``torch.topk``) and numpy's own index, weight and
    interpolation arithmetic on them.  ``torch.quantile`` refuses inputs
    past 2^24 elements, and copying every calibrated layer's input to the
    host is slow."""
    import torch

    n = a.numel()
    if n == 0:
        return 0.0
    dt = np.float32
    # numpy's percentile -> quantile, "linear": the virtual index (n - 1) * q.
    q = np.asanyarray(np.true_divide(percentile, dt(100)))
    virtual = np.asanyarray((n - 1) * q)
    if virtual >= n - 1:
        lo = hi = n - 1
    elif virtual < 0:
        lo = hi = 0
    else:
        lo = int(np.floor(virtual))
        hi = lo + 1
    gamma = np.asanyarray(virtual - np.floor(virtual), dtype=virtual.dtype)
    # Descending top n - lo: its last value is the lo-th smallest.
    top = torch.topk(a, n - lo, sorted=True).values
    pair = top[-2:].flip(0) if hi > lo else top[-1:].repeat(2)
    prev, nxt = (np.asarray(v, dt) for v in pair.cpu().numpy())
    # numpy's _lerp.
    diff = np.subtract(nxt, prev)
    out = np.asanyarray(np.add(prev, diff * gamma))
    if gamma >= 0.5:
        out = np.asanyarray(np.subtract(nxt, diff * (1 - gamma)), dtype=out.dtype)
    return float(out)


def _layer_modules(model, paths) -> dict[tuple, Any]:
    """The port module of each flax module path, in the model's module
    order (the order of the forward's calls)."""
    by_name = {tuple(name.split(".")): m for name, m in model.named_modules() if name}
    missing = [p for p in paths if p not in by_name]
    if missing:
        raise ValueError(f"quantized kernels name no module of the model: "
                         f"{['/'.join(p) for p in missing]}")
    return {path: m for path, m in by_name.items() if path in paths}


def _intercepted(module) -> bool:
    """Whether JAX's interceptor sees the module's flax counterpart
    (``nn.Conv`` or ``nn.Dense``)."""
    from kubernetes_deep_learning_tpu_torch.models.layers import Conv2dNHWC, Dense

    return isinstance(module, (Conv2dNHWC, Dense))


def calibrate_activation_scales(
    spec,
    variables: Any,
    qvars: Any,
    images: np.ndarray,
    percentile: float = DEFAULT_CALIB_PERCENTILE,
    batch_size: int = 8,
    device: str = "cuda",
) -> dict[tuple, np.float32]:
    """Run representative uint8 images through the exact FLOAT32 graph
    (TF32 off) on ``device``; return {flax module path -> static per-tensor
    activation scale} for every layer whose kernel ``qvars`` quantized.

    A forward pre-hook on each such module that JAX's interceptor sees (a
    convolution or a Dense layer; ViT's quantized DenseGeneral kernels get
    no scale, as in JAX) takes the |input| percentile of each batch (numpy's
    "linear" rule); the scale is the max over batches, floored, over 127.
    The hook sees the module's input before its padding, as flax's
    interceptor does.  Offline only (artifact build time).
    """
    import torch

    from kubernetes_deep_learning_tpu_torch import weights
    from kubernetes_deep_learning_tpu_torch.models import (
        create_model,
        exact_float32,
        resolve_device,
    )
    from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize

    dev = resolve_device(device)
    exact_float32(dev)
    model = create_model(spec, dtype=torch.float32)
    model.load_state_dict(weights.from_jax_variables(variables))
    model = model.to(dev).eval()
    modules = {path: m for path, m in _layer_modules(model, quantized_leaves(qvars)).items()
               if _intercepted(m)}
    observed: dict[tuple, float] = {}

    def hook_for(path):
        def hook(_module, args):
            amax = _percentile(args[0].float().abs().flatten(), percentile)
            observed[path] = max(observed.get(path, 0.0), amax)
        return hook

    handles = [m.register_forward_pre_hook(hook_for(path)) for path, m in modules.items()]
    try:
        images = np.asarray(images)
        with torch.inference_mode():
            for i in range(0, max(1, images.shape[0]), batch_size):
                chunk = images[i : i + batch_size]
                if chunk.shape[0] == 0:
                    break
                x = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
                if chunk.dtype == np.uint8:
                    x = normalize(x, spec.preprocessing)
                model(x.float())
    finally:
        for h in handles:
            h.remove()
    return {k: np.float32(max(v, SCALE_FLOOR) / 127.0) for k, v in observed.items()}


def attach_activation_scales(qvars: Any, scales: dict[tuple, Any]) -> Any:
    """Store calibrated per-tensor activation scales next to their ``_q8``
    weight leaves (``_q8_act_scale``, a 0-d float32)."""

    def walk(tree, path):
        if is_quantized_leaf(tree):
            s = scales.get(path[:-1])  # path ends with the kernel name
            if s is not None:
                return {**tree, ACT_SCALE_KEY: np.asarray(s, np.float32)}
            return tree
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return tree

    return walk(qvars, ())


def activation_scales(variables: Any) -> dict[tuple, np.float32]:
    """{module path -> stored activation scale} of a calibrated tree."""
    return {path: np.float32(np.asarray(leaf[ACT_SCALE_KEY]))
            for path, leaf in quantized_leaves(variables).items() if ACT_SCALE_KEY in leaf}


def is_calibrated(variables: Any) -> bool:
    """True when at least one quantized leaf carries an activation scale."""
    return bool(activation_scales(variables))


# --- the w8a8 forward --------------------------------------------------------


def build_w8a8_forward(spec, qvars: Any, device: str = "cuda", converted: tuple | None = None):
    """``models.Forward`` (uint8 or normalized-float NHWC -> float32
    logits) over the calibrated quantized tree ``qvars``: the family's
    exact float32 graph (whatever the artifact's compute dtype, as the JAX
    program) on the dequantized parameters, each convolution with a
    calibrated leaf replaced by an ``ops.int8.Int8Conv2d`` (its int8 weight
    packed for the kernels once, here); an uncalibrated leaf stays a float
    layer on its dequantized weight.  On the card every replaced conv
    launches Q1 or Q2 and nothing in its place: a shape the kernels do not
    take raises here.  ``converted`` is ``weights.from_jax_quantized(qvars)``
    when the caller already holds it.

    Raises ``ValueError`` at the first quantized kernel of a module JAX's
    interceptor does not see (ViT's ``DenseGeneral``: the JAX program fails
    there too, flax reading the int8 leaf as the layer's kernel), and at a
    calibrated Dense layer (no int8 kernel takes one; no family the JAX
    package serves in w8a8 has one, the head is never quantized).
    """
    import torch

    from kubernetes_deep_learning_tpu_torch import weights
    from kubernetes_deep_learning_tpu_torch.models import (
        Forward,
        create_model,
        exact_float32,
        resolve_device,
    )
    from kubernetes_deep_learning_tpu_torch.ops.int8 import Int8Conv2d

    from kubernetes_deep_learning_tpu_torch.models.layers import Conv2dNHWC

    dev = resolve_device(device)
    exact_float32(dev)
    params, leaves = converted or weights.from_jax_quantized(qvars)
    model = create_model(spec, dtype=torch.float32)
    model.load_state_dict(params)
    paths = {tuple(name.split(".")): leaf for name, leaf in leaves.items()}
    modules = _layer_modules(model, paths)
    for path, module in modules.items():
        if not _intercepted(module):
            raise ValueError(
                f"int8-w8a8 cannot serve {spec.name!r} ({spec.family}): "
                f"{'/'.join(path)} is a quantized {type(module).__name__} kernel, which the "
                "w8a8 program does not intercept; the JAX package's build_w8a8_forward fails "
                "at this layer too (flax reads the int8 leaf as its kernel). Serve the float "
                "or int8-weight-only version")
        if paths[path].act_scale is not None and not isinstance(module, Conv2dNHWC):
            raise ValueError(f"int8-w8a8: {'/'.join(path)} is a calibrated "
                             f"{type(module).__name__}; the int8 kernels take convolutions only")
    for path, module in modules.items():
        leaf = paths[path]
        if leaf.act_scale is None:  # uncalibrated: weight-only for this layer
            continue
        parent = model.get_submodule(".".join(path[:-1]))
        setattr(parent, path[-1], Int8Conv2d(module, leaf.weight, leaf.scale, leaf.act_scale,
                                             device=dev))
    model = model.to(dev).eval()
    return Forward(spec, model, False).eval()


# --- artifact build ----------------------------------------------------------

# JAX's calibration file selection (kubernetes_deep_learning_tpu/ops/quantize.py).
CALIB_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def representative_images(
    spec, n: int, seed: int = 0, image_dir: str | None = None
) -> np.ndarray:
    """N uint8 calibration images at the spec's input shape: real sample
    images from ``image_dir``, else seeded uniform noise.

    ``image_dir``: JAX's file selection (its extension set, sorted, cycled
    if fewer than ``n``), each file decoded and resized with the spec's
    filter by the gateway's host pipeline
    (``ops.preprocess.preprocess_bytes``, pixel-equal to PIL for JPEG and
    PNG; no PIL).  A BMP or WebP file, which JAX opens with PIL, raises a
    ``ValueError`` naming it when it is read."""
    h, w, c = spec.input_shape
    if image_dir:
        from kubernetes_deep_learning_tpu_torch.ops.preprocess import preprocess_bytes

        files = sorted(
            os.path.join(image_dir, f)
            for f in os.listdir(image_dir)
            if f.lower().endswith(CALIB_IMAGE_EXTS)
        )
        if not files:
            raise FileNotFoundError(f"no images under {image_dir!r}")
        out = []
        for i in range(n):
            path = files[i % len(files)]
            ext = os.path.splitext(path)[1].lower()
            if ext not in (".png", ".jpg", ".jpeg"):
                raise ValueError(f"cannot read {path!r} ({ext} file): the port decodes "
                                 f"JPEG and PNG only")
            with open(path, "rb") as f:
                out.append(preprocess_bytes(f.read(), (h, w), filter=spec.resize_filter))
        return np.stack(out)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, h, w, c), dtype=np.uint8)


def write_quantized_version(
    root: str,
    name: str,
    scheme: str = SCHEME,
    calib_images: np.ndarray | None = None,
    percentile: float = DEFAULT_CALIB_PERCENTILE,
    min_size: int = 4096,
    from_version: int | None = None,
    device: str = "cuda",
) -> str:
    """Quantize <root>/<name>'s latest (or ``from_version``) float version
    into the NEXT version dir, under ``scheme``; ``int8-w8a8`` calibrates
    on ``device`` from ``calib_images`` (uint8 NHWC; default
    DEFAULT_CALIB_IMAGES noise images).  The version is staged under a
    dot-name and renamed into place, so a version watcher never sees it
    half written."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import create_model

    if scheme not in SCHEMES:
        raise ValueError(f"unknown quantization scheme {scheme!r}; known: {SCHEMES}")
    latest = art.latest_version(root, name)
    if latest is None:
        raise FileNotFoundError(f"no versions of {name!r} under {root!r}")
    version = latest if from_version is None else from_version
    src = art.load_artifact(art.version_dir(root, name, version))
    if src.metadata.get("quantization"):
        raise ValueError(
            f"{name} v{version} is already quantized "
            f"({src.metadata['quantization']}); quantize from a float version"
            + ("" if from_version is not None else " via from_version")
        )
    try:
        create_model(src.spec)
    except KeyError as e:
        raise ValueError(
            f"cannot quantize {name!r}: family {src.spec.family!r} has no forward in the port"
        ) from e
    qvars = quantize_variables(src.variables, min_size=min_size)
    meta = {**src.metadata, "quantization": scheme, "quantized_from_version": version}
    if scheme == SCHEME_W8A8:
        if calib_images is None:
            calib_images = representative_images(src.spec, DEFAULT_CALIB_IMAGES)
        scales = calibrate_activation_scales(
            src.spec, src.variables, qvars, calib_images, percentile=percentile, device=device
        )
        qvars = {**qvars, "params": attach_activation_scales(qvars["params"], scales)}
        meta["calibration"] = {
            "images": int(np.asarray(calib_images).shape[0]),
            "percentile": float(percentile),
            "layers": len(scales),
        }
    dst = art.version_dir(root, name, latest + 1)
    staging = os.path.join(os.path.dirname(dst), f".tmp-{latest + 1}")
    shutil.rmtree(staging, ignore_errors=True)
    art.save_artifact(staging, src.spec, qvars, meta)
    os.rename(staging, dst)
    return dst


def main(argv: list[str] | None = None) -> int:
    """CLI: kdlt-torch-quantize --models <root> --model <name> [--scheme int8-w8a8]."""
    import argparse

    p = argparse.ArgumentParser(description="int8 artifact quantization")
    p.add_argument("--models", required=True, help="artifact root")
    p.add_argument("--model", required=True, help="model name under the root")
    p.add_argument(
        "--scheme", default=SCHEME, choices=list(SCHEMES),
        help="int8-weight-only (weights dequantized at load; no calibration) or "
        "int8-w8a8 (calibrated activation scales; convolutions run int8 x int8 on the "
        "card's int8 kernels, gated at warmup by KDLT_QUANT_TOL)",
    )
    p.add_argument(
        "--calibrate-images", type=int, default=DEFAULT_CALIB_IMAGES,
        help="calibration batch size for --scheme int8-w8a8",
    )
    p.add_argument(
        "--calibrate-percentile", type=float, default=DEFAULT_CALIB_PERCENTILE,
        help="percentile clip on |activation| (100 = absmax)",
    )
    p.add_argument(
        "--calibrate-dir", default=None,
        help="directory of representative images (default: seeded noise; "
        "calibrate on real traffic samples in production)",
    )
    p.add_argument("--calibrate-seed", type=int, default=0)
    p.add_argument(
        "--from-version", type=int, default=None,
        help="quantize this (float) version instead of the latest",
    )
    p.add_argument("--device", default="cuda",
                   help="where calibration runs (cuda, or cpu)")
    args = p.parse_args(argv)
    calib = None
    if args.scheme == SCHEME_W8A8:
        from kubernetes_deep_learning_tpu_torch.export import artifact as art

        version = (
            args.from_version
            if args.from_version is not None
            else art.latest_version(args.models, args.model)
        )
        if version is None:
            raise SystemExit(f"no versions of {args.model!r} under {args.models!r}")
        spec = art.load_artifact(art.version_dir(args.models, args.model, version)).spec
        calib = representative_images(
            spec, args.calibrate_images, seed=args.calibrate_seed,
            image_dir=args.calibrate_dir,
        )
    path = write_quantized_version(
        args.models, args.model, scheme=args.scheme, calib_images=calib,
        percentile=args.calibrate_percentile, from_version=args.from_version,
        device=args.device,
    )
    print(f"wrote quantized artifact ({args.scheme}): {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
