"""Device-peak tables, FLOP counting, and live MFU attribution.

The port of the JAX package's ``runtime/flops.py``.  :class:`MfuAccountant`
turns a model's FLOPs per image and each batch's device time into
always-on gauges (``kdlt_mfu_pct{model,version,bucket}``,
``kdlt_device_busy_ratio``), so the gap to the card's peak is visible on
/metrics, per model and per batch bucket.

FLOPs per image are counted the way the JAX package's
``lowered_flops_per_image`` counts them -- XLA's cost analysis of the
NON-fused graph, before compilation: two per multiply-accumulate of every
matmul and convolution, one per element of every elementwise operation
that is not transcendental, one per reduced element, with layer norm,
softmax, GELU and batch norm broken into those operations
(:func:`flops_per_image`).  The count runs once per model, on the meta
device when the exact forward runs there and else at batch 1 on the CPU,
never on the card's stream and never during traffic: the families served
here have no cross-batch operation, so the count does not depend on the
bucket.
"""

from __future__ import annotations

import functools
import math
import os
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

MFU_ENV = "KDLT_MFU"  # "0" disables the live attribution layer

# Per-card dense peak (TFLOP/s) for the compute dtype, keyed by substrings
# of torch.cuda.get_device_name(), lower-cased and matched in order ("h100
# pcie" before "h100").  NVIDIA's H100 data sheet, without sparsity: bf16
# on the tensor cores.  The float32 entry is the peak of the math the port
# runs: it keeps TF32 off (models.exact_float32), so float32 matmuls and
# convolutions run on the FMA pipes, not the TF32 tensor cores.  An unknown
# device reports MFU as None rather than guessing.
PEAK_TFLOPS_BY_KIND = {
    "h100 pcie": {"bfloat16": 756.0, "float32": 51.0},
    "h100": {"bfloat16": 989.4, "float32": 67.0},
}


def mfu_enabled(explicit: bool | None = None) -> bool:
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(MFU_ENV, "").strip() != "0"


def peak_tflops(device: torch.device, dtype_name: str) -> float | None:
    """The card's dense peak for ``dtype_name``, or None (the CPU, an
    unknown card)."""
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for sub, peaks in PEAK_TFLOPS_BY_KIND.items():
        if sub in kind:
            return peaks.get(dtype_name)
    return None


_aten = torch.ops.aten
# Elementwise operations XLA's cost analysis counts as transcendentals, not
# flops; and copies, which it does not count at all.
_UNCOUNTED = {_aten.exp, _aten.expm1, _aten.log, _aten.log1p, _aten.tanh, _aten.rsqrt,
              _aten.sqrt, _aten.erf, _aten.pow, _aten.sigmoid, _aten.clone, _aten._to_copy,
              _aten.copy}
_REDUCTIONS = {_aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.var, _aten.var_mean,
               _aten.max, _aten.min}


class _FlopCount(TorchDispatchMode):
    """Counts the flops of every aten operation run under it (module
    docstring).  Composite operations are decomposed first, under the mode,
    so their parts are counted."""

    def __init__(self):
        super().__init__()
        from torch._decomp import get_decompositions
        from torch.utils.flop_counter import flop_registry

        self.flops = 0
        self._registry = flop_registry
        self._decomp = get_decompositions([
            _aten.native_layer_norm, _aten._softmax, _aten.gelu, _aten.silu,
            _aten._native_batch_norm_legit_no_training])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in self._registry:
            with self:
                if func in self._decomp:
                    out = self._decomp[func](*args, **kwargs)
                    if out is not NotImplemented:
                        return out
                out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
        out = func(*args, **kwargs)
        if packet in self._registry:  # matmuls and convolutions
            self.flops += self._registry[packet](*args, **kwargs, out_val=out)
        elif packet in _REDUCTIONS:
            self.flops += args[0].numel()
        elif torch.Tag.pointwise in func.tags and packet not in _UNCOUNTED:
            first = out[0] if isinstance(out, (tuple, list)) else out
            self.flops += first.numel()
        return out


@functools.lru_cache(maxsize=16)
def flops_per_image(spec) -> float:
    """FLOPs of one image through the exact (``fast=False``) forward of
    ``spec``'s family, counted at batch 1 (module docstring).  On the meta
    device when the forward runs there (no memory, no arithmetic); a
    family whose forward needs real tensors (ViT's attention picks its
    route from the device) is counted on the CPU.  Cached per spec: the
    count depends on the architecture alone."""
    from kubernetes_deep_learning_tpu_torch.models import Forward, create_model

    def count(device: str) -> float:
        with torch.device(device):
            model = create_model(spec, dtype=torch.float32).eval()
        counter = _FlopCount()
        with torch.inference_mode(), counter:
            Forward(spec, model, False)(
                torch.zeros((1, *spec.input_shape), dtype=torch.uint8, device=device))
        return float(counter.flops)

    try:
        return count("meta")
    except (ValueError, RuntimeError, NotImplementedError):
        return count("cpu")


# Decay half-life for the device-busy accumulator: long enough to smooth
# per-batch jitter, short enough that the gauge tracks a load change within
# a scrape interval or two.
BUSY_HALFLIFE_S = 30.0
_LN2 = math.log(2.0)


class MfuAccountant:
    """Live per-bucket MFU + device-busy gauges for one serving engine.

    ``observe(bucket, n, seconds)`` is called from the engine's completion
    accounting with the batch's device time; it is O(1) -- a dict lookup, a
    couple of multiplies, a gauge set.  The FLOPs per image arrive once,
    from the engine's warmup (``set_flops_per_image``); until then no
    bucket's gauge exists.

    MFU per batch is ``bucket_rows * flops_per_image / (seconds * peak)``:
    the device executes the PADDED bucket, so padding waste honestly
    depresses the number.  The gauge is an EWMA over batches.
    """

    def __init__(self, registry: metrics_lib.Registry, peak_tf: float | None,
                 enabled: bool | None = None):
        self.enabled = mfu_enabled(enabled) and peak_tf is not None
        self._registry = registry
        self._peak_flops = (peak_tf or 0.0) * 1e12
        self._flops_img: float | None = None
        self._ewma: dict[int, float] = {}
        self._gauges: dict[int, metrics_lib.Gauge] = {}
        self._lock = threading.Lock()
        # Busy accounting runs even when MFU itself cannot (unknown device
        # kind): utilization needs no peak table.
        self._busy_enabled = mfu_enabled(enabled)
        self._busy = 0.0
        self._busy_at = time.monotonic()
        self._m_busy = metrics_lib.device_busy_gauge(registry) if self._busy_enabled else None

    def set_flops_per_image(self, flops: float | None) -> None:
        with self._lock:
            self._flops_img = flops

    def observe(self, bucket: int, n: int, seconds: float) -> None:
        """Account one completed batch (``n`` real rows padded to
        ``bucket``) that held the device for ``seconds``."""
        del n  # the device executed the padded bucket either way
        if self._busy_enabled:
            now = time.monotonic()
            with self._lock:
                dt = max(0.0, now - self._busy_at)
                if dt > 0:
                    self._busy *= 0.5 ** (dt / BUSY_HALFLIFE_S)
                    self._busy_at = now
                self._busy += seconds
                # Steady state: a utilization-u stream decays to
                # u * halflife / ln2, so this reads back u directly.
                ratio = min(1.0, self._busy * _LN2 / BUSY_HALFLIFE_S)
            self._m_busy.set(ratio)
        if not self.enabled or seconds <= 0:
            return
        with self._lock:
            flops_img = self._flops_img
            if not flops_img:
                return
            mfu = (bucket * flops_img) / (seconds * self._peak_flops)
            prev = self._ewma.get(bucket)
            mfu = mfu if prev is None else 0.8 * prev + 0.2 * mfu
            self._ewma[bucket] = mfu
            gauge = self._gauges.get(bucket)
            if gauge is None:
                gauge = self._gauges[bucket] = metrics_lib.mfu_bucket_gauge(
                    self._registry, bucket)
        gauge.set(round(mfu * 100.0, 2))

    def snapshot(self) -> dict:
        """{bucket: mfu_pct} for debugging/tests."""
        with self._lock:
            return {b: round(v * 100.0, 2) for b, v in self._ewma.items()}
