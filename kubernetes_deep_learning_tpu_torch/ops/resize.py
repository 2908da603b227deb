"""Device-side image resize: what ``jax.image.resize(x, shape, method)``
computes, in float32 torch products.

The bytes wire's device-resize staging (``runtime.engine``,
``KDLT_INGEST_DEVICE_RESIZE``) decodes on the host at a staging size and
resizes to the model's input on the device, as the JAX engine's
``_ingest_fused`` does with ``jax.image.resize``.  That function is XLA
code, no Pallas kernel, so this port of it is plain torch too:

- ``"linear"``: JAX's defaults, ``antialias=True`` and
  ``precision=HIGHEST``.  The separable weight matrices are built on the
  host once per (input size, output size), as ``jax/_src/image/scale.py``'s
  ``compute_weight_mat`` builds them (triangle kernel widened by the
  downscale factor, columns normalised, samples outside the input zeroed),
  rounded as XLA's compiled program rounds them, and applied as two
  float32 products.
  TF32 stays off for them on the card (``models.exact_float32``).
- ``"nearest"``: ``_resize_nearest``, a gather of rows and columns at
  ``floor((i + 0.5) * in / out)`` computed in float32.

A dimension whose size does not change is left as it is, as JAX leaves it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

METHODS = ("linear", "nearest")


def method_for(resize_filter: str) -> str:
    """The JAX engine's choice: ``"nearest"`` for a nearest spec, else linear."""
    return "nearest" if resize_filter == "nearest" else "linear"


def _fma(a: np.ndarray, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add rounds
    it (the product of two float32 values is exact in float64)."""
    return (a.astype(np.float64) * np.float64(b) + np.float64(c)).astype(np.float32)


def _triangle(in_size: int, out_size: int, fma_sample: bool, fma_kernel: bool):
    """The sample positions and the unnormalised triangle weights,
    (in_size, out_size), in float32."""
    f32 = np.float32
    inv = 1.0 / (out_size / in_size)  # a Python float, as JAX's resize has it
    inv_scale, kernel_scale = f32(inv), f32(max(inv, 1.0))
    centre = np.arange(out_size, dtype=f32) + f32(0.5)
    sample_f = _fma(centre, inv_scale, -0.5) if fma_sample else centre * inv_scale - f32(0.5)
    dist = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    if kernel_scale == 1:
        x = f32(1.0) - dist
    elif fma_kernel:
        x = _fma(dist, -(f32(1.0) / kernel_scale), 1.0)
    else:
        x = f32(1.0) - dist * (f32(1.0) / kernel_scale)
    return sample_f, np.maximum(f32(0.0), x)


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32: output sample j is
    ``sum_i x[i] * w[i, j]`` (``compute_weight_mat``: triangle kernel,
    antialiased, no translation).

    Built in float32 as XLA compiles JAX's function: the division by the
    kernel scale becomes a product by its reciprocal, and the compiled
    program evaluates the weights twice, once for the numerators (the
    sample position by a fused multiply-add) and once for the column sums
    (the kernel by one).  Weights built any other way differ from JAX's by
    up to ~1e-6, which moves the resized pixels by up to ~5e-4."""
    f32 = np.float32
    sample_f, weights = _triangle(in_size, out_size, fma_sample=True, fma_kernel=False)
    _, summed = _triangle(in_size, out_size, fma_sample=False, fma_kernel=True)
    total = np.sum(summed, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    # Zero the samples outside the input.
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    weights = np.where(inside[None, :], weights, f32(0.0)).astype(f32)
    weights.setflags(write=False)
    return weights


@functools.lru_cache(maxsize=64)
def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """The input index of each output sample (``_resize_nearest``:
    ``floor((i + 0.5) * in / out)`` in float32, which XLA evaluates as
    ``(i + 0.5) * (in * (1 / out))``)."""
    f32 = np.float32
    step = f32(in_size) * (f32(1.0) / f32(out_size))
    idx = np.floor((np.arange(out_size, dtype=f32) + f32(0.5)) * step).astype(np.int64)
    idx.setflags(write=False)
    return idx


class Resize:
    """A float32 NHWC batch at ``in_hw`` -> float32 NHWC at ``out_hw``.

    The matrices (or indices) are on ``device`` from construction on, so a
    call makes no host-to-device copy and can be captured into a CUDA graph.
    """

    def __init__(self, in_hw: tuple[int, int], out_hw: tuple[int, int], method: str,
                 device: torch.device | str = "cpu"):
        if method not in METHODS:
            raise ValueError(f"unknown resize method {method!r} (one of {METHODS})")
        self.in_hw = (int(in_hw[0]), int(in_hw[1]))
        self.out_hw = (int(out_hw[0]), int(out_hw[1]))
        self.method = method
        device = torch.device(device)
        from kubernetes_deep_learning_tpu_torch.models import exact_float32

        exact_float32(device)  # no TF32 in the products on the card
        make = weight_matrix if method == "linear" else nearest_indices
        # None: the dimension keeps its size and is left alone.
        self._h, self._w = (
            None if i == o else torch.from_numpy(make(i, o).copy()).to(device)
            for i, o in zip(self.in_hw, self.out_hw))
        if method == "linear" and self._h is not None:
            self._h = self._h.t().contiguous()  # (out, in): rows contract from the left

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or tuple(x.shape[1:3]) != self.in_hw:
            raise ValueError(f"expected (N, {self.in_hw[0]}, {self.in_hw[1]}, C), got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"the resize runs in float32, got {x.dtype}")
        if self.method == "nearest":
            if self._h is not None:
                x = x.index_select(1, self._h)
            if self._w is not None:
                x = x.index_select(2, self._w)
            return x
        # Channels first, so that both products are wide: (n*c*h, w) @
        # (w, ow) as one GEMM, then (oh, h) @ (h, ow) batched over n*c.  (In
        # NHWC each would contract against 3 channels: 15x slower on the
        # card.)
        x = x.permute(0, 3, 1, 2)
        if self._w is not None:
            x = torch.matmul(x, self._w)
        if self._h is not None:
            x = torch.matmul(self._h, x)
        return x.permute(0, 2, 3, 1).contiguous()


def resize_to_uint8(resize: Resize, x: torch.Tensor) -> torch.Tensor:
    """A uint8 batch through ``resize`` and back to uint8 as the JAX engine
    does it: float32, resize, round half to even, clip to 0..255."""
    y = resize(x.to(torch.float32))
    return torch.round(y).clamp_(0.0, 255.0).to(torch.uint8)
