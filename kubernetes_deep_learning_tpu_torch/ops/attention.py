"""Serving attention: flash attention on a hand-written CUDA kernel (K3),
and the einsum route for short sequences.

The port of the serving half of ``kubernetes_deep_learning_tpu/ops/attention.py``,
on (B, H, S, D) tensors as there:

- ``mha_reference``: plain softmax attention that rounds like the JAX
  einsum route (scores from a matmul in the input dtype, then cast to f32
  and scaled; p cast to v's dtype for the PV product);
- ``flash_attention``: online-softmax attention.  On a CUDA tensor it
  launches K3 (``csrc/flash_attention.cu``: bf16 on tensor cores, f32 on
  FMA; head dims 32, 64, 128) and adds one to its launch count; on a CPU
  tensor it computes the plain version, ``flash_attention_reference``,
  which rounds at the kernel's points: f32 scores of input-dtype operands,
  f32 softmax statistics, p in the input dtype, f32 accumulation, and 0
  for a row that no key is visible to;
- ``flash_attention_padded``: the JAX name for ragged lengths.  The kernel
  masks by bounds, so nothing is padded here;
- ``attention_serving``: the einsum route while both sequences are at most
  ``EINSUM_MAX_SEQ`` long, flash attention past it.

The partials form (``attend_block``, ``combine_partials``,
``finalize_partials``) and ``attention_trainable`` are not ported yet.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

NEG_INF = -1e30  # large-but-finite: -inf breaks exp(m - m_new) when a row is fully masked

# Sequence length up to which serving attention takes the einsum route; the
# JAX package's rule, kept so both packages route every shape alike.  It
# bounds the (B, H, S, S) f32 scores the einsum route materialises.
EINSUM_MAX_SEQ = 512

KERNEL_HEAD_DIMS = (32, 64, 128)  # head dims K3 is instantiated for

_counts_lock = threading.Lock()
_launches = {"flash_attention": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset (CUDA path only)."""
    with _counts_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in _launches:
            _launches[k] = 0


def _count(name: str) -> None:
    with _counts_lock:
        _launches[name] += 1


def pick_block(seq: int) -> int | None:
    """Largest 8-aligned block (<= 256) dividing ``seq``, or None: the JAX
    kernel's tiling rule, which the ring-attention slice shards by."""
    for block in (256, 128, 64, 32, 16, 8):
        if seq % block == 0:
            return block
    return None


def use_einsum_attention(sq: int, sk: int) -> bool:
    """The routing rule of ``attention_serving``."""
    return sq <= EINSUM_MAX_SEQ and sk <= EINSUM_MAX_SEQ


def _visible(sq: int, sk: int, causal: bool, k_offset: int, kv_len: int | None, device):
    """(sq, sk) bool: query i sees key j iff j < kv_len and, under
    ``causal``, i >= j + k_offset.  None when every key is visible."""
    if not causal and (kv_len is None or kv_len >= sk):
        return None
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    vis = cols < (sk if kv_len is None else kv_len)
    if causal:
        vis = vis & (rows >= cols + k_offset)
    return vis


def mha_reference(q, k, v, *, causal: bool = False, k_offset: int = 0):
    """Plain softmax attention, (..., S, D) layout: the einsum route."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    vis = _visible(q.shape[-2], k.shape[-2], causal, k_offset, None, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def flash_attention_reference(q, k, v, *, causal: bool = False, k_offset: int = 0,
                              kv_len: int | None = None):
    """The plain version of ``flash_attention`` (see module doc)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    # A product of two bf16 values is exact in f32: these are the scores
    # the tensor cores accumulate in f32.
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    vis = _visible(q.shape[-2], k.shape[-2], causal, k_offset, kv_len, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    dead = m <= NEG_INF * 0.5  # no visible key: 0, not the mean of v
    out = torch.where(dead, 0.0, acc / torch.where(dead, 1.0, l))
    return out.to(q.dtype)


# --- kernel wrapper -----------------------------------------------------------


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when K3 can read it in place (unit last stride, rows
    16-byte aligned), else a contiguous copy."""
    per16 = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % per16 == 0 for st in t.stride()[:-1])):
        return t
    return t.contiguous()


def _launch(q, k, v, causal: bool, k_offset: int, kv_len: int):
    from kubernetes_deep_learning_tpu_torch.ops import _build

    lib = _build.load()
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.kdlt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, sq, sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), k_offset, kv_len, int(q.dtype == torch.bfloat16),
        ctypes.c_float(1.0 / math.sqrt(d)), stream,
    )
    _build.check(lib, code, "flash attention")
    return out


def flash_attention(q, k, v, *, causal: bool = False, k_offset: int = 0,
                    kv_len: int | None = None):
    """Flash attention, q (B, H, Sq, D), k and v (B, H, Sk, D) -> (B, H, Sq, D).

    ``kv_len``: keys at or past it are masked (valid rows of a padded KV);
    ``k_offset``: global position of k[0] relative to q[0] under ``causal``.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q, k, v must be (B,H,S,D), got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or D")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must all be bfloat16 or float32, got {q.dtype} {k.dtype} {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if kv_len is not None and kv_len < 0:
        raise ValueError(f"kv_len must be >= 0, got {kv_len}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, k_offset=k_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {KERNEL_HEAD_DIMS}, got {q.shape[3]}")
    sk = k.shape[2]
    out = _launch(q, k, v, causal, k_offset, sk if kv_len is None else min(kv_len, sk))
    _count("flash_attention")
    return out


def flash_attention_padded(q, k, v, *, causal: bool = False):
    """Flash attention for any sequence lengths.  The JAX version pads S to
    a block multiple, masks the pad keys with ``kv_len`` and slices the pad
    queries off; K3 masks ragged tiles by bounds, so this is
    ``flash_attention`` itself."""
    return flash_attention(q, k, v, causal=causal)


def attention_serving(q, k, v, *, causal: bool = False):
    """Inference attention: the einsum route while both sequences are at
    most ``EINSUM_MAX_SEQ`` long, flash attention past it (K3 on CUDA, its
    plain version on the CPU)."""
    if use_einsum_attention(q.shape[2], k.shape[2]):
        return mha_reference(q, k, v, causal=causal)
    return flash_attention_padded(q, k, v, causal=causal)
