"""Attention: flash attention on hand-written CUDA kernels (K3 and its
partials form K3P), the einsum route for short sequences, and a
differentiable attention for training.

The port of ``kubernetes_deep_learning_tpu/ops/attention.py``, on
(B, H, S, D) tensors as there:

- ``mha_reference``: plain softmax attention that rounds like the JAX
  einsum route (scores from a matmul in the input dtype, then cast to f32
  and scaled; p cast to v's dtype for the PV product);
- ``flash_attention``: online-softmax attention.  On a CUDA tensor it
  launches K3 (``csrc/flash_attention.cu``: bf16 on TMA-fed wgmma, f32 as
  3xTF32 tensor-core products; head dims 32, 64, 128) and adds one to its
  launch count; on a CPU tensor it computes the plain version,
  ``flash_attention_reference``, which rounds at the kernel's points: f32
  scores of input-dtype operands, f32 softmax statistics, p in the input
  dtype, f32 accumulation, and 0 for a row that no key is visible to.
  With ``return_partials=True`` it returns the unnormalised f32
  ``(acc, m, l)`` instead: K3P on CUDA
  (counted as ``flash_attention_partials``),
  ``flash_attention_partials_reference`` on the CPU;
- ``flash_gfold``: non-causal flash attention with ``g`` (batch, head)
  pairs per thread block, the port of ``exp/vit_attn_variants.py``'s
  ``flash_gfold`` (an experiment: on no serving route, as in JAX).  K3G
  on CUDA (counted as ``flash_gfold``), ``flash_attention_reference`` on
  the CPU;
- ``flash_attention_padded``: the JAX name for ragged lengths.  The kernel
  masks by bounds, so nothing is padded here;
- ``attention_serving``: the einsum route while both sequences are at most
  ``EINSUM_MAX_SEQ`` long, flash attention past it;
- ``attend_block``, ``combine_partials``, ``finalize_partials``: the
  partials of one KV block, their log-sum-exp merge and normalisation;
- ``attention_trainable``: differentiable attention (a
  ``torch.autograd.Function``).  Its forward is the partials form where
  ``pick_block`` tiles both sequences (``attend_block`` elsewhere), and it
  saves the log-sum-exp; its backward is the FlashAttention-2
  recomputation over KV blocks in f32 torch matmuls, as the JAX custom
  VJP does in ``jnp``.

A row with no visible key has the partials ``(0, NEG_INF, 0)`` here
(JAX's kernel leaves ``l`` counting the masked keys of the tiles it
visited, which depends on its tile size): ``finalize_partials`` gives 0
for it and ``combine_partials`` of it with any real partial returns that
partial.
"""

from __future__ import annotations

import ctypes
import math

import torch

from kubernetes_deep_learning_tpu_torch.ops._counts import LaunchCounts

NEG_INF = -1e30  # large-but-finite: -inf breaks exp(m - m_new) when a row is fully masked

# Sequence length up to which serving attention takes the einsum route; the
# JAX package's rule, kept so both packages route every shape alike.  It
# bounds the (B, H, S, S) f32 scores the einsum route materialises.
EINSUM_MAX_SEQ = 512

KERNEL_HEAD_DIMS = (32, 64, 128)  # head dims K3 is instantiated for

_counts = LaunchCounts("flash_attention", "flash_attention_partials", "flash_gfold")
launch_counts = _counts.snapshot
reset_launch_counts = _counts.reset
credit_launches = _counts.credit
_count = _counts.count


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


def flash_attention_partials_reference(q, k, v, *, causal: bool = False, k_offset: int = 0,
                                       kv_len: int | None = None):
    """The plain version of ``flash_attention(..., return_partials=True)``:
    f32 ``(acc (B,H,Sq,D), m (B,H,Sq), l (B,H,Sq))``, rounded as
    ``flash_attention_reference`` (l sums the f32 p, acc the input-dtype
    p); a row with no visible key is ``(0, NEG_INF, 0)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    vis = _visible(q.shape[-2], k.shape[-2], causal, k_offset, kv_len, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    dead = m <= NEG_INF * 0.5
    return (acc.masked_fill(dead[..., None], 0.0), m.masked_fill(dead, NEG_INF),
            l.masked_fill(dead, 0.0))


def attend_block(q, k, v, *, causal: bool = False, k_offset: int = 0):
    """Unnormalised attention partials of q against one KV block, as the
    JAX einsum form computes them: ``(acc (..., Sq, D), m (..., Sq),
    l (..., Sq))``, all f32; scores from a matmul in the input dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    vis = _visible(q.shape[-2], k.shape[-2], causal, k_offset, None, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return torch.matmul(p, v.float()), m, p.sum(dim=-1)


def combine_partials(a, b):
    """Merge two ``(acc, m, l)`` partials (log-sum-exp over the KV axis)."""
    acc_a, m_a, l_a = a
    acc_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    alpha = torch.exp(m_a - m)
    beta = torch.exp(m_b - m)
    return acc_a * alpha[..., None] + acc_b * beta[..., None], m, l_a * alpha + l_b * beta


def finalize_partials(partial):
    """``(acc, m, l)`` -> normalised output; a row with ``l == 0`` is 0."""
    acc, _, l = partial
    empty = (l == 0.0)[..., None]
    return torch.where(empty, 0.0, acc / torch.where(empty, 1.0, l[..., None]))


# --- kernel wrapper -----------------------------------------------------------


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when K3 can read it in place (unit last stride, rows
    16-byte aligned), else a contiguous copy."""
    per16 = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % per16 == 0 for st in t.stride()[:-1])):
        return t
    return t.contiguous()


def _launch(q, k, v, causal: bool, k_offset: int, kv_len: int, partials: bool,
            pairs: int | None = None):
    """K3 (-> out), K3P (-> (acc, m, l)) or, given ``pairs``, K3G on q's
    current stream."""
    from kubernetes_deep_learning_tpu_torch.ops import _build

    lib = _build.load()
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    tail = (int(q.dtype == torch.bfloat16), ctypes.c_float(1.0 / math.sqrt(d)),
            torch.cuda.current_stream(q.device).cuda_stream)
    args = (b, h, sq, sk, d, *strides, int(causal), k_offset, kv_len, *tail)
    if pairs is not None:
        out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
        code = lib.kdlt_flash_attention_gfold(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, sk, d,
            *strides, pairs, *tail)
        _build.check(lib, code, "flash attention gfold")
        return out
    if partials:
        acc = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
        m, l = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device) for _ in range(2))
        code = lib.kdlt_flash_attention_partials(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), m.data_ptr(),
            l.data_ptr(), *args)
        _build.check(lib, code, "flash attention partials")
        return acc, m, l
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    code = lib.kdlt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args)
    _build.check(lib, code, "flash attention")
    return out


def flash_attention(q, k, v, *, causal: bool = False, k_offset: int = 0,
                    kv_len: int | None = None, return_partials: bool = False):
    """Flash attention, q (B, H, Sq, D), k and v (B, H, Sk, D) -> (B, H, Sq, D).

    ``kv_len``: keys at or past it are masked (valid rows of a padded KV);
    ``k_offset``: global position of k[0] relative to q[0] under ``causal``.
    ``return_partials``: return the f32 ``(acc, m, l)`` of the online
    softmax (``attend_block``'s layout) instead of the normalised output.
    """
    _check_qkv(q, k, v)
    if kv_len is not None and kv_len < 0:
        raise ValueError(f"kv_len must be >= 0, got {kv_len}")
    if q.device.type == "cpu":
        plain = flash_attention_partials_reference if return_partials else flash_attention_reference
        return plain(q, k, v, causal=causal, k_offset=k_offset, kv_len=kv_len)
    sk = k.shape[2]
    out = _launch(q, k, v, causal, k_offset, sk if kv_len is None else min(kv_len, sk),
                  return_partials)
    _count("flash_attention_partials" if return_partials else "flash_attention")
    return out


def flash_gfold(q, k, v, *, g: int):
    """Non-causal flash attention with ``g`` (batch, head) pairs per block
    (K3G), q (B, H, Sq, D), k and v (B, H, Sk, D); ``g`` must divide B*H.
    Unlike the JAX experiment, Sq and Sk need not be tile multiples: the
    kernel masks ragged tiles by bounds."""
    _check_qkv(q, k, v)
    if g < 1 or (q.shape[0] * q.shape[1]) % g:
        raise ValueError(f"g must divide B*H = {q.shape[0] * q.shape[1]}, got {g}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    out = _launch(q, k, v, False, 0, k.shape[2], False, pairs=g)
    _count("flash_gfold")
    return out


def _check_qkv(q, k, v) -> None:
    """Shapes, dtypes and devices the kernels take; raises otherwise."""
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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda" and q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {KERNEL_HEAD_DIMS}, got {q.shape[3]}")


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


# --- trainable attention --------------------------------------------------------


def _finalize_with_lse(partials, dtype):
    """``(acc, m, l)`` -> (normalised out in ``dtype``, lse = m + log l)."""
    _, m, l = partials
    out = finalize_partials(partials).to(dtype)
    return out, m + torch.log(torch.where(l == 0.0, 1.0, l))


def _forward_with_lse(q, k, v, causal: bool):
    """(out, lse): the partials form (K3P on CUDA) where ``pick_block``
    tiles both sequences, else ``attend_block`` -- JAX's routing rule."""
    if pick_block(q.shape[2]) is None or pick_block(k.shape[2]) is None:
        partials = attend_block(q, k, v, causal=causal)
    else:
        partials = flash_attention(q, k, v, causal=causal, return_partials=True)
    return _finalize_with_lse(partials, q.dtype)


def block_grads(q32, k32, v32, lse_q, delta_q, do32_q, scale: float, mask=None):
    """One (q block, kv block) pair of the FlashAttention-2 backward from
    the saved log-sum-exp; all f32, ``mask`` an optional (sq, sk) bool
    visibility mask."""
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse_q[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do32_q)
    dp = torch.matmul(do32_q, v32.transpose(-1, -2))
    ds = p * (dp - delta_q[..., None])
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
    return dq, dk, dv


def _attn_bwd(causal: bool, q, k, v, out, lse, dout):
    """dq, dk, dv: a scan over KV blocks of ``pick_block(sk) or sk`` keys,
    2-D tiled and skipping the pairs above the diagonal under ``causal``."""
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    block = pick_block(sk) or sk
    # One contiguous f32 copy each: q, k and v may be strided (B, S, H, D)
    # views of the projections.
    q32, k32, v32, do32 = (t.float().contiguous() for t in (q, k, v, dout))
    delta = (do32 * out.float()).sum(dim=-1)  # D_i = sum_d dO_i O_i
    dq = torch.zeros_like(q32)
    dk, dv = torch.empty_like(k32), torch.empty_like(v32)
    block_q = (pick_block(sq) or sq) if causal else sq
    for j in range(0, sk, block):
        kj, vj = k32[:, :, j:j + block], v32[:, :, j:j + block]
        dk_j = torch.zeros_like(kj)
        dv_j = torch.zeros_like(vj)
        for i in range(0, sq, block_q):
            # Under causal, query block i sees key block j only if its last
            # row reaches the block's first key.
            if causal and i + block_q <= j:
                continue
            mask = None
            if causal:
                rows = torch.arange(i, i + block_q, device=q.device)[:, None]
                mask = rows >= torch.arange(j, j + block, device=q.device)[None, :]
            rq = slice(i, i + block_q)
            dq_i, dk_i, dv_i = block_grads(q32[:, :, rq], kj, vj, lse[:, :, rq],
                                           delta[:, :, rq], do32[:, :, rq], scale, mask)
            dq[:, :, rq] += dq_i
            dk_j += dk_i
            dv_j += dv_i
        dk[:, :, j:j + block], dv[:, :, j:j + block] = dk_j, dv_j
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _AttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _forward_with_lse(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _attn_bwd(ctx.causal, q, k, v, out, lse, dout)
        return dq, dk, dv, None


def attention_trainable(q, k, v, causal: bool = False):
    """Differentiable attention, (B, H, S, D).  Forward: the partials form
    (K3P on CUDA) and its log-sum-exp; backward: score blocks recomputed
    from (q, k, lse), so no (S, S) matrix is kept between the passes."""
    return _AttentionTrainable.apply(q, k, v, causal)
