"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these skip where there is no GPU (a CUDA kernel has no CPU
mode).  The file imports no JAX, so it also runs on a GPU machine without
it:  ``python -m pytest tests/test_torch_cuda.py -q``.  Tolerance: relative
max error < 2e-2 (bf16 roundings of the same values, summed in another
order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv as ops


def _rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


def _t(rng, shape, std=1.0, dtype=torch.float32):
    return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)).to(dtype).to("cuda")


def _stage(rng, c_in, c_out, pre, post):
    return dict(dw=_t(rng, (3, 3, c_in), 0.2), pw=_t(rng, (c_in, c_out), c_in ** -0.5, torch.bfloat16),
                scale=_t(rng, (c_out,), 0.1) + 1.0, shift=_t(rng, (c_out,), 0.1),
                pre_relu=pre, post_relu=post)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_cuda_kernels_match_plain_versions(batch):
    """The hand-written kernel against its plain version at the main path's
    widths (middle 19x19x728; exit chains 728->728->1024, 1024->1536->2048)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(batch)
    x = _t(rng, (batch, 19, 19, 728), dtype=torch.bfloat16)
    st = [_stage(rng, 728, 728, True, False) for _ in range(3)]
    w = (torch.stack([s["dw"] for s in st]), torch.stack([s["pw"] for s in st]),
         torch.stack([s["scale"] for s in st]), torch.stack([s["shift"] for s in st]))
    ops.reset_launch_counts()
    got = ops.fused_sepconv_block(x, *w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_sepconv_block"] == 1
    assert _rel(got, ops.sepconv_block_reference(x, *w)) < 2e-2
    for hw, widths, pre, post in ((19, (728, 728, 1024), True, False),
                                  (10, (1024, 1536, 2048), False, True)):
        xc = _t(rng, (batch, hw, hw, widths[0]), dtype=torch.bfloat16)
        stages = [_stage(rng, a, b, pre, post) for a, b in zip(widths, widths[1:])]
        got = ops.fused_sepconv_chain(xc, stages)
        torch.cuda.synchronize()
        assert _rel(got, ops.sepconv_chain_reference(xc, stages)) < 2e-2
    assert ops.launch_counts()["fused_sepconv_chain"] == 2


@pytest.mark.cuda
def test_cuda_kernel_ragged_shapes():
    """Widths that are not multiples of the tiles (K, N, pixels masked)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    x = _t(rng, (3, 5, 7, 40), dtype=torch.bfloat16)
    stages = [_stage(rng, 40, 200, True, True), _stage(rng, 200, 24, False, False)]
    got = ops.fused_sepconv_chain(x, stages)
    torch.cuda.synchronize()
    assert _rel(got, ops.sepconv_chain_reference(x, stages)) < 2e-2
