"""The port's fused sepconv stages against the JAX package's.

On the CPU the port's wrappers compute their plain PyTorch versions; these
are held against the JAX reference (``sepconv_block_reference``) and the
Pallas kernels in interpret mode, on the same numpy-made inputs, with the
JAX tests' tolerance (rel < 2e-2: bf16 rounding of the depthwise result
and of each stage's output, summed in different orders).  The CUDA kernel
itself is held against the plain version in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.ops import fused_sepconv as jax_ops
from kubernetes_deep_learning_tpu_torch import weights
from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv as ops
from torch_threads import one_torch_thread  # noqa: F401


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _bf16(a: np.ndarray) -> tuple[jax.Array, torch.Tensor]:
    """The same bf16 values for both frameworks."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _block_weights(rng, c):
    dw = rng.normal(0, 0.2, (3, 3, 3, c)).astype(np.float32)
    pw_j, pw_t = _bf16(rng.normal(0, 0.05, (3, c, c)))
    s = rng.uniform(0.8, 1.2, (3, c)).astype(np.float32)
    b = rng.normal(0, 0.1, (3, c)).astype(np.float32)
    return (jnp.asarray(dw), pw_j, jnp.asarray(s), jnp.asarray(b)), (
        torch.from_numpy(dw), pw_t, torch.from_numpy(s), torch.from_numpy(b)
    )


@pytest.mark.parametrize(
    "shape",
    [(4, 6, 6, 256), (2, 5, 7, 128), (1, 6, 6, 128), (3, 6, 6, 128), (6, 6, 6, 128)],
)
def test_block_matches_jax(shape):
    rng = np.random.default_rng(0)
    x_j, x_t = _bf16(rng.normal(0, 1, shape))
    wj, wt = _block_weights(rng, shape[-1])
    got = ops.fused_sepconv_block(x_t, *wt).float().numpy()
    assert got.shape == shape
    want_ref = jax_ops.sepconv_block_reference(x_j, *wj)
    assert _rel(got, want_ref) < 2e-2
    want_kernel = jax.jit(lambda *a: jax_ops.fused_sepconv_block(*a, interpret=True))(x_j, *wj)
    assert _rel(got, want_kernel) < 2e-2


def _stage(rng, c_in, c_out, pre, post):
    dw = rng.normal(0, 0.2, (3, 3, c_in)).astype(np.float32)
    pw_j, pw_t = _bf16(rng.normal(0, c_in ** -0.5, (c_in, c_out)))
    s = rng.uniform(0.8, 1.2, c_out).astype(np.float32)
    b = rng.normal(0, 0.1, c_out).astype(np.float32)
    j = dict(dw=jnp.asarray(dw), pw=pw_j, scale=jnp.asarray(s), shift=jnp.asarray(b),
             pre_relu=pre, post_relu=post)
    t = dict(dw=torch.from_numpy(dw), pw=pw_t, scale=torch.from_numpy(s),
             shift=torch.from_numpy(b), pre_relu=pre, post_relu=post)
    return j, t


@pytest.mark.parametrize(
    "batch,hw,widths,pre,post",
    [
        (2, 6, (128, 128, 256), True, False),   # block13 pattern, width grows
        (3, 3, (256, 384, 512), False, True),   # block14 pattern
        (1, 5, (128, 256), True, False),
    ],
)
def test_chain_matches_jax(batch, hw, widths, pre, post):
    rng = np.random.default_rng(1)
    x_j, x_t = _bf16(rng.normal(0, 1, (batch, hw, hw, widths[0])))
    stages = [_stage(rng, a, b, pre, post) for a, b in zip(widths, widths[1:])]
    got = ops.fused_sepconv_chain(x_t, [t for _, t in stages]).float().numpy()
    assert got.shape == (batch, hw, hw, widths[-1])
    want = jax.jit(
        lambda xt: jax_ops.fused_sepconv_chain_t(xt, [j for j, _ in stages], interpret=True)
    )(x_j.transpose(1, 2, 0, 3)).transpose(2, 0, 1, 3)
    assert _rel(got, want) < 2e-2


@pytest.fixture(scope="module")
def xception_variables():
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.models import init_variables

    spec = ModelSpec(name="w", family="xception", input_shape=(96, 96, 3), labels=("a", "b"))
    return init_variables(spec, seed=7)


def test_fold_bn_matches_jax(xception_variables):
    v = xception_variables
    p = weights.from_jax_variables(v)
    name = "block5_sepconv2_bn"
    want = jax_ops.fold_bn(v["params"][name], v["batch_stats"][name])
    got = weights.fold_bn(p, name)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    bad, _ = weights.fold_bn(p, name, eps=1e-5)  # the Keras epsilon, not torch's
    assert not np.allclose(bad.numpy(), got[0].numpy())


def test_middle_block_weights_match_jax(xception_variables):
    v = xception_variables
    want = jax_ops.middle_block_weights(v["params"], v["batch_stats"], "block7")
    got = weights.middle_block_weights(weights.from_jax_variables(v), "block7")
    assert [tuple(g.shape) for g in got] == [(3, 3, 3, 728), (3, 728, 728), (3, 728), (3, 728)]
    assert got[1].dtype == torch.bfloat16 and got[0].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "sep,pre,post",
    [("block13_sepconv2", True, False), ("block14_sepconv1", False, True)],
)
def test_sepconv_stage_weights_match_jax(xception_variables, sep, pre, post):
    v = xception_variables
    want = jax_ops.sepconv_stage_weights(v["params"], v["batch_stats"], sep, f"{sep}_bn", pre, post)
    got = weights.sepconv_stage_weights(weights.from_jax_variables(v), sep, f"{sep}_bn", pre, post)
    assert got["pre_relu"] == pre and got["post_relu"] == post
    for k in ("dw", "pw", "scale", "shift"):
        np.testing.assert_allclose(
            got[k].float().numpy(), np.asarray(want[k], np.float32), rtol=1e-6, atol=1e-7
        )


def test_cpu_path_does_not_count_launches():
    rng = np.random.default_rng(2)
    _, x = _bf16(rng.normal(0, 1, (1, 4, 4, 32)))
    _, w = _block_weights(rng, 32)
    ops.reset_launch_counts()
    ops.fused_sepconv_block(x, *w)
    assert ops.launch_counts() == {"fused_sepconv_block": 0, "fused_sepconv_chain": 0}


def test_wrappers_reject_bad_operands():
    rng = np.random.default_rng(3)
    _, x = _bf16(rng.normal(0, 1, (1, 4, 4, 32)))
    _, (dw, pw, s, b) = _block_weights(rng, 32)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.fused_sepconv_block(x.float(), dw, pw, s, b)
    with pytest.raises(ValueError, match="dw must be"):
        ops.fused_sepconv_block(x, dw[:, :2], pw, s, b)
    with pytest.raises(ValueError, match="pw must be"):
        ops.fused_sepconv_chain(x, [dict(dw=dw[0], pw=pw[0, :16], scale=s[0], shift=b[0],
                                         pre_relu=True, post_relu=False)])
    with pytest.raises(ValueError, match="empty chain"):
        ops.fused_sepconv_chain(x, [])


@pytest.mark.parametrize("shape", [(2, 5, 7, 128), (3, 6, 6, 32)])
def test_prepared_block_stages_are_bit_equal_to_the_stacked_form(shape):
    """``prepare_block``'s stage views, checked once, give the stacked-weight
    call's bits (the forward's per-call path against ``fused_sepconv_block``
    and ``sepconv_block_reference``)."""
    rng = np.random.default_rng(4)
    _, x = _bf16(rng.normal(0, 1, shape))
    _, w = _block_weights(rng, shape[-1])
    stages = ops.prepare_block(*w)
    assert len(stages) == 3 and all(s["pre_relu"] and not s["post_relu"] for s in stages)
    assert all(s["pw"].data_ptr() == w[1][i].data_ptr() for i, s in enumerate(stages))  # views
    got = ops.fused_sepconv_block_stages(x, stages)
    assert torch.equal(got, ops.fused_sepconv_block(x, *w))
    assert torch.equal(got, ops.sepconv_block_reference(x, *w))


def test_prepared_block_checks_once_and_the_call_checks_x():
    rng = np.random.default_rng(5)
    _, x = _bf16(rng.normal(0, 1, (1, 4, 4, 32)))
    _, (dw, pw, s, b) = _block_weights(rng, 32)
    with pytest.raises(ValueError, match="dw must be"):
        ops.prepare_block(dw[:, :2], pw, s, b)
    with pytest.raises(ValueError, match="exactly 3"):
        ops.prepare_block(dw[:2], pw[:2], s[:2], b[:2])
    stages = ops.prepare_block(dw, pw, s, b)
    with pytest.raises(ValueError, match="32 channels"):
        ops.fused_sepconv_block_stages(x[..., :16], stages)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.fused_sepconv_block_stages(x.float(), stages)
