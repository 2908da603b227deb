"""Carry weights across: the flax variable tree <-> the port's parameters.

The JAX package stores ``{"params": ..., "batch_stats": ...}`` with flax's
layouts; the port holds a flat ``state_dict``-style mapping of float32
torch tensors keyed by the flax module path joined with dots:

==============================  ==============================  ===========
flax leaf                       port key                        layout
==============================  ==============================  ===========
params/<conv>/kernel  (HWIO)    <conv>.weight                   OIHW
params/<sep>/depthwise/kernel   <sep>.depthwise.weight          (C,1,3,3)
  (3,3,1,C)
params/<dense>/kernel (in,out)  <dense>.weight                  (out,in)
params/<x>/bias                 <x>.bias
params/<bn>/scale               <bn>.weight
batch_stats/<bn>/mean, var      <bn>.running_mean, running_var
params/<dg>/kernel (3-D)        <dg>.kernel                     unchanged
params/pos_embed                pos_embed                       unchanged
==============================  ==============================  ===========

An int8-quantized tree (``ops.quantize``: a kernel leaf
``{_q8, _q8_scale[, _q8_act_scale]}``) loads through
:func:`from_jax_quantized`: the float parameters of its host-dequantized
tree, and each quantized module's int8 weight in the port's layout with
its scales.

``<dg>`` is a ``DenseGeneral`` (ViT's attention projections): its kernel
keeps flax's layout, (C, heads, head_dim) for query/key/value and
(heads, head_dim, C) for out, so the round trip needs no head count.
LayerNorm's scale and bias map like BatchNorm's.  A tree without
``batch_stats`` (ViT) comes back without it.

Also the kernel-ready forms of ``ops/fused_sepconv.py``,
``ops/fused_entry.py`` and ``ops/fused_mbconv.py`` in the JAX package
(``fold_bn``, ``middle_block_weights``, ``sepconv_stage_weights``,
``entry_block_weights``, ``mbconv_block_weights``), with the same math: BN
folded with the Keras epsilon into an f32 scale/shift, depthwise taps
(k,k,C) f32, 1x1 kernels (C_in,C_out) bf16.  ``fold_bn`` takes another
epsilon for a family that has its own (ResNet's 1.001e-5,
``models.resnet.RESNET_BN_EPS``).

The JAX decode lane's parameter tree (``runtime/decode.py``'s
``_build_params``) crosses as it is, through
:func:`from_jax_decode_params`, into ``runtime.decode.DecodeEngine``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from kubernetes_deep_learning_tpu_torch.ops import quantize as quant

# Keras BatchNormalization default epsilon (TF 2.3), needed for logit parity.
KERAS_BN_EPS = 1e-3

_STAT_KEYS = {"mean": "running_mean", "var": "running_var"}
_PARAM_KEYS = {"bias": "bias", "scale": "weight", "pos_embed": "pos_embed"}


def _flatten(tree: dict, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def from_jax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """Flax variable tree (numpy leaves) -> port params (f32 CPU tensors)."""
    out: dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unknown variable collection {collection!r}")
        for path, leaf in _flatten(tree):
            *module, name = path
            if name in (quant.QUANT_KEY, quant.SCALE_KEY, quant.ACT_SCALE_KEY):
                raise ValueError(f"{'/'.join(path)} is an int8-quantized leaf: load a "
                                 "quantized tree with weights.from_jax_quantized")
            arr = np.array(leaf, np.float32)  # a writable copy
            if collection == "batch_stats":
                suffix = _STAT_KEYS.get(name)
            elif name == "kernel" and arr.ndim == 3:  # DenseGeneral: flax layout
                suffix = "kernel"
            elif name == "kernel":
                suffix = "weight"
                if arr.ndim == 4:  # HWIO (depthwise: (3,3,1,C)) -> OIHW / (C,1,3,3)
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:  # Dense (in, out) -> (out, in)
                    arr = arr.T
                else:
                    raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
            else:
                suffix = _PARAM_KEYS.get(name)
            if suffix is None:
                raise ValueError(f"unknown {collection} leaf {'/'.join(path)}")
            out[".".join((*module, suffix))] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


class Int8Leaf(NamedTuple):
    """One quantized module: its int8 weight in the port's layout (OIHW,
    depthwise (C,1,kh,kw), dense (out,in); a 3-D DenseGeneral kernel keeps
    flax's), its f32 per-output-channel scale, and its activation scale
    (None when the leaf is uncalibrated)."""

    weight: torch.Tensor
    scale: torch.Tensor
    act_scale: np.float32 | None


def from_jax_quantized(variables: dict) -> tuple[dict[str, torch.Tensor], dict[str, Int8Leaf]]:
    """A quantized flax tree -> (``from_jax_variables`` of its
    host-dequantized tree, {port module name -> ``Int8Leaf``})."""
    params = from_jax_variables(quant.dequantize_variables_host(variables))
    leaves = {}
    for path, leaf in quant.quantized_leaves(variables).items():
        q = np.array(leaf[quant.QUANT_KEY], np.int8)  # a writable copy (3-D leaves too)
        if q.ndim == 4:
            q = q.transpose(3, 2, 0, 1)
        elif q.ndim == 2:
            q = q.T
        act = leaf.get(quant.ACT_SCALE_KEY)
        leaves[".".join(path)] = Int8Leaf(
            torch.from_numpy(np.ascontiguousarray(q)),
            torch.from_numpy(np.array(leaf[quant.SCALE_KEY], np.float32)),
            None if act is None else np.float32(np.asarray(act)))
    return params, leaves


def to_jax_variables(params: dict[str, torch.Tensor]) -> dict[str, Any]:
    """Inverse of :func:`from_jax_variables` (numpy f32 leaves)."""
    tree: dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, t in params.items():
        *module, suffix = key.split(".")
        arr = t.detach().cpu().float().numpy()
        if suffix in ("running_mean", "running_var"):
            collection, name = "batch_stats", suffix.removeprefix("running_")
        elif suffix == "weight" and arr.ndim in (2, 4):
            collection, name = "params", "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        elif suffix == "weight":
            collection, name = "params", "scale"
        elif suffix in ("bias", "kernel", "pos_embed"):
            collection, name = "params", suffix
        else:
            raise ValueError(f"unknown parameter {key!r}")
        node = tree[collection]
        for m in module:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return {k: v for k, v in tree.items() if v}


DECODE_TOP = ("embed", "pos", "ln_f")
DECODE_LAYER = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


def from_jax_decode_params(params: dict) -> dict:
    """The JAX decode lane's parameter tree (``runtime/decode.py``'s
    ``_build_params``: ``embed``, ``pos``, ``ln_f`` and a list of layers,
    numpy or jax arrays) as the port's ``runtime.decode.DecodeEngine``
    takes it (``params=``): the same tree of float32 CPU tensors, every
    matrix in JAX's (in, out) layout (the port multiplies ``x @ w`` too)."""

    def leaf(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    missing = [k for k in DECODE_TOP if k not in params]
    missing += [f"layers[{i}].{k}" for i, layer in enumerate(params.get("layers", ()))
                for k in DECODE_LAYER if k not in layer]
    if missing or not params.get("layers"):
        raise ValueError(f"not a decode parameter tree: missing {missing or ['layers']}")
    return {**{k: leaf(params[k]) for k in DECODE_TOP},
            "layers": [{k: leaf(layer[k]) for k in DECODE_LAYER} for layer in params["layers"]]}


def fold_bn(params: dict, name: str, eps: float = KERAS_BN_EPS):
    """Inference BN ``name`` -> (scale, shift), f32: y = x * scale + shift."""
    gamma = params[f"{name}.weight"].float()
    beta = params[f"{name}.bias"].float()
    mean = params[f"{name}.running_mean"].float()
    var = params[f"{name}.running_var"].float()
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def _depthwise_taps(params: dict, conv: str) -> torch.Tensor:
    """A depthwise conv's (C,1,k,k) weight as (k,k,C) f32 taps."""
    return params[f"{conv}.weight"].float()[:, 0].permute(1, 2, 0)


def _matrix(params: dict, conv: str) -> torch.Tensor:
    """A 1x1 conv's OIHW weight as a (C_in, C_out) f32 GEMM operand."""
    return params[f"{conv}.weight"].float()[:, :, 0, 0].t()


def middle_block_weights(params: dict, block: str):
    """One middle block's 3 sepconvs stacked for ``fused_sepconv_block``:
    (dw (3,3,3,C) f32, pw (3,C,C) bf16, scale (3,C) f32, shift (3,C) f32)."""
    dws, pws, scales, shifts = [], [], [], []
    for j in (1, 2, 3):
        sep = f"{block}_sepconv{j}"
        scale, shift = fold_bn(params, f"{sep}_bn")
        dws.append(_depthwise_taps(params, f"{sep}.depthwise"))
        pws.append(_matrix(params, f"{sep}.pointwise"))
        scales.append(scale)
        shifts.append(shift)
    return (
        torch.stack(dws).contiguous(),
        torch.stack(pws).to(torch.bfloat16).contiguous(),
        torch.stack(scales).contiguous(),
        torch.stack(shifts).contiguous(),
    )


def sepconv_stage_weights(params: dict, sep_name: str, bn_name: str,
                          pre_relu: bool, post_relu: bool) -> dict:
    """One ``fused_sepconv_chain`` stage (see middle_block_weights)."""
    scale, shift = fold_bn(params, bn_name)
    return {
        "dw": _depthwise_taps(params, f"{sep_name}.depthwise").contiguous(),
        "pw": _matrix(params, f"{sep_name}.pointwise").to(torch.bfloat16).contiguous(),
        "scale": scale.contiguous(),
        "shift": shift.contiguous(),
        "pre_relu": pre_relu,
        "post_relu": post_relu,
    }


def entry_block_weights(params: dict) -> dict[str, torch.Tensor]:
    """Xception's conv2 + block2 for ``fused_entry_block``: conv2 as a
    (9*C_in, C_b) bf16 matrix in HWIO order (taps (dh, dw)-major, the TPU
    kernel's im2col order), res, pw1, pw2 (C_in, C_out) bf16, dw1 and dw2
    (3,3,C) f32 taps, and the folded BN pairs conv2_s/_b (block1_conv2_bn),
    res_s/_b, bn1_s/_b, bn2_s/_b (block2's) in f32."""
    conv2 = params["block1_conv2.weight"].float().permute(2, 3, 1, 0)  # OIHW -> HWIO
    w = {"conv2": conv2.reshape(-1, conv2.shape[-1]).to(torch.bfloat16)}
    w["conv2_s"], w["conv2_b"] = fold_bn(params, "block1_conv2_bn")
    w["res"] = _matrix(params, "block2_res_conv").to(torch.bfloat16)
    w["res_s"], w["res_b"] = fold_bn(params, "block2_res_bn")
    for j in (1, 2):
        sep = f"block2_sepconv{j}"
        w[f"dw{j}"] = _depthwise_taps(params, f"{sep}.depthwise")
        w[f"pw{j}"] = _matrix(params, f"{sep}.pointwise").to(torch.bfloat16)
        w[f"bn{j}_s"], w[f"bn{j}_b"] = fold_bn(params, f"{sep}_bn")
    return {k: v.contiguous() for k, v in w.items()}


def mbconv_block_weights(params: dict, block: str) -> dict[str, torch.Tensor]:
    """One stride-1 MBConv block (``models.efficientnet.MBConvBlock``) for
    ``fused_mbconv_block``: expand_w (C_in,C_mid), se_r_w (C_mid,S), se_e_w
    (S,C_mid), proj_w (C_mid,C_out) bf16; dw (k,k,C_mid) f32; the folded BN
    scale/shift pairs expand_s/_b, dw_s/_b, proj_s/_b and the SE biases
    se_r_b, se_e_b in f32."""
    exp_s, exp_b = fold_bn(params, f"{block}.expand_bn")
    dw_s, dw_b = fold_bn(params, f"{block}.dw_bn")
    pr_s, pr_b = fold_bn(params, f"{block}.project_bn")
    bf16 = torch.bfloat16
    w = {
        "expand_w": _matrix(params, f"{block}.expand_conv").to(bf16),
        "expand_s": exp_s,
        "expand_b": exp_b,
        "dw": _depthwise_taps(params, f"{block}.dwconv"),
        "dw_s": dw_s,
        "dw_b": dw_b,
        "se_r_w": _matrix(params, f"{block}.se.reduce").to(bf16),
        "se_r_b": params[f"{block}.se.reduce.bias"].float(),
        "se_e_w": _matrix(params, f"{block}.se.expand").to(bf16),
        "se_e_b": params[f"{block}.se.expand.bias"].float(),
        "proj_w": _matrix(params, f"{block}.project_conv").to(bf16),
        "proj_s": pr_s,
        "proj_b": pr_b,
    }
    return {k: v.contiguous() for k, v in w.items()}
