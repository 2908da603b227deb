"""Import Keras .h5 weights into the flax variable tree (the port of
``models/keras_import.py``).

The reference's model artifact is a Keras .h5 (``xception_v4_large_08_0.894.h5``,
reference guide.md:176) which ``convert.py`` re-saves as a TF SavedModel.  Here
the equivalent step loads that .h5 **directly** into the flax variable tree
of numpy arrays that ``weights.from_jax_variables`` takes -- no TensorFlow
and no ``h5py`` in the loop: the file is read by ``h5lite``, the port's
reader of the HDF5 subset Keras writes.  The functions below are the JAX
module's, with the same naming rules; the structure check holds the tree
against the shapes the port's own module declares.

Keras layer names are preserved by the models for named layers
(block1_conv1, ...); layers Keras auto-names (the four residual 1x1 convs and
their BatchNorms, and the head Dense layers) are matched structurally by
weight shape, which is unique per site in Xception.  ResNet50 imports are a
purely syntactic rename (keras.applications names are flat, ours nest the
identical components).
"""

from __future__ import annotations

import re

import numpy as np

from kubernetes_deep_learning_tpu_torch.h5lite import read_keras_h5  # noqa: F401 (JAX's name)
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec

# Residual 1x1 conv kernel shape -> our module name (unique per site).
_XCEPTION_RES_CONVS = {
    (1, 1, 64, 128): "block2_res_conv",
    (1, 1, 128, 256): "block3_res_conv",
    (1, 1, 256, 728): "block4_res_conv",
    (1, 1, 728, 1024): "block13_res_conv",
}
# Residual BatchNorm channel count -> our module name.
_XCEPTION_RES_BNS = {128: "block2_res_bn", 256: "block3_res_bn", 728: "block4_res_bn", 1024: "block13_res_bn"}


def _bn(layer: dict[str, np.ndarray]):
    params = {"scale": layer["gamma"], "bias": layer["beta"]}
    stats = {"mean": layer["moving_mean"], "var": layer["moving_variance"]}
    return params, stats


def _sepconv(layer: dict[str, np.ndarray]):
    dw = layer["depthwise_kernel"]  # keras (kh, kw, c_in, 1)
    pw = layer["pointwise_kernel"]  # (1, 1, c_in, c_out)
    return {
        "depthwise": {"kernel": np.transpose(dw, (0, 1, 3, 2))},  # flax (kh, kw, 1, c_in)
        "pointwise": {"kernel": pw},
    }


def _dense_layers_in_order(layers: dict[str, dict[str, np.ndarray]]):
    """Auto-named head Dense layers (dense, dense_1, ...) in creation order."""
    found = []
    for name, w in layers.items():
        m = re.fullmatch(r"dense(?:_(\d+))?", name)
        if m and "kernel" in w and w["kernel"].ndim == 2:
            found.append((int(m.group(1) or 0), name, w))
    return [(name, w) for _, name, w in sorted(found)]


def _head_from_denses(spec: ModelSpec, layers: dict[str, dict[str, np.ndarray]]):
    """Build the ClassifierHead params from the .h5's Dense layers.

    Auto-named chains (dense, dense_1, ...) map in creation order, last one
    = logits; otherwise a single Dense under any name (Keras calls the
    ImageNet head "predictions") is the logits layer.  Validates hidden
    sizes and class count against the spec so mismatched artifacts fail
    with a clear message, not a structure diff.
    """
    denses = _dense_layers_in_order(layers)
    if not denses:
        others = [
            (n, w) for n, w in layers.items()
            if "kernel" in w and w["kernel"].ndim == 2
        ]
        if len(others) != 1:
            raise ValueError(
                "no Dense head layers found in .h5"
                if not others
                else f"ambiguous head Dense layers: {[n for n, _ in others]}"
            )
        denses = others
    head: dict = {}
    *hidden, (_, logits_w) = denses
    for i, (_, w) in enumerate(hidden):
        head[f"hidden_{i}"] = {"kernel": w["kernel"], "bias": w["bias"]}
    head["logits"] = {"kernel": logits_w["kernel"], "bias": logits_w["bias"]}

    hidden_sizes = tuple(w["kernel"].shape[1] for _, w in hidden)
    if hidden_sizes != spec.head_hidden:
        raise ValueError(
            f".h5 head hidden sizes {hidden_sizes} do not match spec "
            f"{spec.head_hidden}; fix the ModelSpec to match the artifact"
        )
    if logits_w["kernel"].shape[1] != spec.num_classes:
        raise ValueError(
            f".h5 logits width {logits_w['kernel'].shape[1]} != "
            f"{spec.num_classes} labels"
        )
    return head


def xception_variables_from_keras(
    spec: ModelSpec, layers: dict[str, dict[str, np.ndarray]]
):
    """Build flax variables for the Xception family from Keras weights."""
    params: dict = {}
    stats: dict = {}

    def put_bn(name: str, layer):
        p, s = _bn(layer)
        params[name] = p
        stats[name] = s

    # Explicitly-named Keras layers map one-to-one.
    for name, w in layers.items():
        if re.fullmatch(r"block\d+_conv\d", name):
            params[name] = {"kernel": w["kernel"]}
        elif re.fullmatch(r"block\d+_sepconv\d", name):
            params[name] = _sepconv(w)
        elif re.fullmatch(r"block\d+_(conv|sepconv)\d_bn", name):
            put_bn(name, w)

    # Auto-named residual convs + BNs: match by shape (unique per site).
    for name, w in layers.items():
        if "kernel" in w and w["kernel"].ndim == 4 and w["kernel"].shape in _XCEPTION_RES_CONVS:
            params[_XCEPTION_RES_CONVS[w["kernel"].shape]] = {"kernel": w["kernel"]}
        elif "gamma" in w and not name.startswith("block"):
            channels = w["gamma"].shape[0]
            target = _XCEPTION_RES_BNS.get(channels)
            if target is not None:
                put_bn(target, w)

    # Head: auto-named Dense layers in creation order; last one is logits.
    params["head"] = _head_from_denses(spec, layers)

    variables = {"params": params, "batch_stats": stats}
    _check_structure(spec, variables)
    return variables


_RESNET_CONV_RE = re.compile(r"(conv\d_block\d+)_(\d)_conv")
_RESNET_BN_RE = re.compile(r"(conv\d_block\d+)_(\d)_bn")


def resnet50_variables_from_keras(
    spec: ModelSpec, layers: dict[str, dict[str, np.ndarray]]
):
    """Build flax variables for ResNet50 from Keras weights.

    keras.applications.ResNet50 names are flat (``conv2_block1_1_conv``);
    our module nests the same names (``conv2_block1/1_conv``), so the map is
    purely syntactic -- no shape-based matching needed.
    """
    params: dict = {}
    stats: dict = {}

    def put_bn(block: str | None, name: str, layer):
        p, s = _bn(layer)
        if block is None:
            params[name] = p
            stats[name] = s
        else:
            params.setdefault(block, {})[name] = p
            stats.setdefault(block, {})[name] = s

    for name, w in layers.items():
        if name == "conv1_conv":
            params[name] = {"kernel": w["kernel"], "bias": w["bias"]}
        elif name == "conv1_bn":
            put_bn(None, name, w)
        elif m := _RESNET_CONV_RE.fullmatch(name):
            params.setdefault(m.group(1), {})[f"{m.group(2)}_conv"] = {
                "kernel": w["kernel"], "bias": w["bias"]
            }
        elif m := _RESNET_BN_RE.fullmatch(name):
            put_bn(m.group(1), f"{m.group(2)}_bn", w)

    # Head: "predictions" (stock ImageNet) or a dense/dense_1/... fine-tuned
    # chain -- same handling as xception, including head_hidden support.
    params["head"] = _head_from_denses(spec, layers)

    variables = {"params": params, "batch_stats": stats}
    _check_structure(spec, variables)
    return variables


_EFF_BLOCK_RE = re.compile(
    r"block(\d+)([a-z])_"
    r"(expand_conv|expand_bn|dwconv|bn|se_reduce|se_expand|project_conv|project_bn)"
)


def efficientnet_variables_from_keras(
    spec: ModelSpec, layers: dict[str, dict[str, np.ndarray]]
):
    """Build flax variables for the EfficientNet family from Keras weights.

    keras.applications.EfficientNetB* names blocks ``block{stage}{letter}_*``
    (block1a, block1b, block2a, ...); our module numbers them flat in the same
    creation order (block0, block1, ...), so sorting the Keras names by
    (stage, letter) and zipping is an exact rename.  The depthwise kernel
    transposes (kh,kw,c,1) -> (kh,kw,1,c) as in ``_sepconv``; Keras's dw
    BatchNorm is named bare ``_bn`` where ours is ``dw_bn``.

    keras.applications builds Rescaling+Normalization INTO the model; those
    layers are skipped here because the framework normalizes outside the
    model (ops.preprocess), so the spec must say ``preprocessing="torch"``
    (the equivalent recipe) or logits will not match the Keras model.
    """
    # Keras auto-numbers repeated layer instances (normalization_1, ...) when
    # several models were built in one session before saving.
    has_norm = any(
        n == "normalization" or n.startswith("normalization_") for n in layers
    )
    if has_norm and spec.preprocessing != "torch":
        raise ValueError(
            ".h5 contains a keras Normalization layer (EfficientNet-style "
            "built-in preprocessing) but the spec's preprocessing is "
            f"{spec.preprocessing!r}; use 'torch' for logit parity"
        )

    params: dict = {}
    stats: dict = {}

    def put_bn(tree_p, tree_s, name: str, layer):
        p, s = _bn(layer)
        tree_p[name] = p
        tree_s[name] = s

    params["stem_conv"] = {"kernel": layers["stem_conv"]["kernel"]}
    put_bn(params, stats, "stem_bn", layers["stem_bn"])
    params["top_conv"] = {"kernel": layers["top_conv"]["kernel"]}
    put_bn(params, stats, "top_bn", layers["top_bn"])

    blocks: dict[tuple[int, str], dict[str, dict[str, np.ndarray]]] = {}
    for name, w in layers.items():
        if m := _EFF_BLOCK_RE.fullmatch(name):
            blocks.setdefault((int(m.group(1)), m.group(2)), {})[m.group(3)] = w

    for i, key in enumerate(sorted(blocks)):
        sub = blocks[key]
        bp: dict = {}
        bs: dict = {}
        if "expand_conv" in sub:
            bp["expand_conv"] = {"kernel": sub["expand_conv"]["kernel"]}
            put_bn(bp, bs, "expand_bn", sub["expand_bn"])
        dw = sub["dwconv"]["depthwise_kernel"]  # keras (kh, kw, c, 1)
        bp["dwconv"] = {"kernel": np.transpose(dw, (0, 1, 3, 2))}
        put_bn(bp, bs, "dw_bn", sub["bn"])
        if "se_reduce" in sub:
            bp["se"] = {
                "reduce": {
                    "kernel": sub["se_reduce"]["kernel"],
                    "bias": sub["se_reduce"]["bias"],
                },
                "expand": {
                    "kernel": sub["se_expand"]["kernel"],
                    "bias": sub["se_expand"]["bias"],
                },
            }
        bp["project_conv"] = {"kernel": sub["project_conv"]["kernel"]}
        put_bn(bp, bs, "project_bn", sub["project_bn"])
        params[f"block{i}"] = bp
        stats[f"block{i}"] = bs

    params["head"] = _head_from_denses(spec, layers)

    variables = {"params": params, "batch_stats": stats}
    _check_structure(spec, variables)
    return variables


def _keystr(path: tuple[str, ...]) -> str:
    """A leaf's path as ``jax.tree_util.keystr`` spells a dict path."""
    return "".join(f"[{k!r}]" for k in path)


def _leaf_shapes(tree, path: tuple[str, ...] = ()) -> dict[str, tuple[int, ...]]:
    out: dict[str, tuple[int, ...]] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_shapes(v, (*path, k)))
        else:
            out[_keystr((*path, k))] = tuple(np.shape(v))
    return out


def expected_shapes(spec: ModelSpec) -> dict[str, tuple[int, ...]]:
    """The flax tree's leaf shapes for ``spec``, keyed as ``keystr``: the
    port's module built on the meta device (no weights made), mapped to the
    flax layout by ``weights.to_jax_variables`` as ``models.init_variables``
    maps it."""
    import torch

    from kubernetes_deep_learning_tpu_torch.models import create_model
    from kubernetes_deep_learning_tpu_torch.weights import to_jax_variables

    with torch.device("meta"):
        model = create_model(spec)
    empty = {k: torch.empty(t.shape) for k, t in model.state_dict().items()}
    return _leaf_shapes(to_jax_variables(empty))


def _check_structure(spec: ModelSpec, variables) -> None:
    """Verify the imported tree matches the port's module structure."""
    exp_map = expected_shapes(spec)
    got_map = _leaf_shapes(variables)
    missing = sorted(set(exp_map) - set(got_map))
    extra = sorted(set(got_map) - set(exp_map))
    bad = [k for k in exp_map.keys() & got_map.keys() if tuple(exp_map[k]) != tuple(got_map[k])]
    if missing or extra or bad:
        raise ValueError(
            "imported Keras weights do not match model structure:\n"
            f"  missing: {missing[:10]}\n  unexpected: {extra[:10]}\n"
            f"  shape mismatch: {[(k, exp_map[k], got_map[k]) for k in bad[:10]]}"
        )


def load_keras_h5(spec: ModelSpec, path: str):
    """One-call import: .h5 file -> flax variables (numpy) for ``spec``."""
    layers = read_keras_h5(path)
    if spec.family == "xception":
        return xception_variables_from_keras(spec, layers)
    if spec.family == "resnet50":
        return resnet50_variables_from_keras(spec, layers)
    if spec.family.startswith("efficientnet-"):
        return efficientnet_variables_from_keras(spec, layers)
    raise NotImplementedError(f"Keras import not implemented for {spec.family!r}")
