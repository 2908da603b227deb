"""Golden-logit verification: the reference's correctness baseline as a tool
(the port of ``golden.py``).

The reference's only correctness artifact is a human-checked score dict for
one test image ("score for pants is the highest", reference guide.md:623-629)
-- the expected logits below are transcribed from reference guide.md:623-625
(see BASELINE.md).  This CLI makes that check executable: given the
transfer-learned Keras weights (``xception_v4_large_08_0.894.h5``, obtained
out-of-band per reference guide.md:176) and the pants test image, it imports
the weights (``models.keras_import``, no h5py), runs the port's engine on
the exact float32 graph, then on the served configuration (bfloat16 with
``fast="auto"``: on the card, the stage kernels K1/K2), and asserts every
logit within tolerance.

Run against a live stack instead with ``--gateway`` to check the full
HTTP path (gateway -> model server) rather than the engine in-process.

CLI (``kdlt-torch-verify-golden``; exit 1 on any failure)::

    kdlt-torch-verify-golden --weights xception_v4_large_08_0.894.h5 --image pants.jpg
    kdlt-torch-verify-golden --gateway http://localhost:9696 --image-url <url>
"""

from __future__ import annotations

import argparse
import sys

# Transcribed from reference guide.md:623-625 (and BASELINE.md).
GOLDEN_LOGITS = {
    "dress": -1.868,
    "hat": -4.761,
    "longsleeve": -2.316,
    "outwear": -1.062,
    "pants": 9.887,
    "shirt": -2.812,
    "shoes": -3.666,
    "shorts": 3.200,
    "skirt": -2.602,
    "t-shirt": -4.835,
}


def check_scores(scores: dict, atol: float) -> list[str]:
    """Compare a {label: logit} dict to the golden values; return failures."""
    failures = []
    for label, want in GOLDEN_LOGITS.items():
        got = scores.get(label)
        if got is None:
            failures.append(f"{label}: missing from response")
        elif abs(got - want) > atol:
            failures.append(f"{label}: got {got:.3f}, want {want:.3f} (atol {atol})")
    top = max(scores, key=scores.get) if scores else None
    if top != "pants":
        failures.append(f"top-1 is {top!r}, want 'pants' (reference guide.md:628)")
    return failures


def _engine_scores(spec, variables, image, compute_dtype: str, fast, device: str) -> dict:
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.runtime.engine import InferenceEngine

    engine = InferenceEngine(
        art.ModelArtifact(spec, variables, {"compute_dtype": compute_dtype},
                          path="<in-memory>/1"),
        buckets=(1,), device=device, fast=fast)
    try:
        return engine.predict_scores(image[None])[0]
    finally:
        engine.close()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="verify the reference golden logits (the "
                                "PyTorch port's engine)")
    p.add_argument("--image", help="local path to the pants test image")
    p.add_argument("--weights", help="Keras .h5 weights (engine-level check)")
    p.add_argument("--gateway", help="gateway URL (full-stack check instead)")
    p.add_argument("--image-url", help="image URL for the gateway check")
    p.add_argument("--atol", type=float, default=0.05,
                   help="per-logit absolute tolerance (bf16 serving: try 0.2)")
    p.add_argument("--served-atol", type=float, default=0.2,
                   help="tolerance for the served-configuration check "
                        "(bf16 + fused fast path where available)")
    p.add_argument("--skip-served", action="store_true",
                   help="only check the exact f32 graph")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    if args.gateway:
        if not args.image_url:
            p.error("--gateway needs --image-url")
        from kubernetes_deep_learning_tpu_torch.serving.client import predict_url

        scores = predict_url(args.gateway, args.image_url)
    else:
        if not (args.weights and args.image):
            p.error("engine check needs --weights and --image")
        from kubernetes_deep_learning_tpu_torch.modelspec import get_spec
        from kubernetes_deep_learning_tpu_torch.models.keras_import import load_keras_h5
        from kubernetes_deep_learning_tpu_torch.ops import preprocess

        spec = get_spec("clothing-model")
        variables = load_keras_h5(spec, args.weights)
        with open(args.image, "rb") as f:
            image = preprocess.preprocess_bytes(f.read(), spec.input_shape[:2],
                                                filter=spec.resize_filter)
        # fast=False: golden parity checks the exact float32 graph first (the
        # reference-parity gate proper)...
        scores = _engine_scores(spec, variables, image, "float32", False, args.device)

    print("scores:", {k: round(v, 3) for k, v in sorted(scores.items())})
    failures = check_scores(scores, args.atol)
    if failures:
        for f in failures:
            print("FAIL", f, file=sys.stderr)
        return 1
    print(f"OK: all {len(GOLDEN_LOGITS)} logits within atol={args.atol}, top-1 pants")

    if not args.gateway and not args.skip_served:
        # ...and then the configuration actually SERVED: bf16 compute with
        # fast="auto", which on the card is the fused stage kernels (K1/K2).
        served_scores = _engine_scores(spec, variables, image, "bfloat16", "auto", args.device)
        print("served-config scores:",
              {k: round(v, 3) for k, v in sorted(served_scores.items())})
        served_failures = check_scores(served_scores, args.served_atol)
        if served_failures:
            for f in served_failures:
                print("FAIL (served config)", f, file=sys.stderr)
            return 1
        print(f"OK: served config (bf16, fast=auto) within atol={args.served_atol}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
