"""Gateway <-> model-server wire protocol (the tensor wire).

The port's own copy of the JAX package's ``serving/protocol.py`` tensor
wire, byte-compatible with it: msgpack bodies carrying raw little-endian
tensor bytes (``{"inputs": {"shape", "dtype", "data"}}`` in,
``{"outputs": ..., "labels": [...]}`` out), or the TF-Serving-style JSON
fallback (``{"instances": ...}`` in, ``{"predictions": [{label: score}]}``
out).  msgpack goes through ``msgpack_lite``, so the wire needs no
third-party package.  Error replies are JSON ``{"error": ...}`` bodies, and
a 503 carries ``Retry-After`` in the JAX admission package's format
(``retry_after_headers``, re-exported by ``serving.admission``), which the
gateway copies into its own reply.  The priority header and its bounded
class set are the JAX protocol's.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from kubernetes_deep_learning_tpu_torch import msgpack_lite

MSGPACK_CONTENT_TYPE = "application/x-msgpack"
JSON_CONTENT_TYPE = "application/json"

# The model tier stamps every 200 :predict reply with the serving
# artifact's sha256 identity (serving.registry.artifact_hash).  The JAX
# gateway's response cache keys validity on it: a hot reload that changes
# the bytes changes the hash and drops that model's entries, while a
# version bump with identical bytes keeps them.
ARTIFACT_HASH_HEADER = "X-Kdlt-Artifact-Hash"

# A model-tier 503 carrying this header declares a terminal dispatch
# stall (the engine watchdog fired: /healthz is failing, only a restart
# recovers).  The gateway's upstream pool takes the replica out of
# rotation IMMEDIATELY on seeing it -- unlike an overload 503, which is
# transient evidence that takes consecutive failures to act on.
STALLED_HEADER = "X-Kdlt-Stalled"

RETRY_AFTER_HEADER = "Retry-After"
# The stall 503's hint: another replica is the retry, not this one.  The
# overload 503's hint is the admission limiter's, derived from live state
# (``serving.admission``).
STALL_RETRY_AFTER_S = 1.0

# Request priority class (DAGOR-style bounded set), propagated client ->
# gateway -> model tier so admission sheds the lowest class first.  The
# set is closed: an unknown or absent header value falls back to the
# default, so the ``class`` metric label stays bounded whatever a caller
# sends.
PRIORITY_HEADER = "X-Kdlt-Priority"
PRIORITY_CLASSES = ("interactive", "batch", "best-effort")
DEFAULT_PRIORITY = "interactive"
# Shed order: HIGHER rank sheds first (best-effort before batch before
# interactive); grant order is the reverse.
PRIORITY_RANK = {name: rank for rank, name in enumerate(PRIORITY_CLASSES)}

# The Prometheus text exposition the JAX server's /metrics answers with.
METRICS_CONTENT_TYPE = "text/plain"


def retry_after_headers(retry_after_s: float | None) -> dict[str, str]:
    """``Retry-After`` as decimal seconds with three places, as the JAX
    server writes it (fractional: the gateway and the client parse a float)."""
    if retry_after_s is None:
        return {}
    return {RETRY_AFTER_HEADER: f"{max(0.0, retry_after_s):.3f}"}


def parse_priority(raw: str | None) -> str:
    """An ``X-Kdlt-Priority`` value normalized into the bounded class set;
    anything absent, empty or unrecognized is ``interactive`` (the default
    is the HIGHEST class: a client that never heard of priorities keeps its
    service level)."""
    if not raw:
        return DEFAULT_PRIORITY
    value = raw.strip().lower()
    return value if value in PRIORITY_RANK else DEFAULT_PRIORITY


def encode_tensor(arr: np.ndarray) -> dict[str, Any]:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": arr.dtype.name, "data": arr.tobytes()}


def decode_tensor(d: dict[str, Any]) -> np.ndarray:
    arr = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"]))
    return arr.reshape(d["shape"])


def encode_predict_request(images: np.ndarray) -> bytes:
    """uint8 (N,H,W,C) batch -> msgpack request body."""
    return msgpack_lite.packb({"inputs": encode_tensor(images)})


def decode_predict_request(body: bytes, content_type: str) -> np.ndarray:
    """Request body -> uint8 pixels or float32 pre-normalized batch.
    Raises ValueError on a malformed body (the server answers 400)."""
    if content_type.startswith(MSGPACK_CONTENT_TYPE):
        try:
            return decode_tensor(msgpack_lite.unpackb(body)["inputs"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed msgpack request: {e}") from e
    if content_type.startswith(JSON_CONTENT_TYPE) or not content_type:
        try:
            arr = np.asarray(json.loads(body)["instances"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed JSON request: {e}") from e
        if arr.dtype.kind in "iu":
            if arr.size and (arr.min() < 0 or arr.max() > 255):
                raise ValueError(
                    "integer pixel values must be in [0, 255]; send floats "
                    "for pre-normalized data"
                )
            return arr.astype(np.uint8)
        return arr.astype(np.float32)
    raise ValueError(f"unsupported content type {content_type!r}")


def encode_predict_response(logits: np.ndarray, labels, content_type: str) -> tuple[bytes, str]:
    if content_type.startswith(MSGPACK_CONTENT_TYPE):
        body = msgpack_lite.packb({"outputs": encode_tensor(logits), "labels": list(labels)})
        return body, MSGPACK_CONTENT_TYPE
    scores = [dict(zip(labels, map(float, row))) for row in logits]
    return json.dumps({"predictions": scores}).encode(), JSON_CONTENT_TYPE


def decode_predict_response(body: bytes, content_type: str) -> tuple[np.ndarray, list[str]]:
    if content_type.startswith(MSGPACK_CONTENT_TYPE):
        msg = msgpack_lite.unpackb(body)
        return decode_tensor(msg["outputs"]), list(msg["labels"])
    preds = json.loads(body)["predictions"]
    labels = list(preds[0].keys())
    return np.asarray([[p[k] for k in labels] for p in preds], np.float32), labels
