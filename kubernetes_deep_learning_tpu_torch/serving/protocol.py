"""Gateway <-> model-server wire protocol: the tensor wire and the bytes wire.

The port's own copy of the JAX package's ``serving/protocol.py``,
byte-compatible with it: msgpack bodies carrying raw little-endian
tensor bytes (``{"inputs": {"shape", "dtype", "data"}}`` in,
``{"outputs": ..., "labels": [...]}`` out), or the TF-Serving-style JSON
fallback (``{"instances": ...}`` in, ``{"predictions": [{label: score}]}``
out).  The bytes wire (``BYTES_CONTENT_TYPE``) carries the fetched JPEG/PNG
bytes verbatim (``{"images": [bin, ...]}``) for the model tier to decode; a
server offers it on spec discovery (``INGEST_HEADER``) and a gateway sends
it only to a server that offered it.  msgpack goes through ``msgpack_lite``, so the wire needs no
third-party package.  Error replies are JSON ``{"error": ...}`` bodies, and
a 503 carries ``Retry-After`` in the JAX admission package's format
(``retry_after_headers``, re-exported by ``serving.admission``), which the
gateway copies into its own reply.  The priority header and its bounded
class set are the JAX protocol's, and so is the generative lane's wire: a
JSON ``/generate`` body (``decode_generate_request``) answered by
Server-Sent Events frames (``sse_token_event``, ``sse_done_event``,
``parse_sse_events``), byte-equal to JAX's.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from kubernetes_deep_learning_tpu_torch import msgpack_lite

MSGPACK_CONTENT_TYPE = "application/x-msgpack"
JSON_CONTENT_TYPE = "application/json"

# The bytes wire: the request body carries the fetched JPEG/PNG bytes
# verbatim (a msgpack list of bin blobs) and the model tier decodes and
# resizes them itself.  Opt-in both ways: a server advertises the
# capability on its spec-discovery reply (INGEST_HEADER) and a gateway
# sends this content type only to a server that advertised it, so a mixed
# deployment falls back to the tensor wire, never to an error.
BYTES_CONTENT_TYPE = "application/x-kdlt-image-bytes"

# The capability header of GET /v1/models/<name> (comma-separated members
# of the CLOSED set INGEST_CAPS); no header means tensor wire only.
INGEST_HEADER = "X-Kdlt-Ingest"
INGEST_BYTES_CAP = "bytes"
INGEST_CAPS = (INGEST_BYTES_CAP,)

# KDLT_INGEST=0 turns the bytes wire off on either tier: the server stops
# advertising (and accepting) it, the gateway stops sending it.
INGEST_ENV = "KDLT_INGEST"

# Per-blob byte bound on the decode side, the gateway's fetch bound
# (ops.preprocess.MAX_FETCH_BYTES): each tier bounds memory on its own.
MAX_ENCODED_IMAGE_BYTES = 32 * 1024 * 1024

# JPEG/PNG magic prefixes: only payloads identified as one of the two
# formats ride the bytes wire; anything else decodes at the gateway (and
# is refused there) on the tensor wire.
_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

# A token stream's content type; the gateway's response cache refuses to
# store one (serving.cache.storable_response).
EVENT_STREAM_CONTENT_TYPE = "text/event-stream"

# Multi-model routing header: names the model a /predict request targets
# when its path names none (the gateway's /predict/<model> wins).
MODEL_HEADER = "X-Kdlt-Model"

# Response-cache wire surface (serving.cache): a client salts the content
# hash with X-Kdlt-Cache-Bust to opt out of the cache (equal salts still
# coalesce); the gateway stamps every /predict reply with its disposition
# (hit | miss | coalesced | stale).
CACHE_BUST_HEADER = "X-Kdlt-Cache-Bust"
CACHE_STATUS_HEADER = "X-Kdlt-Cache"

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


def ingest_enabled(explicit: bool | None = None) -> bool:
    """Explicit arg > $KDLT_INGEST > on (the switch turns both tiers back
    to the tensor wire only)."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(INGEST_ENV, "").strip().lower() not in ("0", "false", "off", "no")


def parse_ingest_caps(raw: str | None) -> tuple[str, ...]:
    """An X-Kdlt-Ingest header as known capability tokens; unknown tokens
    are dropped (a gateway only ever acts on capabilities it understands)."""
    if not raw:
        return ()
    return tuple(tok for tok in (t.strip().lower() for t in raw.split(",")) if tok in INGEST_CAPS)


def sniff_image_format(data: bytes) -> str | None:
    """"jpeg" or "png" by magic bytes, None for anything else."""
    if data.startswith(_JPEG_MAGIC):
        return "jpeg"
    if data.startswith(_PNG_MAGIC):
        return "png"
    return None


def encode_bytes_predict_request(blobs: list[bytes]) -> bytes:
    """Encoded image blobs -> msgpack request body (the bytes wire)."""
    return msgpack_lite.packb({"images": [bytes(b) for b in blobs]})


def decode_bytes_predict_request(body: bytes, max_images: int | None = None) -> list[bytes]:
    """The inverse of ``encode_bytes_predict_request``, with a network
    decoder's bounds: a non-empty list of non-empty bin blobs, each under
    MAX_ENCODED_IMAGE_BYTES, at most ``max_images`` of them.  Raises
    ValueError (a 400: a malformed body is the client's error)."""
    try:
        msg = msgpack_lite.unpackb(body)
    except Exception as e:  # noqa: BLE001 - mapped to 400 by the caller
        raise ValueError(f"invalid msgpack body: {e}") from e
    if not isinstance(msg, dict) or "images" not in msg:
        raise ValueError('bytes request must be a msgpack map with "images"')
    blobs = msg["images"]
    if not isinstance(blobs, list) or not blobs:
        raise ValueError('"images" must be a non-empty list of image blobs')
    if max_images is not None and len(blobs) > max_images:
        raise ValueError(f"{len(blobs)} images exceeds the {max_images}-image limit")
    for i, blob in enumerate(blobs):
        if not isinstance(blob, (bytes, bytearray)) or not blob:
            raise ValueError(f"image {i} is not a non-empty binary blob")
        if len(blob) > MAX_ENCODED_IMAGE_BYTES:
            raise ValueError(f"image {i} ({len(blob)} bytes) exceeds the "
                             f"{MAX_ENCODED_IMAGE_BYTES}-byte per-image limit")
    return [bytes(b) for b in blobs]


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


# --- the generative lane ------------------------------------------------------
# A JSON request and a Server-Sent Events response, as the JAX protocol's:
# prompts travel as text (the decode engine encodes them byte by byte), and
# every knob has a server-side cap.

GENERATE_MAX_NEW_TOKENS_CAP = 1024


def decode_generate_request(body: bytes) -> dict[str, Any]:
    """Parse and validate a /generate JSON body:
    ``{"prompt": str, "max_new_tokens": int, "stream": bool}``.  Raises
    ValueError on anything malformed (a 400)."""
    try:
        msg = json.loads(body)
    except Exception as e:  # noqa: BLE001 - mapped to 400 by the caller
        raise ValueError(f"invalid JSON body: {e}") from e
    if not isinstance(msg, dict) or "prompt" not in msg:
        raise ValueError('generate body must be a JSON object with "prompt"')
    prompt = msg["prompt"]
    if not isinstance(prompt, str) or not prompt:
        raise ValueError('"prompt" must be a non-empty string')
    raw_n = msg.get("max_new_tokens", 16)
    try:
        n = int(raw_n)
    except (TypeError, ValueError) as e:
        raise ValueError('"max_new_tokens" must be an integer') from e
    if n < 1 or n > GENERATE_MAX_NEW_TOKENS_CAP:
        raise ValueError(f'"max_new_tokens" must be in [1, {GENERATE_MAX_NEW_TOKENS_CAP}]')
    return {"prompt": prompt, "max_new_tokens": n, "stream": bool(msg.get("stream", True))}


def sse_event(payload: dict[str, Any]) -> bytes:
    """One Server-Sent Events frame: ``data: <json>\\n\\n``."""
    return b"data: " + json.dumps(payload, separators=(",", ":")).encode() + b"\n\n"


def sse_token_event(index: int, token: int, text: str) -> bytes:
    """A per-token event: position, token id, and its decoded text."""
    return sse_event({"index": index, "token": token, "text": text})


def sse_done_event(*, tokens: int, ttft_ms: float, tpot_ms: float, finish_reason: str,
                   text: str) -> bytes:
    """The terminal event: totals plus the per-token SLO observations."""
    return sse_event({
        "done": True,
        "tokens": tokens,
        "ttft_ms": round(ttft_ms, 3),
        "tpot_ms": round(tpot_ms, 3),
        "finish_reason": finish_reason,
        "text": text,
    })


def parse_sse_events(raw: bytes) -> list[dict[str, Any]]:
    """Split a complete SSE body back into its JSON payloads (tolerant of a
    trailing partial frame)."""
    events: list[dict[str, Any]] = []
    for frame in raw.split(b"\n\n"):
        frame = frame.strip()
        if not frame.startswith(b"data:"):
            continue
        try:
            events.append(json.loads(frame[len(b"data:"):].strip()))
        except Exception:  # noqa: BLE001 - a partial tail frame
            continue
    return events
