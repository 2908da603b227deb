"""Gateway content-addressed response cache + singleflight coalescing.

The port's copy of the JAX package's ``serving/cache.py``, unchanged but
for its imports: the port's gateway and model server use it as JAX's do.

At millions-of-users scale the same public image URLs recur heavily, yet
until now every duplicate request rode the full gateway -> admission ->
preprocess -> model-tier path.  This module is the classic serving-layer
answer (Clipper's prediction cache, NSDI '17; Go's singleflight), hosted
where the paper's two-tier split wants it -- the IO tier:

- **content addressing**: a request is identified by the sha256 of its
  canonicalized form -- model name + the model's *resolved artifact hash*
  (the registry's sha256 identity, learned from the model tier's
  ``X-Kdlt-Artifact-Hash`` response header) + preprocessing parameters
  (input shape, resize filter) + the payload (the image URL) + an optional
  client salt (``X-Kdlt-Cache-Bust``).  Keying on the artifact hash, not
  the version number, is what makes hot-reload semantics exact: a version
  bump with byte-identical content keeps every entry; changed bytes change
  the hash and drop that model's entries (:meth:`ResponseCache.note_artifact_hash`).

- **singleflight coalescing** (:class:`SingleFlight`): identical in-flight
  requests collapse into ONE upstream call whose result fans out to every
  waiter.  Deadline semantics are per-waiter: a follower whose own budget
  expires gets its own 504 without cancelling the leader, and hedging/
  failover fire once per *flight* (only the leader talks upstream), not
  once per caller.

- **bounded LRU response cache** (:class:`ResponseCache`): successful
  responses only, TTL'd (``KDLT_CACHE_TTL_S``), capped by byte budget
  (``KDLT_CACHE_MAX_MB``), with ``KDLT_CACHE=0`` as the subsystem kill
  switch (no cache, no coalescing -- the exact legacy gateway).

A hit avoids admission, preprocessing, and all device work, so it raises
goodput under overload *and* cuts p50 at idle; the gateway therefore
checks the cache AHEAD of admission (hits never consume AIMD concurrency
slots; coalesced followers are counted admitted-but-not-dispatched).
All ``kdlt_cache_*`` series are minted centrally in utils/metrics.py
(tools/check_metrics.py confines the prefix there).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict

from kubernetes_deep_learning_tpu_torch.serving.protocol import (  # noqa: F401 - re-exported wire surface
    ARTIFACT_HASH_HEADER,
    CACHE_BUST_HEADER,
    CACHE_STATUS_HEADER,
    EVENT_STREAM_CONTENT_TYPE,
)
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

CACHE_ENV = "KDLT_CACHE"
TTL_ENV = "KDLT_CACHE_TTL_S"
MAX_MB_ENV = "KDLT_CACHE_MAX_MB"
NEG_TTL_ENV = "KDLT_CACHE_NEG_TTL_S"
SWR_ENV = "KDLT_CACHE_SWR_S"
# Decoded-uint8 tier byte budget (DecodedCache below); 0 disables the tier.
DECODED_MB_ENV = "KDLT_CACHE_DECODED_MB"
DEFAULT_DECODED_MB = 32.0

# Staleness ceiling between an artifact reload and the first miss that
# teaches the gateway the new hash; 60 s matches the version watcher's
# default poll cadence (one watcher period of bounded staleness).
DEFAULT_TTL_S = 60.0
DEFAULT_MAX_MB = 64.0
# Negative caching: a hammered bad URL (404/400) answers from the cache
# for this long instead of paying the full fetch path per request.  Short
# by design -- a 404 can become a 200 the moment the object is uploaded --
# and 0 disables it.  5xx are NEVER negative-cached: they are the
# upstream's transient state, not the request's.
DEFAULT_NEG_TTL_S = 5.0
NEGATIVE_STATUSES = (400, 404)

# Stale-while-revalidate window: TTL-expired 200s stay resident for this
# many extra seconds and can be served (marked stale) when the caller
# opts in -- the brownout controller's stage-2 degradation.  0 disables
# retention entirely, so the default cache behaves exactly as before.
DEFAULT_SWR_S = 0.0

# A client salt is hashed, never echoed, but still bound it: a multi-KB
# header must not become free amplification of the hash input.
MAX_BUST_SALT_LEN = 128

# The artifact-hash slot of a key before any upstream response has taught
# the gateway the real one (process start, or a model never yet served).
UNRESOLVED_HASH = "unresolved"

WSGI_CACHE_BUST_KEY = "HTTP_X_KDLT_CACHE_BUST"


def cache_enabled(explicit: bool | None = None) -> bool:
    """Explicit arg > $KDLT_CACHE > enabled-by-default (the kill switch
    disables the whole subsystem: response cache AND coalescing)."""
    if explicit is not None:
        return bool(explicit)
    raw = os.environ.get(CACHE_ENV, "").strip().lower()
    return raw not in ("0", "false", "off", "no")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw.strip() else default
    except ValueError:
        return default


def content_key(
    model: str,
    artifact_hash: str,
    preprocess_params: str,
    payload: str | bytes,
    salt: str = "",
) -> str:
    """sha256 over the canonicalized request, length-prefixed per field.

    Length prefixes keep the concatenation unambiguous (``("a", "bc")``
    and ``("ab", "c")`` must not collide); the fields are exactly the
    ISSUE's canonical form: model name, resolved artifact hash,
    preprocessing params, payload bytes, plus the cache-bust salt.
    """
    h = hashlib.sha256()
    for field in (model, artifact_hash, preprocess_params, payload,
                  salt[:MAX_BUST_SALT_LEN]):
        data = field.encode() if isinstance(field, str) else bytes(field)
        h.update(str(len(data)).encode())
        h.update(b":")
        h.update(data)
    return h.hexdigest()


class FlightTimeout(TimeoutError):
    """A coalesced follower's own deadline expired before the flight
    resolved; the follower 504s, the leader keeps flying."""


class Flight:
    """One in-flight upstream computation; followers block on :meth:`wait`.

    The leader resolves it exactly once with the finished response (or
    fails it with the leader's escaped exception); every waiter observes
    the same outcome, each bounded by its OWN timeout.
    """

    __slots__ = ("_done", "_value", "_error", "followers", "started_s")

    def __init__(self):
        self._done = threading.Event()
        self._value = None
        self._error: BaseException | None = None
        self.followers = 0
        self.started_s = time.monotonic()

    def resolve(self, value) -> None:
        self._value = value
        self._done.set()

    def fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

    def wait(self, timeout_s: float | None):
        if not self._done.wait(timeout_s):
            raise FlightTimeout(
                "deadline expired waiting on the coalesced flight"
            )
        if self._error is not None:
            raise self._error
        return self._value


class SingleFlight:
    """Key -> at most one live Flight; later arrivals join as followers.

    The leader MUST call :meth:`finish` before resolving/failing its
    flight (pop-then-resolve): a request arriving after the pop starts a
    fresh flight instead of receiving a result computed under a deadline
    that is not its own.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: dict[str, Flight] = {}  # guarded-by: _lock

    def begin(self, key: str) -> tuple[Flight, bool]:
        """Join or start the key's flight; returns (flight, is_leader)."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is not None:
                flight.followers += 1
                return flight, False
            flight = Flight()
            self._flights[key] = flight
            return flight, True

    def finish(self, key: str, flight: Flight) -> None:
        """Detach a completed flight (leader-only; identity-checked so a
        raced replacement flight is never evicted by a stale leader)."""
        with self._lock:
            if self._flights.get(key) is flight:
                del self._flights[key]

    def stats(self) -> dict:
        with self._lock:
            return {
                "inflight_flights": len(self._flights),
                "waiting_followers": sum(
                    f.followers for f in self._flights.values()
                ),
            }


class _Entry:
    __slots__ = ("body", "ctype", "nbytes", "model", "artifact_hash",
                 "expires_s", "stored_s", "hits", "status")

    def __init__(self, body, ctype, model, artifact_hash, expires_s,
                 status=200):
        self.body = body
        self.ctype = ctype
        self.nbytes = len(body)
        self.model = model
        self.artifact_hash = artifact_hash
        self.expires_s = expires_s
        self.stored_s = time.monotonic()
        self.hits = 0
        self.status = status


class ResponseCache:
    """Bounded, TTL'd, artifact-hash-invalidated LRU of 200 responses.

    Stores ``(body, ctype)`` keyed by content hash.  Thread-safe; all
    sizing is by response-body bytes against the ``KDLT_CACHE_MAX_MB``
    budget.  Invalidation is two-layered: the content key already embeds
    the resolved artifact hash (a reload changes future keys), and
    :meth:`note_artifact_hash` eagerly drops the superseded entries so the
    byte budget is not squatted by unreachable stale data.
    """

    def __init__(
        self,
        registry: metrics_lib.Registry | None = None,
        ttl_s: float | None = None,
        max_mb: float | None = None,
        neg_ttl_s: float | None = None,
        swr_s: float | None = None,
    ):
        self.ttl_s = ttl_s if ttl_s is not None else _env_float(
            TTL_ENV, DEFAULT_TTL_S
        )
        # Negative-entry TTL (404/400): $KDLT_CACHE_NEG_TTL_S, 0 disables
        # negative caching entirely (only 200s are stored).
        self.neg_ttl_s = neg_ttl_s if neg_ttl_s is not None else _env_float(
            NEG_TTL_ENV, DEFAULT_NEG_TTL_S
        )
        # Stale-while-revalidate retention past TTL for 200s only;
        # servable exclusively through stale_ok lookups (brownout stage 2).
        self.swr_s = max(0.0, swr_s if swr_s is not None else _env_float(
            SWR_ENV, DEFAULT_SWR_S
        ))
        max_mb = max_mb if max_mb is not None else _env_float(
            MAX_MB_ENV, DEFAULT_MAX_MB
        )
        self.max_bytes = int(max_mb * 1024 * 1024)
        self._entries: OrderedDict[str, _Entry] = OrderedDict()  # guarded-by: _lock
        self._bytes = 0              # guarded-by: _lock
        self._hashes: dict[str, str] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # Plain-int mirrors of the counters so /debug/cache works with or
        # without a registry (tests construct bare caches).
        self.hits = 0                # guarded-by: _lock
        self.misses = 0              # guarded-by: _lock
        self.coalesced = 0           # guarded-by: _lock
        self.negative_hits = 0       # guarded-by: _lock
        self.stale_hits = 0          # guarded-by: _lock
        self.evictions: dict[str, int] = {  # guarded-by: _lock
            reason: 0 for reason, _ in metrics_lib.CACHE_EVICTION_REASONS
        }
        self._m = (
            metrics_lib.cache_metrics(registry) if registry is not None
            else None
        )

    # --- artifact-hash identity ---------------------------------------------

    def resolved_hash(self, model: str) -> str:
        """The model's last-learned artifact hash (key material); a model
        the gateway has never seen answer resolves to a sentinel, so the
        first flight per process is simply an unmergeable one-off key."""
        with self._lock:
            return self._hashes.get(model, UNRESOLVED_HASH)

    def note_artifact_hash(self, model: str, artifact_hash: str) -> None:
        """Learn/refresh a model's artifact identity from an upstream
        response.  A CHANGED hash is a hot reload with different bytes:
        every entry stored under the old hash is dropped (reason
        "reload").  An unchanged hash -- including a version bump that
        re-exported identical bytes -- keeps all entries."""
        if not artifact_hash:
            return
        with self._lock:
            prev = self._hashes.get(model)
            if prev == artifact_hash:
                return
            self._hashes[model] = artifact_hash
            if prev is None:
                return
            stale = [
                k for k, e in self._entries.items()
                if e.model == model and e.artifact_hash != artifact_hash
            ]
            for k in stale:
                self._evict_locked(k, "reload")
            self._refresh_gauges_locked()

    def count_coalesced(self) -> None:
        """One singleflight follower rode an identical request's flight
        (the gateway counts these here so /debug/cache and the metric
        stay one source)."""
        with self._lock:
            self.coalesced += 1
        self._count("coalesced")

    # --- lookup / store -----------------------------------------------------

    def count_miss(self) -> None:
        """One lookup miss that went on to LEAD its own upstream flight
        (followers of an existing flight count as ``coalesced`` instead,
        so hits + misses + coalesced partitions the cacheable traffic and
        hit_ratio compares flights avoided vs flights flown)."""
        with self._lock:
            self.misses += 1
            self._count("misses")
            self._refresh_gauges_locked()

    def storable_status(self, status: int) -> bool:
        """Whether a response with this status may enter the cache: 200
        always; 400/404 only while negative caching is on (neg_ttl_s > 0).
        5xx (and everything else) never -- an upstream's transient failure
        must not be replayed to innocent followers."""
        if status == 200:
            return True
        return status in NEGATIVE_STATUSES and self.neg_ttl_s > 0

    def storable_response(self, status: int, ctype: str | None) -> bool:
        """storable_status plus the content-type guard: a
        ``text/event-stream`` body is a live connection's transcript, not
        a value.  Caching one -- or letting singleflight fan it out --
        would replay the first client's token stream to a second client
        as a dead recording, with the first stream's TTFT/TPOT stamped in
        its done event.  The generative lane never routes through the
        cache front door, but the store predicate refuses the content
        type outright so no future route can wire a stream into the
        cache by accident."""
        if ctype and ctype.strip().lower().startswith(
            EVENT_STREAM_CONTENT_TYPE
        ):
            return False
        return self.storable_status(status)

    def lookup(self, key: str) -> tuple[int, bytes, str] | None:
        """Hit -> (status, body, ctype) and LRU-touch; miss/expired ->
        None (the caller decides whether the miss leads a flight or
        coalesces, and counts it via count_miss / count_coalesced).
        Negative entries (status != 200) count as hits AND as
        negative_hits."""
        got = self.lookup_swr(key, stale_ok=False)
        return None if got is None else got[:3]

    def lookup_swr(
        self, key: str, stale_ok: bool = False,
    ) -> tuple[int, bytes, str, bool] | None:
        """lookup() plus the stale-while-revalidate window: a TTL-expired
        200 stays resident for ``swr_s`` extra seconds and is served (with
        the final tuple element True) ONLY when the caller passes
        ``stale_ok`` -- the brownout controller's stage-2 degradation.
        Without ``stale_ok`` an in-window entry answers None (the caller
        leads a revalidating flight) but is NOT evicted, so a later
        brownout can still use it.  Past ``expires + swr_s`` the entry is
        gone regardless -- a stale serve can never outlive the window.
        Negative entries never get SWR: a replayed 404 is pure harm."""
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            stale = False
            if entry is not None and entry.expires_s <= now:
                swr = self.swr_s if entry.status == 200 else 0.0
                if now >= entry.expires_s + swr:
                    self._evict_locked(key, "ttl")
                    entry = None
                elif stale_ok and entry.status == 200:
                    stale = True
                else:
                    self._refresh_gauges_locked()
                    return None
            if entry is None:
                self._refresh_gauges_locked()
                return None
            self._entries.move_to_end(key)
            entry.hits += 1
            self.hits += 1
            self._count("hits")
            if stale:
                self.stale_hits += 1
                self._count("stale_hits")
            if entry.status != 200:
                self.negative_hits += 1
                self._count("neg_hits")
            self._refresh_gauges_locked()
            return entry.status, entry.body, entry.ctype, stale

    def get(self, key: str) -> tuple[bytes, str] | None:
        """lookup() without the status (the original surface)."""
        got = self.lookup(key)
        return None if got is None else (got[1], got[2])

    def put(
        self, key: str, body: bytes, ctype: str, model: str,
        artifact_hash: str, status: int = 200,
    ) -> bool:
        """Store one cacheable response; returns False when the body alone
        exceeds the whole byte budget, or the status is not storable.
        Negative entries (400/404) live under the short neg_ttl_s."""
        if len(body) > self.max_bytes or not self.storable_response(
            status, ctype
        ):
            return False
        ttl = self.ttl_s if status == 200 else self.neg_ttl_s
        expires = time.monotonic() + ttl if ttl > 0 else float("inf")
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            entry = _Entry(body, ctype, model, artifact_hash, expires,
                           status=status)
            self._entries[key] = entry
            self._bytes += entry.nbytes
            if self._m is not None:
                self._m["bytes"].inc(entry.nbytes)
            while self._bytes > self.max_bytes and self._entries:
                oldest = next(iter(self._entries))
                if oldest == key:
                    break  # never evict the entry being inserted
                self._evict_locked(oldest, "lru")
            self._refresh_gauges_locked()
        return True

    def invalidate_model(self, model: str) -> int:
        """Drop every entry of one model (operator surface); returns the
        count dropped."""
        with self._lock:
            stale = [
                k for k, e in self._entries.items() if e.model == model
            ]
            for k in stale:
                self._evict_locked(k, "reload")
            self._refresh_gauges_locked()
            return len(stale)

    # --- internals ----------------------------------------------------------

    def _evict_locked(self, key: str, reason: str) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self._bytes -= entry.nbytes
        self.evictions[reason] = self.evictions.get(reason, 0) + 1
        if self._m is not None:
            counter = self._m["evictions"].get(reason)
            if counter is not None:
                counter.inc()

    def _count(self, name: str) -> None:
        if self._m is not None:
            self._m[name].inc()

    def _refresh_gauges_locked(self) -> None:
        if self._m is None:
            return
        self._m["resident"].set(float(self._bytes))
        self._m["entries"].set(float(len(self._entries)))
        total = self.hits + self.misses
        self._m["hit_ratio"].set(self.hits / total if total else 0.0)

    def stats(self) -> dict:
        """The /debug/cache payload body (everything but the flights)."""
        with self._lock:
            total = self.hits + self.misses
            per_model: dict[str, int] = {}
            negative = 0
            for e in self._entries.values():
                per_model[e.model] = per_model.get(e.model, 0) + 1
                negative += e.status != 200
            return {
                "entries": len(self._entries),
                "negative_entries": negative,
                "resident_bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "ttl_s": self.ttl_s,
                "neg_ttl_s": self.neg_ttl_s,
                "swr_s": self.swr_s,
                "hits": self.hits,
                "misses": self.misses,
                "coalesced": self.coalesced,
                "negative_hits": self.negative_hits,
                "stale_hits": self.stale_hits,
                "hit_ratio": round(self.hits / total, 4) if total else 0.0,
                "evictions": dict(self.evictions),
                "entries_by_model": per_model,
                "artifact_hashes": dict(self._hashes),
            }


# --- decoded-uint8 tier (cache carry-over #2) ------------------------------

def decoded_params(input_shape, resize_filter: str) -> str:
    """The canonical preprocess-params half of a decoded-tier key.  Both
    tiers spell it through this one function: a gateway and a model server
    disagreeing on the params string would silently never share entries."""
    return f"{tuple(input_shape)}|{resize_filter}"


def decoded_key(payload: bytes, params: str) -> str:
    """(content bytes, resolved preprocess params) -> decoded-tier key.

    Deliberately EXCLUDES the model name: two models with the same input
    contract decode the same image to the same pixels, so a cross-model
    hit skips the decode+resize entirely.  Content-addressed keys make
    entries immutable -- no TTL, no artifact invalidation."""
    h = hashlib.sha256()
    h.update(payload)
    h.update(b"|")
    h.update(params.encode())
    return h.hexdigest()


class DecodedCache:
    """Bounded LRU of decoded+resized uint8 image tensors.

    The decode stage's memo (GUIDE 10q): keyed by
    :func:`decoded_key` so identical image content requested for ANY
    model with the same input contract skips JPEG/PNG decode and resize.
    Lives on both tiers -- the gateway's legacy preprocess path and the
    model tier's bytes-wire decode stage consult one instance each.

    Entries are immutable by contract: callers must never mutate a
    returned array (get() marks it read-only to enforce that cheaply).
    KDLT_CACHE_DECODED_MB=0 disables the tier (get/put become no-ops).
    All kdlt_cache_decoded_* series are minted centrally in
    utils/metrics.py.
    """

    def __init__(
        self,
        registry: metrics_lib.Registry | None = None,
        max_mb: float | None = None,
    ):
        max_mb = max_mb if max_mb is not None else _env_float(
            DECODED_MB_ENV, DEFAULT_DECODED_MB
        )
        self.max_bytes = int(max_mb * 1024 * 1024)
        self._entries: "OrderedDict[str, object]" = OrderedDict()  # guarded-by: _lock
        self._bytes = 0              # guarded-by: _lock
        self._lock = threading.Lock()
        self.hits = 0                # guarded-by: _lock
        self.misses = 0              # guarded-by: _lock
        self.evictions = 0           # guarded-by: _lock
        self._m = (
            metrics_lib.cache_decoded_metrics(registry)
            if registry is not None else None
        )

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    def get(self, key: str):
        """Hit -> the decoded uint8 array (read-only view) + LRU touch;
        miss -> None."""
        if not self.enabled:
            return None
        with self._lock:
            arr = self._entries.get(key)
            if arr is None:
                self.misses += 1
                if self._m is not None:
                    self._m["misses"].inc()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            if self._m is not None:
                self._m["hits"].inc()
            return arr

    def put(self, key: str, arr) -> bool:
        """Store one decoded tensor; returns False when disabled or the
        tensor alone exceeds the whole byte budget."""
        if not self.enabled or arr.nbytes > self.max_bytes:
            return False
        stored = arr.copy() if not arr.flags.c_contiguous else arr
        stored.setflags(write=False)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = stored
            self._bytes += stored.nbytes
            while self._bytes > self.max_bytes and self._entries:
                oldest = next(iter(self._entries))
                if oldest == key:
                    break  # never evict the entry being inserted
                victim = self._entries.pop(oldest)
                self._bytes -= victim.nbytes
                self.evictions += 1
                if self._m is not None:
                    self._m["evictions"].inc()
            self._refresh_gauges_locked()
        return True

    def _refresh_gauges_locked(self) -> None:
        if self._m is None:
            return
        self._m["resident"].set(float(self._bytes))
        self._m["entries"].set(float(len(self._entries)))

    def stats(self) -> dict:
        """The /debug/cache "decoded" section."""
        with self._lock:
            total = self.hits + self.misses
            return {
                "enabled": self.enabled,
                "entries": len(self._entries),
                "resident_bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_ratio": round(self.hits / total, 4) if total else 0.0,
                "evictions": self.evictions,
            }
