"""Multi-replica model-tier upstream pool for the gateway, and its HTTP client.

The port's copy of the JAX package's ``serving/upstream.py``, with one
change: the card's machine has no ``requests``, so the pool and the gateway
talk HTTP through ``HttpClient`` below, built on ``http.client``.  It keeps
one pool of keep-alive connections per replica, shared by every handler
thread (at most ``POOL_SIZE`` idle, JAX's ``pool_maxsize``), sets
``TCP_NODELAY`` on every socket and sends a request's head and body in one
``send``: with Nagle on, a second small segment waits out the peer's
delayed ACK.  A response is read whole before its connection goes back to
the pool, and a connection whose exchange failed at any point is closed,
never pooled; a hedged attempt that loses therefore either finishes its
read or closes its socket.

In the JAX package PR 2 left the gateway knowing exactly one model-tier address
(``KDLT_SERVING_HOST``) guarded by one circuit breaker: a dead upstream was
a fast local 503, but never a *recovery* -- availability was outsourced
entirely to Kubernetes replica scaling behind one Service VIP, which hides
per-replica health from the tier that has the per-request context to act
on it.  This pool makes the gateway itself failure-aware, following "The
Tail at Scale" (Dean & Barroso, CACM '13):

- ``KDLT_SERVING_HOST`` accepts a comma-separated replica list;
- per-replica health = passive error tracking (consecutive failures mark a
  replica unhealthy) + an active ``/healthz`` prober that brings it back,
  plus a per-replica :class:`CircuitBreaker` (the PR 2 single breaker,
  generalized);
- replica selection is power-of-two-choices over healthy replicas
  (EWMA-latency-weighted; ties fall back to the round-robin rotation, so
  a fresh pool behaves exactly like the old round-robin), falling back to
  unhealthy ones gated by their breakers (the breaker's half-open probe is
  the passive recovery path when the active prober is not running);
- hedge policy state (``KDLT_HEDGE_DELAY_MS``) lives here; the gateway
  fires the actual hedged HTTP attempts.

**Dynamic membership** (PR 11): the pool can change shape under live
traffic.  ``KDLT_POOL_RESOLVE_S > 0`` re-resolves the configured DNS
name(s) on that cadence -- the Kubernetes headless-Service contract: the
service name's A records are exactly the ready pod IPs, so scale events
show up as membership deltas.  ``KDLT_SERVING_HOST=dns+srv://name`` asks
for SRV resolution (port from DNS) when dnspython is importable,
degrading to A-record resolution otherwise.  Joiners enter QUARANTINED:
invisible to selection until their first ``/readyz`` 200, so a
still-warming pod never eats live traffic.  Leavers are removed from
rotation immediately but nothing in flight is cancelled -- requests
already dispatched to a departed replica complete and their accounting
is harmless -- and their per-replica metric series are retired so
/metrics never accumulates stale hosts.  A departed replica's discovered
model contract is memoized by host: a DNS flap that re-adds the same
endpoint restores the spec cache instead of re-paying discovery (the
per-request spec validation still guards staleness).  The prober also
watches healthy replicas' ``/readyz``: a SIGTERM'd model server flips
/readyz at drain *start*, so it leaves new-primary rotation within one
probe interval -- the drain window receives only hedges already in
flight, never fresh primaries.

``KDLT_FAILOVER=0`` disables health/hedging/selection smarts (blind
round-robin) -- the A/B baseline arm of ``bench.py --chaos-ab`` and
``--churn-ab``.

The pool tracks a ``reference_spec``: the first model contract discovered
from any replica.  Replicas must match it before serving traffic through
this gateway (checked on first use and re-checked when a replica rejoins
after being unhealthy), so a replica left serving a different model
version surfaces as an explicit error, never silently mixed responses.
"""

from __future__ import annotations

import datetime
import http.client
import json
import logging
import os
import socket
import threading
import time
import urllib.parse
from typing import Callable

from kubernetes_deep_learning_tpu_torch.serving.admission import CircuitBreaker
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

# --- HTTP client -------------------------------------------------------------

POOL_SIZE = 64  # idle keep-alive connections kept per replica


class RequestException(OSError):
    """An upstream HTTP exchange failed: connect, send, read or timeout."""


class HTTPError(RequestException):
    """``Response.raise_for_status`` on a 4xx or 5xx reply."""


class Response:
    """A whole upstream reply: ``status_code``, ``headers`` (read without
    regard to case), ``content``, ``elapsed`` (send to last byte)."""

    def __init__(self, status_code: int, headers, content: bytes, elapsed_s: float):
        self.status_code = status_code
        self.headers = headers
        self.content = content
        self.elapsed = datetime.timedelta(seconds=elapsed_s)

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self):
        return json.loads(self.content)

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HTTPError(f"{self.status_code} error: {self.text[:200]}")


class _Connection(http.client.HTTPConnection):
    def connect(self) -> None:
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _send_output(self, message_body=None, encode_chunked=False):
        # The head and a bytes body in one send (http.client sends them
        # apart, which with small bodies costs a segment and an ACK wait).
        if isinstance(message_body, (bytes, bytearray)):
            self._buffer.extend((b"", b""))
            msg = b"\r\n".join(self._buffer) + bytes(message_body)
            del self._buffer[:]
            self.send(msg)
            return
        super()._send_output(message_body, encode_chunked)


_STALE = (http.client.RemoteDisconnected, ConnectionResetError, BrokenPipeError)


class HttpClient:
    """Keep-alive HTTP/1.1 over ``http.client``: one connection pool per
    (host, port), shared by all threads.  ``timeout`` is seconds or a
    ``(connect, read)`` pair, as ``requests`` takes it."""

    def __init__(self, pool_size: int = POOL_SIZE):
        self._pool_size = pool_size
        self._idle: dict[tuple[str, int], list[_Connection]] = {}
        self._lock = threading.Lock()
        self._closed = False

    def _checkout(self, key: tuple[str, int]) -> _Connection | None:
        with self._lock:
            idle = self._idle.get(key)
            return idle.pop() if idle else None

    def _checkin(self, key: tuple[str, int], conn: _Connection) -> None:
        with self._lock:
            idle = self._idle.setdefault(key, [])
            if not self._closed and len(idle) < self._pool_size:
                idle.append(conn)
                return
        conn.close()

    def request(self, method: str, url: str, body: bytes | None = None,
                headers: dict | None = None, timeout=None) -> Response:
        parts = urllib.parse.urlsplit(url)
        key = (parts.hostname or "localhost", parts.port or 80)
        path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        connect_s, read_s = timeout if isinstance(timeout, tuple) else (timeout, timeout)
        hdrs = {"Host": parts.netloc, "Content-Length": str(len(body or b"")), **(headers or {})}
        for attempt in (0, 1):
            conn = self._checkout(key)
            reused = conn is not None
            if conn is None:
                conn = _Connection(key[0], key[1], timeout=connect_s)
            t0 = time.perf_counter()
            try:
                if conn.sock is None:
                    conn.connect()
                conn.sock.settimeout(read_s)
                conn.putrequest(method, path, skip_host=True, skip_accept_encoding=True)
                for k, v in hdrs.items():
                    conn.putheader(k, v)
                conn.endheaders(message_body=body if body is not None else b"")
                resp = conn.getresponse()
                content = resp.read()
            except _STALE as e:
                conn.close()
                if reused and attempt == 0:
                    continue  # a kept-alive socket the peer had closed: once more, fresh
                raise RequestException(f"{method} {url}: {e!r}") from e
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                raise RequestException(f"{method} {url}: {e!r}") from e
            except BaseException:
                conn.close()
                raise
            elapsed = time.perf_counter() - t0
            if resp.will_close:
                conn.close()
            else:
                self._checkin(key, conn)
            return Response(resp.status, resp.headers, content, elapsed)
        raise AssertionError("unreachable")

    def get(self, url: str, headers: dict | None = None, timeout=None) -> Response:
        return self.request("GET", url, None, headers, timeout)

    def post(self, url: str, data: bytes | None = None, headers: dict | None = None,
             timeout=None) -> Response:
        return self.request("POST", url, data if data is not None else b"", headers, timeout)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, {}
        for conns in idle.values():
            for conn in conns:
                conn.close()

    def stream(self, method: str, url: str, body: bytes | None = None,
               headers: dict | None = None, timeout=None) -> "StreamResponse":
        """A request whose reply body is read as it arrives (a token stream),
        on a connection of its own that the reply's ``close()`` closes: a
        stream is never pooled.  The read timeout bounds each read, not the
        stream."""
        parts = urllib.parse.urlsplit(url)
        path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        connect_s, read_s = timeout if isinstance(timeout, tuple) else (timeout, timeout)
        conn = _Connection(parts.hostname or "localhost", parts.port or 80, timeout=connect_s)
        try:
            conn.connect()
            conn.sock.settimeout(read_s)
            conn.putrequest(method, path, skip_host=True, skip_accept_encoding=True)
            for k, v in {"Host": parts.netloc, "Content-Length": str(len(body or b"")),
                         **(headers or {})}.items():
                conn.putheader(k, v)
            conn.endheaders(message_body=body if body is not None else b"")
            return StreamResponse(conn, conn.getresponse())
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            raise RequestException(f"{method} {url}: {e!r}") from e
        except BaseException:
            conn.close()
            raise


class StreamResponse:
    """An upstream reply read as it arrives: ``status_code``, ``headers``,
    ``iter_content()`` (the chunks as they come), ``content`` (the rest,
    whole) and ``close()``, which closes its connection."""

    def __init__(self, conn: _Connection, resp: http.client.HTTPResponse):
        self._conn = conn
        self._resp = resp
        self.status_code = resp.status
        self.headers = resp.headers

    def iter_content(self, chunk_size: int = 65536):
        while True:
            try:
                chunk = self._resp.read1(chunk_size)
            except (OSError, http.client.HTTPException) as e:
                raise RequestException(f"stream read: {e!r}") from e
            if not chunk:
                return
            yield chunk

    @property
    def content(self) -> bytes:
        try:
            return self._resp.read()
        except (OSError, http.client.HTTPException) as e:
            raise RequestException(f"body read: {e!r}") from e

    def close(self) -> None:
        self._conn.close()


def get_status(url: str, timeout: float) -> int | None:
    """One GET on a fresh connection: the reply's status, or None when the
    replica cannot be reached (the prober's liveness question)."""
    client = HttpClient(pool_size=0)
    try:
        return client.get(url, timeout=timeout).status_code
    except RequestException:
        return None
    finally:
        client.close()


HEDGE_DELAY_ENV = "KDLT_HEDGE_DELAY_MS"
PROBE_INTERVAL_ENV = "KDLT_PROBE_INTERVAL_S"
FAILOVER_ENV = "KDLT_FAILOVER"
POOL_RESOLVE_ENV = "KDLT_POOL_RESOLVE_S"
SRV_SCHEME = "dns+srv://"

DEFAULT_PROBE_INTERVAL_S = 1.0
# Membership re-resolution cadence when a resolver is present but
# KDLT_POOL_RESOLVE_S is unset (the dns+srv:// form, bench injection).
DEFAULT_RESOLVE_INTERVAL_S = 2.0
# Consecutive request failures before passive tracking marks a replica
# unhealthy.  2, not 1: a single failure can be one bad connection in an
# otherwise healthy replica's pool; two in a row with zero successes
# between is a pattern worth routing around (the active prober or the
# breaker's half-open probe brings it back).
UNHEALTHY_AFTER = 2
# EWMA smoothing for observed per-replica latency (the power-of-two-
# choices ranking signal): new sample weight 0.2 -- reactive enough to
# shift load off a slowing replica within a few requests, smooth enough
# that one tail outlier does not flip the ranking.
EWMA_ALPHA = 0.2
# Departed-replica spec memo bound: hosts beyond this fall off oldest-
# first (a flapping DNS view must not grow the memo without bound).
SPEC_MEMO_CAP = 64

_log = logging.getLogger(__name__)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw.strip() else default
    except ValueError:
        return default


def parse_hosts(serving_host: str) -> list[str]:
    """Comma-separated host:port list -> hosts (order preserved, deduped)."""
    hosts: list[str] = []
    for h in serving_host.split(","):
        h = h.strip().rstrip("/")
        if h and h not in hosts:
            hosts.append(h)
    if not hosts:
        raise ValueError(f"no upstream hosts in {serving_host!r}")
    return hosts


def _split_host_port(target: str) -> tuple[str, str]:
    host, _, port = target.rpartition(":")
    if not host:  # no colon at all: a bare name, no port
        return target, ""
    return host, port


def dns_resolver(targets: list[str]) -> Callable[[], list[str]]:
    """Resolver re-resolving each ``name:port`` to its CURRENT A records
    (union across targets, first-seen order, deduped).

    Pointing ``KDLT_SERVING_HOST`` at a Kubernetes headless Service name
    with ``KDLT_POOL_RESOLVE_S > 0`` turns scale events into membership
    deltas: the headless Service resolves to every ready pod IP.  A name
    that fails to resolve contributes nothing (the pool separately
    refuses an ENTIRELY empty resolution, so a DNS outage never dumps
    the fleet)."""

    def resolve() -> list[str]:
        out: list[str] = []
        for t in targets:
            host, port = _split_host_port(t)
            try:
                infos = socket.getaddrinfo(
                    host, int(port) if port else None, type=socket.SOCK_STREAM
                )
            except (OSError, ValueError):
                continue
            for info in infos:
                addr = info[4][0]
                if ":" in addr:  # v6 literal needs brackets in a URL
                    addr = f"[{addr}]"
                entry = f"{addr}:{port}" if port else addr
                if entry not in out:
                    out.append(entry)
        return out

    return resolve


def srv_resolver(target: str) -> Callable[[], list[str]]:
    """Resolver for a ``dns+srv://name`` target: SRV records carry both
    the address and the port.  dnspython is optional in this image; when
    it is absent the resolver degrades to A-record resolution of
    ``name[:port]`` (same membership signal, port from the URL)."""

    def resolve() -> list[str]:
        name, port = _split_host_port(target)
        try:
            import dns.resolver  # type: ignore[import-not-found]
        except ImportError:
            return dns_resolver([target])()
        try:
            answers = dns.resolver.resolve(name, "SRV")
        except Exception:  # noqa: BLE001 - resolver failures are transient
            return []
        out: list[str] = []
        for rr in answers:
            entry = f"{str(rr.target).rstrip('.')}:{rr.port}"
            if entry not in out:
                out.append(entry)
        return out

    return resolve


def resolve_serving_host(
    serving_host: str,
) -> tuple[list[str], Callable[[], list[str]] | None]:
    """Initial host list + the resolver implied by the address FORM.

    ``dns+srv://...`` yields its resolver (and its current resolution as
    the boot membership -- empty is allowed: the pool starts hollow and
    fills on the first successful resolve).  A plain comma list yields no
    resolver here; :class:`UpstreamPool` builds the A-record re-resolver
    itself when ``KDLT_POOL_RESOLVE_S`` asks for one.
    """
    if serving_host.startswith(SRV_SCHEME):
        target = serving_host[len(SRV_SCHEME):].strip().rstrip("/")
        if not target:
            raise ValueError(f"no SRV target in {serving_host!r}")
        resolver = srv_resolver(target)
        try:
            hosts = resolver() or []
        except Exception:  # noqa: BLE001 - boot must not hinge on DNS
            hosts = []
        return hosts, resolver
    return parse_hosts(serving_host), None


class UpstreamReplica:
    """One model-tier replica: address + health + breaker + spec cache."""

    def __init__(self, host: str, registry: metrics_lib.Registry | None = None):
        self.host = host
        self.base = f"http://{host}"
        self.breaker = CircuitBreaker()
        self.healthy = True
        self.consecutive_failures = 0
        # Dynamic-membership states: a QUARANTINED joiner is invisible to
        # selection until its first /readyz 200; a DRAINING replica (its
        # /readyz flipped 503 while still alive) finishes in-flight work
        # but takes no new primaries.
        self.quarantined = False
        self.draining = False
        # Power-of-two-choices signal + accounting.
        self.ewma_ms: float | None = None
        self.picks = 0
        self.spec = None  # the DEFAULT model's discovered ModelSpec
        # Non-default models' contracts (multi-model routing), keyed by
        # model name; cleared with ``spec`` when the replica rejoins so
        # every contract is re-validated before serving again.
        self.specs: dict[str, object] = {}
        self._registry = registry
        if registry is not None:
            m = metrics_lib.pool_replica_metrics(registry, host)
            self._metrics_child = m["child"]
            self._gauge = m["healthy"]
            self._m_picks = m["picks"]
            self._m_ewma = m["ewma_ms"]
        else:
            self._metrics_child = None
            self._gauge = self._m_picks = self._m_ewma = None
        if self._gauge is not None:
            self._gauge.set(1.0)

    @property
    def routable(self) -> bool:
        """Eligible for new primary traffic."""
        return self.healthy and not self.quarantined and not self.draining

    def set_healthy(self, healthy: bool) -> None:
        self.healthy = healthy
        if self._gauge is not None:
            self._gauge.set(1.0 if healthy else 0.0)

    def note_latency(self, seconds: float) -> None:
        """Fold one observed request latency into the EWMA."""
        ms = seconds * 1e3
        self.ewma_ms = (
            ms
            if self.ewma_ms is None
            else (1.0 - EWMA_ALPHA) * self.ewma_ms + EWMA_ALPHA * ms
        )
        if self._m_ewma is not None:
            self._m_ewma.set(self.ewma_ms)

    def count_pick(self) -> None:
        self.picks += 1
        if self._m_picks is not None:
            self._m_picks.inc()

    def retire(self) -> None:
        """Drop this replica's per-replica series from the registry: a
        departed member must not leave stale samples on /metrics (or leak
        a series per churn event)."""
        if self._registry is not None and self._metrics_child is not None:
            self._registry.remove(self._metrics_child)

    def __repr__(self) -> str:  # diagnostics in error messages/logs
        state = (
            "quarantined" if self.quarantined
            else "draining" if self.draining
            else "up" if self.healthy
            else "DOWN"
        )
        return f"<replica {self.host} {state}>"


class UpstreamPool:
    """Replica selection + health accounting for the gateway's upstream hop.

    The pool owns *policy state* (who is healthy, whose breaker allows,
    hedge delay, probe cadence, membership); the gateway owns the HTTP
    mechanics.  All selection methods are thread-safe; ``self.replicas``
    is rebound copy-on-write under membership changes, so iterating
    handlers always see a consistent (possibly slightly stale) list.
    """

    def __init__(
        self,
        hosts: list[str],
        registry: metrics_lib.Registry | None = None,
        failover: bool | None = None,
        hedge_delay_ms: float | None = None,
        probe_interval_s: float | None = None,
        unhealthy_after: int = UNHEALTHY_AFTER,
        resolver: Callable[[], list[str]] | None = None,
        resolve_interval_s: float | None = None,
        on_event: Callable | None = None,
    ):
        # Flight-recorder hook (utils/flightrecorder.py): called as
        # ``on_event(kind, **attrs)`` at every membership/health edge so
        # the owning tier's incident timeline sees pool churn.  Must be
        # cheap; failures are swallowed (observability never breaks
        # routing).
        self._on_event = on_event
        if failover is None:
            failover = os.environ.get(FAILOVER_ENV, "").strip() != "0"
        self.failover = bool(failover)
        if hedge_delay_ms is None:
            hedge_delay_ms = _env_float(HEDGE_DELAY_ENV, 0.0)
        self.hedge_delay_s = max(0.0, hedge_delay_ms) / 1e3
        if probe_interval_s is None:
            probe_interval_s = _env_float(
                PROBE_INTERVAL_ENV, DEFAULT_PROBE_INTERVAL_S
            )
        self.probe_interval_s = probe_interval_s
        if resolve_interval_s is None:
            resolve_interval_s = _env_float(POOL_RESOLVE_ENV, 0.0)
        self.resolve_interval_s = max(0.0, resolve_interval_s)
        if resolver is None and self.resolve_interval_s > 0:
            resolver = dns_resolver(list(hosts))
        elif resolver is not None and self.resolve_interval_s <= 0:
            # An explicitly-handed resolver (dns+srv:// form, bench
            # injection) implies dynamic membership even without
            # KDLT_POOL_RESOLVE_S; give it the default cadence.
            self.resolve_interval_s = DEFAULT_RESOLVE_INTERVAL_S
        self.resolver = resolver
        self._unhealthy_after = max(1, unhealthy_after)
        self._registry = registry
        self.replicas = [UpstreamReplica(h, registry) for h in hosts]
        self.reference_spec = None  # the default model's reference contract
        # Non-default models' reference contracts (multi-model routing).
        self.reference_specs: dict[str, object] = {}
        # Departed replicas' discovered contracts, keyed by host (bounded):
        # a DNS flap that re-adds an endpoint restores its spec cache.
        self._spec_memo: dict[str, tuple] = {}  # guarded-by: _lock
        self.joins = 0               # guarded-by: _lock
        self.leaves = 0              # guarded-by: _lock
        self._lock = threading.Lock()
        self._rr = 0                 # guarded-by: _lock
        m = (
            metrics_lib.upstream_pool_metrics(registry)
            if registry is not None
            else None
        )
        self.m_failover = m["failover"] if m else None
        self.m_hedge_fired = m["hedge_fired"] if m else None
        self.m_hedge_won = m["hedge_won"] if m else None
        mm = (
            metrics_lib.pool_membership_metrics(registry)
            if registry is not None
            else None
        )
        self._m_members = mm["members"] if mm else None
        self._m_joins = mm["joins"] if mm else None
        self._m_leaves = mm["leaves"] if mm else None
        if self._m_members is not None:
            self._m_members.set(float(len(self.replicas)))
        self._probe_stop = threading.Event()
        self._probe_thread: threading.Thread | None = None

    # --- selection ---------------------------------------------------------

    def _rotation(self) -> list[UpstreamReplica]:
        reps = self.replicas  # one read: membership rebinds copy-on-write
        with self._lock:
            idx = self._rr
            self._rr += 1
        n = len(reps)
        return [reps[(idx + i) % n] for i in range(n)] if n else []

    def choose(
        self, exclude=(), gate_breaker: bool = True
    ) -> UpstreamReplica | None:
        """Pick the next replica to try, or None when every candidate is
        refused.

        Routable replicas first, ranked by power-of-two-choices: the
        rotation's first two routable candidates are compared by latency
        EWMA and the lighter one leads (a tie -- e.g. a fresh pool with no
        samples -- keeps plain round-robin order, so behavior without
        latency signal is exactly the PR 3 rotation).  Unhealthy replicas
        remain the last-resort fallback: their breaker's half-open probe
        is how a replica recovers when the active prober is not running.
        QUARANTINED joiners and DRAINING leavers are never candidates --
        not even as fallback -- so a warming pod and a drain window take
        no new primaries.  ``gate_breaker`` mirrors the admission-enabled
        posture: each returned candidate consumed a breaker ``allow()``
        (half-open probe accounting), so callers MUST follow up with
        record_success/record_failure.  With failover disabled the pool
        is a blind round-robin: no health, no breaker, no membership
        smarts, every replica takes its turn dead or alive.
        """
        candidates = [r for r in self._rotation() if r not in exclude]
        if not self.failover:
            return candidates[0] if candidates else None
        routable = [r for r in candidates if r.routable]
        if len(routable) >= 2:
            # Two choices, lighter EWMA first.  A replica with NO samples
            # ranks lightest (it should receive traffic and earn one); a
            # tie -- both unsampled, or equal -- keeps rotation order, so
            # a signal-less pool degrades to plain round-robin.
            a, b = routable[0], routable[1]
            a_w = a.ewma_ms if a.ewma_ms is not None else -1.0
            b_w = b.ewma_ms if b.ewma_ms is not None else -1.0
            if b_w < a_w:
                routable[0], routable[1] = b, a
        fallback = [
            r for r in candidates
            if not r.healthy and not r.quarantined and not r.draining
        ]
        for r in routable + fallback:
            if not gate_breaker or r.breaker.allow():
                r.count_pick()
                return r
        return None

    def has_healthy_candidate(self, exclude=()) -> bool:
        """Non-consuming peek: is failover to a ROUTABLE replica possible?
        (Used to decide immediate-failover vs backoff-retry on a 503;
        deliberately ignores breakers so it never consumes probe slots.)"""
        if not self.failover:
            return False
        return any(r not in exclude and r.routable for r in self.replicas)

    def snapshot_ordered(self) -> list[UpstreamReplica]:
        """Replicas, routable first (for spec discovery sweeps)."""
        reps = self.replicas
        return [r for r in reps if r.routable] + [
            r for r in reps if not r.routable
        ]

    # --- accounting --------------------------------------------------------

    def _emit(self, kind: str, **attrs) -> None:
        cb = self._on_event
        if cb is None:
            return
        try:
            cb(kind, **attrs)
        except Exception:  # noqa: BLE001 - recorder problems never gate routing
            pass

    def record_failure(self, replica: UpstreamReplica) -> None:
        flipped = False
        with self._lock:
            replica.consecutive_failures += 1
            if (
                replica.consecutive_failures >= self._unhealthy_after
                and replica.healthy
            ):
                replica.set_healthy(False)
                flipped = True
        replica.breaker.record_failure()
        if flipped:
            self._emit(
                "pool.unhealthy", host=replica.host,
                failures=replica.consecutive_failures,
            )

    def record_success(
        self, replica: UpstreamReplica, latency_s: float | None = None
    ) -> None:
        flipped = False
        with self._lock:
            replica.consecutive_failures = 0
            if not replica.healthy:
                replica.set_healthy(True)
                flipped = True
        if latency_s is not None:
            replica.note_latency(latency_s)
        replica.breaker.record_success()
        if flipped:
            self._emit("pool.healthy", host=replica.host, via="traffic")

    def mark_stalled(self, replica: UpstreamReplica) -> None:
        """A replica answered with a DECLARED dispatch stall (the
        X-Kdlt-Stalled 503: its engine watchdog fired and only a restart
        recovers it).  Unlike an overload 503 -- transient evidence that
        takes UNHEALTHY_AFTER consecutive failures to act on -- a declared
        stall takes the replica out of rotation immediately, so new
        requests (and every waiter of a coalesced flight) fail over on
        the FIRST observation instead of feeding the wedged replica.
        The /healthz prober rejoins it once the restarted pod answers 200
        (the stalled process fails its own /healthz, so no flapping)."""
        flipped = False
        with self._lock:
            replica.consecutive_failures = max(
                replica.consecutive_failures, self._unhealthy_after
            )
            if replica.healthy:
                flipped = True
            replica.set_healthy(False)
        if flipped:
            # Only the healthy->stalled edge: a wedged replica answers
            # every queued request with the stall header, and repeating
            # the pair per response would crowd the bounded timeline.
            self._emit("pool.stalled", host=replica.host)
            self._emit("pool.unhealthy", host=replica.host, reason="stalled")

    def mark_spec_mismatch(self, replica: UpstreamReplica) -> None:
        """Route around a replica serving a different model contract.  Its
        cached (mismatching) spec is kept: only a health-state rejoin
        (probe success) clears it for re-validation, so a permanently
        wrong replica stays out instead of flapping per request."""
        flipped = False
        with self._lock:
            if replica.healthy:
                flipped = True
            replica.set_healthy(False)
        if flipped:
            self._emit(
                "pool.unhealthy", host=replica.host, reason="spec_mismatch"
            )

    def min_retry_after_s(self) -> float:
        """Smallest positive breaker cool-down across replicas (0 if none):
        the soonest any upstream might accept work again."""
        waits = [r.breaker.retry_after_s() for r in self.replicas]
        positive = [w for w in waits if w > 0]
        return min(positive) if positive else 0.0

    # --- dynamic membership ------------------------------------------------

    def set_membership(self, hosts: list[str]) -> dict:
        """Apply a resolved host view: unknown hosts JOIN (quarantined
        until their first /readyz 200), known hosts keep their state,
        missing hosts LEAVE (out of rotation now; in-flight work on them
        completes untouched; series retired; spec memoized for flap
        re-adds).  An empty view is REFUSED -- a DNS outage must not dump
        a serving fleet.  Returns ``{"joined": [...], "left": [...]}``.
        """
        wanted: list[str] = []
        for h in hosts:
            h = h.strip().rstrip("/")
            if h and h not in wanted:
                wanted.append(h)
        if not wanted:
            return {"joined": [], "left": []}
        left: list[UpstreamReplica] = []
        joined: list[str] = []
        with self._lock:
            current = {r.host: r for r in self.replicas}
            if set(wanted) == set(current):
                return {"joined": [], "left": []}
            new_replicas: list[UpstreamReplica] = []
            for h in wanted:
                if h in current:
                    new_replicas.append(current[h])
                    continue
                r = UpstreamReplica(h, self._registry)
                if self.failover:
                    # Health-probe quarantine: no traffic until proven
                    # ready.  Blind mode has no prober to release it, so
                    # joiners go straight into rotation there.
                    r.quarantined = True
                    r.set_healthy(False)
                new_replicas.append(r)
                joined.append(h)
            gone = set(current) - set(wanted)
            for r in self.replicas:
                if r.host in gone:
                    left.append(r)
                    self._spec_memo[r.host] = (r.spec, dict(r.specs))
            while len(self._spec_memo) > SPEC_MEMO_CAP:
                self._spec_memo.pop(next(iter(self._spec_memo)))
            self.replicas = new_replicas  # copy-on-write rebind
            self.joins += len(joined)
            self.leaves += len(left)
        for r in left:
            r.retire()
        if self._m_members is not None:
            self._m_members.set(float(len(wanted)))
        if joined and self._m_joins is not None:
            self._m_joins.inc(len(joined))
        if left and self._m_leaves is not None:
            self._m_leaves.inc(len(left))
        if joined or left:
            _log.info(
                "pool membership changed: +%s -%s (now %d members)",
                joined, [r.host for r in left], len(wanted),
            )
        for h in joined:
            self._emit("pool.join", host=h, members=len(wanted))
            if self.failover:
                self._emit("pool.quarantine", host=h)
        for r in left:
            self._emit("pool.leave", host=r.host, members=len(wanted))
        return {"joined": joined, "left": [r.host for r in left]}

    def resolve_now(self) -> dict:
        """Run the resolver once and apply the delta (no-op without one)."""
        if self.resolver is None:
            return {"joined": [], "left": []}
        try:
            hosts = self.resolver() or []
        except Exception:  # noqa: BLE001 - resolver failures are transient
            hosts = []
        return self.set_membership(hosts)

    # --- active probing ----------------------------------------------------

    def start_probing(self) -> None:
        """Start the prober/resolver thread (daemon).

        Runs when there is anything for it to do: active health probing
        (failover on, a positive probe interval, and at least two
        replicas OR dynamic membership that could add a second) or
        membership re-resolution (a resolver plus a positive
        ``KDLT_POOL_RESOLVE_S``).  No-op otherwise, and idempotent.
        """
        if self._probe_thread is not None:
            return
        resolving = self.resolver is not None and self.resolve_interval_s > 0
        probing = (
            self.failover
            and self.probe_interval_s > 0
            and (len(self.replicas) >= 2 or resolving)
        )
        if not (probing or resolving):
            return
        self._probe_stop.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="kdlt-upstream-prober", daemon=True
        )
        self._probe_thread.start()

    def _probe_loop(self) -> None:
        intervals = [self.probe_interval_s, self.resolve_interval_s]
        tick = min(i for i in intervals if i > 0)
        last_resolve = 0.0
        while not self._probe_stop.wait(tick):
            now = time.monotonic()
            if (
                self.resolver is not None
                and self.resolve_interval_s > 0
                and now - last_resolve >= self.resolve_interval_s
            ):
                last_resolve = now
                try:
                    self.resolve_now()
                except Exception:  # noqa: BLE001 - the prober must never die
                    pass
            if self.failover and self.probe_interval_s > 0:
                try:
                    self.probe_once()
                except Exception:  # noqa: BLE001
                    pass

    def probe_once(self) -> None:
        """One probe sweep over the membership.

        - QUARANTINED joiners: GET /readyz; the first 200 releases the
          quarantine (readiness, not liveness: a joiner is warm and
          accepting by contract when /readyz says so).  A memoized spec
          from a previous membership (DNS flap) is restored instead of
          re-paying discovery.
        - UNHEALTHY replicas: GET /healthz; a 200 rejoins.  Rejoin resets
          the breaker (the probe IS the recovery evidence; waiting out
          the breaker cool-down on top would stretch recovery past one
          probe interval) and drops the cached spec so the contract is
          re-validated before the replica serves again.
        - HEALTHY replicas: GET /readyz as a drain watch; a non-200 from
          a live process flips the replica DRAINING (out of new-primary
          rotation within one probe interval, NOT a failure -- in-flight
          work and hedges finish normally), and a later 200 un-drains it
          (rollout aborted).  A dead connection while draining demotes to
          plain unhealthy so the /healthz path owns recovery.
        """
        timeout = min(1.0, max(0.1, self.probe_interval_s or 1.0))

        def probe(url: str) -> int | None:
            return get_status(url, timeout)

        for r in list(self.replicas):
            if r.quarantined:
                if probe(f"{r.base}/readyz") == 200:
                    with self._lock:
                        r.consecutive_failures = 0
                        memo = self._spec_memo.pop(r.host, None)
                        if memo is not None:
                            r.spec, specs = memo
                            r.specs = dict(specs)
                        r.quarantined = False
                        r.set_healthy(True)
                    r.breaker.reset()
                    self._emit("pool.healthy", host=r.host, via="quarantine")
            elif not r.healthy:
                if probe(f"{r.base}/healthz") == 200:
                    with self._lock:
                        r.consecutive_failures = 0
                        r.spec = None
                        r.specs.clear()
                        r.draining = False
                        r.set_healthy(True)
                    r.breaker.reset()
                    # The probe is the half-open trial for the replica's
                    # breaker: a 200 re-admits it to rotation.
                    self._emit("breaker.half_open", host=r.host)
                    self._emit("pool.healthy", host=r.host, via="probe")
            else:
                status = probe(f"{r.base}/readyz")
                if r.draining:
                    if status == 200:
                        with self._lock:
                            r.draining = False
                    elif status is None:
                        # The draining process is gone: hand recovery to
                        # the unhealthy//healthz path.
                        with self._lock:
                            r.draining = False
                            r.set_healthy(False)
                        self._emit(
                            "pool.unhealthy", host=r.host, reason="drain_dead"
                        )
                elif status is not None and status != 200:
                    with self._lock:
                        r.draining = True
                    _log.info(
                        "replica %s readyz=%d: draining (no new primaries)",
                        r.host, status,
                    )
                    self._emit("pool.drain", host=r.host, status=status)

    # --- introspection -----------------------------------------------------

    def debug_payload(self) -> dict:
        """The /debug/pool document: membership + per-replica selection
        state (what ``kdlt-client --stats`` renders per replica)."""
        reps = list(self.replicas)
        with self._lock:
            joins, leaves = self.joins, self.leaves
        return {
            "failover": self.failover,
            "hedge_delay_ms": self.hedge_delay_s * 1e3,
            "probe_interval_s": self.probe_interval_s,
            "resolve_interval_s": self.resolve_interval_s,
            "members": len(reps),
            "joins": joins,
            "leaves": leaves,
            "replicas": [
                {
                    "host": r.host,
                    "healthy": r.healthy,
                    "quarantined": r.quarantined,
                    "draining": r.draining,
                    "consecutive_failures": r.consecutive_failures,
                    "picks": r.picks,
                    "ewma_ms": (
                        round(r.ewma_ms, 3) if r.ewma_ms is not None else None
                    ),
                }
                for r in reps
            ],
        }

    def close(self) -> None:
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
            self._probe_thread = None
