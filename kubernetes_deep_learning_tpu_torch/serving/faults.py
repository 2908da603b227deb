"""Deterministic fault injection for the serving hot path.

The port's copy of the JAX package's ``serving/faults.py`` (the port's
gateway fires its ``gateway.upstream`` point).

The reference (and PRs 0-2 here) can only *hope* the serving path recovers
from failure: nothing in the system can deliberately break a component, so
"failover works" was an untested belief.  Chaos-engineering practice
(Basiri et al., "Chaos Engineering", IEEE Software '16) says recovery code
that is never exercised is broken by default; this module makes breaking a
component a one-env-var operation, deterministic enough to assert on in
tests and the bench.py --chaos-ab harness.

Configuration: ``KDLT_FAULTS=point:kind:rate[:arg][,point:kind:rate[:arg]]``
with ``KDLT_FAULTS_SEED`` (default 0) seeding the per-(point, kind) random
streams, so the exact same request sequence sees the exact same faults on
every run regardless of thread interleaving across points.

Fault points are the ``FAULT_POINTS`` registry below -- the closed
vocabulary of names compiled into the serving path (the fault matrix,
GUIDE.md section 10e):

==================  =====================================================
point               where it fires
==================  =====================================================
``gateway.upstream``  the gateway's upstream POST to a model-tier replica
                      (before the socket is touched; an injected error is
                      indistinguishable from a dead replica)
``server.predict``    the model server's /predict handler, after routing
                      and admission (corrupt applies to the response bytes)
``dispatch.submit``   InFlightDispatcher.submit, before predict_async
``dispatch.complete`` the dispatcher's completion thread, before the
                      blocking device sync (a ``hang`` here is a wedged
                      device handle -- the watchdog's prey)
``grpc.predict``      the gRPC PredictionService unary shell
``crosshost.broadcast`` the cross-host input broadcast, before the
                      collective is issued
``crosshost.collective`` the cross-host collective compute step
==================  =====================================================

Kinds:

- ``error``      raise :class:`InjectedFault` (a server-side 5xx-shaped
                 failure, never a client 400)
- ``latency``    sleep ``arg`` milliseconds (default 100)
- ``hang``       sleep ``arg`` SECONDS (default 300) -- a wedged component,
                 not a slow one; pair with the dispatcher watchdog
- ``disconnect`` raise :class:`InjectedDisconnect` (a ConnectionError; HTTP
                 handlers translate it into an abrupt socket close with no
                 response bytes)
- ``corrupt``    garble the payload handed to :meth:`FaultInjector.corrupt`
                 (response-body corruption; decoders must fail loudly)

Inertness contract: when ``KDLT_FAULTS`` is unset/empty, :func:`from_env`
returns ``None`` and every call site is a single ``is not None`` check --
the production hot path pays nothing.  Components each build their OWN
injector at construction time (no process-global mutable state), so tests
can run faulted and clean servers side by side in one process.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
import zlib

FAULTS_ENV = "KDLT_FAULTS"
SEED_ENV = "KDLT_FAULTS_SEED"

KINDS = ("error", "latency", "hang", "disconnect", "corrupt")

# The closed vocabulary of fault points (see the module docstring's matrix
# for where each fires).  Production ``fire()``/``corrupt()`` call sites
# use these exact strings; kdlt-lint's closed-vocab pass enforces
# membership statically, so a chaos experiment against a typo'd point
# cannot silently "pass" by testing nothing.  parse_rules itself stays
# permissive (tests inject at synthetic points).
FAULT_POINTS = frozenset({
    "gateway.upstream",
    "server.predict",
    "dispatch.submit",
    "dispatch.complete",
    "grpc.predict",
    "crosshost.broadcast",
    "crosshost.collective",
})

DEFAULT_LATENCY_MS = 100.0
DEFAULT_HANG_S = 300.0


class InjectedFault(RuntimeError):
    """A deliberately injected component failure (server-fault-shaped)."""


class InjectedDisconnect(ConnectionError):
    """A deliberately injected abrupt connection loss."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    point: str
    kind: str
    rate: float       # firing probability per arrival at the point, [0, 1]
    arg: float | None  # latency: ms; hang: seconds; others: unused


def parse_rules(spec: str) -> tuple[FaultRule, ...]:
    """``point:kind:rate[:arg]``, comma-separated -> validated rules.

    Raises ValueError on malformed entries: a typo'd chaos experiment must
    fail the boot loudly, not silently run the healthy configuration and
    "pass" the recovery test.
    """
    rules = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"fault entry {entry!r} is not point:kind:rate[:arg]"
            )
        point, kind, rate_s = parts[0], parts[1], parts[2]
        if not point:
            raise ValueError(f"fault entry {entry!r} has an empty point")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {KINDS})")
        rate = float(rate_s)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate {rate!r} outside [0, 1] in {entry!r}")
        arg = float(parts[3]) if len(parts) == 4 else None
        rules.append(FaultRule(point, kind, rate, arg))
    return tuple(rules)


class FaultInjector:
    """Applies configured fault rules at named points, deterministically.

    Each (point, kind) pair draws from its own seeded random stream, so
    which arrivals fault depends only on (seed, point, kind, arrival
    index at that point) -- never on thread scheduling across points.
    """

    def __init__(self, rules: tuple[FaultRule, ...], seed: int = 0):
        self.rules = rules
        self.seed = seed
        self._by_point: dict[str, list[FaultRule]] = {}
        for r in rules:
            self._by_point.setdefault(r.point, []).append(r)
        self._rngs = {
            (r.point, r.kind): random.Random(
                zlib.crc32(f"{seed}/{r.point}/{r.kind}".encode())
            )
            for r in rules
        }
        self.counts: dict[tuple[str, str], int] = {
            (r.point, r.kind): 0 for r in rules
        }
        self._lock = threading.Lock()
        # kdlt_fault_injected_total{point,kind} counters per attached
        # registry, pre-created at attach so the series are visible at 0.
        self._counters: list[dict[tuple[str, str], object]] = []

    @classmethod
    def from_env(cls, environ=None) -> "FaultInjector | None":
        """The env-configured injector, or None (the inert fast path)."""
        environ = os.environ if environ is None else environ
        spec = environ.get(FAULTS_ENV, "").strip()
        if not spec:
            return None
        raw_seed = environ.get(SEED_ENV, "").strip()
        try:
            seed = int(raw_seed) if raw_seed else 0
        except ValueError:
            seed = 0
        rules = parse_rules(spec)
        return cls(rules, seed=seed) if rules else None

    def attach(self, registry) -> None:
        """Export kdlt_fault_injected_total{point,kind} on ``registry``."""
        counters = {
            (r.point, r.kind): registry.with_labels(
                point=r.point, kind=r.kind
            ).counter(
                "kdlt_fault_injected_total",
                "faults injected by the KDLT_FAULTS framework",
            )
            for r in self.rules
        }
        with self._lock:
            self._counters.append(counters)

    def _roll(self, rule: FaultRule) -> bool:
        with self._lock:
            fired = self._rngs[(rule.point, rule.kind)].random() < rule.rate
            if fired:
                self.counts[(rule.point, rule.kind)] += 1
                for counters in self._counters:
                    counters[(rule.point, rule.kind)].inc()
        return fired

    def fire(self, point: str) -> None:
        """Apply the control-flow kinds configured at ``point`` (in rule
        order): latency/hang sleep on the calling thread, error/disconnect
        raise.  ``corrupt`` rules are ignored here (see :meth:`corrupt`)."""
        for rule in self._by_point.get(point, ()):
            if rule.kind == "corrupt" or not self._roll(rule):
                continue
            if rule.kind == "latency":
                time.sleep((rule.arg if rule.arg is not None else DEFAULT_LATENCY_MS) / 1e3)
            elif rule.kind == "hang":
                time.sleep(rule.arg if rule.arg is not None else DEFAULT_HANG_S)
            elif rule.kind == "error":
                raise InjectedFault(f"injected fault at {point}")
            elif rule.kind == "disconnect":
                raise InjectedDisconnect(f"injected disconnect at {point}")

    def corrupt(self, point: str, data: bytes) -> bytes:
        """Apply any firing ``corrupt`` rule at ``point`` to ``data``.

        Garbles a prefix (XOR) so decoders fail structurally instead of
        returning shifted-but-plausible values -- a corrupt response must
        surface as a loud 502-class decode error, never silent bad data.
        """
        for rule in self._by_point.get(point, ()):
            if rule.kind == "corrupt" and self._roll(rule):
                head = bytes(b ^ 0x5A for b in data[:64])
                return head + data[64:]
        return data


def from_env(environ=None) -> FaultInjector | None:
    """Module-level convenience mirror of FaultInjector.from_env."""
    return FaultInjector.from_env(environ)
