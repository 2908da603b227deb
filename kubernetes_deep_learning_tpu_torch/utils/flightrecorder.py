"""Incident flight recorder: a black box for the serving stack.

The port's copy of the JAX package's ``utils/flightrecorder.py``, with the
same closed event vocabulary, trigger rules and bundle format (the
brownout kinds stay in the vocabulary though this package emits none of
them until ROADMAP A12b; the generative lane emits the decode kinds).  The
serving path emits failure signals -- SLO burn
(utils/slo.py), dispatch-stall watchdogs (runtime/engine.py), registry
loads and unloads -- but each is transient: traces age out of the ring,
/debug/* pages show only *current* state, and by the time an operator
arrives the causal evidence is gone.  This module records the
evidence at the moment it happens (Dapper's lesson) at always-on cost
(GWP's discipline):

* **Event timeline** -- a bounded, lock-cheap ring of structured events
  (wall + monotonic stamped, bounded ``kind`` vocabulary) fed by hooks at
  every failure edge in both tiers.
* **Trigger engine** -- declarative rules (``KDLT_INCIDENT_TRIGGERS``,
  grammar ``name[=threshold]``) with per-trigger hysteresis and a dedup
  window, so a flapping signal yields ONE incident, not a bundle storm.
* **Bundle capture** -- on fire, a background worker atomically writes a
  self-contained JSON bundle under ``KDLT_INCIDENT_DIR``: the last-N
  timeline events (sorted), the implicated traces (pinned against Tracer
  eviction via the ``incident`` retention class), every registered
  /debug snapshot, a metrics-delta since the previous capture, and (model
  tier, opt-in ``KDLT_INCIDENT_PROFILE_S``) a short device profile.
  Count/byte caps evict oldest-first.
* **Surfacing** -- ``index()``/``get()`` back the tier's /debug/incidents
  endpoints.  All kdlt_incident_* series are minted in utils/metrics.py
  (incident_metrics), nowhere else.

The recorder is per-tier and constructor-injected (never process-global:
one process may run several model servers).  ``KDLT_INCIDENT=0`` is the
kill switch -- every hook degrades to a cheap no-op.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time

from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

ENABLE_ENV = "KDLT_INCIDENT"
DIR_ENV = "KDLT_INCIDENT_DIR"
TRIGGERS_ENV = "KDLT_INCIDENT_TRIGGERS"
DEDUP_ENV = "KDLT_INCIDENT_DEDUP_S"
MAX_BUNDLES_ENV = "KDLT_INCIDENT_MAX_BUNDLES"
MAX_MB_ENV = "KDLT_INCIDENT_MAX_MB"
PROFILE_ENV = "KDLT_INCIDENT_PROFILE_S"

DEFAULT_TRIGGERS = "burn-crossing,brownout=1,dispatch-stall,replica-unhealthy"
DEFAULT_DEDUP_S = 60.0
DEFAULT_MAX_BUNDLES = 32
DEFAULT_MAX_MB = 64.0
RING_EVENTS = 512     # timeline ring capacity (per tier)
BUNDLE_EVENTS = 128   # last-N timeline events captured into a bundle
BUNDLE_TRACES = 8     # most-recent implicated traces pinned per bundle

# The closed event vocabulary.  record() REJECTS anything else: an
# unbounded kind set would make the timeline (and any future kind-labeled
# series) unbounded, and every emitter is in-repo -- a new failure edge
# adds its kind here first.
EVENT_KINDS = frozenset({
    "brownout.enter",     # ladder moved up a stage (attrs: stage, burn)
    "brownout.exit",      # ladder moved down a stage (attrs: stage, burn)
    "burn.cross",         # worst-model 5m burn crossed the trigger
                          # threshold (attrs: direction up|down, burn)
    "shed.burst",         # >= threshold admission sheds in one eval tick
    "breaker.open",       # gateway shed because a replica breaker is open
    "breaker.half_open",  # probe re-admitted a previously failed replica
    "dispatch.stall",     # dispatch watchdog declared the pipeline dead
    "pool.join",          # replica joined the upstream pool
    "pool.leave",         # replica left the upstream pool
    "pool.drain",         # replica entered draining
    "pool.quarantine",    # joiner held in probe quarantine
    "pool.unhealthy",     # replica flipped unhealthy (breaker opened)
    "pool.healthy",       # replica flipped back healthy
    "pool.stalled",       # replica advertised a dispatch stall (header)
    "registry.load",      # model version loaded/activated
    "registry.unload",    # model version unloaded
    "quant.gate_fail",    # int8 warmup tolerance gate refused activations
    "warm.compile",       # warmup bucket missed the compile cache
    "incident.capture",   # the recorder itself captured a bundle
    "decode.saturated",   # every decode slot busy while the admission
                          # queue is non-empty (attrs: queued, slots)
    "decode.shed",        # a generation was refused/retired by policy --
                          # queue full or deadline (attrs: reason)
})

# Trigger rules: what fires each one, what clears (re-arms) it, and the
# default threshold.  A trigger with a clear kind is HYSTERETIC: after a
# fire it stays armed -- further fires are suppressed, even past the dedup
# window -- until the clearing signal is seen.  A trigger without one
# (dispatch-stall) re-arms on the dedup window alone: the stall is
# terminal for its dispatcher, so a later fire is a genuinely new stall.
TRIGGER_RULES = {
    "burn-crossing": {
        "fire": "burn.cross", "clear": "burn.cross", "threshold": 1.0,
    },
    "brownout": {
        "fire": "brownout.enter", "clear": "brownout.exit", "threshold": 1.0,
    },
    "dispatch-stall": {
        "fire": "dispatch.stall", "clear": None, "threshold": None,
    },
    "replica-unhealthy": {
        "fire": "pool.unhealthy", "clear": "pool.healthy", "threshold": None,
    },
}


def parse_triggers(spec: str) -> dict:
    """``name[=threshold],...`` -> {name: threshold}.  Unknown names are a
    hard error (the vocabulary bounds the metric label), bad thresholds
    too -- a typo'd trigger spec must fail loudly at construction, not
    silently record nothing during the incident it was meant to catch."""
    out: dict = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, _, thr = part.partition("=")
        name = name.strip()
        if name not in TRIGGER_RULES:
            raise ValueError(
                f"unknown incident trigger {name!r}; known: "
                f"{', '.join(sorted(TRIGGER_RULES))}"
            )
        out[name] = float(thr) if thr.strip() else TRIGGER_RULES[name]["threshold"]
    return out


def merge_windows(entries: list, window_s: float = 30.0) -> list:
    """Group incident summaries (own + replicas') into causal windows: one
    failure typically fires triggers on several processes within seconds
    (a stalled replica -> model-tier dispatch-stall + gateway
    replica-unhealthy).  Entries closer than ``window_s`` merge."""
    dated = [
        e for e in entries if isinstance(e.get("fired_at_s"), (int, float))
    ]
    dated.sort(key=lambda e: e["fired_at_s"])
    windows: list = []
    for e in dated:
        ref = {
            "id": e.get("id"), "origin": e.get("origin", "local"),
            "tier": e.get("tier"), "trigger": e.get("trigger"),
            "fired_at_s": e["fired_at_s"],
        }
        if windows and e["fired_at_s"] - windows[-1]["end_s"] <= window_s:
            w = windows[-1]
            w["end_s"] = e["fired_at_s"]
            w["incidents"].append(ref)
            if e.get("trigger") and e["trigger"] not in w["triggers"]:
                w["triggers"].append(e["trigger"])
        else:
            windows.append({
                "start_s": e["fired_at_s"], "end_s": e["fired_at_s"],
                "triggers": [e["trigger"]] if e.get("trigger") else [],
                "incidents": [ref],
            })
    return windows


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except (TypeError, ValueError):
        return default


class FlightRecorder:
    """Per-tier event timeline + trigger engine + bundle store.

    Thread model: record() appends to a deque under a short lock and runs
    the trigger gate inline; a fire only *enqueues* a capture -- the
    expensive part (snapshots, metrics parse, optional profile sleep,
    disk write) runs on one daemon worker, so hot paths (request
    handlers, the brownout loop, pool probes) never block on it, and
    concurrent fires serialize into complete, atomic bundles.
    """

    def __init__(
        self,
        tier: str,
        registry=None,
        *,
        tracer=None,
        incident_dir: str | None = None,
        triggers: str | None = None,
        dedup_s: float | None = None,
        max_bundles: int | None = None,
        max_mb: float | None = None,
        profile_s: float | None = None,
        profiler=None,
        clock=time.monotonic,
        wall=time.time,
        enabled: bool | None = None,
        ring_events: int = RING_EVENTS,
        bundle_events: int = BUNDLE_EVENTS,
    ):
        env = os.environ
        if enabled is None:
            enabled = env.get(ENABLE_ENV, "1") not in ("0", "false", "off")
        self.enabled = bool(enabled)
        self.tier = tier
        self.tracer = tracer
        self.incident_dir = (
            env.get(DIR_ENV, "") if incident_dir is None else incident_dir
        )
        spec = env.get(TRIGGERS_ENV, "") or DEFAULT_TRIGGERS
        if triggers is not None:
            spec = triggers
        self._triggers = {
            name: {"threshold": thr, "armed": False, "last_fired_m": None}
            for name, thr in parse_triggers(spec).items()
        }
        self.dedup_s = (
            _env_float(DEDUP_ENV, DEFAULT_DEDUP_S)
            if dedup_s is None else float(dedup_s)
        )
        self.max_bundles = int(
            _env_float(MAX_BUNDLES_ENV, DEFAULT_MAX_BUNDLES)
            if max_bundles is None else max_bundles
        )
        self.max_mb = (
            _env_float(MAX_MB_ENV, DEFAULT_MAX_MB)
            if max_mb is None else float(max_mb)
        )
        self.profile_s = (
            _env_float(PROFILE_ENV, 0.0)
            if profile_s is None else float(profile_s)
        )
        self._profiler = profiler
        self._clock = clock
        self._wall = wall
        self.bundle_events = int(bundle_events)
        self._ring: collections.deque = collections.deque(  # guarded-by: _ring_lock
            maxlen=int(ring_events)
        )
        self._ring_lock = threading.Lock()
        self._trig_lock = threading.Lock()
        self._index_lock = threading.Lock()
        self._index: list = []       # guarded-by: _index_lock
        self._bundles: dict = {}     # guarded-by: _index_lock
        self._seq = 0                # guarded-by: _index_lock
        self._registry = registry
        # _last_metrics is touched only by _metrics_delta on the capture
        # worker thread (single consumer); no lock needed.
        self._last_metrics: dict | None = None
        self._shed_seen = 0          # guarded-by: _trig_lock
        self._shed_mark = 0          # guarded-by: _trig_lock
        self._last_burn: float | None = None  # guarded-by: _trig_lock
        self._m = (
            metrics_lib.incident_metrics(registry)
            if registry is not None else None
        )
        self._queue: queue.Queue = queue.Queue(maxsize=16)
        self._worker: threading.Thread | None = None  # guarded-by: _idle
        self._pending = 0            # guarded-by: _idle
        self._idle = threading.Condition()
        self._closed = False         # guarded-by: _idle
        # Snapshot providers: name -> zero-arg callable returning the same
        # JSON the matching /debug/<name> endpoint serves.  Registered by
        # the owning tier at construction time, read-only afterwards.
        self._providers: dict = {}
        if self.enabled and self.incident_dir:
            self._reindex_dir()

    # --- timeline ----------------------------------------------------------

    def record(self, kind: str, rid: str | None = None, **attrs) -> None:
        """Append one structured event to the ring and run the trigger
        gate.  Cheap by design: a dict build, a deque append under a
        short lock, and a handful of comparisons."""
        if not self.enabled:
            return
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        ev: dict = {
            "t": self._wall(), "m": self._clock(),
            "tier": self.tier, "kind": kind,
        }
        if rid:
            ev["rid"] = rid
        if attrs:
            ev["attrs"] = attrs
        with self._ring_lock:
            self._ring.append(ev)
        self._check_triggers(ev)

    def events(self, last: int | None = None) -> list:
        with self._ring_lock:
            out = list(self._ring)
        if last is not None:
            out = out[-int(last):]
        return out

    def observe_burn(self, burn: float) -> None:
        """Edge-detect the worst-model burn against the burn-crossing
        trigger's threshold and emit burn.cross events on each crossing.
        Called once per brownout eval tick; the crossing threshold IS the
        trigger threshold (``burn-crossing=2.5`` moves both)."""
        if not self.enabled:
            return
        thr = self.trigger_threshold("burn-crossing", 1.0)
        with self._trig_lock:
            prev, self._last_burn = self._last_burn, burn
        if prev is None:
            return
        if prev < thr <= burn:
            self.record(
                "burn.cross", direction="up",
                burn=round(burn, 4), threshold=thr,
            )
        elif burn < thr <= prev:
            self.record(
                "burn.cross", direction="down",
                burn=round(burn, 4), threshold=thr,
            )

    def note_shed(self) -> None:
        """O(1) shed tick from admission hot paths; tick_shed_burst turns
        the per-tick delta into at most one shed.burst event."""
        if self.enabled:
            with self._trig_lock:
                self._shed_seen += 1

    def tick_shed_burst(self, min_burst: int = 10) -> None:
        if not self.enabled:
            return
        with self._trig_lock:
            seen = self._shed_seen
            delta, self._shed_mark = seen - self._shed_mark, seen
        if delta >= min_burst:
            self.record("shed.burst", count=delta)

    def trigger_threshold(self, name: str, default: float) -> float:
        st = self._triggers.get(name)
        if st is None or st["threshold"] is None:
            return default
        return st["threshold"]

    # --- trigger engine ----------------------------------------------------

    def _matches_fire(self, name: str, st: dict, ev: dict) -> bool:
        rule = TRIGGER_RULES[name]
        if ev["kind"] != rule["fire"]:
            return False
        attrs = ev.get("attrs") or {}
        if name == "burn-crossing":
            return (
                attrs.get("direction") == "up"
                and float(attrs.get("burn", 0.0)) >= st["threshold"]
            )
        if name == "brownout":
            return float(attrs.get("stage", 0)) >= st["threshold"]
        return True

    def _matches_clear(self, name: str, st: dict, ev: dict) -> bool:
        rule = TRIGGER_RULES[name]
        if rule["clear"] is None or ev["kind"] != rule["clear"]:
            return False
        attrs = ev.get("attrs") or {}
        if name == "burn-crossing":
            return attrs.get("direction") == "down"
        if name == "brownout":
            return float(attrs.get("stage", 0)) < st["threshold"]
        return True

    def _check_triggers(self, ev: dict) -> None:
        for name, st in self._triggers.items():
            with self._trig_lock:
                if self._matches_clear(name, st, ev):
                    st["armed"] = False
                if not self._matches_fire(name, st, ev):
                    continue
                now = self._clock()
                last = st["last_fired_m"]
                deduped = last is not None and (now - last) < self.dedup_s
                if deduped or st["armed"]:
                    if self._m is not None:
                        c = self._m["suppressed"].get(name)
                        if c is not None:
                            c.inc()
                    continue
                st["last_fired_m"] = now
                if TRIGGER_RULES[name]["clear"] is not None:
                    st["armed"] = True
            self._enqueue_capture(name, ev)

    # --- bundle capture ----------------------------------------------------

    def add_snapshot_provider(self, name: str, fn) -> None:
        """Register a /debug/<name>-shaped snapshot callable (construction
        time only; see the _providers declaration in __init__)."""
        self._providers[name] = fn

    def _enqueue_capture(self, trigger: str, ev: dict) -> None:
        with self._ring_lock:
            tail = list(self._ring)[-self.bundle_events:]
        with self._idle:
            if self._closed:
                return
            self._pending += 1
        try:
            self._queue.put_nowait((trigger, ev, tail, time.perf_counter()))
        except queue.Full:
            # A full capture queue means the worker is wedged (or the
            # dedup window is misconfigured to ~0); losing THIS bundle is
            # better than blocking the failure path that fired it.
            with self._idle:
                self._pending -= 1
                self._idle.notify_all()
            if self._m is not None:
                c = self._m["suppressed"].get(trigger)
                if c is not None:
                    c.inc()
            return
        # Double-checked: the unlocked read only skips the lock when a worker
        # already exists; creation re-checks under _idle.
        if self._worker is None:
            with self._idle:
                if self._worker is None and not self._closed:
                    self._worker = threading.Thread(
                        target=self._worker_loop,
                        name=f"kdlt-incident-{self.tier}", daemon=True,
                    )
                    self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            trigger, ev, tail, t0 = item
            try:
                self._capture(trigger, ev, tail, t0)
            except Exception:  # noqa: BLE001 - the recorder must never kill
                pass           # its host tier; a failed capture is just lost
            finally:
                with self._idle:
                    self._pending -= 1
                    self._idle.notify_all()

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until every enqueued capture has been written (tests and
        smoke runs use this; production never waits)."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._pending > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(left)
        return True

    def _capture(self, trigger: str, ev: dict, tail: list, t0: float) -> None:
        with self._index_lock:
            self._seq += 1
            seq = self._seq
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(ev["t"]))
        bundle_id = f"inc-{stamp}-{seq:04d}-{trigger}"
        events = sorted(tail, key=lambda e: e.get("m", 0.0))
        bundle: dict = {
            "id": bundle_id,
            "tier": self.tier,
            "trigger": trigger,
            "fired_at_s": ev["t"],
            "event": ev,
            "events": events,
            "snapshots": {},
            "traces": {},
            "metrics_delta": self._metrics_delta(),
        }
        for name, fn in self._providers.items():
            try:
                bundle["snapshots"][name] = fn()
            except Exception as e:  # noqa: BLE001 - a broken provider must
                bundle["snapshots"][name] = {"error": str(e)}  # not void the bundle
        if self.tracer is not None:
            rids: list = []
            for e in reversed(events):
                r = e.get("rid")
                if r and r not in rids:
                    rids.append(r)
                if len(rids) >= BUNDLE_TRACES:
                    break
            for r in rids:
                try:
                    # Pin first (upgrade-only), then read: classified
                    # ``incident`` the trace outlives ring churn for as
                    # long as the operator needs the bundle's ids to
                    # resolve via /debug/trace/<rid>.
                    self.tracer.classify(r, "incident")
                    info = self.tracer.trace_info(r)
                except Exception:  # noqa: BLE001 - trace already evicted
                    info = None
                if info:
                    bundle["traces"][r] = info
        if self.profile_s > 0 and self._profiler is not None:
            try:
                bundle["profile"] = self._profiler(self.profile_s)
            except Exception as e:  # noqa: BLE001 - profiling is best-effort
                bundle["profile"] = {"error": str(e)}
        bundle["captured_at_s"] = self._wall()
        bundle["capture_latency_s"] = round(time.perf_counter() - t0, 4)
        self._store(bundle)
        if self._m is not None:
            c = self._m["captures"].get(trigger)
            if c is not None:
                c.inc()
        self.record(
            "incident.capture", incident_id=bundle_id, trigger=trigger,
            latency_s=bundle["capture_latency_s"],
        )

    def _store(self, bundle: dict) -> None:
        data = json.dumps(bundle, indent=1, default=str)
        path = ""
        if self.incident_dir:
            try:
                os.makedirs(self.incident_dir, exist_ok=True)
                path = os.path.join(self.incident_dir, bundle["id"] + ".json")
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(data)
                # Atomic publish: a reader (or a crash) never observes a
                # torn bundle -- it exists complete or not at all.
                os.replace(tmp, path)
            except OSError:
                path = ""
        entry = {
            "id": bundle["id"], "tier": bundle["tier"],
            "trigger": bundle["trigger"],
            "fired_at_s": bundle["fired_at_s"],
            "captured_at_s": bundle.get("captured_at_s"),
            "capture_latency_s": bundle.get("capture_latency_s"),
            "events": len(bundle.get("events", ())),
            "traces": sorted(bundle.get("traces", {})),
            "bytes": len(data), "path": path,
        }
        with self._index_lock:
            self._index.append(entry)
            self._bundles[bundle["id"]] = bundle
            self._evict_locked()
            if self._m is not None:
                self._m["open"].set(len(self._index))

    def _evict_locked(self) -> None:
        max_bytes = int(self.max_mb * 1024 * 1024)
        while len(self._index) > 1 and (
            len(self._index) > self.max_bundles
            or sum(e["bytes"] for e in self._index) > max_bytes
        ):
            old = self._index.pop(0)  # oldest-first
            self._bundles.pop(old["id"], None)
            if old.get("path"):
                try:
                    os.remove(old["path"])
                except OSError:
                    pass
            if self._m is not None:
                c = self._m["dropped"].get(old.get("trigger"))
                if c is not None:
                    c.inc()

    def _reindex_dir(self) -> None:
        """Adopt a previous process's bundles (the dir outlives restarts
        on the cache volume) so caps and the open gauge stay honest."""
        try:
            names = sorted(os.listdir(self.incident_dir))
        except OSError:
            return
        adopted: list = []
        for name in names:
            if not (name.startswith("inc-") and name.endswith(".json")):
                continue
            path = os.path.join(self.incident_dir, name)
            try:
                with open(path, encoding="utf-8") as f:
                    bundle = json.load(f)
                size = os.path.getsize(path)
            except (OSError, ValueError):
                continue
            adopted.append({
                "id": bundle.get("id", name[:-5]),
                "tier": bundle.get("tier"),
                "trigger": bundle.get("trigger"),
                "fired_at_s": bundle.get("fired_at_s"),
                "captured_at_s": bundle.get("captured_at_s"),
                "capture_latency_s": bundle.get("capture_latency_s"),
                "events": len(bundle.get("events", ())),
                "traces": sorted(bundle.get("traces", {})),
                "bytes": size, "path": path,
            })
        with self._index_lock:
            self._index.extend(adopted)
            self._index.sort(key=lambda e: e.get("fired_at_s") or 0.0)
            self._evict_locked()
            if self._m is not None:
                self._m["open"].set(len(self._index))

    def _metrics_delta(self) -> dict:
        """Every series whose value moved since the previous capture,
        parsed back out of the registry's own text exposition -- the one
        format every metric already renders to."""
        if self._registry is None:
            return {}
        cur: dict = {}
        try:
            text = self._registry.render()
        except Exception:  # noqa: BLE001 - diagnostics only
            return {}
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            line = line.split(" # ", 1)[0].rstrip()  # strip exemplars
            try:
                key, val = line.rsplit(" ", 1)
                cur[key] = float(val)
            except ValueError:
                continue
        prev, self._last_metrics = self._last_metrics or {}, cur
        return {
            k: round(v - prev.get(k, 0.0), 6)
            for k, v in cur.items() if v != prev.get(k, 0.0)
        }

    # --- surfacing ---------------------------------------------------------

    def index(self) -> list:
        """Bundle summaries, newest first (what /debug/incidents serves)."""
        with self._index_lock:
            return [dict(e) for e in reversed(self._index)]

    def debug_payload(self) -> dict:
        return {
            "tier": self.tier,
            "enabled": self.enabled,
            "dir": self.incident_dir,
            "triggers": {
                name: {
                    "threshold": st["threshold"], "armed": st["armed"],
                }
                for name, st in self._triggers.items()
            },
            "dedup_s": self.dedup_s,
            "caps": {"max_bundles": self.max_bundles, "max_mb": self.max_mb},
            "incidents": self.index(),
        }

    def get(self, bundle_id: str) -> dict | None:
        """Full bundle by id: memory mirror first, then disk (bundles a
        previous process wrote survive on the volume)."""
        with self._index_lock:
            got = self._bundles.get(bundle_id)
            if got is not None:
                return got
            entry = next(
                (e for e in self._index if e["id"] == bundle_id), None
            )
        if entry is None or not entry.get("path"):
            return None
        try:
            with open(entry["path"], encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def close(self) -> None:
        with self._idle:
            self._closed = True
            worker = self._worker
        if worker is not None:
            self._queue.put(None)
            worker.join(timeout=5.0)
