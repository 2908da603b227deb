"""Unified SLO-aware scheduling core: which requests run next, for which model.

The port of the JAX package's ``runtime/scheduler.py``.  Many models share
one card, and the question is *whose* batch runs next:

    per request in:   (model, payload, deadline budget, implicit cost
                       estimate from the model's observed service times)
    dispatch plan out: one (model, batch) handed to ONE shared
                       InFlightDispatcher -- one bounded in-flight budget and
                       one FIFO completion thread for the whole tier, because
                       the card runs one stream's work in order whichever
                       model captured it.

Per model there is a *lane*: a bounded queue with the continuous-batching
flush rule (dispatch when full; linger up to ``max_delay`` for stragglers
when small -- the DynamicBatcher's policy).  Across lanes a policy
arbitrates:

- ``fifo`` -- the naive baseline: whichever lane's head request arrived
  first.  Head-of-line blocking across models is what it shows.
- ``weighted_deadline`` (default) -- earliest *effective* deadline first: a
  lane's urgency is its earliest absolute deadline minus the estimated
  service time of the batch (the latest viable start), so a slow model's
  request outranks a fast model's with the same deadline.  On top, per-model
  *weight floors*: each lane is guaranteed ``WEIGHT_FLOOR_FRACTION`` of its
  weight's fair share of observed device time; a lane starved below its
  floor preempts the deadline order.

Knobs: ``KDLT_SCHED_POLICY`` (weighted_deadline | fifo) and
``KDLT_SCHED_WEIGHTS`` ("modelA=2,modelB=1"; unlisted models weigh 1).

On the card a plan's units are gathered straight into a staging slot the
engine lends (one host copy, not a concatenate and then a copy).  The
scheduler also counts, per engine, the plans it has taken and not yet seen
complete: ``wait_engine_idle`` is what an unloaded version waits on before
its engine frees the graphs those plans replay.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future

import numpy as np

from kubernetes_deep_learning_tpu_torch.runtime.batcher import BatcherClosed, QueueFull
from kubernetes_deep_learning_tpu_torch.runtime.engine import InFlightDispatcher, StagedBatch
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib
from kubernetes_deep_learning_tpu_torch.utils import trace as trace_lib

SCHED_POLICY_ENV = "KDLT_SCHED_POLICY"
SCHED_WEIGHTS_ENV = "KDLT_SCHED_WEIGHTS"
POLICIES = ("weighted_deadline", "fifo")
DEFAULT_POLICY = "weighted_deadline"

# A lane is guaranteed this fraction of its weight's fair share of device
# time before the starvation guard preempts the deadline order.  Below 1.0
# on purpose: a floor against starvation, not a fair-share enforcer.
WEIGHT_FLOOR_FRACTION = 0.5

# Served-share accounting decays with this half-life so the floor guard
# reacts to the CURRENT mix, not the whole process history.
SHARE_HALFLIFE_S = 10.0

# Requests without a deadline budget get this implicit slack for ordering
# (the reference's 20 s ceiling): among deadline-less traffic the weighted
# policy therefore degrades to FIFO.
DEFAULT_SLACK_S = 20.0

# Priority classes move a unit's EFFECTIVE deadline (ordering only: the
# real deadline still decides timeouts): lower classes concede this much
# slack.  The names are serving.protocol.PRIORITY_CLASSES, spelled here
# because the runtime sits below the wire contract; unknown or absent
# classes get none.
PRIORITY_SLACK_S = {"interactive": 0.0, "batch": 1.0, "best-effort": 5.0}


def resolve_policy(policy: str | None = None) -> str:
    """Explicit arg > $KDLT_SCHED_POLICY > weighted_deadline.  Unknown
    values degrade to the default rather than killing serving."""
    if policy is None:
        policy = os.environ.get(SCHED_POLICY_ENV, "").strip().lower()
    else:
        policy = str(policy).strip().lower()
    return policy if policy in POLICIES else DEFAULT_POLICY


def resolve_weights(raw: str | None = None) -> dict[str, float]:
    """Parse "modelA=2,modelB=0.5" (the $KDLT_SCHED_WEIGHTS format) into a
    name -> weight map; malformed entries are skipped, non-positive weights
    clamped to a small positive value."""
    if raw is None:
        raw = os.environ.get(SCHED_WEIGHTS_ENV, "")
    weights: dict[str, float] = {}
    for part in str(raw).split(","):
        name, sep, value = part.strip().partition("=")
        if not sep or not name:
            continue
        try:
            weights[name] = max(float(value), 1e-3)
        except ValueError:
            continue
    return weights


class UnitFuture(Future):
    """A queued unit's future.  ``engine`` is the engine its plan was
    dispatched to (set when the plan is taken): after a hot swap a unit
    queued under the old version may be served by the new one, and the
    reply names the version that served it."""

    engine = None


class _Unit:
    """One queued unit of work: a single image or a pre-formed chunk.  Units
    are never split across batches, so a chunk's rows stay contiguous."""

    __slots__ = ("images", "n", "future", "deadline_abs", "trace", "enq_t", "enq_w", "single",
                 "priority")

    def __init__(self, images, n, deadline_abs, trace, single, priority=None):
        self.images = images
        self.n = n
        self.future = UnitFuture()
        self.deadline_abs = deadline_abs  # absolute time.monotonic, or None
        self.trace = trace  # utils.trace.RequestTrace, or None
        self.enq_t = time.monotonic()
        self.enq_w = trace_lib.now_s() if trace is not None else 0.0
        self.single = single  # resolve to one row (True) or the row block
        self.priority = priority  # PRIORITY_SLACK_S key, or None


class Lane:
    """Per-model scheduling state: queue, flush policy, share accounting.

    The lane survives engine hot swaps (a version reload replaces
    ``engine``; queued units are engine-agnostic until dispatch), which is
    what makes a reload of model A invisible to model B's work.
    """

    def __init__(self, name: str, engine, weight: float, max_delay_s: float,
                 queue_cap: int, metrics: dict):
        self.name = name
        self.engine = engine
        self.weight = weight
        self.max_delay_s = max_delay_s
        self.queue_cap = queue_cap
        self.queue: list[_Unit] = []
        self.pending_images = 0
        self.m = metrics
        self.m["weight"].set(weight)
        # Decayed device-seconds this lane consumed (the share the weight
        # floor guards) and the per-image service-time EWMA (the cost
        # behind effective deadlines).  Own lock: the dispatch thread reads
        # shares under the scheduler lock while the dispatcher's completion
        # thread reports served time without it.
        self._share_lock = threading.Lock()
        self.served_s = 0.0          # guarded-by: _share_lock
        self._served_at = time.monotonic()  # guarded-by: _share_lock
        self.cost_per_image_s: float | None = None  # guarded-by: _share_lock

    @property
    def max_batch(self) -> int:
        return self.engine.max_batch

    def decayed_served(self, now: float) -> float:
        with self._share_lock:
            return self._decayed_served_locked(now)

    def _decayed_served_locked(self, now: float) -> float:
        dt = max(0.0, now - self._served_at)
        if dt > 0:
            self.served_s *= 0.5 ** (dt / SHARE_HALFLIFE_S)
            self._served_at = now
        return self.served_s

    def observe_served(self, seconds: float, n_images: int) -> None:
        now = time.monotonic()
        with self._share_lock:
            self._decayed_served_locked(now)
            self.served_s += seconds
            per_image = seconds / max(n_images, 1)
            self.cost_per_image_s = (
                per_image if self.cost_per_image_s is None
                else 0.7 * self.cost_per_image_s + 0.3 * per_image
            )
        self.m["device_seconds"].inc(seconds)

    def cost_estimate_s(self, n_images: int) -> float:
        """Estimated service time of an ``n_images`` batch (0 until the
        first completion seeds the EWMA)."""
        with self._share_lock:
            return (self.cost_per_image_s or 0.0) * n_images

    def effective_deadline(self, now: float) -> float:
        """Earliest absolute deadline among queued units minus the
        estimated service time of the head batch: the latest moment a
        dispatch can still start and make its deadline."""
        batch = min(self.pending_images, self.max_batch)
        est = self.cost_estimate_s(batch)
        earliest = min(
            (u.deadline_abs if u.deadline_abs is not None else u.enq_t + DEFAULT_SLACK_S)
            + PRIORITY_SLACK_S.get(u.priority, 0.0)
            for u in self.queue
        )
        return earliest - est

    def oldest_enq_t(self) -> float:
        return self.queue[0].enq_t if self.queue else float("inf")


class UnifiedScheduler:
    """The model tier's one queue and scheduler: requests in, plans out.

    One dispatch thread takes every decision; one shared InFlightDispatcher
    executes the plans (its depth is the whole tier's in-flight budget).
    """

    def __init__(self, registry: metrics_lib.Registry | None = None,
                 policy: str | None = None, weights: dict[str, float] | None = None,
                 pipeline_depth: int | None = None, queue_cap: int = 2048,
                 dispatcher: InFlightDispatcher | None = None):
        self.registry = registry or metrics_lib.Registry()
        self.policy = resolve_policy(policy)
        self._weights = dict(weights) if weights is not None else resolve_weights()
        self._queue_cap = queue_cap
        self.dispatcher = dispatcher or InFlightDispatcher(
            None, depth=pipeline_depth, registry=self.registry)
        self._owns_dispatcher = dispatcher is None
        self._cond = threading.Condition()
        self._lanes: dict[str, Lane] = {}  # guarded-by: _cond
        # Lane metrics persist across unregister/re-register cycles.
        self._lane_metrics: dict[str, dict] = {}  # guarded-by: _cond
        self._closed = False         # guarded-by: _cond
        # Plans taken and not yet completed, per engine (id): what
        # wait_engine_idle waits on.  Its own condition, so a wake meant for
        # the dispatch thread never lands on an idle waiter.
        self._idle = threading.Condition()
        self._busy: dict[int, int] = {}  # guarded-by: _idle
        self._m_models = self.registry.gauge(
            "kdlt_sched_models", "models registered with the scheduler")
        self._m_policy = {
            p: self.registry.with_labels(policy=p).gauge(
                "kdlt_sched_policy", "1 for the active arbitration policy")
            for p in POLICIES
        }
        self._m_policy[self.policy].set(1.0)
        self._thread = threading.Thread(target=self._run, name="kdlt-scheduler", daemon=True)
        self._thread.start()

    @property
    def stalled(self) -> bool:
        return self.dispatcher.stalled

    # --- lane lifecycle -----------------------------------------------------

    def register(self, name: str, engine, weight: float | None = None,
                 max_delay_ms: float = 2.0) -> Lane:
        """Add a model lane, or hot-swap an existing lane's engine (a version
        reload): queued units are engine-agnostic, so a swap never drops or
        reorders work, and other lanes are untouched."""
        if weight is None:
            weight = self._weights.get(name, 1.0)
        with self._cond:
            if self._closed:
                raise BatcherClosed("scheduler is shut down")
            lane = self._lanes.get(name)
            if lane is not None:
                lane.engine = engine
                lane.weight = weight
                lane.m["weight"].set(weight)
                return lane
            metrics = self._lane_metrics.get(name)
            if metrics is None:
                metrics = metrics_lib.scheduler_lane_metrics(self.registry, name)
                self._lane_metrics[name] = metrics
                self.dispatcher.stage_histograms(name)
            lane = Lane(name, engine, weight, max_delay_ms / 1e3, self._queue_cap, metrics)
            self._lanes[name] = lane
            self._m_models.set(float(len(self._lanes)))
            return lane

    def unregister(self, name: str, engine=None) -> None:
        """Remove a lane (model unloaded).  ``engine`` guards the hot-swap
        race: a superseded version's close must not tear down the lane its
        replacement already owns."""
        with self._cond:
            lane = self._lanes.get(name)
            if lane is None or (engine is not None and lane.engine is not engine):
                return
            del self._lanes[name]
            self._m_models.set(float(len(self._lanes)))
            pending = lane.queue[:]
            lane.queue.clear()
            lane.pending_images = 0
            lane.m["queue_depth"].set(0.0)
        for u in pending:
            if not u.future.cancelled():
                u.future.set_exception(BatcherClosed(f"model {name!r} was unloaded"))

    def lane(self, name: str) -> Lane | None:
        with self._cond:
            return self._lanes.get(name)

    def wait_engine_idle(self, engine, timeout: float | None = None) -> bool:
        """Wait until no plan this scheduler took for ``engine`` is still
        being dispatched or in flight; False on timeout.  Once a swap has
        pointed the lane elsewhere no new plan takes the engine, so this is
        the point after which an unloaded version may free its graphs."""
        with self._idle:
            return self._idle.wait_for(lambda: not self._busy.get(id(engine)), timeout)

    def _release(self, engine) -> None:
        with self._idle:
            left = self._busy[id(engine)] - 1
            if left:
                self._busy[id(engine)] = left
            else:
                del self._busy[id(engine)]
                self._idle.notify_all()

    def lanes_snapshot(self) -> dict:
        """Point-in-time per-lane state: depth, pending images, decayed
        device-second share, cost EWMA.  JSON-ready."""
        now = time.monotonic()
        with self._cond:
            return {
                "policy": self.policy,
                "stalled": self.stalled,
                "lanes": {
                    name: {
                        "weight": lane.weight,
                        "queue_depth": len(lane.queue),
                        "pending_images": lane.pending_images,
                        "queue_cap": lane.queue_cap,
                        "max_delay_s": lane.max_delay_s,
                        "served_s": round(lane.decayed_served(now), 6),
                        "cost_per_image_s": (
                            round(lane.cost_per_image_s, 6)
                            if lane.cost_per_image_s is not None else None
                        ),
                    }
                    for name, lane in self._lanes.items()
                },
            }

    # --- request intake -----------------------------------------------------

    def submit(self, model: str, image: np.ndarray, deadline=None, trace=None,
               priority=None) -> Future:
        """One HWC uint8 image; the future resolves to its logits row.

        ``deadline`` is a serving.admission Deadline (or None); its
        remaining budget becomes the request's absolute deadline in the
        arbitration order.  ``priority`` (a PRIORITY_SLACK_S key) relaxes
        the unit's effective deadline for lower classes.  ``trace`` gets
        the ``batcher.queue_wait`` span, then the pipeline-stage spans."""
        image = np.asarray(image)
        return self._enqueue(model, image[None], 1, deadline, trace, single=True,
                             priority=priority)

    def submit_batch(self, model: str, images: np.ndarray, deadline=None, trace=None,
                     priority=None) -> Future:
        """A pre-formed uint8 chunk (n <= the model's max bucket); the
        future resolves to its n logits rows, contiguous and in order."""
        images = np.asarray(images)
        return self._enqueue(model, images, images.shape[0], deadline, trace, single=False,
                             priority=priority)

    def _enqueue(self, model, images, n, deadline, trace, single, priority=None) -> Future:
        if images.dtype != np.uint8:
            raise ValueError(f"scheduler takes uint8 images, got {images.dtype}")
        deadline_abs = None
        if deadline is not None:
            deadline_abs = time.monotonic() + max(deadline.remaining_s(), 0.0)
        with self._cond:
            if self._closed:
                raise BatcherClosed("scheduler is shut down")
            lane = self._lanes.get(model)
            if lane is None:
                raise ValueError(f"no scheduling lane for model {model!r}")
            expected = tuple(lane.engine.spec.input_shape)
            if tuple(images.shape[1:]) != expected:
                raise ValueError(f"image shape {tuple(images.shape[1:])} != expected {expected}")
            if n > lane.max_batch:
                raise ValueError(f"chunk of {n} exceeds model {model!r}'s max bucket "
                                 f"{lane.max_batch}; chunk before submitting")
            if lane.pending_images + n > lane.queue_cap:
                lane.m["queue_full"].inc()
                raise QueueFull(f"request queue full for model {model!r}")
            unit = _Unit(images, n, deadline_abs, trace, single, priority=priority)
            lane.queue.append(unit)
            lane.pending_images += n
            lane.m["queue_depth"].set(float(lane.pending_images))
            self._cond.notify()
        return unit.future

    # --- the dispatch loop --------------------------------------------------

    def _lane_ready_locked(self, lane: Lane, now: float) -> bool:
        """The continuous-batching flush rule, per lane: dispatch when the
        batch is full, the linger expired, or the scheduler is draining for
        close; or once the effective deadline is upon us (lingering then
        only turns a viable request into a missed one)."""
        if not lane.queue:
            return False
        if lane.pending_images >= lane.max_batch or self._closed:
            return True
        if now - lane.queue[0].enq_t >= lane.max_delay_s:
            return True
        return lane.effective_deadline(now) <= now

    def _choose(self, ready: list[Lane], now: float) -> Lane:
        if len(ready) == 1:
            return ready[0]
        if self.policy == "fifo":
            return min(ready, key=Lane.oldest_enq_t)
        # weighted_deadline: weight floors first, then earliest effective
        # deadline.  Shares and floors count only the lanes contending now.
        total_w = sum(lane.weight for lane in ready) or 1.0
        served = {lane.name: lane.decayed_served(now) for lane in ready}
        total_served = sum(served.values())
        if total_served > 0:
            starved = []
            for lane in ready:
                fair = lane.weight / total_w
                actual = served[lane.name] / total_served
                deficit = fair * WEIGHT_FLOOR_FRACTION - actual
                if deficit > 0:
                    starved.append((deficit, lane))
            if starved:
                _, lane = max(starved, key=lambda d_l: d_l[0])
                lane.m["floor_boosts"].inc()
                return lane
        return min(ready, key=lambda lane: lane.effective_deadline(now))

    def _take_plan(self):
        """Block until a dispatch plan exists: (lane, engine, units, total)
        -- or None when closed and drained."""
        with self._cond:
            while True:
                lanes = [lane for lane in self._lanes.values() if lane.queue]
                if not lanes:
                    if self._closed:
                        return None
                    self._cond.wait()
                    continue
                now = time.monotonic()
                ready = [lane for lane in lanes if self._lane_ready_locked(lane, now)]
                if not ready:
                    # Sleep until the earliest linger or deadline readiness;
                    # new submits notify and re-evaluate sooner.
                    wake = min(
                        min(lane.queue[0].enq_t + lane.max_delay_s, lane.effective_deadline(now))
                        for lane in lanes
                    )
                    self._cond.wait(timeout=max(wake - now, 1e-4))
                    continue
                lane = self._choose(ready, now)
                units: list[_Unit] = []
                total = 0
                taken_at = time.monotonic()
                while lane.queue and total + lane.queue[0].n <= lane.max_batch:
                    unit = lane.queue.pop(0)
                    units.append(unit)
                    total += unit.n
                    lane.m["queue_age"].observe(max(0.0, taken_at - unit.enq_t))
                lane.pending_images -= total
                lane.m["queue_depth"].set(float(lane.pending_images))
                # Read under the lock a swap takes: once register() points
                # the lane at a new engine, no later plan takes the old one.
                engine = lane.engine
                for unit in units:
                    unit.future.engine = engine
                with self._idle:
                    self._busy[id(engine)] = self._busy.get(id(engine), 0) + 1
                return lane, engine, units, total

    def _run(self) -> None:
        while True:
            plan = self._take_plan()
            if plan is None:
                return
            lane, engine, units, total = plan
            lane.m["batch_size"].observe(total)
            lane.m["dispatch"].inc()
            traces = [u.trace for u in units if u.trace is not None]
            if traces:
                taken_w = trace_lib.now_s()
                tags = {"batch": total, "model": lane.name}
                for u in units:
                    if u.trace is not None:
                        u.trace.defer(((trace_lib.SPAN_BATCHER_QUEUE_WAIT, u.enq_w,
                                        taken_w - u.enq_w, tags),))
            slot = None
            t_sub = time.monotonic()
            try:
                if len(units) == 1:
                    batch = units[0].images
                elif getattr(engine, "lends_staging", False):
                    # Gather the units straight into a pinned slot the engine
                    # lends: one host copy instead of a concatenate and a copy.
                    slot = engine.lend_staging()
                    off = 0
                    for u in units:
                        slot.array[off:off + u.n] = u.images
                        off += u.n
                    batch = StagedBatch(slot, total)
                else:
                    batch = np.concatenate([u.images for u in units])
                fut = self.dispatcher.submit(batch, traces=traces, engine=engine,
                                             model=lane.name)
            except Exception as e:  # noqa: BLE001 - a stalled/closed dispatcher, a bad batch
                self._release(engine)
                for u in units:
                    if not u.future.cancelled():
                        u.future.set_exception(e)
                continue
            finally:
                if slot is not None:  # its H2D copy is enqueued (or never will be)
                    engine.return_staging(slot)
            fut.add_done_callback(
                lambda f, lane=lane, engine=engine, units=units, total=total, t=t_sub:
                self._publish(lane, engine, units, total, t, f)
            )

    def _publish(self, lane: Lane, engine, units, total: int, t_sub: float,
                 fut_batch: Future) -> None:
        """Fan one completed plan's rows (or failure) out to its units.  Runs
        on the dispatcher's completion thread; must not raise."""
        lane.observe_served(max(time.monotonic() - t_sub, 0.0), total)
        self._release(engine)
        exc = fut_batch.exception()
        if exc is not None:
            for u in units:
                if not u.future.cancelled():
                    u.future.set_exception(exc)
            return
        rows = fut_batch.result()
        off = 0
        for u in units:
            if not u.future.cancelled():
                u.future.set_result(rows[off] if u.single else rows[off:off + u.n])
            off += u.n

    def close(self, drain: bool = True) -> None:
        """Stop intake; with ``drain`` the queued units still run, else they
        fail with BatcherClosed.  Closes the dispatcher only if it made it."""
        with self._cond:
            self._closed = True
            if not drain:
                for lane in self._lanes.values():
                    pending = lane.queue[:]
                    lane.queue.clear()
                    lane.pending_images = 0
                    lane.m["queue_depth"].set(0.0)
                    for u in pending:
                        if not u.future.cancelled():
                            u.future.set_exception(BatcherClosed("scheduler shut down"))
            self._cond.notify_all()
        self._thread.join(timeout=30.0)
        if self._owns_dispatcher:
            self.dispatcher.close(drain=True)
