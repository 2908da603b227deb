"""The port's ``runtime/scheduler.py`` against the JAX package's, on the CPU.

- ``resolve_policy`` and ``resolve_weights`` agree under the same
  environment (and explicit arguments);
- both packages' ``UnifiedScheduler._choose`` pick the same lane over real
  ``_Unit``s at a pinned ``now``: fifo, the effective deadline with a cost
  estimate, the weight floor and the priority slack;
- the port's scheduler: two models on one shared dispatcher get their own
  rows (single images and chunks, interleaved), the queue cap raises
  ``QueueFull``, a hot swap keeps the lane and a stale close is a no-op,
  close without drain fails the queued waiters, and fifo starves a light
  lane behind a heavy one where weighted_deadline serves it first -- an
  engine gated on events decides the order, never a sleep.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from kubernetes_deep_learning_tpu.runtime import scheduler as jax_sched
from kubernetes_deep_learning_tpu.utils import metrics as jax_metrics
from kubernetes_deep_learning_tpu_torch.runtime import BatcherClosed, QueueFull
from kubernetes_deep_learning_tpu_torch.runtime import scheduler as port_sched
from kubernetes_deep_learning_tpu_torch.serving.admission import Deadline
from kubernetes_deep_learning_tpu_torch.utils import metrics as port_metrics
from torch_threads import one_torch_thread  # noqa: F401

_SHAPE = (2, 2, 3)
_PKGS = {"jax": (jax_sched, jax_metrics), "port": (port_sched, port_metrics)}


# --- knobs -------------------------------------------------------------------------


@pytest.mark.parametrize("env,arg", [
    (None, None), ("fifo", None), (" FIFO ", None), ("nonsense", None),
    ("fifo", "weighted_deadline"), (None, "Fifo"), (None, "bogus"),
])
def test_resolve_policy_agrees_with_jax(monkeypatch, env, arg):
    if env is None:
        monkeypatch.delenv("KDLT_SCHED_POLICY", raising=False)
    else:
        monkeypatch.setenv("KDLT_SCHED_POLICY", env)
    assert port_sched.resolve_policy(arg) == jax_sched.resolve_policy(arg)


@pytest.mark.parametrize("env,arg", [
    (None, None), ("a=2,b=0.5", None), ("a=2, b=x,=3,c,d=-1", None),
    ("a=2", "b=4"), (None, ""),
])
def test_resolve_weights_agrees_with_jax(monkeypatch, env, arg):
    if env is None:
        monkeypatch.delenv("KDLT_SCHED_WEIGHTS", raising=False)
    else:
        monkeypatch.setenv("KDLT_SCHED_WEIGHTS", env)
    assert port_sched.resolve_weights(arg) == jax_sched.resolve_weights(arg)


def test_policy_constants_match_jax():
    for name in ("POLICIES", "DEFAULT_POLICY", "WEIGHT_FLOOR_FRACTION", "SHARE_HALFLIFE_S",
                 "DEFAULT_SLACK_S", "PRIORITY_SLACK_S", "SCHED_POLICY_ENV",
                 "SCHED_WEIGHTS_ENV"):
        assert getattr(port_sched, name) == getattr(jax_sched, name), name


# --- _choose parity ------------------------------------------------------------------

NOW = 1000.0


def _unit(pkg, enq_t, deadline_in=None, priority=None, n=1):
    sched, _ = _PKGS[pkg]
    images = np.zeros((n, *_SHAPE), np.uint8)
    deadline_abs = None if deadline_in is None else NOW + deadline_in
    u = sched._Unit(images, n, deadline_abs, None, n == 1, priority=priority)
    u.enq_t = enq_t
    return u


def _lane(pkg, name, units, weight=1.0, served_s=0.0, cost_per_image_s=None, max_batch=8):
    sched, metrics = _PKGS[pkg]
    engine = SimpleNamespace(spec=SimpleNamespace(name=name, input_shape=_SHAPE),
                             max_batch=max_batch)
    lane = sched.Lane(name, engine, weight, 0.002, 2048,
                      metrics.scheduler_lane_metrics(metrics.Registry(), name))
    lane.queue.extend(units)
    lane.pending_images = sum(u.n for u in units)
    lane.served_s = served_s
    lane._served_at = NOW  # no decay between the shares' time and NOW
    lane.cost_per_image_s = cost_per_image_s
    return lane


# Each case: policy, and per lane (name, [units as (enq_t, deadline_in,
# priority)], weight, served_s, cost_per_image_s); then the lane to pick.
_CASES = {
    # fifo: the oldest head wins, whatever the deadlines say.
    "fifo": ("fifo", [("a", [(999.0, 5.0, None)], 1.0, 0.0, None),
                      ("b", [(998.5, 60.0, None)], 1.0, 0.0, None)], "b"),
    # the same lanes under weighted_deadline: the earlier deadline wins.
    "deadline": ("weighted_deadline", [("a", [(999.0, 5.0, None)], 1.0, 0.0, None),
                                       ("b", [(998.5, 60.0, None)], 1.0, 0.0, None)], "a"),
    # effective deadline with cost: b's deadline is later, but 8 images at
    # 50 ms each leave it less slack than a's (1.2 - 0.4 < 1.0).
    "cost": ("weighted_deadline",
             [("a", [(999.0, 1.0, None)], 1.0, 1.0, 0.001),
              ("b", [(999.0, 1.2, None)] * 8, 1.0, 1.0, 0.05)], "b"),
    # weight floor: b had 5% of the device time against a fair 50% (floor
    # 25%): it preempts a's earlier deadline.
    "floor": ("weighted_deadline",
              [("a", [(999.0, 0.1, None)], 1.0, 9.5, 0.001),
               ("b", [(999.0, 10.0, None)], 1.0, 0.5, 0.001)], "b"),
    # the floor follows the weights: with a weighing 19, b's 5% is over its
    # floor (2.5%), and the deadline order holds.
    "floor-weights": ("weighted_deadline",
                      [("a", [(999.0, 0.1, None)], 19.0, 9.5, 0.001),
                       ("b", [(999.0, 10.0, None)], 1.0, 0.5, 0.001)], "a"),
    # priority slack: a best-effort unit concedes 5 s, so an interactive
    # unit with a later deadline goes first.
    "priority": ("weighted_deadline",
                 [("a", [(999.0, 1.0, "best-effort")], 1.0, 0.0, None),
                  ("b", [(999.0, 2.0, "interactive")], 1.0, 0.0, None)], "b"),
    # no deadline: DEFAULT_SLACK_S from enqueue, so the order is arrival.
    "no-deadline": ("weighted_deadline",
                    [("a", [(999.0, None, None)], 1.0, 0.0, None),
                     ("b", [(998.0, None, None)], 1.0, 0.0, None)], "b"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_choose_matches_jax(case):
    policy, lanes, want = _CASES[case]
    picked = {}
    for pkg, (sched, metrics) in _PKGS.items():
        built = [_lane(pkg, name, [_unit(pkg, *u) for u in units], weight, served, cost)
                 for name, units, weight, served, cost in lanes]
        s = sched.UnifiedScheduler(registry=metrics.Registry(), policy=policy, weights={},
                                   pipeline_depth=1)
        try:
            boosts = [lane.m["floor_boosts"].value for lane in built]
            picked[pkg] = s._choose(built, NOW).name
            boosted = [lane.name for lane, b in zip(built, boosts)
                       if lane.m["floor_boosts"].value > b]
            assert boosted == (["b"] if case == "floor" else []), (pkg, boosted)
        finally:
            s.close()
    assert picked == {"jax": want, "port": want}


# --- the port's scheduler over a fake engine ----------------------------------------


class _Engine:
    """A served model's stand-in: rows are (engine id, the image's first
    pixel); each dispatch is logged, and the next dispatch after ``hold``
    is set waits inside the engine until the event is set (the dispatch
    thread blocks there)."""

    def __init__(self, name: str, ident: float, log: list, max_batch: int = 4):
        self.spec = SimpleNamespace(name=name, input_shape=_SHAPE)
        self.max_batch = max_batch
        self.ident = ident
        self.log = log
        self.hold: threading.Event | None = None
        self.entered = threading.Event()

    def bucket_for(self, n: int) -> int:
        return n

    def predict_async(self, images):
        images = np.asarray(images)
        self.log.append((self.spec.name, len(images)))
        hold, self.hold = self.hold, None
        self.entered.set()
        if hold is not None:
            assert hold.wait(30)
        rows = np.stack([np.full(len(images), self.ident, np.float32),
                         images[:, 0, 0, 0].astype(np.float32)], axis=1)
        return rows, len(images)


def _images(values):
    out = np.zeros((len(values), *_SHAPE), np.uint8)
    out[:, 0, 0, 0] = values
    return out


def _scheduler(policy="weighted_deadline", depth=2, **kw):
    return port_sched.UnifiedScheduler(registry=port_metrics.Registry(), policy=policy,
                                       weights={}, pipeline_depth=depth, **kw)


def test_two_models_share_one_dispatcher_and_get_their_own_rows():
    log: list = []
    a, b = _Engine("a", 1.0, log), _Engine("b", 2.0, log)
    s = _scheduler()
    try:
        s.register("a", a, max_delay_ms=1.0)
        s.register("b", b, max_delay_ms=1.0)
        futs = []
        for i in range(12):
            if i % 3 == 2:
                imgs = _images([10 * i + k for k in range(3)])
                futs.append((("a", "b")[i % 2], imgs, True,
                             s.submit_batch(("a", "b")[i % 2], imgs)))
            else:
                imgs = _images([10 * i])
                futs.append((("a", "b")[i % 2], imgs, False,
                             s.submit(("a", "b")[i % 2], imgs[0])))
        for model, imgs, chunk, fut in futs:
            got = fut.result(timeout=30)
            ident = {"a": 1.0, "b": 2.0}[model]
            if chunk:
                np.testing.assert_array_equal(got[:, 0], ident)
                np.testing.assert_array_equal(got[:, 1], imgs[:, 0, 0, 0])
            else:
                np.testing.assert_array_equal(got, [ident, imgs[0, 0, 0, 0]])
        assert {name for name, _ in log} == {"a", "b"}
        assert all(n <= 4 for _, n in log)
        assert sum(n for _, n in log) == 8 + 4 * 3
    finally:
        s.close()


def test_queue_cap_raises_queue_full_and_bad_submits_raise_value_error():
    s = _scheduler(queue_cap=3)
    try:
        s.register("a", _Engine("a", 1.0, []))
        with pytest.raises(QueueFull):
            s.submit_batch("a", _images([1, 2, 3, 4]))
        with pytest.raises(ValueError, match="max bucket"):
            s.submit_batch("a", _images([1] * 5))
        with pytest.raises(ValueError, match="no scheduling lane"):
            s.submit("b", _images([1])[0])
        with pytest.raises(ValueError, match="image shape"):
            s.submit("a", np.zeros((3, 3, 3), np.uint8))
        with pytest.raises(ValueError, match="uint8"):
            s.submit("a", np.zeros(_SHAPE, np.float32))
        assert s.lane("a").m["queue_full"].value == 1.0
    finally:
        s.close()


def test_hot_swap_keeps_the_lane_and_a_stale_close_is_a_no_op():
    log: list = []
    old, new = _Engine("a", 1.0, log), _Engine("a", 2.0, log)
    s = _scheduler()
    try:
        lane = s.register("a", old, weight=2.0)
        assert s.register("a", new) is lane and lane.engine is new
        s.unregister("a", engine=old)  # the superseded version's close
        assert s.lane("a") is lane
        np.testing.assert_array_equal(s.submit("a", _images([7])[0]).result(30), [2.0, 7.0])
        assert s.wait_engine_idle(old, timeout=0) and s.wait_engine_idle(new, timeout=5)
        s.unregister("a", engine=new)
        assert s.lane("a") is None
        with pytest.raises(ValueError, match="no scheduling lane"):
            s.submit("a", _images([1])[0])
    finally:
        s.close()


def test_wait_engine_idle_waits_for_a_plan_in_flight():
    log: list = []
    eng = _Engine("a", 1.0, log)
    release = eng.hold = threading.Event()
    s = _scheduler()
    try:
        s.register("a", eng, max_delay_ms=0.0)
        fut = s.submit("a", _images([3])[0])
        assert eng.entered.wait(30)
        assert not s.wait_engine_idle(eng, timeout=0.05)  # the plan is mid-dispatch
        release.set()
        assert s.wait_engine_idle(eng, timeout=30)
        np.testing.assert_array_equal(fut.result(0), [1.0, 3.0])
    finally:
        release.set()
        s.close()


def test_close_without_drain_fails_the_queued_waiters():
    log: list = []
    eng = _Engine("a", 1.0, log)
    release = eng.hold = threading.Event()
    s = _scheduler(depth=1)
    closer = None
    try:
        s.register("a", eng, max_delay_ms=0.0)
        first = s.submit("a", _images([1])[0])
        assert eng.entered.wait(30)  # plan 1 is inside the engine's dispatch
        lane = s.lane("a")
        queued = [s.submit("a", _images([v])[0]) for v in (2, 3)]
        closer = threading.Thread(target=s.close, kwargs={"drain": False})
        closer.start()
        for fut in queued:
            with pytest.raises(BatcherClosed):
                fut.result(timeout=30)
        assert lane.pending_images == 0
        with pytest.raises(BatcherClosed):
            s.submit("a", _images([4])[0])
        release.set()
        np.testing.assert_array_equal(first.result(30), [1.0, 1.0])
    finally:
        release.set()
        if closer is not None:
            closer.join(30)
        else:
            s.close()


@pytest.mark.parametrize("policy,order", [
    ("fifo", ["heavy", "heavy", "light"]),
    ("weighted_deadline", ["heavy", "light", "heavy"]),
])
def test_fifo_starves_the_light_lane_where_weighted_serves_it(policy, order):
    """A heavy lane's first batch holds the dispatch thread (an event, not a
    sleep) while three more heavy images (10 s budgets) and then one light
    image (a 0.5 s budget) queue.  On release, fifo takes the older heavy
    images first; weighted_deadline the light one, whose effective deadline
    is earliest (and whose share of device time is below its floor)."""
    log: list = []
    heavy, light = _Engine("heavy", 1.0, log), _Engine("light", 2.0, log)
    release = heavy.hold = threading.Event()
    s = _scheduler(policy=policy, depth=1)
    try:
        s.register("heavy", heavy, max_delay_ms=0.0)
        s.register("light", light, max_delay_ms=0.0)
        futs = [s.submit("heavy", _images([0])[0], deadline=Deadline(10.0))]
        assert heavy.entered.wait(30)  # the dispatch thread is held in it
        futs += [s.submit("heavy", _images([v])[0], deadline=Deadline(10.0)) for v in (1, 2, 3)]
        futs.append(s.submit("light", _images([9])[0], deadline=Deadline(0.5)))
        release.set()
        for f in futs:
            f.result(timeout=30)
        assert [name for name, _ in log] == order, log
        assert [n for _, n in log] == ([1, 3, 1] if policy == "fifo" else [1, 1, 3])
    finally:
        release.set()
        s.close()
