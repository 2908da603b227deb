"""The port's admission classes against the JAX package's, on the same sequences.

``serving/admission/`` of the port (``Deadline``, ``AdaptiveLimiter``,
``AdmissionController``, ``Shed``) is a copy of the model-tier half of the
JAX package's; these tests drive both with the same inputs and require the
same outputs: ``Deadline.from_header`` on every kind of header, the AIMD
limit's trajectory under one acquire/release/latency sequence with a fixed
clock, the shed reasons and statuses, per-model budget shares and
priority eviction (the templates of ``tests/test_admission_serving.py``),
and the derived ``Retry-After`` with its jitter drawn from a fixed
``random.Random``.
"""

from __future__ import annotations

import random
import threading
from types import SimpleNamespace

import pytest

from kubernetes_deep_learning_tpu.serving.admission import controller as jax_controller
from kubernetes_deep_learning_tpu.serving.admission import deadline as jax_deadline
from kubernetes_deep_learning_tpu.serving.admission import limiter as jax_limiter
from kubernetes_deep_learning_tpu.serving.admission import shed as jax_shed
from kubernetes_deep_learning_tpu.utils import metrics as jax_metrics
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.admission import controller as port_controller
from kubernetes_deep_learning_tpu_torch.serving.admission import deadline as port_deadline
from kubernetes_deep_learning_tpu_torch.serving.admission import limiter as port_limiter
from kubernetes_deep_learning_tpu_torch.serving.admission import shed as port_shed
from kubernetes_deep_learning_tpu_torch.utils import metrics as port_metrics
from torch_threads import one_torch_thread  # noqa: F401

PACKAGES = {
    "jax": SimpleNamespace(deadline=jax_deadline, limiter=jax_limiter, controller=jax_controller,
                           shed=jax_shed, metrics=jax_metrics),
    "port": SimpleNamespace(deadline=port_deadline, limiter=port_limiter,
                            controller=port_controller, shed=port_shed, metrics=port_metrics),
}


class FakeClock:
    """A monotonic clock the test advances by hand."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    """One fake clock behind ``time.monotonic`` in both packages' admission modules."""
    c = FakeClock()
    for pkg in PACKAGES.values():
        for mod in (pkg.deadline, pkg.limiter, pkg.controller):
            monkeypatch.setattr(mod, "time", SimpleNamespace(monotonic=c.monotonic))
    return c


def _wait_for(predicate, timeout_s=2.0):
    ev = threading.Event()
    for _ in range(int(timeout_s / 0.005)):
        if predicate():
            return True
        ev.wait(0.005)
    return predicate()


def test_protocol_priority_matches_jax():
    from kubernetes_deep_learning_tpu.serving import protocol as jax_protocol

    for name in ("PRIORITY_HEADER", "PRIORITY_CLASSES", "DEFAULT_PRIORITY", "PRIORITY_RANK"):
        assert getattr(protocol, name) == getattr(jax_protocol, name), name
    for raw in (None, "", "  ", "batch", " Best-Effort ", "INTERACTIVE", "vip", "batch,x"):
        assert protocol.parse_priority(raw) == jax_protocol.parse_priority(raw), raw
    assert port_shed.retry_after_headers is protocol.retry_after_headers
    assert port_shed.RETRY_AFTER_HEADER == jax_shed.RETRY_AFTER_HEADER
    for v in (None, -1.0, 0.0, 0.0504, 1.0, 12.3456):
        assert port_shed.retry_after_headers(v) == jax_shed.retry_after_headers(v), v


@pytest.mark.parametrize("env", [{}, {"KDLT_ADMISSION_DEFAULT_DEADLINE_MS": "750",
                                      "KDLT_ADMISSION_MAX_DEADLINE_MS": "4000"}])
def test_deadline_from_header_matches_jax(clock, monkeypatch, env):
    """Absent, blank, garbage and non-finite headers take the default
    budget; a non-positive one is already exhausted; a large one is capped;
    ``remaining_s``, ``expired``, ``clamp`` and the re-sent header value
    follow the clock."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_deadline.DEADLINE_HEADER == jax_deadline.DEADLINE_HEADER == "X-Request-Deadline-Ms"
    raws = (None, "", "   ", "abc", "nan", "inf", "-inf", "-5", "0", "0.4", "250", " 1500 ",
            "1e9", 7.5)
    for raw in raws:
        got, want = (pkg.deadline.Deadline.from_header(raw) for pkg in
                     (PACKAGES["port"], PACKAGES["jax"]))
        assert got.budget_s == want.budget_s, raw
        for step in (0.0, 0.1, 2.0, 1000.0):
            clock.t += step
            assert got.remaining_s() == want.remaining_s(), (raw, step)
            assert got.expired == want.expired, (raw, step)
            assert got.header_value() == want.header_value(), (raw, step)
            for t in (0.0005, 0.2, 30.0):
                assert got.clamp(t) == want.clamp(t), (raw, step, t)
    default = port_deadline.Deadline.from_header(None).budget_s
    assert default == float(env.get("KDLT_ADMISSION_DEFAULT_DEADLINE_MS", 20_000)) / 1e3
    capped = port_deadline.Deadline.from_header("1e9").budget_s
    assert capped == float(env.get("KDLT_ADMISSION_MAX_DEADLINE_MS", 300_000)) / 1e3
    assert port_deadline.Deadline.from_header("-5").expired


# (clock advance before the step in s, action, argument): "acquire" takes a
# slot; "release" frees one with (overloaded, headroom); "ticket" admits
# through the controller with a deadline of that many ms, then releases
# after the clock moves on by the latency given (the AIMD bands).
_SEQUENCE = (
    [(0.0, "acquire", None)] * 4
    + [(0.01, "release", (False, True))] * 4
    + [(0.0, "acquire", None), (0.02, "release", (True, False)),
       (0.05, "acquire", None), (0.03, "release", (True, False)),    # inside the cooldown
       (0.2, "acquire", None), (0.0, "release", (True, False)),      # after it
       (0.0, "acquire", None), (0.0, "release", (False, False))]     # the hold band
    + [(0.05, "ticket", (600.0, 0.05))] * 5     # 8% of the budget spent: increase
    + [(0.05, "ticket", (600.0, 0.2))] * 3      # 33%: hold
    + [(0.15, "ticket", (600.0, 0.45))] * 4     # 75%: congestion, once a cooldown
    + [(0.0, "ticket", (200.0, 0.01))] * 10
)


def _trajectory(pkg, clock) -> list[float]:
    lim = pkg.limiter.AdaptiveLimiter(min_limit=2, max_limit=12, initial=4, budgets=None)
    ctl = pkg.controller.AdmissionController(pkg.metrics.Registry(), tier="model-server",
                                             enabled=True, limiter=lim)
    out = []
    for advance, action, arg in _SEQUENCE:
        clock.t += advance
        if action == "acquire":
            lim.acquire()
        elif action == "release":
            overloaded, headroom = arg
            lim.release(overloaded=overloaded, headroom=headroom)
        else:
            budget_ms, latency_s = arg
            ticket = ctl.admit(pkg.deadline.Deadline(budget_ms / 1e3), model="m")
            clock.t += latency_s
            ticket.release()
        out.append(lim.limit)
    assert lim.inflight == 0 and ctl.inflight == 0
    return out


def test_aimd_trajectory_matches_jax(clock):
    t0 = clock.t
    want = _trajectory(PACKAGES["jax"], clock)
    clock.t = t0
    got = _trajectory(PACKAGES["port"], clock)
    assert got == want
    # The sequence moves the limit up, down and holds it.
    assert max(got) > 4 and min(got) < 4 and len(set(got)) > 8


def _shed_outcome(pkg, clock, case: str):
    lim = pkg.limiter.AdaptiveLimiter(min_limit=1, max_limit=1, initial=1, queue_cap=1,
                                      budgets=None, max_queue_wait_s=0.0)
    ctl = pkg.controller.AdmissionController(pkg.metrics.Registry(), tier="model-server",
                                             enabled=True, limiter=lim)
    random_ = random.Random(7)
    pkg.limiter.random, saved = random_, pkg.limiter.random
    try:
        if case == "draining":
            ctl.begin_drain()
            deadline = pkg.deadline.Deadline(1.0)
        elif case == "deadline_exhausted":
            deadline = pkg.deadline.Deadline.from_header("0")
        else:  # the one slot held: "queue_timeout" waits 0 s, "queue_full" finds the cap
            ctl.admit(pkg.deadline.Deadline(1.0))
            deadline = pkg.deadline.Deadline(1.0)
            if case == "queue_full":
                lim.queue_cap = 0
        with pytest.raises(pkg.shed.Shed) as e:
            ctl.admit(deadline, model="m", priority="batch")
    finally:
        pkg.limiter.random = saved
    shed = e.value
    return shed.reason, shed.http_status, shed.headers()


@pytest.mark.parametrize("case", ["draining", "deadline_exhausted", "queue_timeout",
                                  "queue_full"])
def test_shed_reasons_and_statuses_match_jax(clock, case):
    got = _shed_outcome(PACKAGES["port"], clock, case)
    want = _shed_outcome(PACKAGES["jax"], clock, case)
    assert got == want
    assert got[0] == case and got[1] == (504 if case == "deadline_exhausted" else 503)
    assert ("Retry-After" in got[2]) == (case != "deadline_exhausted")


def test_admission_metrics_render_like_jax(clock):
    """The same decisions render the same ``kdlt_admission_*`` samples."""
    pages = []
    for pkg in (PACKAGES["port"], PACKAGES["jax"]):
        reg = pkg.metrics.Registry()
        lim = pkg.limiter.AdaptiveLimiter(min_limit=2, max_limit=4, initial=2, budgets=None)
        ctl = pkg.controller.AdmissionController(reg, tier="model-server", enabled=True,
                                                 limiter=lim)
        t = ctl.admit(pkg.deadline.Deadline(0.5), model="m", priority="batch")
        t.release()
        with pytest.raises(pkg.shed.Shed):
            ctl.admit(pkg.deadline.Deadline(0.0), model="m")
        ctl.begin_drain()
        lines = [ln for ln in reg.render().splitlines()
                 if ln.startswith("kdlt_admission_") and "_bucket" not in ln]
        pages.append(sorted(lines))
    assert pages[0] == pages[1]
    assert 'kdlt_admission_shed_total{tier="model-server",shed_reason="deadline_exhausted"} 1.0' \
        in pages[0]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_budget_shares_follow_weights(package):
    lim = PACKAGES[package].limiter.AdaptiveLimiter(min_limit=1, max_limit=8, initial=8,
                                                    budgets={"a": 1.0, "b": 3.0})
    lim.acquire(model="a")
    lim.acquire(model="b")
    assert lim.shares() == {"a": 2.0, "b": 6.0}
    lim.release(model="b")
    assert lim.shares() == {"a": 8.0}


def test_budget_env_matches_jax(monkeypatch):
    cases = [("", ""), ("a=2,b=0.5", ""), ("off", "x=3"), ("auto", "x=3,y=bad,=1,z"),
             ("a=0,b", "")]
    for budgets, weights in cases:
        monkeypatch.setenv("KDLT_ADMIT_BUDGETS", budgets)
        monkeypatch.setenv("KDLT_SCHED_WEIGHTS", weights)
        assert port_limiter.env_budgets() == jax_limiter.env_budgets(), (budgets, weights)
    monkeypatch.setenv("KDLT_ADMISSION_MAX_CONCURRENCY", "300")
    assert port_limiter.env_max_limit() == jax_limiter.env_max_limit() == 300.0


@pytest.mark.parametrize("package", ["jax", "port"])
def test_under_share_arrival_evicts_over_share_waiter(package):
    limiter, shed_cls = PACKAGES[package].limiter, PACKAGES[package].shed.Shed
    lim = limiter.AdaptiveLimiter(min_limit=1, max_limit=2, initial=2, queue_cap=1,
                                  budgets={"a": 1.0, "b": 1.0})
    lim.acquire(model="a")
    lim.acquire(model="a")
    outcome: dict = {}

    def over_share_waiter():
        try:
            lim.acquire(budget_s=40.0, model="a")
            outcome["a"] = "granted"
        except shed_cls as e:
            outcome["a"] = e

    ta = threading.Thread(target=over_share_waiter)
    ta.start()
    assert _wait_for(lambda: lim.queue_depth == 1)
    granted: list[float] = []
    tb = threading.Thread(target=lambda: granted.append(lim.acquire(budget_s=40.0, model="b")))
    tb.start()
    ta.join(timeout=5)
    assert not ta.is_alive()
    shed = outcome["a"]
    assert isinstance(shed, shed_cls) and shed.reason == "budget_exhausted"
    assert 0.0 < shed.retry_after_s <= 12.5
    lim.release(model="a")
    tb.join(timeout=5)
    assert not tb.is_alive() and granted and lim.inflight == 2


@pytest.mark.parametrize("package", ["jax", "port"])
def test_higher_class_arrival_preempts_lower_class_waiter(package):
    limiter, shed_cls = PACKAGES[package].limiter, PACKAGES[package].shed.Shed
    lim = limiter.AdaptiveLimiter(min_limit=1, max_limit=2, initial=2, queue_cap=1, budgets=None)
    lim.acquire()
    lim.acquire()
    outcome: dict = {}

    def lowly_waiter():
        try:
            lim.acquire(budget_s=40.0, priority="best-effort")
            outcome["be"] = "granted"
        except shed_cls as e:
            outcome["be"] = e

    t = threading.Thread(target=lowly_waiter)
    t.start()
    assert _wait_for(lambda: lim.queue_depth == 1)
    granted: list[float] = []
    ti = threading.Thread(
        target=lambda: granted.append(lim.acquire(budget_s=40.0, priority="interactive")))
    ti.start()
    t.join(timeout=5)
    assert not t.is_alive()
    assert isinstance(outcome["be"], shed_cls) and outcome["be"].reason == "preempted"
    # A newcomer no better than the queue sheds queue_full instead.
    with pytest.raises(shed_cls) as e:
        lim.acquire(budget_s=40.0, priority="best-effort")
    assert e.value.reason == "queue_full"
    lim.release()
    ti.join(timeout=5)
    assert not ti.is_alive() and granted


def test_retry_after_derived_from_queue_and_hold_ewma():
    """The derived hint's range (floor, hold EWMA over the limit, ceiling),
    and with the same seeded ``random.Random`` the port draws JAX's values."""
    from kubernetes_deep_learning_tpu_torch.serving.admission.limiter import (
        RETRY_AFTER_JITTER,
        RETRY_AFTER_MAX_S,
        RETRY_AFTER_MIN_S,
        AdaptiveLimiter,
    )

    assert (RETRY_AFTER_MIN_S, RETRY_AFTER_MAX_S, RETRY_AFTER_JITTER) == (
        jax_limiter.RETRY_AFTER_MIN_S, jax_limiter.RETRY_AFTER_MAX_S,
        jax_limiter.RETRY_AFTER_JITTER)
    lo, hi = 1.0 - RETRY_AFTER_JITTER, 1.0 + RETRY_AFTER_JITTER
    kw = dict(min_limit=1, max_limit=4, initial=4, target_wait_s=0.0, budgets=None)
    lim = AdaptiveLimiter(**kw, rng=random.Random(3))
    jlim = jax_limiter.AdaptiveLimiter(**kw)
    saved = jax_limiter.random
    jax_limiter.random = random.Random(3)
    try:
        for hold, base in ((None, RETRY_AFTER_MIN_S), (2.0, 0.5), (1000.0, RETRY_AFTER_MAX_S)):
            if hold is not None:
                for limiter_ in (lim, jlim):
                    limiter_._hold_ewma_s = hold
            got = [lim.retry_after_s() for _ in range(64)]
            assert got == [jlim.retry_after_s() for _ in range(64)]
            assert all(base * lo <= s <= base * hi for s in got), (hold, min(got), max(got))
            assert max(got) > min(got)  # the jitter varies the hint
    finally:
        jax_limiter.random = saved
    # The first observed hold seeds the EWMA: (waiters + 1) / limit * hold.
    fresh = AdaptiveLimiter(**kw, rng=random.Random(0))
    fresh.release(held_s=2.0)
    assert all(0.5 * lo <= fresh.retry_after_s() <= 0.5 * hi for _ in range(16))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_release_wakes_only_the_waiter_it_grants(package, monkeypatch):
    """16 requests queued behind a full limiter; one release grants one of
    them.  The port wakes that waiter alone; the JAX package wakes all 16
    (under the interpreter lock, 128 waiters woken at every one of ~850
    releases a second take a whole core)."""
    limiter = PACKAGES[package].limiter
    wakes = [0]

    class Counting(threading.Condition):
        def wait(self, timeout=None):
            try:
                return super().wait(timeout)
            finally:
                wakes[0] += 1

    monkeypatch.setattr(limiter, "threading", SimpleNamespace(
        Condition=Counting, Lock=threading.Lock, Thread=threading.Thread))
    lim = limiter.AdaptiveLimiter(min_limit=1, max_limit=1, initial=1, budgets=None)
    lim.acquire()
    granted = []
    threads = [threading.Thread(target=lambda: granted.append(lim.acquire(budget_s=30.0)),
                                daemon=True) for _ in range(16)]
    for t in threads:
        t.start()
    assert _wait_for(lambda: lim.queue_depth == 16)
    threading.Event().wait(0.05)
    wakes[0] = 0
    lim.release()
    assert _wait_for(lambda: len(granted) == 1)
    if package == "port":
        threading.Event().wait(0.1)
        assert wakes[0] == 1
    else:
        assert _wait_for(lambda: wakes[0] == 16)
    for _ in range(16):  # let the rest through
        lim.release()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads) and len(granted) == 16
