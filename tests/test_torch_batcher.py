"""Server-side batching and the in-flight dispatch pipeline, JAX and port.

Every contract of ``tests/test_batcher.py`` and ``tests/test_dispatch.py``
runs as one test parametrised over the JAX package's classes and the
port's (``runtime.batcher.DynamicBatcher``, ``runtime.engine.
InFlightDispatcher``): ordering and row wiring, backpressure at depth,
dispatch and sync failures, close/drain, the next batch dispatched
before the last completes, the queue cap, ``resolve_pipeline_depth``,
the stage metrics and the watchdog.  The batcher contracts also run
against the port's C++ queue (``runtime.native_batcher.NativeBatcher``,
built with g++), and ``create_batcher`` picks by core count and raises
for ``native`` when the queue will not build.  The engine stand-in
completes each batch only when the test releases it, so overlap is
asserted by construction, never by sleeps.

Then the port's ``ModelServer`` on the CPU (a 96-px Xception exported by
the JAX package, buckets 1, 2, 4, 8): 8 concurrent one-image requests
beside a 5-image and a 9-image one, each reply held against JAX's
``build_forward`` of the same images (rtol/atol 1e-3, as
``test_torch_serving.py``), the engine counters against the batch sizes
of the scheduler's lane (the default ``--batcher auto``, as in JAX, serves
every uint8 batch through ``runtime.scheduler.UnifiedScheduler``), the
stalled-pipeline and full-queue answers (JSON bodies and ``Retry-After``,
as the JAX server's), ``--no-batching``, each ``--batcher`` and the
``/metrics`` page (engine series under ``{model, version}``, lane and
pipeline series under ``{model}``).
"""

from __future__ import annotations

import concurrent.futures
import json
import re
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from kubernetes_deep_learning_tpu.export import export_model
from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward
from kubernetes_deep_learning_tpu.models import init_variables as jax_init_variables
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
from kubernetes_deep_learning_tpu.modelspec import register_spec
from kubernetes_deep_learning_tpu.runtime import batcher as jax_batcher
from kubernetes_deep_learning_tpu.runtime import engine as jax_engine
from kubernetes_deep_learning_tpu.utils import metrics as jax_metrics
from kubernetes_deep_learning_tpu_torch.runtime import batcher as port_batcher
from kubernetes_deep_learning_tpu_torch.runtime import create_batcher
from kubernetes_deep_learning_tpu_torch.runtime import engine as port_engine
from kubernetes_deep_learning_tpu_torch.runtime.native_batcher import NativeBatcher
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.model_server import build_server
from kubernetes_deep_learning_tpu_torch.utils import metrics as port_metrics
from torch_threads import one_torch_thread  # noqa: F401

PACKAGES = {
    "jax": SimpleNamespace(batcher=jax_batcher, engine=jax_engine, metrics=jax_metrics,
                           Batcher=jax_batcher.DynamicBatcher),
    "port": SimpleNamespace(batcher=port_batcher, engine=port_engine, metrics=port_metrics,
                            Batcher=port_batcher.DynamicBatcher),
}
# The batcher contracts run against the port's C++ queue too.
BATCHERS = {**PACKAGES, "native": SimpleNamespace(
    batcher=port_batcher, engine=port_engine, metrics=port_metrics, Batcher=NativeBatcher)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(params=sorted(BATCHERS))
def bpkg(request):
    return BATCHERS[request.param]


# --- a controlled-completion engine -------------------------------------------


class _Handle:
    """Device-result stand-in: np.asarray blocks until release()."""

    def __init__(self, out, fail=False):
        self._out = out
        self._fail = fail
        self._ev = threading.Event()

    def release(self):
        self._ev.set()

    def __array__(self, dtype=None, copy=None):
        assert self._ev.wait(timeout=10), "handle never released"
        if self._fail:
            raise RuntimeError("device fault at sync")
        return self._out


class ControlledEngine:
    """The engines' ``predict_async`` surface, each batch completing only
    when the test releases its handle.  Row r of batch i is
    [i, r, sum of the row's pixels], so a row wired to the wrong batch,
    position or request shows in the values."""

    spec = SimpleNamespace(input_shape=(2, 2, 3), num_classes=3)

    def __init__(self, max_batch=8, fail_dispatch_at=(), fail_sync_at=()):
        self.max_batch = max_batch
        self.handles: list[_Handle] = []
        self.dispatches = 0
        self.completed: list[int] = []
        self._fail_dispatch_at = set(fail_dispatch_at)
        self._fail_sync_at = set(fail_sync_at)
        self._lock = threading.Lock()
        self._issued = 0

    def predict_async(self, images):
        with self._lock:
            i = self._issued
            self._issued += 1
        try:
            if i in self._fail_dispatch_at:
                raise ValueError(f"dispatch {i} rejected")
            n = images.shape[0]
            out = np.zeros((n, 3), np.float32)
            out[:, 0] = i
            out[:, 1] = np.arange(n)
            out[:, 2] = images.reshape(n, -1).sum(axis=1)
            h = _Handle(out, fail=i in self._fail_sync_at)
            self.handles.append(h)
            return h, n
        finally:
            # Counted once the handle is in ``handles``: tests poll this
            # count, then take the handle.
            with self._lock:
                self.dispatches += 1

    def record_completed(self, n, seconds, device_s=None):
        self.completed.append(n)


def _imgs(n, value=0):
    return np.full((n, 2, 2, 3), value, np.uint8)


def _until(cond, timeout=5.0):
    """Poll for a state the test set up (not a timing): True once ``cond``."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


def _release_all(eng):
    for h in list(eng.handles):
        h.release()


def _queued(b) -> int:
    """Requests a batcher holds that no batch has taken yet."""
    return b.pending() if isinstance(b, NativeBatcher) else len(b._queue)


# --- dispatcher contracts -------------------------------------------------------


def test_resolve_pipeline_depth(pkg, monkeypatch):
    resolve = pkg.engine.resolve_pipeline_depth
    monkeypatch.delenv("KDLT_PIPELINE_DEPTH", raising=False)
    assert resolve() == 2
    assert resolve(4) == 4
    assert resolve(0) == 1  # clamped
    monkeypatch.setenv("KDLT_PIPELINE_DEPTH", "3")
    assert resolve() == 3
    assert resolve(1) == 1  # explicit beats env
    monkeypatch.setenv("KDLT_PIPELINE_DEPTH", "banana")
    assert resolve() == 2  # a typo degrades to the default


def test_ordering_and_future_wiring(pkg):
    eng = ControlledEngine()
    d = pkg.engine.InFlightDispatcher(eng, depth=2)
    try:
        f0 = d.submit(_imgs(3, 1))
        f1 = d.submit(_imgs(2, 2))
        eng.handles[0].release()
        out0 = f0.result(timeout=5)
        assert out0[:, 0].tolist() == [0, 0, 0] and out0[:, 2].tolist() == [12] * 3
        assert not f1.done()
        eng.handles[1].release()
        out1 = f1.result(timeout=5)
        assert out1[:, 0].tolist() == [1, 1] and out1[:, 1].tolist() == [0, 1]
        assert eng.completed == [3, 2]  # async completions were accounted
    finally:
        _release_all(eng)
        d.close()


def test_backpressure_blocks_at_depth_limit(pkg):
    eng = ControlledEngine()
    d = pkg.engine.InFlightDispatcher(eng, depth=2)
    try:
        d.submit(_imgs(1))
        d.submit(_imgs(1))
        third = concurrent.futures.Future()
        t = threading.Thread(target=lambda: third.set_result(d.submit(_imgs(1))), daemon=True)
        t.start()
        # With 2 batches in flight the third submit must not reach the
        # engine until a slot frees (batch 0 materializes).
        t.join(timeout=0.2)
        assert t.is_alive() and not third.done() and eng.dispatches == 2
        eng.handles[0].release()
        fut3 = third.result(timeout=5)
        assert eng.dispatches == 3
        eng.handles[1].release()
        eng.handles[2].release()
        assert fut3.result(timeout=5)[0, 0] == 2.0
        t.join(timeout=5)
        assert not t.is_alive()
    finally:
        _release_all(eng)
        d.close()


def test_sync_failure_lands_on_the_right_future(pkg):
    eng = ControlledEngine(fail_sync_at={1})
    d = pkg.engine.InFlightDispatcher(eng, depth=3)
    try:
        futs = [d.submit(_imgs(1)) for _ in range(3)]
        _release_all(eng)
        assert futs[0].result(timeout=5)[0, 0] == 0.0
        with pytest.raises(RuntimeError, match="device fault at sync"):
            futs[1].result(timeout=5)
        # The pipeline survives the failed batch, and the failed batch never
        # inflated the success accounting.
        assert futs[2].result(timeout=5)[0, 0] == 2.0
        assert eng.completed == [1, 1]
    finally:
        d.close()


def test_dispatch_failure_resolves_that_submits_future(pkg):
    eng = ControlledEngine(fail_dispatch_at={0})
    d = pkg.engine.InFlightDispatcher(eng, depth=1)
    try:
        bad = d.submit(_imgs(1))
        with pytest.raises(ValueError, match="dispatch 0 rejected"):
            bad.result(timeout=5)
        ok = d.submit(_imgs(1))  # the failed dispatch released its slot
        eng.handles[0].release()
        assert ok.result(timeout=5)[0, 0] == 1.0
    finally:
        _release_all(eng)
        d.close()


def test_close_drains_inflight_and_rejects_new_submits(pkg):
    eng = ControlledEngine()
    d = pkg.engine.InFlightDispatcher(eng, depth=2)
    futs = [d.submit(_imgs(1)) for _ in range(2)]
    closer = threading.Thread(target=d.close, daemon=True)
    closer.start()
    # close() must wait out both in-flight batches.
    closer.join(timeout=0.2)
    assert closer.is_alive() and not any(f.done() for f in futs)
    _release_all(eng)
    closer.join(timeout=10)
    assert not closer.is_alive()
    for i, f in enumerate(futs):
        assert f.done() and f.result()[0, 0] == float(i)
    with pytest.raises(pkg.engine.DispatcherClosed):
        d.submit(_imgs(1))
    d.close()  # idempotent


def test_dispatcher_emits_stage_metrics(pkg):
    reg = pkg.metrics.Registry()
    eng = ControlledEngine()
    d = pkg.engine.InFlightDispatcher(eng, depth=2, registry=reg)
    try:
        f = d.submit(_imgs(1))
        eng.handles[0].release()
        f.result(timeout=5)
        text = reg.render()
        for stage in ("enqueue_wait", "dispatch", "execute", "readback"):
            assert f"kdlt_pipeline_{stage}_seconds_count 1" in text
        assert "kdlt_pipeline_depth 2.0" in text
    finally:
        d.close()


def test_watchdog_declare_stall(pkg):
    """declare_stall fails the in-flight waiters with DispatchStall, stops
    intake and counts the stranded batches; the watchdog itself declares
    one when a handle outlives its floor."""
    reg = pkg.metrics.Registry()
    eng = ControlledEngine()
    d = pkg.engine.InFlightDispatcher(eng, depth=2, registry=reg, watchdog=False)
    try:
        futs = [d.submit(_imgs(1)) for _ in range(2)]
        assert not d.stalled
        d.declare_stall()
        assert d.stalled
        for f in futs:
            with pytest.raises(pkg.engine.DispatchStall):
                f.result(timeout=5)
        with pytest.raises(pkg.engine.DispatchStall):
            d.submit(_imgs(1))
        assert "kdlt_dispatch_stall_total 2.0" in reg.render()
    finally:
        d.close()
        _release_all(eng)

    eng = ControlledEngine()
    d = pkg.engine.InFlightDispatcher(eng, depth=2, watchdog=True, stall_floor_s=0.05)
    try:
        stuck = d.submit(_imgs(1))  # never released
        with pytest.raises(pkg.engine.DispatchStall):
            stuck.result(timeout=10)
        assert d.stalled
    finally:
        d.close()
        _release_all(eng)


# --- batcher contracts ----------------------------------------------------------


def test_batcher_dispatches_next_batch_before_previous_completes(bpkg):
    """With a pipelined engine the dispatch thread starts (assembles AND
    dispatches) batch N+1 while batch N is still executing -- held open by
    batch N's unreleased handle, so the overlap is structural."""
    eng = ControlledEngine(max_batch=1)  # one request per batch
    b = bpkg.Batcher(eng, max_delay_ms=0, pipeline_depth=2)
    try:
        f0 = b.submit(_imgs(1, 1)[0])
        f1 = b.submit(_imgs(1, 2)[0])
        assert _until(lambda: eng.dispatches == 2)
        assert eng.completed == [] and not f0.done()
        eng.handles[1].release()
        eng.handles[0].release()
        assert f0.result(timeout=5).tolist() == [0.0, 0.0, 12.0]
        assert f1.result(timeout=5).tolist() == [1.0, 0.0, 24.0]
    finally:
        _release_all(eng)
        b.close()


def test_batcher_wires_rows_to_their_requests(bpkg):
    """Concurrent requests coalesce (the engine is held busy, so the queue
    fills) and every request gets its own row back."""
    eng = ControlledEngine(max_batch=8)
    b = bpkg.Batcher(eng, max_delay_ms=5, pipeline_depth=2)
    try:
        first = b.submit(_imgs(1, 0)[0])
        assert _until(lambda: eng.dispatches == 1)
        futs = {v: b.submit(_imgs(1, v)[0]) for v in range(1, 40)}
        while not all(f.done() for f in futs.values()):
            _release_all(eng)
            time.sleep(0.002)
        assert first.result(timeout=5)[2] == 0.0
        for v, f in futs.items():
            assert f.result(timeout=5)[2] == v * 12.0, v
        sizes = [len(h._out) for h in eng.handles]
        assert max(sizes) > 1 and all(s <= 8 for s in sizes) and sum(sizes) == 40
    finally:
        _release_all(eng)
        b.close()


def test_batcher_engine_error_propagates_and_batcher_survives(bpkg):
    eng = ControlledEngine(fail_dispatch_at={0})
    b = bpkg.Batcher(eng, max_delay_ms=0, pipeline_depth=2)
    try:
        with pytest.raises(ValueError, match="dispatch 0 rejected"):
            b.predict(_imgs(1, 1)[0], timeout=5)
        f = b.submit(_imgs(1, 2)[0])
        assert _until(lambda: eng.dispatches == 2)
        eng.handles[0].release()
        assert f.result(timeout=5).tolist() == [1.0, 0.0, 24.0]
    finally:
        _release_all(eng)
        b.close()


def test_batcher_serial_engine_unchanged(bpkg):
    """Engines without predict_async keep the dispatch-then-sync loop (no
    dispatcher), as does depth 1."""

    class Plain:
        max_batch = 4
        spec = SimpleNamespace(input_shape=(2, 2, 3), num_classes=2)

        def predict(self, images):
            s = images.reshape(images.shape[0], -1).sum(axis=1)
            return np.stack([s, s * 2], axis=1).astype(np.float32)

    b = bpkg.Batcher(Plain(), max_delay_ms=1, pipeline_depth=2)
    try:
        assert b._dispatcher is None
        assert b.predict(_imgs(1, 3)[0]).tolist() == [36.0, 72.0]
    finally:
        b.close()
    eng = ControlledEngine()
    b = bpkg.Batcher(eng, max_delay_ms=1, pipeline_depth=1)
    try:
        assert b._dispatcher is None
    finally:
        b.close()


def test_batcher_queue_cap_rejects(bpkg):
    """Two batches in flight and a third blocked at the depth limit: the
    queue then holds queue_cap requests and the next is rejected."""
    reg = bpkg.metrics.Registry()
    eng = ControlledEngine(max_batch=1)
    b = bpkg.Batcher(eng, max_delay_ms=0, queue_cap=2, registry=reg,
                                   pipeline_depth=2)
    try:
        futs = []
        for v in range(3):  # each taken off the queue before the next
            futs.append(b.submit(_imgs(1, v)[0]))
            assert _until(lambda: not _queued(b))
        assert eng.dispatches == 2
        futs += [b.submit(_imgs(1, v)[0]) for v in (3, 4)]
        with pytest.raises(bpkg.batcher.QueueFull):
            b.submit(_imgs(1, 5)[0])
        assert "kdlt_batcher_rejected_total 1.0" in reg.render()
        while not all(f.done() for f in futs):
            _release_all(eng)
            time.sleep(0.002)
        assert [f.result()[2] for f in futs] == [0.0, 12.0, 24.0, 36.0, 48.0]
    finally:
        _release_all(eng)
        b.close()


def test_batcher_close_rejects_new_and_drains(bpkg):
    eng = ControlledEngine()
    b = bpkg.Batcher(eng, max_delay_ms=1, pipeline_depth=2)
    fut = b.submit(_imgs(1, 1)[0])
    assert _until(lambda: eng.dispatches == 1)
    closer = threading.Thread(target=b.close, daemon=True)
    closer.start()
    eng.handles[0].release()
    closer.join(timeout=10)
    assert not closer.is_alive()
    assert fut.result(timeout=5).tolist() == [0.0, 0.0, 12.0]
    with pytest.raises(bpkg.batcher.BatcherClosed):
        b.submit(_imgs(1, 1)[0])


# --- the port's model server on the CPU ----------------------------------------

_SPEC_KW = dict(
    name="torch-batch-xception",
    family="xception",
    input_shape=(96, 96, 3),
    labels=("dress", "hat", "pants", "shirt"),
    preprocessing="tf",
    resize_filter="nearest",
)
_BUCKETS = "1,2,4,8"


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A float32 96-px Xception exported by the JAX exporter, and JAX's
    forward of its variables."""
    spec = register_spec(JaxModelSpec(**_SPEC_KW))
    root = tmp_path_factory.mktemp("models")
    variables = jax_init_variables(spec, seed=7)
    export_model(spec, variables, str(root), dtype=np.float32)
    fwd = jax.jit(jax_build_forward(spec, dtype=None))
    return spec, str(root), lambda imgs: np.asarray(fwd(variables, imgs))


def _server(root, *flags):
    server = build_server(["--model-root", root, "--host", "127.0.0.1", "--port", "0",
                           "--buckets", _BUCKETS, "--device", "cpu", *flags])
    server.start()
    server.warmup()
    return server


def _post(port, name, images):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:predict",
        data=protocol.encode_predict_request(images), method="POST",
        headers={"Content-Type": protocol.MSGPACK_CONTENT_TYPE},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, protocol.decode_predict_response(r.read(), r.headers["Content-Type"])[0]
    except urllib.error.HTTPError as e:
        return e.code, (e.read(), e.headers.get(protocol.STALLED_HEADER))


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _requests(spec):
    rng = np.random.default_rng(21)
    shape = spec.input_shape
    return [rng.integers(0, 256, (n, *shape), np.uint8) for n in [1] * 8 + [5, 9]]


def _send_concurrently(port, name, batches):
    barrier = threading.Barrier(len(batches))

    def one(imgs):
        barrier.wait(timeout=30)
        return _post(port, name, imgs)

    with concurrent.futures.ThreadPoolExecutor(len(batches)) as pool:
        return list(pool.map(one, batches))


def _series(text, name, model):
    """{le or "": value} of one series family of a rendered registry: the
    model's (a served version's series also carry its ``version``)."""
    out = {}
    for m in re.finditer(rf'^{name}\{{model="{model}"(?:,version="\d+")?(?:,le="([^"]+)")?\}} '
                         r'(\S+)$', text, re.M):
        out[m.group(1) or ""] = float(m.group(2))
    return out


def test_model_server_batches_and_chunks_match_jax(exported):
    spec, root, jax_forward = exported
    server = _server(root)
    try:
        batches = _requests(spec)
        replies = _send_concurrently(server.port, spec.name, batches)
        for imgs, (status, got) in zip(batches, replies):
            assert status == 200, got
            assert got.shape == (len(imgs), len(spec.labels))
            np.testing.assert_allclose(got, jax_forward(imgs), rtol=1e-3, atol=1e-3)
        text = server.registry.render()
    finally:
        server.shutdown()
    name = spec.name
    # Every image rides the model's lane: the 8 single images, the 5-image
    # request as one unit and the 9-image one as units of 8 and 1, packed
    # into plans of at most 8 rows.
    sizes = _series(text, "kdlt_batcher_batch_size_bucket", name)
    assert _series(text, "kdlt_batcher_batch_size_sum", name)[""] == 22.0
    n_batched = _series(text, "kdlt_batcher_batch_size_count", name)[""]
    # With buckets (1, 2, 4, 8) a batch of s rows pads to the histogram bin
    # it falls in, so the padding follows from the batch-size histogram.
    cum, padded_rows = 0.0, 0.0
    for le in ("1", "2", "4", "8"):
        padded_rows += (sizes[le] - cum) * int(le)
        cum = sizes[le]
    assert cum == n_batched
    assert _series(text, "kdlt_sched_dispatch_total", name)[""] == n_batched
    assert _series(text, "kdlt_engine_images_total", name)[""] == 22.0
    assert _series(text, "kdlt_engine_batches_total", name)[""] == n_batched
    assert _series(text, "kdlt_engine_pad_images_total", name)[""] == padded_rows - 22
    assert _series(text, "kdlt_pipeline_dispatch_seconds_count", name)[""] == n_batched


def test_model_server_no_batching_serves_the_same_replies(exported):
    spec, root, jax_forward = exported
    server = _server(root, "--no-batching")
    try:
        model = server.models[spec.name]
        assert model.batcher is None and model.dispatcher is not None
        batches = _requests(spec)
        replies = _send_concurrently(server.port, spec.name, batches)
        for imgs, (status, got) in zip(batches, replies):
            assert status == 200, got
            np.testing.assert_allclose(got, jax_forward(imgs), rtol=1e-3, atol=1e-3)
        text = server.registry.render()
        assert _series(text, "kdlt_engine_batches_total", spec.name)[""] == 8 + 1 + 2
        assert "kdlt_batcher_batch_size" not in text
    finally:
        server.shutdown()


def test_model_server_answers_503_once_the_pipeline_stalls(exported):
    spec, root, _ = exported
    server = _server(root, "--pipeline-depth", "2", "--max-delay-ms", "0")
    try:
        assert _get(server.port, "/healthz") == (200, b"ok")
        assert _get(server.port, "/readyz") == (200, b"ready")
        server.scheduler.dispatcher.declare_stall()  # the lanes' shared dispatcher
        assert _get(server.port, "/healthz") == (503, b"dispatch stalled")
        assert _get(server.port, "/readyz") == (503, b"dispatch stalled")
        imgs = np.zeros((1, *spec.input_shape), np.uint8)
        for batch in (imgs, np.concatenate([imgs] * 9)):  # one image, and chunks
            status, (body, stalled) = _post(server.port, spec.name, batch)
            assert status == 503 and stalled == "1", body
            assert json.loads(body)["error"].startswith("dispatch stalled")
        status, models = _get(server.port, "/v1/models")
        assert status == 200 and json.loads(models)[spec.name]["ready"]
    finally:
        server.shutdown()


def test_model_server_answers_503_when_the_queue_is_full(exported):
    spec, root, _ = exported
    server = _server(root)
    try:
        server.scheduler.lane(spec.name).queue_cap = 0
        status, (body, stalled) = _post(server.port, spec.name,
                                        np.zeros((1, *spec.input_shape), np.uint8))
        assert status == 503 and stalled is None
        assert json.loads(body)["error"].startswith("overloaded")
    finally:
        server.shutdown()


def test_model_server_cli_defaults_are_jaxs():
    """--max-delay-ms 2, --pipeline-depth 0 ($KDLT_PIPELINE_DEPTH or 2),
    batching on: the JAX server's defaults."""
    from kubernetes_deep_learning_tpu_torch.serving.model_server import _parser

    args = _parser().parse_args(["--model-root", "x"])
    assert (args.max_delay_ms, args.pipeline_depth, args.no_batching) == (2.0, 0, False)


def test_model_server_batcher_flag_default_is_jaxs():
    """--batcher auto, the JAX server's default (its ``batcher_impl``)."""
    import inspect

    from kubernetes_deep_learning_tpu.serving.model_server import ModelServer as JaxModelServer

    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer, _parser

    jax_default = inspect.signature(JaxModelServer).parameters["batcher_impl"].default
    assert _parser().parse_args(["--model-root", "x"]).batcher == jax_default == "auto"
    assert inspect.signature(ModelServer).parameters["batcher_impl"].default == jax_default


@pytest.mark.parametrize("impl", ["native", "python"])
def test_model_server_batcher_flag_serves_the_same_replies(exported, impl):
    """``--batcher native`` and ``--batcher python``: the replies of the
    concurrent requests match JAX's forward, and ``/metrics`` serves the
    engine, batcher and pipeline series of the registry.  As in JAX,
    ``native`` keeps the model's private C++ queue (single images only)
    and ``python`` serves through the scheduler's lane (every image)."""
    spec, root, jax_forward = exported
    server = _server(root, "--batcher", impl)
    try:
        model = server.models[spec.name]
        if impl == "native":
            assert isinstance(model.batcher, NativeBatcher) and server.scheduler is None
        else:
            assert model.batcher is None and server.scheduler.lane(spec.name) is not None
        batches = _requests(spec)
        replies = _send_concurrently(server.port, spec.name, batches)
        for imgs, (status, got) in zip(batches, replies):
            assert status == 200, got
            np.testing.assert_allclose(got, jax_forward(imgs), rtol=1e-3, atol=1e-3)
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=30) as r:
            ctype, text = r.headers["Content-Type"], r.read().decode()
    finally:
        server.shutdown()
    assert ctype == "text/plain"
    assert _series(text, "kdlt_engine_images_total", spec.name)[""] == 22.0
    # The C++ queue takes the single images and the dispatcher also the
    # 9-image request's chunks of 8 and 1; the lane takes every image.
    on_lane = impl == "python"
    assert _series(text, "kdlt_batcher_batch_size_sum", spec.name)[""] == (22.0 if on_lane else 8.0)
    n_batched = _series(text, "kdlt_batcher_batch_size_count", spec.name)[""]
    assert (_series(text, "kdlt_pipeline_dispatch_seconds_count", spec.name)[""]
            == n_batched + (0 if on_lane else 2))


# --- create_batcher ---------------------------------------------------------------


def test_create_batcher_picks_by_core_count(monkeypatch):
    """The JAX rule: native with 2 or more cores in the affinity mask, Python
    on one core; ``python`` and ``native`` as asked."""
    import os

    eng = ControlledEngine()
    for cores, impl, want in (({0, 1}, "auto", NativeBatcher),
                              ({0}, "auto", port_batcher.DynamicBatcher),
                              ({0}, "native", NativeBatcher),
                              ({0, 1, 2}, "python", port_batcher.DynamicBatcher)):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid, cores=cores: cores)
        b = create_batcher(eng, impl=impl, max_delay_ms=1, pipeline_depth=1)
        try:
            assert type(b) is want, (cores, impl)
        finally:
            b.close()
    with pytest.raises(ValueError, match="unknown batcher"):
        create_batcher(eng, impl="rust")


def test_create_batcher_native_raises_when_the_queue_will_not_build(monkeypatch, tmp_path):
    """A compiler that does not exist and an empty build directory: ``native``
    raises, ``auto`` takes the Python batcher."""
    import os

    from kubernetes_deep_learning_tpu_torch.ops import _native

    monkeypatch.setattr(_native, "_lib", None)  # forget the library built so far
    monkeypatch.setenv("KDLT_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1, 2, 3})
    eng = ControlledEngine()
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        create_batcher(eng, impl="native", pipeline_depth=1)
    b = create_batcher(eng, impl="auto", max_delay_ms=1, pipeline_depth=1)
    try:
        assert type(b) is port_batcher.DynamicBatcher
    finally:
        b.close()
    monkeypatch.setenv("CXX", "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="false failed"):
        create_batcher(eng, impl="native", pipeline_depth=1)
    assert not list(tmp_path.iterdir())  # nothing half-built is left to load
