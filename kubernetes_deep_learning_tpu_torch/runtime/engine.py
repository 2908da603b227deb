"""Inference engine: bucketed batch padding around the forward module, and
the in-flight dispatch pipeline over it.

The port of ``runtime/engine.py``'s single-device ``InferenceEngine`` and
``InFlightDispatcher``.  A request batch is padded up to the smallest
bucket that holds it, so the device only ever sees the bucket shapes that
``warmup()`` ran.  On the card, warmup is the counterpart of the JAX
engine's per-bucket compile: for each bucket in turn it runs the forward
once on a side stream (building the CUDA kernels and warming cuDNN and
cuBLAS), then captures it into a CUDA graph over a static uint8 input and a
static logits output, and replays it once.  A kernel that fails to build or
launch, or a forward that cannot be captured (a host sync, a pageable
copy), fails warmup: there is no fallback to eager execution on the card.

Inputs:
- uint8 (N,H,W,C): the serving path, in the artifact's compute dtype
  (``metadata["compute_dtype"]``, default bfloat16) on the fused path when
  ``fast`` resolves to it;
- float32 (N,H,W,C), already normalized: the exact float32 graph, the
  debug/reference path (built on first use).

On the card, ``predict_async`` waits for nothing the device is doing: the
batch is staged in a pinned host buffer, copied into the bucket's static
input with ``non_blocking``, the bucket's graph is replayed behind it, and
the logits' copy back into pinned host memory is enqueued right after,
followed by the event the returned handle waits on, all on one stream.  So
batch N+1 can be staged and launched while batch N runs, and batch N's
readback never waits behind batch N+1.  A replay credits the kernel
launches its capture recorded to the kernels' launch counts.

Staging slots hold ``max_batch`` images each and sit in a free list, the
oldest handed out first: ``pipeline_depth + 1`` of them at first, more
only while one is lent.  ``lend_staging`` lends one to a batcher that
gathers its requests straight into it (``StagedBatch``); the borrower owns
it until it hands it back, after ``predict_async`` has enqueued its H2D
copy, so no other dispatch can refill it in between.  A slot is refilled
only after the H2D copy that last read it has run (an event per slot).

Device-resize staging (``$KDLT_INGEST_DEVICE_RESIZE=HxW``, off by
default; the JAX engine's knob): ``predict_ingest_async`` takes the bytes
wire's uint8 batches at HxW, and the staged program resizes them on the
device to the model's input (``ops.resize``, what ``jax.image.resize``
computes), rounds and clips them back to uint8 and runs the forward.  On
the card it is a CUDA graph per bucket of its own, captured by ``warmup()``
after the plain buckets on the same capture thread, stream and pool, and
fed from pinned slots at HxW.  Off, none of it exists.

Accounting: every completed batch feeds the engine's counters and, through
``runtime.flops.MfuAccountant``, the live ``kdlt_mfu_pct{bucket}`` and
``kdlt_device_busy_ratio`` gauges, with the batch's DEVICE time -- on the
card, the interval between a timing event recorded on the stream just
before the graph's replay and the handle's ``done`` event (the JAX engine
uses dispatch->sync, which at depth 2 also holds the previous batch's
execution); on the CPU the wall interval.  ``warmup()`` counts the
model's FLOPs per image once (``runtime.flops.flops_per_image``) before
the engine reports ready, and ``bucket_audit()`` serves the padding waste
per bucket over the recent batches.

Quantized artifacts (``ops.quantize``; the JAX engine's scheme dispatch,
gate and downgrade): ``metadata["quantization"]`` names the scheme.
``int8-weight-only`` serves the float forward (the fused path on the card)
on the host-dequantized parameters, dequantized once at load.
``int8-w8a8`` serves ``ops.quantize.build_w8a8_forward`` (the exact
float32 graph with every calibrated conv on the int8 kernels Q1/Q2; the
fused path stays off), unless $KDLT_QUANT_SCHEME=weight-only serves it
weight-only.  After the buckets are captured, ``warmup()`` runs the gate:
the w8a8 replay on the bucket for min(8, max_batch) against the
weight-only forward on seeded images must agree within $KDLT_QUANT_TOL
(relative max-abs) with top-1 agreement >= 0.99; otherwise the engine
logs an error, counts ``kdlt_quant_gate_failures_total``, frees the w8a8
graphs and re-captures the weight-only forward before it reports ready.
``quantization`` / ``quantization_active`` and ``kdlt_quant_scheme``
report the requested and the serving scheme.

``close()`` gives an unloaded version's device memory back: it waits for
the event of the engine's last dispatch, then drops its bucket graphs,
their pool, its staging slots and its parameters, and releases the cached
blocks, under the capture lock so the release never runs while another
engine captures.  The caller first makes sure no dispatch of the engine is
still to come (``UnifiedScheduler.wait_engine_idle``, or closing the
batcher and dispatcher that fed it).
"""

from __future__ import annotations

import collections
import gc
import logging
import os
import queue as queue_lib
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import NamedTuple, Sequence

import numpy as np
import torch

from kubernetes_deep_learning_tpu_torch import weights
from kubernetes_deep_learning_tpu_torch.export.artifact import ModelArtifact
from kubernetes_deep_learning_tpu_torch.models import build_forward, resolve_device
from kubernetes_deep_learning_tpu_torch.ops import _counts
from kubernetes_deep_learning_tpu_torch.ops import quantize as quant_lib
from kubernetes_deep_learning_tpu_torch.ops import resize as resize_lib
from kubernetes_deep_learning_tpu_torch.runtime import flops as flops_lib
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib
from kubernetes_deep_learning_tpu_torch.utils import trace as trace_lib

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

PIPELINE_DEPTH_ENV = "KDLT_PIPELINE_DEPTH"
DEFAULT_PIPELINE_DEPTH = 2

# Engine watchdog (serving-path fault tolerance): an in-flight dispatch
# handle stuck beyond ``multiple`` x the bucket's expected latency (EWMA of
# observed completions; ``floor`` seconds until there are samples, and
# never below the floor) is declared stalled -- its future fails with the
# retryable DispatchStall, the dispatcher flips unhealthy (the model
# server's /healthz follows, so the orchestrator restarts the pod), and
# kdlt_dispatch_stall_total counts it.  KDLT_WATCHDOG=0 disables.
WATCHDOG_ENV = "KDLT_WATCHDOG"
WATCHDOG_MULTIPLE_ENV = "KDLT_WATCHDOG_MULTIPLE"
WATCHDOG_FLOOR_S_ENV = "KDLT_WATCHDOG_FLOOR_S"
DEFAULT_WATCHDOG_MULTIPLE = 10.0
DEFAULT_WATCHDOG_FLOOR_S = 30.0

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

log = logging.getLogger(__name__)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw.strip() else default
    except ValueError:
        return default


def resolve_pipeline_depth(depth: int | None = None) -> int:
    """The in-flight dispatch depth: explicit arg > $KDLT_PIPELINE_DEPTH > 2.

    Depth 1 is serial dispatch (each batch fully materialized before the
    next is assembled).  Depth 2 overlaps batch N+1's staging, H2D copy and
    kernel launches with batch N's device execution, which is the whole win
    on one card: the device runs one stream's work in order, so depth 3+
    only queues more work behind it and adds latency without adding
    throughput.  Clamped to >=1; a typo'd env value degrades to the default
    rather than killing serving.
    """
    if depth is None:
        raw = os.environ.get(PIPELINE_DEPTH_ENV, "")
        try:
            depth = int(raw) if raw.strip() else DEFAULT_PIPELINE_DEPTH
        except ValueError:
            depth = DEFAULT_PIPELINE_DEPTH
    return max(1, int(depth))


# Device-resize staging for the bytes wire: KDLT_INGEST_DEVICE_RESIZE=HxW
# makes the decode stage stop its host resize at HxW and hands the engine
# that staging resolution; the engine's staged program (a CUDA graph per
# bucket on the card) resizes to spec.input_shape on the device
# (ops.resize, what jax.image.resize computes) ahead of the forward.  Off
# by default: the device resize is not bit-exact with the host's (PIL's),
# and bytes-wire logits equal tensor-wire logits only with the host resize.
INGEST_DEVICE_RESIZE_ENV = "KDLT_INGEST_DEVICE_RESIZE"


def ingest_device_resize(explicit: str | None = None) -> tuple[int, int] | None:
    """Parse the staging resolution: 'HxW' -> (H, W); unset/off -> None.
    An explicit argument beats the environment; a bad value raises
    ValueError."""
    raw = explicit if explicit is not None else os.environ.get(INGEST_DEVICE_RESIZE_ENV, "")
    raw = (raw or "").strip().lower()
    if not raw or raw in ("0", "off", "false", "no"):
        return None
    try:
        h_s, w_s = raw.split("x")
        h, w = int(h_s), int(w_s)
    except ValueError:
        raise ValueError(
            f"{INGEST_DEVICE_RESIZE_ENV} must be 'HxW' (e.g. 512x512), got {raw!r}") from None
    if h <= 0 or w <= 0:
        raise ValueError(f"{INGEST_DEVICE_RESIZE_ENV} dims must be positive, got {raw!r}")
    return (h, w)


class DispatcherClosed(RuntimeError):
    """The in-flight dispatcher has been permanently shut down."""


class EngineClosed(RuntimeError):
    """The engine was closed (its version unloaded); another version serves."""


class DispatchStall(RuntimeError):
    """An in-flight dispatch was declared stuck by the watchdog.

    Retryable from the caller's point of view (another replica can serve
    the request); for THIS process it is terminal evidence -- the
    completion thread is wedged on a device sync that never returns, so
    the dispatcher stops intake and the serving health check fails until
    the orchestrator restarts the pod.
    """


class InFlightDispatcher:
    """Bounded multi-in-flight dispatch pipeline over an engine.

    ``submit(images)`` enqueues a bucket's forward via
    ``engine.predict_async`` and returns a Future immediately, so the caller
    starts assembling the NEXT batch while this one executes; a dedicated
    completion thread materializes results (the blocking device sync) in
    FIFO dispatch order and resolves each Future.  Backpressure: submit
    blocks while ``depth`` batches are already in flight, so host assembly
    can run at most ``depth`` batches ahead of the device.

    Guarantees:

    - **Ordering**: completions happen in submit order (single FIFO
      completion queue), and each Future resolves to exactly its own
      batch's rows -- never another caller's.
    - **Same results**: the same predict_async + np.asarray
      materialization path as the engine's own synchronous predict().
    - **Exception wiring**: a dispatch failure resolves THAT submit's
      Future with the exception; a device-side failure surfacing at sync
      resolves the in-flight batch's Future.  Neither kills the pipeline.
    - **Clean shutdown**: close(drain=True) completes every in-flight
      batch before the completion thread exits; submits after close raise
      DispatcherClosed.

    Aliasing contract (inherited from predict_async): a submitted ``images``
    array must stay unmodified until its Future resolves.  The port's
    engine copies it into its own pinned staging ring before returning.

    Per-stage latency lands in the kdlt_pipeline_*_seconds histograms
    (utils.metrics.PIPELINE_STAGES documents the stage semantics); a traced
    member request gets the same four intervals as spans.
    """

    def __init__(self, engine=None, depth: int | None = None,
                 registry: metrics_lib.Registry | None = None,
                 watchdog: bool | None = None,
                 stall_multiple: float | None = None,
                 stall_floor_s: float | None = None):
        # ``engine=None``: each submit() names its engine (one bounded
        # in-flight budget, one FIFO completion thread and one watchdog
        # over several engines sharing a device).
        self._engine = engine
        self.depth = resolve_pipeline_depth(depth)
        self._slots = threading.Semaphore(self.depth)
        self._completions: queue_lib.Queue = queue_lib.Queue()
        self._closed = False         # guarded-by: _close_lock
        self._close_lock = threading.Lock()
        registry = registry or getattr(engine, "registry", None) or metrics_lib.Registry()
        self._registry = registry
        self._m_stage = metrics_lib.pipeline_stage_histograms(registry)
        # Model-labelled stage series (a scheduler's shared dispatcher),
        # minted by stage_histograms.
        self._m_stage_models: dict[str, dict] = {}
        self._m_depth = registry.gauge(
            "kdlt_pipeline_depth", "configured in-flight dispatch depth"
        )
        self._m_depth.set(float(self.depth))
        self._m_stalls = metrics_lib.dispatch_stall_counter(registry)
        # Watchdog state: in-flight ledger (token -> (future, (engine,
        # bucket) key, dispatch time)) the watchdog scans, per-key EWMA of
        # observed dispatch->sync latency, and the terminal "stalled" flag.
        self._stalled = threading.Event()
        self._inflight: dict[int, tuple[Future, tuple, float]] = {}  # guarded-by: _inflight_lock
        self._inflight_lock = threading.Lock()
        self._seq = 0                # guarded-by: _inflight_lock
        self._expected_s: dict[tuple, float] = {}  # guarded-by: _inflight_lock
        if watchdog is None:
            watchdog = os.environ.get(WATCHDOG_ENV, "").strip() != "0"
        self._stall_multiple = (
            stall_multiple if stall_multiple is not None
            else _env_float(WATCHDOG_MULTIPLE_ENV, DEFAULT_WATCHDOG_MULTIPLE)
        )
        self._stall_floor_s = (
            stall_floor_s if stall_floor_s is not None
            else _env_float(WATCHDOG_FLOOR_S_ENV, DEFAULT_WATCHDOG_FLOOR_S)
        )
        self._watchdog_stop = threading.Event()
        self._watchdog_thread = None
        if watchdog and self._stall_floor_s > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, name="kdlt-dispatch-watchdog", daemon=True
            )
            self._watchdog_thread.start()
        self._thread = threading.Thread(
            target=self._complete_loop, name="kdlt-dispatch-readback", daemon=True
        )
        self._thread.start()

    @property
    def stalled(self) -> bool:
        """True once the watchdog declared an in-flight dispatch stuck; the
        dispatcher no longer accepts work and serving health should fail."""
        return self._stalled.is_set()

    def stage_histograms(self, model: str | None = None) -> dict:
        """The stage histograms a batch's times land in: the unlabelled set,
        or the ``model``-labelled one when a scheduler attributes each
        batch to its model (minted on first call: a scheduler calls this
        when it adds a model's lane, so the series read 0 until its first
        batch)."""
        if model is None:
            return self._m_stage
        stages = self._m_stage_models.get(model)
        if stages is None:
            stages = self._m_stage_models[model] = metrics_lib.pipeline_stage_histograms(
                self._registry, model=model)
        return stages

    def _engine_key(self, engine):
        spec = getattr(engine, "spec", None)
        return getattr(spec, "name", None) or id(engine)

    def submit(self, images, traces=(), engine=None, model: str | None = None) -> Future:
        """Dispatch one uint8 batch (an array, or a ``StagedBatch`` in a slot
        the engine lent); returns a Future of its logits rows.

        Blocks only while ``depth`` batches are in flight (backpressure) --
        never on device execution of the batch itself.  ``traces`` carries
        the member requests' ``utils.trace.RequestTrace`` objects: each
        member's waterfall gets the four pipeline-stage spans, from the same
        boundaries that feed kdlt_pipeline_*_seconds, recorded at
        completion.  ``engine`` overrides the construction-time engine for
        THIS batch; ``model`` attributes its stage times to that model's
        series.
        """
        engine = engine if engine is not None else self._engine
        if engine is None:
            raise ValueError("no engine: pass engine= per submit or at init")
        if self._stalled.is_set():
            # The completion thread is wedged on a sync that never returns;
            # slots will never free, so blocking on one would hang the
            # caller.  Fail fast and retryably (another replica can serve).
            raise DispatchStall("dispatch pipeline is stalled")
        traces = tuple(t for t in traces if t is not None)
        t0 = time.perf_counter()
        w0 = trace_lib.now_s() if traces else 0.0
        self._slots.acquire()
        # The slot-semaphore handshake orders this read: close() drains
        # every slot before flipping _closed, so a submit holding a slot
        # observes the flip or the drain, never a torn state.
        if self._closed:
            self._slots.release()
            raise DispatcherClosed("dispatcher is shut down")
        if self._stalled.is_set():
            self._slots.release()
            raise DispatchStall("dispatch pipeline is stalled")
        stages = self.stage_histograms(model)
        stages["enqueue_wait"].observe(time.perf_counter() - t0)
        w1 = trace_lib.now_s() if traces else 0.0
        fut: Future = Future()
        t1 = time.perf_counter()
        try:
            handle, n = engine.predict_async(images)
        except Exception as e:  # dispatch failure belongs to THIS future
            self._slots.release()
            fut.set_exception(e)
            return fut
        dispatched_at = time.perf_counter()
        stages["dispatch"].observe(dispatched_at - t1)
        w2 = trace_lib.now_s() if traces else 0.0
        bkey = (self._engine_key(engine), self._bucket_of(engine, n))
        with self._inflight_lock:
            token = self._seq
            self._seq += 1
            self._inflight[token] = (fut, bkey, dispatched_at)
        self._completions.put((handle, n, fut, dispatched_at, token, engine, bkey, stages,
                               traces, (w0, w1, w2)))
        return fut

    def _complete_loop(self) -> None:
        while True:
            item = self._completions.get()
            if item is None:
                return
            self._complete_one(*item)

    def _complete_one(self, handle, n: int, fut: Future, dispatched_at: float, token: int,
                      engine, bkey, stages: dict, traces=(), walls=(0.0, 0.0, 0.0)) -> None:
        """MUST NOT raise: an exception escaping here kills the completion
        thread, which strands every later batch's waiters AND deadlocks
        close() -- so anything unexpected fails THIS future instead."""
        w3 = trace_lib.now_s() if traces else 0.0
        t0 = time.perf_counter()
        try:
            rows = np.asarray(handle)[:n]  # blocking device sync
        except Exception as e:  # device-side failure surfaces at sync
            with self._inflight_lock:
                self._inflight.pop(token, None)
            self._slots.release()
            if not fut.cancelled():
                fut.set_exception(e)
            return
        t1 = time.perf_counter()
        stages["execute"].observe(t0 - dispatched_at)
        stages["readback"].observe(t1 - t0)
        self._observe_latency(bkey, t1 - dispatched_at)
        with self._inflight_lock:
            self._inflight.pop(token, None)
        try:
            if hasattr(engine, "record_completed"):
                # The engine accounts only its own synchronous path;
                # pipelined batches report here after materialization
                # succeeds (failed batches never inflate the counters).
                engine.record_completed(n, t1 - dispatched_at,
                                        getattr(handle, "device_seconds", None))
        except Exception:  # noqa: BLE001 - accounting must not stall results
            log.exception("record_completed failed")
        if traces:
            # Per-member stage spans from the SHARED perf-counter boundaries
            # (one batch, one set of intervals): contiguous and
            # non-overlapping in every member's waterfall.  Deferred before
            # the future resolves, so each member's own thread records them
            # before its reply (RequestTrace.defer): this thread, which every
            # batch's results wait on, only hands the intervals over.
            w0, w1, w2 = walls
            w4 = w3 + (t1 - t0)
            stages = ((trace_lib.SPAN_PIPELINE_ENQUEUE_WAIT, w0, w1 - w0, {}),
                      (trace_lib.SPAN_PIPELINE_DISPATCH, w1, w2 - w1, {}),
                      (trace_lib.SPAN_PIPELINE_EXECUTE, w2, w3 - w2, {}),
                      (trace_lib.SPAN_PIPELINE_READBACK, w3, w4 - w3, {}))
            try:
                for tr in traces:
                    tr.defer(stages)
            except Exception:  # noqa: BLE001 - tracing must not stall results
                log.exception("recording the pipeline spans failed")
        self._slots.release()
        try:
            if not fut.cancelled():
                fut.set_result(rows)
        except Exception:  # noqa: BLE001 - the watchdog failed it first
            pass

    # --- watchdog ----------------------------------------------------------

    def _bucket_of(self, engine, n: int) -> int:
        bucket_for = getattr(engine, "bucket_for", None)
        if bucket_for is None:
            return n
        try:
            return bucket_for(n)
        except Exception:  # noqa: BLE001 - accounting key only
            return n

    def _observe_latency(self, bkey, seconds: float) -> None:
        """Per-(engine, bucket) EWMA of dispatch->sync latency; the
        watchdog's notion of "expected"."""
        with self._inflight_lock:
            prev = self._expected_s.get(bkey)
            self._expected_s[bkey] = seconds if prev is None else 0.7 * prev + 0.3 * seconds

    def _stall_bound_s(self, bkey) -> float:
        """How long an in-flight dispatch with this (engine, bucket) key may
        run before it is stuck: multiple x the key's EWMA, never below the
        floor (and exactly the floor until the key has a sample)."""
        with self._inflight_lock:
            expected = self._expected_s.get(bkey)
        if expected is None:
            return self._stall_floor_s
        return max(self._stall_floor_s, self._stall_multiple * expected)

    def _watchdog_loop(self) -> None:
        interval = max(0.01, min(1.0, self._stall_floor_s / 5.0))
        while not self._watchdog_stop.wait(interval):
            if self._check_stall():
                return  # terminal: the pipeline is declared dead

    def _check_stall(self) -> bool:
        """One watchdog scan; returns True when a stall was declared."""
        now = time.perf_counter()
        with self._inflight_lock:
            entries = list(self._inflight.items())
        overdue = [
            token for token, (_, bkey, t0) in entries if now - t0 > self._stall_bound_s(bkey)
        ]
        if not overdue:
            return False
        log.error(
            "dispatch watchdog: %d in-flight batch(es) stuck past their stall "
            "bound (oldest %.1fs); failing waiters and marking the pipeline stalled",
            len(overdue), max(now - t0 for _, (_, _, t0) in entries),
        )
        self.declare_stall()
        return True

    def declare_stall(self) -> None:
        """Declare the pipeline terminally stalled: fail every in-flight
        waiter retryably, stop intake, flip unhealthy.

        The completion thread materializes in FIFO order, so one stuck
        handle blocks every later in-flight batch too -- this process
        needs a restart, its callers need another replica.  The watchdog
        is the normal caller; tests call it directly to stage a wedged
        replica without waiting out a real device hang.
        """
        self._stalled.set()
        with self._inflight_lock:
            stranded = list(self._inflight.values())
            self._inflight.clear()
        for fut, _bkey, _t0 in stranded:
            self._m_stalls.inc()
            try:
                if not fut.done():
                    fut.set_exception(DispatchStall("in-flight dispatch exceeded its stall bound"))
            except Exception:  # noqa: BLE001 - racing completion
                pass

    def close(self, drain: bool = True) -> None:
        """Stop intake, drain every in-flight batch, stop the completion
        thread.

        Quiesces through the slot semaphore: acquiring all ``depth`` slots
        both waits for in-flight work to finish materializing (each slot is
        released only after its Future resolves) and blocks any racing
        submit, which then observes ``_closed`` and raises -- so no Future
        can be stranded by a close/submit race.  drain=False is accepted
        for signature symmetry with the batcher but behaves identically:
        work already dispatched is on the device regardless, so its waiters
        are always resolved.

        A STALLED dispatcher cannot quiesce (the completion thread is
        wedged and its slots never free): close skips the drain, leaving
        the daemon threads to die with the process -- which is imminent,
        since the stall already failed the health check.
        """
        del drain
        self._watchdog_stop.set()
        with self._close_lock:
            if self._closed:
                return
            if not self._stalled.is_set():
                for _ in range(self.depth):  # wait out the in-flight batches
                    self._slots.acquire()
                self._closed = True
                for _ in range(self.depth):  # wake blocked submits -> raise
                    self._slots.release()
            else:
                self._closed = True
        self._completions.put(None)
        self._thread.join(timeout=0.5 if self._stalled.is_set() else 30.0)
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=5.0)


class DeviceLogits:
    """An in-flight result: ``np.asarray(handle)`` waits for ``done`` (a
    CUDA event recorded after the copy of the logits into the pinned
    ``rows``) and returns the host rows; a CPU result has no event.
    ``start``, a timing event recorded just before the forward's launch,
    gives the batch's device time once ``done`` has completed."""

    def __init__(self, rows: torch.Tensor, done: torch.cuda.Event | None = None,
                 start: torch.cuda.Event | None = None):
        self._rows = rows
        self._done = done
        self._start = start

    @property
    def device_seconds(self) -> float | None:
        """Seconds from ``start`` to ``done`` on the stream (None without a
        start event); read after the handle was materialized."""
        if self._start is None:
            return None
        return self._start.elapsed_time(self._done) / 1e3

    def __array__(self, dtype=None, copy=None):
        if self._done is not None:
            self._done.synchronize()
        arr = self._rows.numpy()
        return arr if dtype is None else arr.astype(dtype)


class StagingSlot:
    """A pinned host buffer of ``max_batch`` images (``host``, and ``array``,
    its numpy view), and the event recorded after the H2D copy that last
    read it."""

    def __init__(self, shape: tuple[int, ...]):
        self.host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        self.array = self.host.numpy()
        self.copied = torch.cuda.Event(blocking=True)


class _SlotRing:
    """Pinned staging slots of one shape in a FIFO free list, the oldest
    handed out first: ``first`` of them at first use, one more whenever the
    list is empty."""

    def __init__(self, shape: tuple[int, ...], first: int):
        self.shape = shape
        self.first = first
        self._free: collections.deque[StagingSlot] = collections.deque()  # guarded-by: _lock
        self._made = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    def lend(self) -> StagingSlot:
        with self._lock:
            if not self._free:
                fresh = 1 if self._made else self.first
                self._free.extend(StagingSlot(self.shape) for _ in range(fresh))
                self._made += fresh
            slot = self._free.popleft()
        slot.copied.synchronize()  # the H2D copy that last read this slot has run
        return slot

    def give_back(self, slot: StagingSlot) -> None:
        with self._lock:
            self._free.append(slot)

    def clear(self) -> None:
        with self._lock:
            self._free.clear()


class StagedBatch(NamedTuple):
    """``n`` images a borrower wrote into rows ``[:n]`` of a lent slot."""

    slot: StagingSlot
    n: int


class _BucketGraph(NamedTuple):
    """One bucket's captured forward: its static input and output, and the
    kernel launches each replay makes (``ops._counts.recording``)."""

    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: dict


# One capture at a time in the process: the buckets of an engine, and the
# engines of a server, are captured one after another; an engine's close
# releases memory under it too, so the release never runs during a capture.
# The model server's /debug/profile holds it for its window, so a profiler
# never starts or stops while a graph is being captured.
capture_lock = threading.Lock()
# Every capture runs on one thread and one stream per device (under
# capture_lock).  cuBLAS keeps a handle per thread and a workspace per
# (handle, stream) for the life of the process: captures from whichever
# thread loads a version (the server's at start, the version watcher's at a
# reload), each on a fresh stream, would leave one more behind every time.
_capture_streams: dict = {}
_capture_thread: ThreadPoolExecutor | None = None


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    stream = _capture_streams.get(device)
    if stream is None:
        stream = _capture_streams[device] = torch.cuda.Stream(device)
    return stream


def _on_capture_thread(fn, *args):
    """``fn(*args)`` on the capture thread (under capture_lock); its
    result, or its exception."""
    global _capture_thread
    if _capture_thread is None:
        _capture_thread = ThreadPoolExecutor(1, thread_name_prefix="kdlt-capture")
    return _capture_thread.submit(fn, *args).result()


class InferenceEngine:
    def __init__(self, artifact: ModelArtifact, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 device: str | torch.device = "cuda", fast: bool | str = "auto",
                 registry: metrics_lib.Registry | None = None,
                 pipeline_depth: int | None = None, ingest_resize: str | None = None):
        """``pipeline_depth`` (None = $KDLT_PIPELINE_DEPTH or 2) sizes the
        per-bucket staging ring: depth + 1 pinned buffers, so a dispatcher
        of that depth never waits for a buffer.  ``ingest_resize``: the
        bytes wire's staging resolution, 'HxW' (None =
        $KDLT_INGEST_DEVICE_RESIZE, off by default; see
        ``predict_ingest_async``)."""
        self.spec = artifact.spec
        # The served artifact's identity (serving.registry.artifact_hash),
        # set when a registry serves this engine.
        self.artifact_hash: str | None = None
        self.buckets = tuple(sorted(buckets))
        self.max_batch = self.buckets[-1]
        self.device = resolve_device(device)
        name = artifact.metadata.get("compute_dtype", "bfloat16")
        if name not in _DTYPES:
            raise ValueError(f"unsupported compute dtype {name!r}")
        self.compute_dtype = _DTYPES[name]
        self._quantization = artifact.metadata.get("quantization") or None
        self._quantization_active = self._quantization
        self.quant_gate_failed = False
        self.quant_gate_drift = self.quant_gate_top1 = None
        self._quant_gate_checked = False
        self._fast_request = fast
        self._fallback = None  # the weight-only forward the gate built
        if self._quantization is not None:
            if self._quantization not in quant_lib.SCHEMES:
                raise ValueError(f"unknown quantization scheme {self._quantization!r}")
            if (self._quantization == quant_lib.SCHEME_W8A8
                    and quant_lib.resolve_scheme_override() == "weight-only"):
                log.warning("%s=weight-only: serving %s without int8 activations",
                            quant_lib.QUANT_SCHEME_ENV, self.spec.name)
                self._quantization_active = quant_lib.SCHEME
        if self._quantization_active == quant_lib.SCHEME_W8A8:
            # One conversion serves both forwards: the w8a8 one now, the
            # weight-only one if the gate downgrades.
            self._params, leaves = weights.from_jax_quantized(artifact.variables)
            self._forward = quant_lib.build_w8a8_forward(
                self.spec, artifact.variables, self.device, converted=(self._params, leaves))
        else:
            self._params = weights.from_jax_variables(
                quant_lib.dequantize_variables_host(artifact.variables)
                if self._quantization else artifact.variables)
            self._forward = self._weight_forward()
        self.fast = self._forward.fast
        self._exact_f32 = None
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: _lock
        # The event after this engine's last dispatch (its D2H copy): once
        # it has completed, the device has finished every replay of it.
        self._last_done: torch.cuda.Event | None = None  # guarded-by: _lock
        self._ready = threading.Event()
        depth = resolve_pipeline_depth(pipeline_depth)
        self._slots = _SlotRing((self.max_batch, *self.spec.input_shape), depth + 1)
        self._graphs: dict[int, _BucketGraph] = {}  # guarded-by: _lock
        # The device-resize staging (off: None, and nothing below exists).
        staging = ingest_device_resize(ingest_resize)
        if staging == tuple(self.spec.input_shape[:2]):
            staging = None  # a no-op resize: the plain forward serves it
        self._ingest_staging = staging
        self._resize = self._staged_slots = None
        self._staged_graphs: dict[int, _BucketGraph] = {}  # guarded-by: _lock
        if staging is not None:
            self._resize = resize_lib.Resize(staging, self.spec.input_shape[:2],
                                             resize_lib.method_for(self.spec.resize_filter),
                                             self.device)
            if self.device.type == "cuda":
                self._staged_slots = _SlotRing((self.max_batch, *self.ingest_source_shape),
                                               depth + 1)
        # One memory pool for all of this engine's bucket graphs.  Safe only
        # because replays never overlap: every replay, and the copy of its
        # output into pinned rows, is enqueued on the one current stream
        # before any later replay.  A second stream would make a shared pool
        # unsafe (two replays could then write the same intermediates).
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        registry = registry or metrics_lib.Registry()
        self.registry = registry
        self._m_infer_latency = registry.histogram(
            "kdlt_engine_infer_seconds",
            "batch latency dispatch->sync (pipelined serving may include "
            "bounded queue-wait/assembly overlap)",
        )
        self._m_images = registry.counter("kdlt_engine_images_total", "images executed")
        self._m_batches = registry.counter("kdlt_engine_batches_total", "batches executed")
        self._m_pad_waste = registry.counter(
            "kdlt_engine_pad_images_total", "padding rows executed (bucket waste)"
        )
        # Live device-time attribution (runtime.flops): the registry carries
        # this engine's model/version labels, so the gauges read
        # kdlt_mfu_pct{model,version,bucket} on /metrics.
        self._mfu = flops_lib.MfuAccountant(
            registry, flops_lib.peak_tflops(self.device, name))
        # Recent (bucket, admitted rows) per batch, for bucket_audit.
        # deque.append is atomic; readers snapshot with list().
        self._bucket_history: collections.deque[tuple[int, int]] = collections.deque(
            maxlen=2048)
        # The ACTIVE scheme's gauge is 1 (post-gate, post-override).
        self._m_quant = metrics_lib.quant_metrics(registry)
        self._refresh_scheme_gauge()

    def _weight_forward(self):
        """The float forward over ``self._params`` in the compute dtype (the
        fused path where it resolves): unquantized and weight-only serving,
        and the w8a8 gate's reference and fallback."""
        return build_forward(self.spec, self._params, self.compute_dtype, self._fast_request,
                             self.device)

    def _refresh_scheme_gauge(self) -> None:
        active = self._quantization_active or "float32"
        for scheme, gauge in self._m_quant["scheme"].items():
            gauge.set(1.0 if scheme == active else 0.0)

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    @property
    def quantization(self) -> str | None:
        """The artifact's requested quantization scheme tag (or None)."""
        return self._quantization

    @property
    def quantization_active(self) -> str | None:
        """The scheme actually serving: the requested one unless the warmup
        tolerance gate or $KDLT_QUANT_SCHEME downgraded int8-w8a8 to
        weight-only."""
        return self._quantization_active

    def sharding_info(self) -> dict:
        """The status page's sharding keys: one device, the JAX package's
        "single" scheme."""
        return {"sharding": "single", "model_parallel": 1, "mesh_shape": None}

    @property
    def lends_staging(self) -> bool:
        """Whether ``lend_staging`` has pinned slots to lend (on the card)."""
        return self.device.type == "cuda"

    def warmup(self) -> float:
        """Run every bucket once, in turn (on the card: building the kernels,
        capturing the bucket's graph and replaying it), count the FLOPs per
        image for the MFU gauges (unless ``KDLT_MFU=0``); gate readiness.  A
        w8a8 engine runs the tolerance gate after its buckets, and on a
        failure re-warms every bucket on the weight-only forward first."""
        t0 = time.perf_counter()
        while True:
            for b in self.buckets:
                np.asarray(self.predict_async(np.zeros((b, *self.spec.input_shape), np.uint8))[0])
            if self._quant_gate_pending() and not self._run_quant_gate():
                self._downgrade_w8a8()
                continue
            break
        if self._ingest_staging is not None:
            for b in self.buckets:
                np.asarray(self.predict_ingest_async(
                    np.zeros((b, *self.ingest_source_shape), np.uint8))[0])
        if flops_lib.mfu_enabled():
            self._mfu.set_flops_per_image(flops_lib.flops_per_image(self.spec))
        dt = time.perf_counter() - t0
        self._ready.set()
        return dt

    # --- w8a8 tolerance gate ----------------------------------------------

    def _quant_gate_pending(self) -> bool:
        return (self._quantization_active == quant_lib.SCHEME_W8A8
                and not self._quant_gate_checked)

    def _run_quant_gate(self) -> bool:
        """The w8a8 forward's logits on a seeded uint8 batch (the bucket for
        min(8, max_batch), replayed from its graph on the card) against the
        weight-only forward, the program the fallback would serve.  Passes
        iff top-1 agreement >= GATE_TOP1 and the relative max-abs drift <=
        $KDLT_QUANT_TOL."""
        self._quant_gate_checked = True
        tol = quant_lib.resolve_quant_tol()
        b = self.bucket_for(min(8, self.max_batch))
        x = np.random.default_rng(0).integers(0, 256, size=(b, *self.spec.input_shape),
                                              dtype=np.uint8)
        got = np.asarray(self.predict_async(x)[0])[:b]
        self._fallback = self._weight_forward()
        with torch.inference_mode():
            ref = self._fallback(torch.from_numpy(x).to(self.device)).float().cpu().numpy()
        drift = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))
        top1 = float((got.argmax(-1) == ref.argmax(-1)).mean())
        ok = drift <= tol and top1 >= quant_lib.GATE_TOP1
        if ok:
            self._fallback = None
            log.info("w8a8 tolerance gate PASSED for %s: top-1 agreement %.4f (>= %.2f), "
                     "relative max-abs logit drift %.4f (<= %s=%.3g) over a %d-image golden "
                     "batch; serving int8 activations", self.spec.name, top1,
                     quant_lib.GATE_TOP1, drift, quant_lib.QUANT_TOL_ENV, tol, b)
        else:
            log.error("w8a8 tolerance gate FAILED for %s: top-1 agreement %.4f (need >= %.2f), "
                      "relative max-abs logit drift %.4f (need <= %s=%.3g) over a %d-image "
                      "golden batch; REFUSING int8 activations and serving weight-only -- "
                      "re-calibrate the artifact (kdlt-torch-quantize --scheme int8-w8a8)",
                      self.spec.name, top1, quant_lib.GATE_TOP1, drift,
                      quant_lib.QUANT_TOL_ENV, tol, b)
        self.quant_gate_drift = drift
        self.quant_gate_top1 = top1
        return ok

    def _downgrade_w8a8(self) -> None:
        """After a gate failure: serve weight-only (the gate's reference
        forward, the fused path again where it resolves).  The w8a8 bucket
        graphs are freed as ``close()`` frees them (after the last dispatch's
        event, under the capture lock); warmup re-captures the buckets on the
        capture thread."""
        self.quant_gate_failed = True
        self._quantization_active = quant_lib.SCHEME
        self._m_quant["gate_failures"].inc()
        self._refresh_scheme_gauge()
        with self._lock:
            last, self._last_done = self._last_done, None
            if last is not None:
                last.synchronize()
            with capture_lock:
                self._graphs.clear()
                self._staged_graphs.clear()
                self._forward, self._fallback = self._fallback, None
                self.fast = self._forward.fast
                if self.device.type == "cuda":
                    self._pool = torch.cuda.graph_pool_handle()
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()

    def bucket_audit(self) -> dict:
        """Per-bucket padding waste over the recent batches, with the FLOPs
        per image (``/debug/profile?audit=buckets``): a high
        ``padding_waste_ratio`` means the bucket ladder, not the program, is
        burning the flops."""
        hist = list(self._bucket_history)
        flops = flops_lib.flops_per_image(self.spec)  # counted at warmup, cached
        out: dict = {"window": len(hist), "buckets": {}}
        for b in self.buckets:
            admitted = [n for bucket, n in hist if bucket == b]
            total = sum(admitted)
            out["buckets"][int(b)] = {
                "batches": len(admitted),
                "mean_admitted": (total / len(admitted)) if admitted else None,
                "padding_waste_ratio": 1.0 - total / (len(admitted) * b) if admitted else None,
                "flops_per_image": flops,
            }
        return out

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch {n} exceeds max bucket {self.max_batch}")

    def _checked(self, images, dtype) -> np.ndarray:
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[1:] != tuple(self.spec.input_shape):
            raise ValueError(f"expected (N, {self.spec.input_shape}), got {images.shape}")
        if images.dtype != dtype:
            raise ValueError(f"expected {np.dtype(dtype).name} images, got {images.dtype}")
        return images

    def _padded(self, images: np.ndarray) -> torch.Tensor:
        """The batch padded to its bucket, from pageable host memory: the
        CPU path and the exact float32 graph's."""
        n = images.shape[0]
        bucket = self.bucket_for(n)
        if bucket != n:
            pad = np.zeros((bucket - n, *images.shape[1:]), images.dtype)
            images = np.concatenate([images, pad], axis=0)
        # Wire arrays are read-only views of the request body; torch wants a
        # writable buffer, so np.require copies those (and only those).
        return torch.from_numpy(np.require(images, requirements=["C", "W"])).to(self.device)

    def lend_staging(self) -> StagingSlot:
        """The oldest free pinned slot of ``max_batch`` rows, owned by the
        caller until ``return_staging``: it may write rows ``[:n]`` and
        dispatch them as ``StagedBatch(slot, n)``.  Waits, if need be, for the
        H2D copy that last read the slot (on the card only)."""
        if not self.lends_staging:
            raise RuntimeError("staging slots are pinned memory for the card")
        return self._slots.lend()

    def return_staging(self, slot: StagingSlot) -> None:
        """Hand a lent slot back, once any dispatch of it has been enqueued."""
        self._slots.give_back(slot)

    def _graph(self, bucket: int, staged: bool = False) -> _BucketGraph:
        """The bucket's captured forward (``staged``: its staged program),
        captured on first use (under ``_lock``)."""
        graphs = self._staged_graphs if staged else self._graphs
        g = graphs.get(bucket)
        if g is None:
            with capture_lock:
                g = graphs[bucket] = _on_capture_thread(self._capture, bucket, staged)
        return g

    def _capture(self, bucket: int, staged: bool) -> _BucketGraph:
        """The bucket's forward captured, on the capture thread (the caller's
        inference mode and device do not carry over to it)."""
        with torch.inference_mode(), torch.cuda.device(self.device):
            return self._capture_on(bucket, staged)

    def _capture_on(self, bucket: int, staged: bool = False) -> _BucketGraph:
        shape = self.ingest_source_shape if staged else self.spec.input_shape
        forward = self._staged_forward if staged else self._forward
        static_in = torch.zeros((bucket, *shape), dtype=torch.uint8, device=self.device)
        current = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            forward(static_in)  # builds the kernels, warms cuDNN and cuBLAS
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: CUDA calls of other threads (another engine serving)
        # neither break this capture nor are captured into it.
        with _counts.recording() as launches, torch.cuda.graph(
                graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
            static_out = forward(static_in)
        return _BucketGraph(graph, static_in, static_out, launches)

    def graph_memory_bytes(self) -> int:
        """Device memory reserved for this engine's bucket graphs: the
        segments of their shared pool (0 before any capture)."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))

    def _replay(self, slot: StagingSlot, n: int, staged: bool = False) -> DeviceLogits:
        """Rows ``[:n]`` of a staging slot through the bucket's graph (its
        staged program's when ``staged``): the pad rows zeroed, the H2D copy
        into the static input, the replay and the D2H copy, enqueued without
        waiting (under ``_lock``)."""
        g = self._graph(self.bucket_for(n), staged)
        bucket = g.static_in.shape[0]
        slot.array[n:bucket] = 0
        g.static_in.copy_(slot.host[:bucket], non_blocking=True)
        stream = torch.cuda.current_stream(self.device)
        slot.copied.record(stream)
        # The batch's device time runs from here to the handle's event: the
        # stream runs in order, so a batch still executing ahead of this one
        # is not in it.
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        g.graph.replay()
        _counts.credit(g.launches)
        return self._handle(g.static_out, start)

    def _handle(self, logits: torch.Tensor, start: torch.cuda.Event | None = None
                ) -> DeviceLogits:
        """On the card: the D2H copy into pinned memory, enqueued behind the
        forward, and the event after it (a timing event when ``start`` is
        given)."""
        if self.device.type != "cuda":
            return DeviceLogits(logits)
        rows = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
        rows.copy_(logits, non_blocking=True)
        # A blocking event: the waiting thread sleeps instead of spinning
        # on a host core the HTTP threads need (``chip_smoke.py`` measures
        # the host CPU time of both waits).
        done = torch.cuda.Event(blocking=True, enable_timing=start is not None)
        done.record(torch.cuda.current_stream(self.device))
        self._last_done = done
        return DeviceLogits(rows, done, start)

    def predict_async(self, images: np.ndarray | StagedBatch) -> tuple[DeviceLogits, int]:
        """Dispatch a uint8 batch without waiting; returns (handle, n).
        ``np.asarray(handle)[:n]`` materializes the logits.  The images are
        copied before this returns, so the caller may reuse its array (or
        hand back its lent slot)."""
        if isinstance(images, StagedBatch):
            if not 1 <= images.n <= self.max_batch:
                raise ValueError(f"a staged batch holds 1..{self.max_batch} images, "
                                 f"got {images.n}")
            with self._lock, torch.inference_mode():
                self._check_open()
                return self._replay(images.slot, images.n), images.n
        images = self._checked(images, np.uint8)
        n = images.shape[0]
        with self._lock, torch.inference_mode():
            self._check_open()
            if self.device.type != "cuda":
                return self._handle(self._forward(self._padded(images))), n
            self.bucket_for(n)  # a batch past the largest bucket fails before staging
            slot = self.lend_staging()
            try:
                slot.array[:n] = images
                return self._replay(slot, n), n
            finally:
                self.return_staging(slot)

    @property
    def ingest_source_shape(self) -> tuple[int, int, int]:
        """Per-image (H, W, C) the bytes wire's decode stage must produce:
        ``spec.input_shape``, or the staging resolution when
        $KDLT_INGEST_DEVICE_RESIZE (or ``ingest_resize``) sets one."""
        if self._ingest_staging is None:
            return tuple(self.spec.input_shape)
        return (*self._ingest_staging, self.spec.input_shape[2])

    def _staged_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The staged program: a uint8 batch at the staging resolution ->
        float32, resized to ``spec.input_shape`` (``ops.resize``, the JAX
        engine's ``jax.image.resize``), rounded half to even, clipped to
        0..255, uint8 -> the engine's own forward."""
        return self._forward(resize_lib.resize_to_uint8(self._resize, x))

    def predict_ingest_async(self, images: np.ndarray) -> tuple[DeviceLogits, int]:
        """The bytes wire's dispatch: a uint8 batch at ``ingest_source_shape``.

        Without staging this is ``predict_async``: the decode stage already
        resized to ``spec.input_shape`` on the host, bit-exact with the
        tensor wire.  With $KDLT_INGEST_DEVICE_RESIZE=HxW the batch is at
        HxW and the staged program resizes it on the device ahead of the
        forward (approximate numerics; an opt-in).  On the card every
        bucket's staged program is a CUDA graph of its own, captured as the
        plain buckets' are, fed from pinned slots at the staging shape.  The
        same handle and aliasing contract as ``predict_async``: the images
        are copied before this returns."""
        if self._ingest_staging is None:
            return self.predict_async(images)
        src = self.ingest_source_shape
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[1:] != src:
            raise ValueError(f"expected (N, {src}), got {images.shape}")
        if images.dtype != np.uint8:
            raise ValueError(f"predict_ingest_async takes uint8 images, got {images.dtype}")
        n = images.shape[0]
        with self._lock, torch.inference_mode():
            self._check_open()
            if self.device.type != "cuda":
                return self._handle(self._staged_forward(self._padded(images))), n
            self.bucket_for(n)  # a batch past the largest bucket fails before staging
            slot = self._staged_slots.lend()
            try:
                slot.array[:n] = images
                return self._replay(slot, n, staged=True), n
            finally:
                self._staged_slots.give_back(slot)

    def _check_open(self) -> None:
        if self._closed:
            raise EngineClosed(f"the engine of {self.spec.name!r} is closed")

    def close(self) -> None:
        """Give this engine's device memory back (an unloaded version).

        The caller has made sure no dispatch of this engine is still to
        come.  Then: wait for the event of its last dispatch (replaying or
        reading a graph whose pool was freed would be a use after free),
        drop the bucket graphs, their pool, the staging slots and the
        parameters, and release the cached blocks -- under the capture lock,
        so the release never runs while another engine captures.  Later
        predicts raise EngineClosed.  Idempotent.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            last, self._last_done = self._last_done, None
        if last is not None:
            last.synchronize()
        with capture_lock:
            # No predict passes _check_open any more: nothing else reads these.
            self._graphs.clear()
            self._staged_graphs.clear()
            self._pool = None
            self._params = self._forward = self._exact_f32 = self._fallback = None
            self._resize = None
            self._slots.clear()
            if self._staged_slots is not None:
                self._staged_slots.clear()
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def record_completed(self, n: int, seconds: float, device_s: float | None = None) -> None:
        """Account a successfully synced batch (counters, latency, MFU).

        predict() accounts its own synchronous path; the dispatcher reports
        its batches here after materialization succeeds, so failed batches
        never inflate the success counters.  ``seconds`` is dispatch->sync,
        which under pipelining can include bounded queue-wait/assembly
        overlap (see the histogram help); ``device_s``, the batch's device
        time (the handle's), feeds the MFU and busy gauges in its place.
        """
        self._m_infer_latency.observe(seconds)
        self._m_images.inc(n)
        self._m_batches.inc()
        bucket = self.bucket_for(n)
        self._m_pad_waste.inc(bucket - n)
        self._mfu.observe(bucket, n, seconds if device_s is None else device_s)
        self._bucket_history.append((bucket, n))

    def _exact_forward(self):
        with self._lock:
            self._check_open()
            if self._exact_f32 is None:
                self._exact_f32 = build_forward(
                    self.spec, self._params, torch.float32, False, self.device
                )
            return self._exact_f32

    def predict(self, images: np.ndarray | StagedBatch) -> np.ndarray:
        """uint8 or normalized float32 (N,H,W,C) -> float32 logits (N, classes)."""
        if not isinstance(images, StagedBatch):
            images = np.asarray(images)
        if isinstance(images, StagedBatch) or images.dtype == np.uint8:
            t0 = time.perf_counter()
            handle, n = self.predict_async(images)
            out = np.asarray(handle)[:n]
            self.record_completed(n, time.perf_counter() - t0, handle.device_seconds)
            return out
        if images.dtype != np.float32:
            raise ValueError(
                f"dtype {images.dtype} unsupported: send uint8 pixels or "
                "float32 pre-normalized data"
            )
        images = self._checked(images, np.float32)
        fn = self._exact_forward()
        n = images.shape[0]
        with self._lock, torch.inference_mode():
            handle = self._handle(fn(self._padded(images)))
        out = np.asarray(handle)[:n]
        # No latency sample here: the debug path's lazy first build would
        # land an outlier in the serving histogram.
        self._m_images.inc(n)
        self._m_batches.inc()
        self._m_pad_waste.inc(self.bucket_for(n) - n)
        return out

    def predict_scores(self, images: np.ndarray) -> list[dict[str, float]]:
        """Labelled score dicts, the reference's response shape."""
        logits = self.predict(images)
        return [dict(zip(self.spec.labels, map(float, row))) for row in logits]
