"""Autoregressive decode: paged KV-cache + continuous batching.

The port of the JAX package's ``runtime/decode.py``: the generative lane's
device half, with the same two design commitments.

- **Continuous batching** (Orca, OSDI '22): requests join and leave the
  device batch at *token* boundaries.  The step program runs at one fixed
  width (``max_slots``); a per-step scheduler slot-fills freed decode slots
  from the admission queue instead of waiting for the whole batch to
  drain.  Membership changes are an active-mask flip plus a prefill --
  never a new program.
- **Paged KV-cache** (vLLM, SOSP '23): the cache is a pool of fixed-size
  pages; each slot owns a page list (the page table), allocated at
  admission and returned at retirement.  Page 0 is the trash page:
  inactive slots and prompt padding write there, so the batched scatter
  needs no branch.

The model is the JAX package's tiny byte-level causal transformer, its
arithmetic done in float32 as JAX does it (``decode_logits``,
``prefill_logits``): the same cache layout ``[L, 2, P, page, H, Dh]``, the
same ``where(mask, scores, -1e9)`` before the max (a masked position's
softmax weight is exactly 0, so garbage in a masked position, or in the
trash page, never reaches a result), greedy argmax.  Its weights are
port-seeded: a ``torch.Generator`` seeded from the model name as JAX seeds
its PRNG (``zlib.crc32(model) & 0x7FFFFFFF``) draws normals at JAX's
scales.  ``weights.from_jax_decode_params`` carries JAX's own tree across
instead (the CPU tests hold the two packages' programs against each other
on it).

On the card every program is a CUDA graph: one per prefill bucket and one
for the step at width S, captured on the image engine's capture thread and
stream under ``runtime.engine.capture_lock`` (one thread, one stream: a
cuBLAS workspace is not left behind per capturing thread).  They are the
counterparts of JAX's ``jax.jit(..., donate_argnums=(1,))``: every graph
writes in place into the ONE cache tensor all of them captured, and reads
its inputs from a static device tensor that each dispatch fills by one
copy from pinned host memory (page table, lengths, last tokens and active
mask packed in one int64 row per slot).  No host sync sits inside a graph.
On the CPU the same functions run eager (the tests); nothing falls back
from one to the other, and a missing card raises.

Bit-exactness across batch composition is the load-bearing property: one
slot's computation reads only its own page list, its own length and its
own last token, masked positions weigh exactly 0, no reduction runs across
slots, and the SAME graph serves every batch composition, solo included.
So a request's tokens decoded in a shifting continuous batch are
bit-identical to the same request decoded alone (``decode_solo``).
"""

from __future__ import annotations

import gc
import math
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import NamedTuple

import numpy as np
import torch

from kubernetes_deep_learning_tpu_torch.models import resolve_device
from kubernetes_deep_learning_tpu_torch.runtime.engine import (
    DeviceLogits,
    _capture_stream,
    _on_capture_thread,
    capture_lock,
)
from kubernetes_deep_learning_tpu_torch.runtime.errors import QueueFull
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.admission.deadline import Deadline
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib
from kubernetes_deep_learning_tpu_torch.utils import trace as trace_lib

# Byte-level vocabulary: 256 raw bytes + BOS + EOS.  No tokenizer on the
# wire: prompts travel as text and are encoded here.
BOS_TOKEN = 256
EOS_TOKEN = 257
VOCAB_SIZE = 258

# Decode-lane knobs.  Slots is the fixed device batch width (one step
# graph); page size and max pages bound one sequence's context at
# page_size * max_pages_per_seq tokens.
SLOTS_ENV = "KDLT_DECODE_SLOTS"
PAGE_SIZE_ENV = "KDLT_DECODE_PAGE_SIZE"
MAX_PAGES_ENV = "KDLT_DECODE_MAX_PAGES"
QUEUE_CAP_ENV = "KDLT_DECODE_QUEUE_CAP"

DEFAULT_SLOTS = 4
DEFAULT_PAGE_SIZE = 16
DEFAULT_MAX_PAGES = 8
DEFAULT_QUEUE_CAP = 64

# The prefill ladder (prompt positions INCLUDING the BOS token, like the
# image engine's batch buckets): one program per bucket, prompts pad up to
# the next rung.
PROMPT_BUCKETS = (16, 32, 64)

# Learned positions up to the hard context cap (JAX's table).
POSITIONS = 4096


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw.strip() else default
    except ValueError:
        return default


def encode_prompt(prompt: str) -> list[int]:
    """Text -> [BOS, *bytes].  Byte-level: any unicode string encodes."""
    return [BOS_TOKEN, *prompt.encode("utf-8")]


def decode_tokens(tokens: list[int]) -> str:
    """Emitted token ids -> text (EOS and any non-byte ids drop out)."""
    return bytes(t for t in tokens if 0 <= t < 256).decode("utf-8", errors="replace")


def prompt_bucket(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n (the prefill program the prompt pads into)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens exceeds the largest prefill bucket {buckets[-1]}")


# --- the model: plain functions on tensors, JAX's arithmetic in f32 ---------


def build_params(seed: int, d_model: int, n_layers: int) -> dict:
    """Port-seeded toy-LM weights: normals at JAX's scales, in JAX's order,
    from a CPU ``torch.Generator`` (the same seed gives the same weights on
    any device)."""
    gen = torch.Generator().manual_seed(seed)

    def mat(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * scale

    params = {
        "embed": mat((VOCAB_SIZE, d_model), 0.05),
        "pos": mat((POSITIONS, d_model), 0.02),
        "ln_f": torch.ones(d_model),
        "layers": [],
    }
    for _ in range(n_layers):
        params["layers"].append({
            "ln1": torch.ones(d_model),
            "wqkv": mat((d_model, 3 * d_model), 1.0 / math.sqrt(d_model)),
            "wo": mat((d_model, d_model), 1.0 / math.sqrt(d_model)),
            "ln2": torch.ones(d_model),
            "w1": mat((d_model, 4 * d_model), 1.0 / math.sqrt(d_model)),
            "w2": mat((4 * d_model, d_model), 0.5 / math.sqrt(d_model)),
        })
    return params


def _rms(x, scale):
    return x * scale / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)


def _qkv(layer, x, n_heads: int):
    d = x.shape[-1]
    q, k, v = torch.split(_rms(x, layer["ln1"]) @ layer["wqkv"], d, dim=-1)
    shape = (*x.shape[:-1], n_heads, d // n_heads)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _mlp(layer, x):
    return torch.relu(_rms(x, layer["ln2"]) @ layer["w1"]) @ layer["w2"]


def _logits(params, x):
    return _rms(x, params["ln_f"]) @ params["embed"].T


def _softmax_masked(scores, mask):
    """JAX's masked softmax: the mask applied with ``where`` BEFORE the max,
    so a masked position weighs exactly 0 (never ``inf - inf``)."""
    scores = torch.where(mask, scores, -1e9)
    w = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return w / w.sum(dim=-1, keepdim=True)


def decode_logits(params, cache, page_table, lengths, last_tokens, active):
    """One batched decode step at fixed width S; returns the logits [S, V].

    ``cache``       [L, 2, P, page, H, Dh] f32, written in place
    ``page_table``  [S, max_pages] int64   (page 0 = trash)
    ``lengths``     [S] int64              tokens already written
    ``last_tokens`` [S] int64              the token each slot consumes
    ``active``      [S] bool

    Writes each active slot's K/V at logical position ``lengths[s]`` and
    attends over positions 0..lengths[s] inclusive.  No reduction across
    slots anywhere in here.
    """
    page = cache.shape[3]
    n_heads, head_dim = cache.shape[4], cache.shape[5]
    s_slots, max_pages = page_table.shape
    ctx = max_pages * page
    x = params["embed"][last_tokens] + params["pos"][lengths]           # [S, D]
    write_page = page_table.gather(1, (lengths // page)[:, None])[:, 0]
    write_page = torch.where(active, write_page, 0)                      # trash
    write_off = lengths % page
    pos_ids = torch.arange(ctx, device=lengths.device)
    att_mask = (pos_ids[None, :] <= lengths[:, None])[:, None, :]        # [S, 1, ctx]
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, n_heads)                                # [S, H, Dh]
        cache[li, 0][write_page, write_off] = k
        cache[li, 1][write_page, write_off] = v
        k_ctx = cache[li, 0][page_table].reshape(s_slots, ctx, n_heads, head_dim)
        v_ctx = cache[li, 1][page_table].reshape(s_slots, ctx, n_heads, head_dim)
        scores = torch.einsum("shd,sthd->sht", q, k_ctx) / math.sqrt(head_dim)
        w = _softmax_masked(scores, att_mask)
        attn = torch.einsum("sht,sthd->shd", w, v_ctx).reshape(s_slots, -1)
        x = x + attn @ layer["wo"]
        x = x + _mlp(layer, x)
    return _logits(params, x)


def prefill_logits(params, cache, tokens, length, page_ids):
    """One prompt's prefill at one bucket shape T = len(tokens); returns the
    last true position's logits [V].

    ``tokens``   [T] int64 (BOS + prompt bytes, padded to the bucket)
    ``length``   0-d int64 (true token count)
    ``page_ids`` [max_pages] int64, this slot's page list

    Full causal self-attention within the prompt (never reads the cache);
    K/V written to the slot's pages, padding positions to the trash page.
    """
    page, n_heads = cache.shape[3], cache.shape[4]
    t_len = tokens.shape[0]
    pos = torch.arange(t_len, device=tokens.device)
    x = params["embed"][tokens] + params["pos"][pos]                    # [T, D]
    real = pos < length
    write_page = torch.where(real, page_ids[pos // page], 0)
    write_off = pos % page
    causal = ((pos[None, :] <= pos[:, None]) & real[None, :])[None]      # [1, T, T]
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, n_heads)                                # [T, H, Dh]
        cache[li, 0][write_page, write_off] = k
        cache[li, 1][write_page, write_off] = v
        scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
        w = _softmax_masked(scores, causal)
        attn = torch.einsum("hqk,khd->qhd", w, v).reshape(t_len, -1)
        x = x + attn @ layer["wo"]
        x = x + _mlp(layer, x)
    return _logits(params, x.index_select(0, (length - 1).reshape(1)))[0]


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


# --- the engine -------------------------------------------------------------


class _DecodeGraph(NamedTuple):
    """One captured program: its static packed input and its token output."""

    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor


STEP = "step"  # the step program's key beside the prefill buckets


class DecodeEngine:
    """The decode lane's device state: weights, paged cache, slot tables.

    The DecodeScheduler's loop thread is the one caller in serving; a lock
    keeps the slot tables and the graphs' static inputs consistent should
    another thread (a warmup, a test) dispatch too.

    ``step_async`` only dispatches: it enqueues the step and returns the
    unmaterialized token handle.  The ONE host sync an iteration is
    ``materialize()`` (a CUDA event recorded after the tokens' copy into
    pinned memory, as the image engine's handle waits).
    """

    def __init__(
        self,
        model: str = "gen-default",
        *,
        max_slots: int | None = None,
        page_size: int | None = None,
        max_pages_per_seq: int | None = None,
        d_model: int = 32,
        n_layers: int = 2,
        n_heads: int = 2,
        prompt_buckets: tuple[int, ...] | None = None,
        seed: int | None = None,
        params: dict | None = None,
        device: str | torch.device = "cuda",
    ):
        """``params``: a parameter tree (``weights.from_jax_decode_params``)
        in place of the port-seeded one; it sets ``d_model`` and
        ``n_layers``."""
        self.device = resolve_device(device)
        self.model = model
        self.max_slots = max_slots or _env_int(SLOTS_ENV, DEFAULT_SLOTS)
        self.page_size = page_size or _env_int(PAGE_SIZE_ENV, DEFAULT_PAGE_SIZE)
        self.max_pages_per_seq = max_pages_per_seq or _env_int(MAX_PAGES_ENV, DEFAULT_MAX_PAGES)
        self.max_context = self.page_size * self.max_pages_per_seq
        self.prompt_buckets = tuple(sorted(
            b for b in (prompt_buckets or PROMPT_BUCKETS) if b <= self.max_context))
        if not self.prompt_buckets:
            raise ValueError(f"no prefill bucket fits inside the {self.max_context}-token context")
        if params is not None:
            d_model, n_layers = params["embed"].shape[1], len(params["layers"])
        if d_model % n_heads:
            raise ValueError("d_model must divide into n_heads")
        self.d_model, self.n_layers, self.n_heads = d_model, n_layers, n_heads
        self._seed = seed if seed is not None else zlib.crc32(model.encode()) & 0x7FFFFFFF
        if params is None:
            params = build_params(self._seed, d_model, n_layers)
        self._params = _to_device(params, self.device)

        # Page pool: page 0 is the trash page, never allocated.
        self.num_pages = 1 + self.max_slots * self.max_pages_per_seq
        self._cache = torch.zeros(
            (n_layers, 2, self.num_pages, self.page_size, n_heads, d_model // n_heads),
            dtype=torch.float32, device=self.device)
        self._free_pages = list(range(self.num_pages - 1, 0, -1))
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._slot_pages: dict[int, list[int]] = {}

        # Host-side slot tables, packed into one device copy per dispatch
        # (tiny [S]-shaped ints; the cache itself never leaves the device).
        self.page_table = np.zeros((self.max_slots, self.max_pages_per_seq), np.int32)
        self.lengths = np.zeros((self.max_slots,), np.int32)
        self.last_tokens = np.zeros((self.max_slots,), np.int32)
        self.active = np.zeros((self.max_slots,), bool)

        self._lock = threading.RLock()
        self._closed = False
        self._graphs: dict = {}  # STEP or a prefill bucket -> _DecodeGraph
        # One pool for every graph: their replays never overlap (one stream).
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None

    @property
    def params(self) -> dict:
        return self._params

    @property
    def cache(self) -> torch.Tensor:
        return self._cache

    @property
    def graphs_captured(self) -> int:
        return len(self._graphs)

    # --- slot/page bookkeeping (host-side) ---------------------------------

    def pages_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.page_size)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free_pages)

    @property
    def active_slots(self) -> int:
        return int(self.active.sum())

    def has_capacity(self, total_tokens: int) -> bool:
        return bool(self._free_slots) and self.pages_needed(total_tokens) <= len(self._free_pages)

    def acquire_slot(self, total_tokens: int) -> int | None:
        """Claim a slot + its page list for a generation of at most
        ``total_tokens`` positions; None when slots or pages are short."""
        n = self.pages_needed(total_tokens)
        if total_tokens > self.max_context:
            raise ValueError(f"{total_tokens} tokens exceed the {self.max_context}-token "
                             "context (page_size * max_pages_per_seq)")
        with self._lock:
            if not self._free_slots or n > len(self._free_pages):
                return None
            slot = self._free_slots.pop()
            pages = [self._free_pages.pop() for _ in range(n)]
            self._slot_pages[slot] = pages
            self.page_table[slot] = 0
            self.page_table[slot, :len(pages)] = pages
            self.lengths[slot] = 0
            self.last_tokens[slot] = 0
            self.active[slot] = False  # flips on at prefill
            return slot

    def release_slot(self, slot: int) -> None:
        with self._lock:
            self.active[slot] = False
            self.lengths[slot] = 0
            self.page_table[slot] = 0
            self._free_pages.extend(reversed(self._slot_pages.pop(slot, [])))
            self._free_slots.append(slot)

    # --- device dispatch ----------------------------------------------------

    def logits(self, key, packed: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
        """The step's (``key == STEP``) or a prefill bucket's logits on a
        packed int64 input (``step_inputs``, ``prefill_inputs``), eager,
        against ``cache`` (written in place): each program's tokens are
        their greedy argmax."""
        if key == STEP:
            mp = self.max_pages_per_seq
            return decode_logits(self._params, cache, packed[:, :mp], packed[:, mp],
                                 packed[:, mp + 1], packed[:, mp + 2] != 0)
        return prefill_logits(self._params, cache, packed[:key], packed[key], packed[key + 1:])

    def _program(self, key, packed: torch.Tensor) -> torch.Tensor:
        """What a dispatch runs (and a graph captures): the greedy tokens."""
        return _greedy(self.logits(key, packed, self._cache))

    def _dispatch(self, key, packed: np.ndarray) -> DeviceLogits:
        """Enqueue one program on the packed host input; on the card: one
        H2D copy into the graph's static input, the replay, the tokens' D2H
        copy into pinned memory and the event after it.  Under ``_lock``."""
        if self._closed:
            raise RuntimeError("the decode engine is closed")
        host = torch.from_numpy(packed)
        with torch.no_grad():
            if self.device.type != "cuda":
                return DeviceLogits(self._program(key, host))
            g = self._graph(key)
            g.static_in.copy_(host.pin_memory(), non_blocking=True)
            g.graph.replay()
            out = torch.empty(g.static_out.shape, dtype=g.static_out.dtype, pin_memory=True)
            out.copy_(g.static_out, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record(torch.cuda.current_stream(self.device))
            return DeviceLogits(out, done)

    def _graph(self, key) -> _DecodeGraph:
        """The program's graph, captured on first use on the capture thread."""
        g = self._graphs.get(key)
        if g is None:
            with capture_lock:
                g = self._graphs[key] = _on_capture_thread(self._capture, key)
        return g

    def _capture(self, key) -> _DecodeGraph:
        """Capture one program over a fresh static input: an eager run on
        the capture stream first (kernels, cuBLAS), then the capture.  The
        static input's placeholder writes the trash page only (every slot
        inactive; a one-token prompt on page list 0)."""
        with torch.no_grad(), torch.cuda.device(self.device):
            if key == STEP:
                shape = (self.max_slots, self.max_pages_per_seq + 3)
            else:
                shape = (key + 1 + self.max_pages_per_seq,)
            static_in = torch.zeros(shape, dtype=torch.int64, device=self.device)
            if key != STEP:
                static_in[key] = 1
            current = torch.cuda.current_stream(self.device)
            side = _capture_stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self._program(key, static_in)
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                static_out = self._program(key, static_in)
            return _DecodeGraph(graph, static_in, static_out)

    def prefill_inputs(self, slot: int, prompt_tokens: list[int]) -> tuple[int, np.ndarray]:
        """(the prompt's bucket, its prefill's packed input): the tokens
        padded to the bucket | the true length | the slot's page list."""
        n = len(prompt_tokens)
        bucket = prompt_bucket(n, self.prompt_buckets)
        packed = np.zeros((bucket + 1 + self.max_pages_per_seq,), np.int64)
        packed[:n] = prompt_tokens
        packed[bucket] = n
        packed[bucket + 1:] = self.page_table[slot]
        return bucket, packed

    def prefill(self, slot: int, prompt_tokens: list[int]):
        """Dispatch one prompt's prefill into ``slot``; returns the
        unmaterialized first-token handle.  The slot is live afterwards:
        its length covers the prompt and the next step consumes the first
        token (once materialized and stored via ``seed_token``)."""
        with self._lock:
            handle = self._dispatch(*self.prefill_inputs(slot, prompt_tokens))
            self.lengths[slot] = len(prompt_tokens)
            self.active[slot] = True
            return handle

    def seed_token(self, slot: int, token: int) -> None:
        """Store the token the next step consumes for ``slot``."""
        self.last_tokens[slot] = token

    def step_inputs(self) -> np.ndarray:
        """The step's packed input: page table | length | last token |
        active, one int64 row per slot."""
        return np.concatenate([self.page_table, self.lengths[:, None], self.last_tokens[:, None],
                               self.active[:, None]], axis=1).astype(np.int64)

    def step_async(self):
        """Dispatch one batched decode step; returns the unmaterialized
        next-token handle.  No host sync in here."""
        with self._lock:
            handle = self._dispatch(STEP, self.step_inputs())
            self.lengths = self.lengths + self.active.astype(np.int32)
            return handle

    def materialize(self, handle) -> np.ndarray:
        """The per-iteration host sync: handle -> host int32 array."""
        return np.asarray(handle)

    # --- reference, warmup, close -------------------------------------------

    def decode_solo(self, prompt: str, max_new_tokens: int) -> list[int]:
        """The bit-exactness reference: decode one request alone through
        the SAME programs.  Requires an idle engine."""
        if self.active.any() or self._slot_pages:
            raise RuntimeError("decode_solo requires an idle engine")
        tokens = encode_prompt(prompt)
        slot = self.acquire_slot(len(tokens) + max_new_tokens)
        if slot is None:
            raise RuntimeError("no capacity for a solo decode")
        try:
            out: list[int] = []
            tok = int(self.materialize(self.prefill(slot, tokens)))
            out.append(tok)
            while tok != EOS_TOKEN and len(out) < max_new_tokens:
                self.seed_token(slot, tok)
                tok = int(self.materialize(self.step_async())[slot])
                out.append(tok)
            return out
        finally:
            self.release_slot(slot)

    def warmup(self, buckets: tuple[int, ...] | None = None) -> dict:
        """Run the decode ladder once: every prefill bucket plus the step
        (on the card each first run captures its graph).  Returns the
        per-program wall times for kdlt-torch-warm's report."""
        report = {"model": self.model, "buckets": {}, "step_s": 0.0}
        for b in buckets or self.prompt_buckets:
            if b > self.max_context:
                continue
            t0 = time.perf_counter()
            slot = self.acquire_slot(min(b + 1, self.max_context))
            if slot is None:
                break
            try:
                self.materialize(self.prefill(slot, [BOS_TOKEN] * b))
            finally:
                self.release_slot(slot)
            report["buckets"][str(b)] = round(time.perf_counter() - t0, 4)
        t0 = time.perf_counter()
        slot = self.acquire_slot(2)
        if slot is not None:
            try:
                self.materialize(self.prefill(slot, [BOS_TOKEN]))
                self.seed_token(slot, BOS_TOKEN)
                self.materialize(self.step_async())
            finally:
                self.release_slot(slot)
        report["step_s"] = round(time.perf_counter() - t0, 4)
        report["graphs"] = self.graphs_captured
        return report

    def close(self) -> None:
        """Give the device memory back: the graphs, their pool, the cache
        and the weights (under the capture lock, as the image engine's
        close).  The caller has stopped dispatching; later dispatches
        raise.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            with capture_lock:
                self._graphs.clear()
                self._pool = None
                self._cache = self._params = None
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()


def _to_device(params: dict, device: torch.device) -> dict:
    def put(t):
        return torch.as_tensor(t, dtype=torch.float32).to(device)

    return {
        **{k: put(params[k]) for k in ("embed", "pos", "ln_f")},
        "layers": [{k: put(v) for k, v in layer.items()} for layer in params["layers"]],
    }


# --- the continuous-batching scheduler --------------------------------------


FINISH_STOP = "stop"            # EOS emitted
FINISH_LENGTH = "length"        # max_new_tokens reached
FINISH_DEADLINE = "deadline"    # budget expired mid-stream
FINISH_CANCELLED = "cancelled"  # client went away


@dataclass
class Generation:
    """One in-flight generation: the scheduler's bookkeeping plus the
    event queue its transport thread drains."""

    rid: str
    prompt_tokens: list[int]
    max_new_tokens: int
    priority: str = protocol.DEFAULT_PRIORITY
    deadline: Deadline | None = None
    t_submit: float = field(default_factory=time.perf_counter)
    t_first: float | None = None
    t_last: float | None = None
    tokens: list[int] = field(default_factory=list)
    finish_reason: str | None = None
    slot: int | None = None
    events: Queue = field(default_factory=Queue)
    _cancel: threading.Event = field(default_factory=threading.Event)

    def cancel(self) -> None:
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def ttft_s(self) -> float | None:
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    def tpot_s(self) -> float | None:
        if self.t_first is None or self.t_last is None or len(self.tokens) < 2:
            return None
        return (self.t_last - self.t_first) / (len(self.tokens) - 1)

    def iter_events(self, timeout_s: float = 60.0):
        """Drain the event queue: yields ("token", index, id, text) then
        one ("done", finish_reason); transport-thread side."""
        while True:
            try:
                ev = self.events.get(timeout=timeout_s)
            except Empty:
                return
            yield ev
            if ev[0] == "done":
                return


class DecodeScheduler:
    """The per-step scheduler: admission queue in, token events out.

    ``continuous=True`` (the lane's reason to exist): every loop iteration
    first slot-fills freed decode slots from the queue, by (priority rank,
    absolute deadline) order, then runs ONE batched step and fans the
    materialized tokens out to their generations.

    ``continuous=False`` is the static request-boundary baseline: admissions
    happen only when the whole batch has drained.  Same engine, same
    programs; only the admission policy differs.
    """

    def __init__(
        self,
        engine: DecodeEngine,
        *,
        continuous: bool = True,
        registry: metrics_lib.Registry | None = None,
        recorder=None,
        tracer=None,
        queue_cap: int | None = None,
    ):
        self.engine = engine
        self.continuous = continuous
        self.registry = registry
        self.recorder = recorder
        self.tracer = tracer
        self.queue_cap = queue_cap or _env_int(QUEUE_CAP_ENV, DEFAULT_QUEUE_CAP)
        self.metrics = (metrics_lib.decode_metrics(registry, engine.model)
                        if registry is not None else None)
        self._queue: list[Generation] = []
        self._live: dict[int, Generation] = {}
        self._cond = threading.Condition()
        self._seq = 0
        self._closed = False
        self._saturated = False
        self._thread = threading.Thread(target=self._loop, name="kdlt-decode", daemon=True)
        self._started = False

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._started:
            self._thread.join(timeout=10.0)

    # --- submission (transport threads) ------------------------------------

    def submit(self, prompt: str, max_new_tokens: int, *, rid: str = "",
               priority: str | None = None, deadline: Deadline | None = None) -> Generation:
        """Enqueue one generation; raises QueueFull at the cap (a retryable
        503 at the transports) and ValueError for a prompt that cannot fit
        (a 400)."""
        tokens = encode_prompt(prompt)
        total = len(tokens) + max_new_tokens
        if total > self.engine.max_context:
            raise ValueError(
                f"prompt ({len(tokens)} tokens) + max_new_tokens ({max_new_tokens}) exceeds "
                f"the {self.engine.max_context}-token context")
        prompt_bucket(len(tokens), self.engine.prompt_buckets)  # raises early
        gen = Generation(rid=rid, prompt_tokens=tokens, max_new_tokens=max_new_tokens,
                         priority=protocol.parse_priority(priority), deadline=deadline)
        with self._cond:
            if self._closed:
                raise QueueFull("decode scheduler is shut down")
            if len(self._queue) >= self.queue_cap:
                if self.recorder is not None:
                    self.recorder.record("decode.shed", rid=rid or None, reason="queue_full")
                raise QueueFull(f"decode admission queue at capacity ({self.queue_cap})")
            self._seq += 1
            gen._order = (  # type: ignore[attr-defined]
                protocol.PRIORITY_RANK.get(gen.priority, 0),
                deadline.remaining_s() + time.monotonic() if deadline is not None
                else float("inf"),
                self._seq,
            )
            self._queue.append(gen)
            if self.metrics:
                self.metrics["queue_depth"].set(len(self._queue))
            self._cond.notify_all()
        return gen

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    # --- the decode loop (one thread owns the device state) -----------------

    def _admit_locked(self) -> list[Generation]:
        """Pop admissible generations under the lock; continuous mode
        slot-fills whatever is free, static mode waits for a full drain."""
        if not self.continuous and self._live:
            return []
        admitted: list[Generation] = []
        self._queue.sort(key=lambda g: g._order)  # type: ignore[attr-defined]
        remaining: list[Generation] = []
        for gen in self._queue:
            if gen.cancelled or (gen.deadline is not None and gen.deadline.expired):
                gen.finish_reason = FINISH_CANCELLED if gen.cancelled else FINISH_DEADLINE
                gen.events.put(("done", gen.finish_reason))
                if self.recorder is not None and gen.finish_reason == FINISH_DEADLINE:
                    self.recorder.record("decode.shed", rid=gen.rid or None, reason="deadline")
                continue
            total = len(gen.prompt_tokens) + gen.max_new_tokens
            if self.engine.has_capacity(total):
                slot = self.engine.acquire_slot(total)
                if slot is not None:
                    gen.slot = slot
                    admitted.append(gen)
                    continue
            remaining.append(gen)
        self._queue = remaining
        if remaining and not admitted and self.engine.active_slots:
            if not self._saturated and self.recorder is not None:
                self.recorder.record("decode.saturated", queued=len(remaining),
                                     slots=self.engine.max_slots)
            self._saturated = True
        else:
            self._saturated = False
        if self.metrics:
            self.metrics["queue_depth"].set(len(self._queue))
        return admitted

    def _emit(self, gen: Generation, token: int, now: float) -> None:
        idx = len(gen.tokens)
        gen.tokens.append(int(token))
        if gen.t_first is None:
            gen.t_first = now
            if self.tracer is not None:
                self.tracer.record(gen.rid, trace_lib.SPAN_DECODE_FIRST_TOKEN, gen.t_submit,
                                   now - gen.t_submit)
        gen.t_last = now
        gen.events.put(("token", idx, int(token), decode_tokens([int(token)])))
        if self.metrics:
            self.metrics["tokens"].inc()

    def _retire(self, gen: Generation, reason: str) -> None:
        gen.finish_reason = reason
        if gen.slot is not None:
            self.engine.release_slot(gen.slot)
            self._live.pop(gen.slot, None)
            gen.slot = None
        if self.metrics:
            self.metrics["generations"].inc()
            ttft, tpot = gen.ttft_s(), gen.tpot_s()
            if ttft is not None:
                self.metrics["ttft"].observe(ttft)
            if tpot is not None:
                self.metrics["tpot"].observe(tpot)
            self.metrics["active_slots"].set(self.engine.active_slots)
            self.metrics["pages_in_use"].set(self.engine.pages_in_use)
        if self.recorder is not None and reason == FINISH_DEADLINE:
            self.recorder.record("decode.shed", rid=gen.rid or None, reason="deadline")
        gen.events.put(("done", reason))

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and not self._queue and not self._live:
                    self._cond.wait(timeout=0.5)
                if self._closed:
                    for gen in self._queue:
                        gen.finish_reason = FINISH_CANCELLED
                        gen.events.put(("done", FINISH_CANCELLED))
                    self._queue.clear()
                    for gen in list(self._live.values()):
                        self._retire(gen, FINISH_CANCELLED)
                    return
                admitted = self._admit_locked()

            # Prefill the admissions (one program per bucket); the first
            # token comes straight out of prefill: its materialization IS
            # the TTFT moment.
            for gen in admitted:
                t0 = time.perf_counter()
                first = int(self.engine.materialize(
                    self.engine.prefill(gen.slot, gen.prompt_tokens)))
                now = time.perf_counter()
                if self.metrics:
                    self.metrics["prefill_seconds"].observe(now - t0)
                    self.metrics["active_slots"].set(self.engine.active_slots)
                    self.metrics["pages_in_use"].set(self.engine.pages_in_use)
                if self.tracer is not None:
                    self.tracer.record(gen.rid, trace_lib.SPAN_DECODE_PREFILL, t0, now - t0)
                self._live[gen.slot] = gen
                self._emit(gen, first, now)
                if first == EOS_TOKEN or len(gen.tokens) >= gen.max_new_tokens:
                    self._retire(gen, FINISH_STOP if first == EOS_TOKEN else FINISH_LENGTH)
                else:
                    self.engine.seed_token(gen.slot, first)

            if not self._live:
                continue

            # One batched step: dispatch, then the single host sync.
            t0 = time.perf_counter()
            toks = self.engine.materialize(self.engine.step_async())
            now = time.perf_counter()
            if self.metrics:
                self.metrics["steps"].inc()
                self.metrics["step_seconds"].observe(now - t0)
            for slot, gen in list(self._live.items()):
                tok = int(toks[slot])
                self._emit(gen, tok, now)
                if gen.cancelled:
                    self._retire(gen, FINISH_CANCELLED)
                elif tok == EOS_TOKEN:
                    self._retire(gen, FINISH_STOP)
                elif len(gen.tokens) >= gen.max_new_tokens:
                    self._retire(gen, FINISH_LENGTH)
                elif gen.deadline is not None and gen.deadline.expired:
                    self._retire(gen, FINISH_DEADLINE)
                else:
                    self.engine.seed_token(slot, tok)
