"""The port's decode subsystem (``runtime/decode.py``) on the CPU, against
the JAX package's.

- The programs: with JAX's ``_build_params`` carried across by
  ``weights.from_jax_decode_params``, the port's ``prefill_logits`` and
  ``decode_logits`` are held against JAX's ``_prefill`` and
  ``_decode_step`` over a whole teacher-forced generation (every slot fed
  JAX's token): the cache within 1e-5 relative after every program, and
  the next token equal wherever JAX's top-2 logit margin (computed here
  from JAX's ``_rms``/``_qkv``/``_mlp``/``_logits``) is above 1e-4.  Below
  that margin a last-bit difference may pick the other token, and greedy
  decoding would then follow another stream, which is why whole streams
  are held only against the same engine's own ``decode_solo``.
- The port counterpart of every test of JAX's ``tests/test_decode.py``,
  on the port's CPU engine (2 slots, 8-token pages, as there), the
  whole-stream invariant included: a continuous batch's streams are
  bit-identical to ``decode_solo``'s.
- The port-seeded weights: JAX's seed rule and scales, deterministic.
- SSE frames and /generate bodies: the port's protocol and JAX's read each
  other's frames and judge the same bodies alike.
"""

from __future__ import annotations

import math
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.runtime import decode as jax_decode
from kubernetes_deep_learning_tpu.serving import protocol as jax_protocol
from kubernetes_deep_learning_tpu_torch.runtime import decode as decode_lib
from kubernetes_deep_learning_tpu_torch.runtime.errors import QueueFull
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.admission import Deadline
from kubernetes_deep_learning_tpu_torch.weights import from_jax_decode_params
from torch_threads import one_torch_thread  # noqa: F401

CACHE_TOL = 1e-5    # relative max-abs, the port's cache against JAX's
MARGIN = 1e-4       # top-2 logit margin above which the greedy tokens must agree


# --- token + SSE plumbing -------------------------------------------------------


def test_encode_decode_prompt_round_trip():
    tokens = decode_lib.encode_prompt("hello, tpu!")
    assert tokens == jax_decode.encode_prompt("hello, tpu!")
    assert tokens[0] == decode_lib.BOS_TOKEN == jax_decode.BOS_TOKEN
    assert decode_lib.decode_tokens(tokens[1:]) == "hello, tpu!"
    specials = [decode_lib.BOS_TOKEN, 104, 105, decode_lib.EOS_TOKEN]
    assert decode_lib.decode_tokens(specials) == jax_decode.decode_tokens(specials) == "hi"
    assert (decode_lib.EOS_TOKEN, decode_lib.VOCAB_SIZE) == (jax_decode.EOS_TOKEN,
                                                             jax_decode.VOCAB_SIZE)


def test_prompt_bucket_picks_smallest_fit_and_raises_on_overflow():
    buckets = decode_lib.PROMPT_BUCKETS
    assert buckets == jax_decode.PROMPT_BUCKETS == (16, 32, 64)
    for n in (1, 16, 17, 33, 64):
        assert decode_lib.prompt_bucket(n, buckets) == jax_decode.prompt_bucket(n, buckets)
    assert [decode_lib.prompt_bucket(n, buckets) for n in (1, 16, 17, 64)] == [16, 16, 32, 64]
    with pytest.raises(ValueError):
        decode_lib.prompt_bucket(65, buckets)


def test_knobs_and_defaults_are_jaxs():
    for name in ("SLOTS_ENV", "PAGE_SIZE_ENV", "MAX_PAGES_ENV", "QUEUE_CAP_ENV", "DEFAULT_SLOTS",
                 "DEFAULT_PAGE_SIZE", "DEFAULT_MAX_PAGES", "DEFAULT_QUEUE_CAP", "FINISH_STOP",
                 "FINISH_LENGTH", "FINISH_DEADLINE", "FINISH_CANCELLED"):
        assert getattr(decode_lib, name) == getattr(jax_decode, name), name
    assert (decode_lib.DEFAULT_SLOTS, decode_lib.DEFAULT_PAGE_SIZE, decode_lib.DEFAULT_MAX_PAGES,
            decode_lib.DEFAULT_QUEUE_CAP) == (4, 16, 8, 64)


def test_generation_ttft_tpot_math():
    gen = decode_lib.Generation(rid="r", prompt_tokens=[256], max_new_tokens=4)
    assert gen.ttft_s() is None and gen.tpot_s() is None
    gen.t_first = gen.t_submit + 0.5
    gen.t_last = gen.t_first + 0.3
    gen.tokens = [1, 2, 3, 4]
    assert gen.ttft_s() == pytest.approx(0.5)
    # TPOT excludes the first token (TTFT's): 0.3 s over 3 gaps.
    assert gen.tpot_s() == pytest.approx(0.1)
    gen.tokens = [1]
    assert gen.tpot_s() is None


def _frames(proto) -> bytes:
    return (proto.sse_token_event(0, 104, "h") + proto.sse_token_event(1, 105, "i")
            + proto.sse_done_event(tokens=2, ttft_ms=1.5, tpot_ms=0.5, finish_reason="length",
                                   text="hi"))


def test_sse_events_round_trip_through_the_parser():
    events = protocol.parse_sse_events(_frames(protocol))
    assert [e.get("token") for e in events[:-1]] == [104, 105]
    done = events[-1]
    assert done["done"] is True and done["finish_reason"] == "length"
    assert done["text"] == "hi" and done["tokens"] == 2


@pytest.mark.parametrize("writer,reader", [(protocol, jax_protocol), (jax_protocol, protocol)],
                         ids=["port-frames-jax-parser", "jax-frames-port-parser"])
def test_sse_frames_cross_the_two_packages(writer, reader):
    """The frames are byte-equal, and each package parses the other's,
    a trailing partial frame included."""
    raw = _frames(writer)
    assert raw == _frames(reader)
    assert reader.parse_sse_events(raw + b'data: {"index": 2') == writer.parse_sse_events(raw)


_BAD_BODIES = (
    b"notjson",
    b'["prompt"]',
    b'{"nope": 1}',
    b'{"prompt": ""}',
    b'{"prompt": 3}',
    b'{"prompt": "x", "max_new_tokens": 0}',
    b'{"prompt": "x", "max_new_tokens": "many"}',
    ('{"prompt": "x", "max_new_tokens": %d}' % (protocol.GENERATE_MAX_NEW_TOKENS_CAP + 1)).encode(),
)


def test_decode_generate_request_validation():
    ok = protocol.decode_generate_request(b'{"prompt": "hi"}')
    assert ok == {"prompt": "hi", "max_new_tokens": 16, "stream": True}
    ok = protocol.decode_generate_request(b'{"prompt": "hi", "max_new_tokens": 3, "stream": false}')
    assert ok["max_new_tokens"] == 3 and ok["stream"] is False
    for bad in _BAD_BODIES:
        with pytest.raises(ValueError):
            protocol.decode_generate_request(bad)


def test_generate_request_decoding_equals_jaxs():
    assert protocol.GENERATE_MAX_NEW_TOKENS_CAP == jax_protocol.GENERATE_MAX_NEW_TOKENS_CAP
    for body in (b'{"prompt": "hi"}', b'{"prompt": "\\u00e9t\\u00e9", "max_new_tokens": "7"}',
                 b'{"prompt": "x", "stream": 0, "max_new_tokens": 1024}'):
        assert protocol.decode_generate_request(body) == jax_protocol.decode_generate_request(body)
    for bad in _BAD_BODIES:
        errors = []
        for proto in (protocol, jax_protocol):
            with pytest.raises(ValueError) as info:
                proto.decode_generate_request(bad)
            errors.append(str(info.value).split(":")[0])
        assert errors[0] == errors[1], bad


# --- the programs against JAX's, teacher-forced ----------------------------------


def _jax_prefill_logits(params, cache, tokens, length, page_ids):
    """JAX's ``_prefill`` body with the last true position's logits out."""
    page, n_heads, t_len = cache.shape[3], cache.shape[4], tokens.shape[0]
    pos = jnp.arange(t_len, dtype=jnp.int32)
    x = params["embed"][tokens] + params["pos"][pos]
    real = pos < length
    write_page = jnp.where(real, page_ids[pos // page], 0)
    causal = (pos[None, :] <= pos[:, None]) & real[None, :]
    for li, layer in enumerate(params["layers"]):
        q, k, v = jax_decode._qkv(layer, x, n_heads)
        cache = cache.at[li, 0, write_page, pos % page].set(k)
        cache = cache.at[li, 1, write_page, pos % page].set(v)
        scores = jnp.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
        scores = jnp.where(causal[None], scores, -1e9)
        w = jnp.exp(scores - scores.max(axis=-1, keepdims=True))
        w = w / w.sum(axis=-1, keepdims=True)
        x = x + jnp.einsum("hqk,khd->qhd", w, v).reshape(t_len, -1) @ layer["wo"]
        x = x + jax_decode._mlp(layer, x)
    return jax_decode._logits(params, x[length - 1])


def _jax_step_logits(params, cache, page_table, lengths, last_tokens, active):
    """JAX's ``_decode_step`` body with the logits out."""
    page, n_heads, head_dim = cache.shape[3], cache.shape[4], cache.shape[5]
    s_slots, max_pages = page_table.shape
    ctx = max_pages * page
    x = params["embed"][last_tokens] + params["pos"][lengths]
    write_page = jnp.take_along_axis(page_table, (lengths // page)[:, None], axis=1)[:, 0]
    write_page = jnp.where(active, write_page, 0)
    att_mask = jnp.arange(ctx, dtype=jnp.int32)[None, :] <= lengths[:, None]
    for li, layer in enumerate(params["layers"]):
        q, k, v = jax_decode._qkv(layer, x, n_heads)
        cache = cache.at[li, 0, write_page, lengths % page].set(k)
        cache = cache.at[li, 1, write_page, lengths % page].set(v)
        k_ctx = cache[li, 0][page_table].reshape(s_slots, ctx, n_heads, head_dim)
        v_ctx = cache[li, 1][page_table].reshape(s_slots, ctx, n_heads, head_dim)
        scores = jnp.einsum("shd,sthd->sht", q, k_ctx) / math.sqrt(head_dim)
        scores = jnp.where(att_mask[:, None, :], scores, -1e9)
        w = jnp.exp(scores - scores.max(axis=-1, keepdims=True))
        w = w / w.sum(axis=-1, keepdims=True)
        x = x + jnp.einsum("sht,sthd->shd", w, v_ctx).reshape(s_slots, -1) @ layer["wo"]
        x = x + jax_decode._mlp(layer, x)
    return jax_decode._logits(params, x)


def _margin(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _cache_rel(port: torch.Tensor, ref) -> float:
    """Relative max-abs over every page but the trash page (page 0), where
    padding and inactive slots write duplicates in no fixed order."""
    ref = np.asarray(ref)[:, :, 1:]
    return float(np.abs(port.numpy()[:, :, 1:] - ref).max() / max(np.abs(ref).max(), 1e-30))


# (slots, page size, pages a sequence, prompts): JAX's test engine, and the
# lane's defaults with a prompt in each of the three prefill buckets.
PARITY = {
    "jax-test-engine": (2, 8, 4, ("a much longer prompt string", "x")),
    "defaults": (4, 16, 8, ("short", "a prompt of twenty b", "x" * 40, "y" * 60)),
}


@pytest.mark.parametrize("config", list(PARITY))
def test_programs_match_jax_over_a_teacher_forced_generation(config):
    slots, page, max_pages, prompts = PARITY[config]
    jparams = jax_decode._build_params(11, 32, 2, 2)
    params = from_jax_decode_params(jax.tree_util.tree_map(np.asarray, jparams))
    buckets = tuple(b for b in decode_lib.PROMPT_BUCKETS if b <= page * max_pages)
    shape = (2, 2, 1 + slots * max_pages, page, 2, 16)
    jcache = jnp.zeros(shape, jnp.float32)
    cache = torch.zeros(shape)
    page_table = np.zeros((slots, max_pages), np.int32)
    for s in range(slots):
        page_table[s] = 1 + s * max_pages + np.arange(max_pages)
    j_prefill, j_prefill_logits = jax.jit(jax_decode._prefill), jax.jit(_jax_prefill_logits)
    j_step, j_step_logits = jax.jit(jax_decode._decode_step), jax.jit(_jax_step_logits)
    compared = under_margin = 0
    lengths = np.zeros(slots, np.int32)
    last = np.zeros(slots, np.int32)
    active = np.zeros(slots, bool)
    for s, prompt in enumerate(prompts):
        tokens = decode_lib.encode_prompt(prompt)
        n, bucket = len(tokens), decode_lib.prompt_bucket(len(tokens), buckets)
        padded = np.zeros(bucket, np.int32)
        padded[:n] = tokens
        logits = np.asarray(j_prefill_logits(jparams, jcache, padded, np.int32(n), page_table[s]))
        jcache, first = j_prefill(jparams, jcache, padded, np.int32(n), page_table[s])
        got = decode_lib.prefill_logits(params, cache, torch.from_numpy(padded).long(),
                                        torch.tensor(n), torch.from_numpy(page_table[s]).long())
        assert _cache_rel(cache, jcache) <= CACHE_TOL, (prompt, _cache_rel(cache, jcache))
        if _margin(logits) > MARGIN:
            assert int(torch.argmax(got)) == int(first), prompt
            compared += 1
        else:
            under_margin += 1
        lengths[s], last[s], active[s] = n, int(first), True
    # Decode until the longest generation fills its slot's context.
    steps = page * max_pages - int(lengths.max())
    for _ in range(steps):
        args = (page_table, lengths, last, active)
        logits = np.asarray(j_step_logits(jparams, jcache, *args))
        jcache, nxt = j_step(jparams, jcache, *args)
        got = decode_lib.decode_logits(params, cache, *(torch.from_numpy(a).long() for a in args[:3]),
                                       torch.from_numpy(active))
        assert _cache_rel(cache, jcache) <= CACHE_TOL, _cache_rel(cache, jcache)
        nxt = np.array(nxt)
        wide = _margin(logits) > MARGIN
        assert (torch.argmax(got, dim=-1).numpy()[wide] == nxt[wide]).all()
        compared += int(wide.sum())
        under_margin += int((~wide).sum())
        lengths = lengths + active.astype(np.int32)
        last = nxt  # teacher forcing: both programs consume JAX's tokens
    assert compared >= 0.9 * (compared + under_margin) and compared >= slots * steps // 2, \
        (compared, under_margin)


def test_greedy_step_is_the_argmax_of_its_logits():
    """The engine's tokens are ``argmax(decode_logits)`` (first max on a
    tie, as ``jnp.argmax``), int32, for every slot, in one call."""
    engine = decode_lib.DecodeEngine("gen-test", max_slots=2, page_size=8, max_pages_per_seq=4,
                                     device="cpu")
    slot = engine.acquire_slot(10)
    engine.materialize(engine.prefill(slot, [256, 1, 2]))
    engine.seed_token(slot, 7)
    packed = torch.from_numpy(engine.step_inputs())
    cache = engine.cache.clone()
    logits = engine.logits(decode_lib.STEP, packed, cache)
    assert torch.equal(logits, decode_lib.decode_logits(
        engine.params, engine.cache.clone(), packed[:, :4], packed[:, 4], packed[:, 5],
        packed[:, 6] != 0))
    toks = engine.materialize(engine.step_async())
    assert toks.dtype == np.int32 and toks.shape == (2,)
    assert toks[slot] == int(torch.argmax(logits[slot]))
    assert torch.equal(cache, engine.cache)
    ties = torch.tensor([[0.0, 2.0, 2.0], [5.0, 5.0, 1.0]])
    assert decode_lib._greedy(ties).tolist() == np.argmax(ties.numpy(), -1).tolist() == [1, 0]
    engine.release_slot(slot)


# --- the seeded weights ----------------------------------------------------------


def test_port_seeded_weights_follow_jaxs_seed_rule_and_scales():
    engine = decode_lib.DecodeEngine("gen-default", device="cpu")
    jax_engine = jax_decode.DecodeEngine("gen-default")
    assert engine._seed == jax_engine._seed == zlib.crc32(b"gen-default") & 0x7FFFFFFF
    again = decode_lib.build_params(engine._seed, 32, 2)
    jp = jax_engine._params
    for name, scale in (("embed", 0.05), ("pos", 0.02)):
        assert engine.params[name].shape == jp[name].shape
        assert torch.equal(engine.params[name], again[name])
        assert float(engine.params[name].std()) == pytest.approx(scale, rel=0.05)
    for layer, jlayer in zip(engine.params["layers"], jp["layers"]):
        for name, scale in (("wqkv", 1 / math.sqrt(32)), ("wo", 1 / math.sqrt(32)),
                            ("w1", 1 / math.sqrt(32)), ("w2", 0.5 / math.sqrt(32))):
            assert layer[name].shape == jlayer[name].shape
            assert float(layer[name].std()) == pytest.approx(scale, rel=0.1), name
        assert torch.equal(layer["ln1"], torch.ones(32))
    other = decode_lib.DecodeEngine("gen-other", device="cpu")
    assert not torch.equal(other.params["embed"], engine.params["embed"])


def test_from_jax_decode_params_refuses_a_partial_tree():
    jp = jax.tree_util.tree_map(np.asarray, jax_decode._build_params(0, 32, 1, 2))
    tree = from_jax_decode_params(jp)
    assert tree["embed"].dtype == torch.float32 and len(tree["layers"]) == 1
    assert np.array_equal(tree["layers"][0]["w2"].numpy(), jp["layers"][0]["w2"])
    del jp["layers"][0]["wo"]
    with pytest.raises(ValueError, match=r"layers\[0\]\.wo"):
        from_jax_decode_params(jp)


def test_engine_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_lib.DecodeEngine("gen-default")


# --- the paged engine (the port's CPU engine: 2 slots, 8-token pages) ------------


@pytest.fixture(scope="module")
def engine():
    return decode_lib.DecodeEngine("gen-test", max_slots=2, page_size=8, max_pages_per_seq=4,
                                   device="cpu")


def test_paged_allocation_frees_on_release(engine):
    assert engine.pages_in_use == 0
    slot = engine.acquire_slot(20)  # 20 tokens -> 3 pages of 8
    try:
        assert slot is not None
        assert engine.pages_in_use == 3
        assert engine.active_slots == 0  # flips on at prefill
        assert 0 not in engine._slot_pages[slot]  # page 0 is the trash page
    finally:
        engine.release_slot(slot)
    assert engine.pages_in_use == 0 and engine.active_slots == 0


def test_slot_exhaustion_returns_none_not_error(engine):
    slots = [engine.acquire_slot(8) for _ in range(engine.max_slots)]
    try:
        assert all(s is not None for s in slots)
        assert engine.acquire_slot(8) is None
    finally:
        for s in slots:
            engine.release_slot(s)


def test_solo_decode_is_deterministic(engine):
    a = engine.decode_solo("abc", 6)
    b = engine.decode_solo("abc", 6)
    assert a == b and len(a) <= 6


REQUESTS = [
    ("short", 10),
    ("a much longer prompt string", 4),
    ("mid-size prompt", 8),
    ("x", 12),
    ("long-ish prompt here", 6),
]


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "static"])
def test_batch_streams_bit_identical_to_solo(engine, continuous):
    """The lane's invariant: a request decoded in a SHIFTING batch
    (members joining and retiring around it) yields exactly the tokens of
    the same request decoded alone.  Mixed prompt lengths cover both
    prefill buckets; mixed budgets force slot churn mid-flight; the static
    scheduler runs the same programs in another order."""
    sched = decode_lib.DecodeScheduler(engine, continuous=continuous)
    sched.start()
    streamed: dict[int, list[int]] = {}

    def drive(i, prompt, mnt):
        gen = sched.submit(prompt, mnt, rid=f"r{i}")
        streamed[i] = [ev[2] for ev in gen.iter_events(timeout_s=60.0) if ev[0] == "token"]

    threads = [threading.Thread(target=drive, args=(i, p, n)) for i, (p, n) in enumerate(REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    sched.close()
    assert not any(t.is_alive() for t in threads)
    assert sorted(streamed) == list(range(len(REQUESTS)))
    for i, (prompt, mnt) in enumerate(REQUESTS):
        assert streamed[i] == engine.decode_solo(prompt, mnt), f"req {i} diverged from solo"
    assert engine.pages_in_use == 0 and engine.active_slots == 0


def test_scheduler_submit_rejects_oversize_prompts(engine):
    sched = decode_lib.DecodeScheduler(engine, continuous=True)
    with pytest.raises(ValueError):  # 41 tokens + 10 > the 32-token context
        sched.submit("x" * 40, 10)
    sched.close()


def test_scheduler_queue_cap_sheds_with_queuefull(engine):
    sched = decode_lib.DecodeScheduler(engine, continuous=True, queue_cap=1)
    sched.submit("a", 2)  # the loop is not started: it stays queued
    with pytest.raises(QueueFull):
        sched.submit("b", 2)
    sched.close()


def test_expired_deadline_finishes_as_deadline_without_tokens(engine):
    sched = decode_lib.DecodeScheduler(engine, continuous=True)
    sched.start()
    gen = sched.submit("abc", 4, deadline=Deadline(0.0))
    events = list(gen.iter_events(timeout_s=30.0))
    sched.close()
    assert events == [("done", decode_lib.FINISH_DEADLINE)]
    assert gen.tokens == []


def test_cancel_stops_a_queued_generation(engine):
    sched = decode_lib.DecodeScheduler(engine, continuous=True)
    gen = sched.submit("abc", 4)
    gen.cancel()
    sched.start()
    deadline = time.monotonic() + 30.0
    while not gen.done and time.monotonic() < deadline:
        time.sleep(0.01)
    sched.close()
    assert gen.finish_reason == decode_lib.FINISH_CANCELLED


def test_warmup_runs_the_ladder_and_close_gives_the_engine_back():
    engine = decode_lib.DecodeEngine("gen-test", max_slots=2, page_size=8, max_pages_per_seq=4,
                                     device="cpu")
    report = engine.warmup()
    assert report["model"] == "gen-test"
    assert sorted(report["buckets"], key=int) == ["16", "32"]  # 64 > the 32-token context
    assert report["step_s"] >= 0 and report["graphs"] == 0  # eager on the CPU
    assert engine.pages_in_use == 0 and engine.active_slots == 0
    engine.close()
    engine.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        engine.decode_solo("abc", 2)
