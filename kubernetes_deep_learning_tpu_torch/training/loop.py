"""fit(): the training entry point -- loop, logging, checkpoint/resume, export
(the port of ``training/loop.py``).

Composes ``build_train_step``, ``data.PrefetchIterator`` (host-to-device
overlap), ``checkpoint.Checkpointer`` (periodic snapshots and resume) and,
in ``fit_and_export``, ``export.exporter.export_model``, so a finished run
lands in the versioned artifact layout that both packages' model servers
scan.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

import torch

from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.training import checkpoint as ckpt_lib
from kubernetes_deep_learning_tpu_torch.training.data import PrefetchIterator
from kubernetes_deep_learning_tpu_torch.training.trainer import (
    Optimizer,
    TrainState,
    build_eval_step,
    build_train_step,
    create_train_state,
)

_SUMS = ("loss_sum", "top1_sum", "topk_sum", "count")


def evaluate(spec: ModelSpec, state: TrainState, batches: Iterable,
             eval_step: Callable | None = None) -> dict[str, float]:
    """One validation pass: mean loss, top-1 and top-k accuracy.

    ``batches`` yields (uint8 images, int labels), of any sizes: the sums
    aggregate per example, on the device, and are read once at the end.
    Pass a prebuilt ``eval_step`` when calling repeatedly (fit does).
    """
    step_fn = eval_step or build_eval_step(spec)
    totals = {k: torch.zeros((), dtype=torch.float64, device=state.device) for k in _SUMS}
    for images, labels in batches:
        m = step_fn(state, images, labels)
        for k in _SUMS:
            totals[k] += m[k]
    t = {k: float(v) for k, v in totals.items()}
    n = max(t["count"], 1.0)
    return {"val_loss": t["loss_sum"] / n, "val_top1": t["top1_sum"] / n,
            "val_topk": t["topk_sum"] / n, "count": int(t["count"])}


def fit(
    spec: ModelSpec,
    tx: Optimizer,
    batches: Iterable,
    steps: int,
    seed: int = 0,
    ckpt_dir: str | None = None,
    ckpt_every: int = 0,
    max_to_keep: int = 3,
    log_every: int = 0,
    log_fn: Callable[[str], None] = print,
    state: TrainState | None = None,
    eval_batches: Callable[[], Iterable] | None = None,
    eval_every: int = 0,
    eval_history: list | None = None,
    device: str | torch.device = "cuda",
):
    """Train to ``steps`` total optimizer steps; returns (state, history).

    As the JAX ``fit``: ``eval_batches`` is a zero-argument factory of a
    fresh (images, labels) iterable; with ``eval_every`` a validation pass
    runs at that cadence and once after the final step (only the final
    one without it), logged and appended to ``eval_history`` as
    ``(step, metrics)``.  With ``ckpt_dir`` an existing checkpoint is
    restored and training continues from its step.  ``history`` holds
    (step, loss) at the logging cadence and always the last executed step;
    each entry is one host sync, and the steps between are not synced.
    The compute dtype is float32, as the JAX ``fit``'s; ``state`` (if
    given) decides the device, else ``device``.
    """
    if state is None:
        state = create_train_state(spec, tx, seed=seed, device=device)

    ckpt = None
    if ckpt_dir is not None:
        ckpt = ckpt_lib.Checkpointer(ckpt_dir, max_to_keep=max_to_keep)
        if ckpt.restore(state) is not None:
            log_fn(f"resumed from {ckpt_dir} at step {state.step}")

    step_fn = build_train_step(spec)
    eval_fn = build_eval_step(spec) if eval_batches is not None else None
    it = PrefetchIterator(batches, device=state.device)

    history: list[tuple[int, float]] = []
    t0 = time.perf_counter()
    step = start_step = state.step
    metrics = None

    def record():
        loss = float(metrics["loss"])  # the one device sync of a log line
        history.append((step, loss))
        rate = (step - start_step) / max(time.perf_counter() - t0, 1e-9)
        log_fn(f"step {step}/{steps} loss {loss:.4f} ({rate:.1f} steps/s)")

    def run_eval():
        m = evaluate(spec, state, eval_batches(), eval_step=eval_fn)
        if eval_history is not None:
            eval_history.append((step, m))
        log_fn(f"eval step {step}: val_loss {m['val_loss']:.4f} "
               f"val_top1 {m['val_top1']:.4f} val_topk {m['val_topk']:.4f} "
               f"({m['count']} examples)")

    try:
        try:
            while step < steps:
                try:
                    images, labels = next(it)
                except StopIteration:
                    log_fn(f"data exhausted at step {step}/{steps}")
                    break
                state, metrics = step_fn(state, images, labels)
                step = state.step
                if log_every and step % log_every == 0 and step < steps:
                    record()
                if eval_fn is not None and eval_every and step % eval_every == 0 and step < steps:
                    run_eval()
                if ckpt is not None and ckpt_every and step % ckpt_every == 0:
                    ckpt.save(state)
        finally:
            # Stop the producer on every exit: an abandoned prefetch thread
            # would pin depth + 1 device batches.
            it.close()

        if metrics is not None:  # always record the final executed step
            record()
        if eval_fn is not None:
            # The final quality pass, whatever the cadence, also after zero
            # steps (a run resumed at `steps`).
            run_eval()
        if ckpt is not None:
            ckpt.save(state)  # no-op if this step was already saved
    finally:
        if ckpt is not None:
            ckpt.close()  # joins the writes
    return state, history


def fit_and_export(spec: ModelSpec, tx: Optimizer, batches: Iterable, steps: int,
                   artifact_root: str, **fit_kwargs) -> str:
    """fit(), then export the trained parameters as the next served
    version under ``artifact_root``; returns the version directory."""
    from kubernetes_deep_learning_tpu_torch.export.exporter import export_model

    state, _ = fit(spec, tx, batches, steps, **fit_kwargs)
    return export_model(spec, state.variables(), artifact_root)
