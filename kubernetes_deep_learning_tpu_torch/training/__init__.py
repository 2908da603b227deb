"""Training for the port: ``fit`` on one device, checkpoint and resume,
export of the trained parameters, batches from an image folder (the port
of ``training/``).  Every family trains: ViT, and the BatchNorm families
on batch statistics; see ``trainer``."""

from kubernetes_deep_learning_tpu_torch.training.checkpoint import Checkpointer
from kubernetes_deep_learning_tpu_torch.training.data import (
    PrefetchIterator,
    image_folder_batches,
    map_batches,
    synthetic_batches,
)
from kubernetes_deep_learning_tpu_torch.training.loop import evaluate, fit, fit_and_export
from kubernetes_deep_learning_tpu_torch.training.trainer import (
    TrainState,
    build_eval_step,
    build_train_step,
    create_train_state,
)

__all__ = [
    "Checkpointer",
    "PrefetchIterator",
    "TrainState",
    "build_eval_step",
    "build_train_step",
    "create_train_state",
    "evaluate",
    "fit",
    "fit_and_export",
    "image_folder_batches",
    "map_batches",
    "synthetic_batches",
]
