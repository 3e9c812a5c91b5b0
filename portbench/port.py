"""How the harness reaches the system under test, ``rnet_torch``: its model
configuration (held to the configuration file's widths), its dictionaries
built from the harness's words, its Trainer and server, and the weights
the harness drew put into its model. The port is imported inside these
functions only, so that the harness's own modules import without it.
"""

from __future__ import annotations

import gc
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import data, reference


def model_config(cell) -> Any:
    """The port's ``ModelConfig`` of the cell: its configuration as
    ``rnet_torch.config.load_config`` gives it, with the traffic's
    implementation, precision and augmentation. Raises where the port's
    widths differ from the configuration file's."""
    from rnet_torch.config import load_config

    t = cell.traffic
    overrides = {"rl_impl": t["rl_impl"], "compute_dtype": t["compute_dtype"], "device_augment": t.get("device_augment"),
                 "augment_impl": t.get("augment_impl")}
    cfg = load_config(cell.config["port_config"], overrides=overrides)
    for key, want in cell.config["widths"].items():
        got = getattr(cfg, key)
        if (list(got) if isinstance(got, tuple) else got) != want:
            raise ValueError(f"the port's {cell.config['port_config']} has {key}={got!r}; the configuration "
                             f"file {cell.config['name']} states {want!r}")
    return cfg


def dictionaries():
    from rnet_torch.data.vocab import Dictionaries

    words, answers = data.dictionary()
    return Dictionaries(words, answers)


def vocab_size() -> int:
    return len(data.dictionary()[0]) + 1


@torch.no_grad()
def put_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the harness's weights into the port's model, in place (the
    optimizer and any captured graph read the same tensors). Raises where
    the model's parameters and buffers are not the reference's layout."""
    live = model.state_dict()
    if sorted(live) != sorted(weights) or any(tuple(live[k].shape) != tuple(weights[k].shape) for k in live):
        theirs = {k: tuple(v.shape) for k, v in live.items()}
        ours = {k: tuple(v.shape) for k, v in weights.items()}
        raise ValueError(f"the port's model differs from the reference's layout: {theirs} against {ours}")
    for k, v in live.items():
        v.copy_(weights[k])


class Split:
    """What the Trainer reads of a split whose device arrays the harness
    hands it itself: its length and its question families."""

    serve_indices = False

    def __init__(self, n: int, families: Optional[np.ndarray] = None):
        self.n = n
        self.families = families

    def __len__(self) -> int:
        return self.n

    def question_categories(self) -> Optional[np.ndarray]:
        return self.families


def n_families() -> int:
    from rnet_torch.data.categories import QUESTION_CATEGORIES

    return len(QUESTION_CATEGORIES)


def trainer(cfg, cell, run, train: Split, val: Split, checkpoint_dir: str):
    """The port's ``Trainer`` at the traffic's batch size and optimizer,
    its generator seeded from the run's seed; its log goes to stderr."""
    from rnet_torch.train.loop import Trainer
    from rnet_torch.train.schedules import DoublingSchedule

    t = cell.traffic
    return Trainer(
        cfg, vocab_size(), train, val, dictionaries(),
        lr=DoublingSchedule(t.get("lr", 1e-4), step=0), bs=DoublingSchedule(t["batch_size"], step=0),
        clip_norm=t.get("clip_norm", 50.0), seed=data.stream_seed(run.seed, "train_state"),
        log_interval=t["log_interval"], log_fn=lambda *a, **k: print(*a, file=sys.stderr, **k),
        device=run.device, checkpoint_dir=checkpoint_dir,
    )


def weights(cell, run) -> Dict[str, torch.Tensor]:
    w = cell.config["widths"]
    return reference.draw_weights(w, vocab_size(), data.device_generator(run.seed, "weights", run.device), run.device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
