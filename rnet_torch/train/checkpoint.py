"""Per-epoch checkpoints of the full train state, resume, keep-N.

Port of ``rnet/train/checkpoint.py::CheckpointManager``. Each epoch is saved
as ``<dir>/<name>_epoch_NNN``: one ``torch.save`` file (the port's own
format; rnet's orbax directories need JAX to read) holding the model's
parameters and BatchNorm buffers, the Adam state, the step count and the
state of the generator every random draw of training comes from, so a
resume continues the run exactly. It is written under a temporary name and
renamed when complete. Weights go to rnet through
``rnet_torch.checkpoint.export_weights`` (the weights-only pkl).

Next to the epochs the manager records the run's dictionaries in rnet's
sidecar format (``run_dicts_path``), and it raises at construction when the
directory records dictionaries that differ from this run's: word and answer
ids follow first-seen data order, so a regenerated dataset would permute the
answer head silently.

In a multi-GPU run (``mesh``) rank 0 writes, and every rank waits for it
at a barrier before going on; a resume reads the same file on every rank
(the replicas are equal, so rank 0's state is everyone's).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from ..checkpoint import check_match, load_run_dicts, run_dicts_path
from ..parallel.mesh import Mesh, barrier, is_primary
from .steps import TrainState, load_adam_state


def _dicts_payload(dicts) -> dict:
    return {"word_to_idx": dict(dicts.word_to_idx), "answer_to_idx": dict(dicts.answer_to_idx)}


class CheckpointManager:
    """Per-epoch saves under <dir>/<name>_epoch_<NNN> + resume.

    keep=0 (the default) retains every epoch, as the reference does;
    keep=N > 0 deletes all but the newest N after each save.
    """

    def __init__(self, directory: str, model_name: str, keep: int = 0, dicts=None, mesh: Optional[Mesh] = None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        self.model_name = model_name
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.dicts = dicts
        self._pat = re.compile(rf"^{re.escape(model_name)}_epoch_(\d+)$")
        if dicts is not None:
            existing = load_run_dicts(self.directory, model_name)
            if existing is not None and existing != (
                dict(dicts.word_to_idx),
                {k: int(v) for k, v in dicts.answer_to_idx.items()},
            ):
                raise ValueError(
                    f"checkpoint dir {self.directory} records dictionaries "
                    f"(from {run_dicts_path(self.directory, model_name)}) that differ from "
                    f"the current dataset's: the data was regenerated with another "
                    f"seed or content, so answer indices would permute silently. "
                    f"Regenerate the dataset with the original seed, or use a fresh "
                    f"--checkpoint-dir (or delete the sidecar if the old checkpoints "
                    f"are disposable)."
                )

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{self.model_name}_epoch_{epoch:03d}")

    def _epochs(self) -> list:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory) if (m := self._pat.match(f)))

    def save(self, state: TrainState, epoch: int) -> str:
        path = self._path(epoch)
        if is_primary(self.mesh):
            self._write(state, path)
        barrier(self.mesh)
        return path

    def _write(self, state: TrainState, path: str) -> None:
        if self.dicts is not None:
            p = run_dicts_path(self.directory, self.model_name)
            if not os.path.exists(p):
                with open(p, "w") as f:
                    json.dump(_dicts_payload(self.dicts), f)
        payload = {
            "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "adam": state.adam.state_dict(),
            "step": int(state.step),
            "generator": state.generator.get_state(),
        }
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        self._gc()

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        for e in self._epochs()[: -self.keep]:
            os.remove(self._path(e))

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def _resolve(self, path_or_epoch) -> str:
        return self._path(path_or_epoch) if isinstance(path_or_epoch, int) else os.path.abspath(path_or_epoch)

    def _load(self, path_or_epoch, model) -> dict:
        path = self._resolve(path_or_epoch)
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path} is a directory, an orbax checkpoint of rnet: restoring orbax "
                "checkpoints comes with a later slice of the port (ROADMAP.md); export "
                "weights with rnet/train/checkpoint.py::export_weights and pass the .pkl"
            )
        payload = torch.load(path, map_location="cpu", weights_only=True)
        check_match(path, payload["model"], model.state_dict())
        return payload

    def restore(self, state: TrainState, path_or_epoch) -> TrainState:
        """Restore the full state in place from a path or an epoch number
        (the parameters, buffers and LR tensors keep their storage)."""
        payload = self._load(path_or_epoch, state.model)
        state.model.load_state_dict(payload["model"])
        load_adam_state(state.adam, payload["adam"])
        state.step = int(payload["step"])
        state.generator.set_state(payload["generator"])
        return state

    def restore_weights(self, model, path_or_epoch) -> None:
        """Restore parameters and BatchNorm buffers only into ``model`` (eval,
        inference, extraction)."""
        model.load_state_dict(self._load(path_or_epoch, model)["model"])
