"""Per-epoch checkpoints of the full train state, resume, keep-N.

Port of ``rnet/train/checkpoint.py::CheckpointManager``. Each epoch is saved
as ``<dir>/<name>_epoch_NNN``: one ``torch.save`` file (the port's own
format) holding the model's parameters and BatchNorm buffers, the Adam
state, the step count and the state of the generator every random draw of
training comes from, so a resume continues the run exactly. It is written
under a temporary name and renamed when complete. Weights go to rnet
through ``rnet_torch.checkpoint.export_weights`` (the weights-only pkl).

An epoch that rnet saved, the orbax directory of the same name, restores
too (``rnet_torch.ocdbt`` reads it): ``restore_weights`` takes its
``params`` and ``batch_stats``, ``restore`` also its step and Adam's
``mu``/``nu``/``count``, found in ``opt_state`` wherever rnet's optimizer
chain put them. rnet's random key has no torch counterpart, so the two
runs' random streams part there: the port's generator is seeded with the
key's first 64 bits (``rnet_seed``), the same seed for the same
checkpoint. ``latest_epoch`` and ``keep`` count both kinds of epoch.

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
import shutil
from typing import Optional

import numpy as np
import torch

from ..checkpoint import check_match, load_run_dicts, load_weights, run_dicts_path, state_dict_of
from ..convert import flax_to_adam_state, flax_to_state_dict
from ..ocdbt import restore as restore_rnet_epoch
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
            path = self._path(e)
            if os.path.isdir(path):  # an epoch rnet saved
                shutil.rmtree(path)
            else:
                os.remove(path)

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def _resolve(self, path_or_epoch) -> str:
        return self._path(path_or_epoch) if isinstance(path_or_epoch, int) else os.path.abspath(path_or_epoch)

    def restore(self, state: TrainState, path_or_epoch) -> TrainState:
        """Restore the full state in place from a path or an epoch number
        (the parameters, buffers and LR tensors keep their storage)."""
        path = self._resolve(path_or_epoch)
        if os.path.isdir(path):
            tree = restore_rnet_epoch(path)
            state.model.load_state_dict(state_dict_of(tree, path, state.model))
            flax_to_adam_state(state.model, state.adam, _adam_state(tree, path, state.model))
            state.step = int(tree["step"])
            state.generator.manual_seed(rnet_seed(tree["rng"]))
            return state
        payload = self._load(path, state.model)
        state.model.load_state_dict(payload["model"])
        load_adam_state(state.adam, payload["adam"])
        state.step = int(payload["step"])
        state.generator.set_state(payload["generator"])
        return state

    def restore_weights(self, model, path_or_epoch) -> None:
        """Restore parameters and BatchNorm buffers only into ``model`` (eval,
        inference, extraction)."""
        path = self._resolve(path_or_epoch)
        if os.path.isdir(path):
            load_weights(model, path)
        else:
            model.load_state_dict(self._load(path, model)["model"])

    @staticmethod
    def _load(path: str, model) -> dict:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        check_match(path, payload["model"], model.state_dict())
        return payload


def _adam_state(tree, path: str, model) -> dict:
    """The one ``{"mu", "nu", "count"}`` node of rnet's ``opt_state`` (the
    adam state inside ``inject_hyperparams``, after the clip and decay
    links), its moments validated against ``model``'s parameters."""
    found = []

    def visit(node):
        if isinstance(node, dict):
            if {"mu", "nu", "count"} <= set(node):
                found.append(node)
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)

    visit(tree.get("opt_state"))
    if len(found) != 1:
        raise ValueError(f"checkpoint {path}: expected one Adam state (mu, nu, count) in opt_state, found {len(found)}")
    params = dict(model.named_parameters())
    for moment in ("mu", "nu"):
        check_match(f"{path} (Adam {moment})", flax_to_state_dict({"params": found[0][moment]}), params)
    return found[0]


def rnet_seed(key_data) -> int:
    """The port's generator seed on a resume from rnet: the first 64 bits
    of rnet's raw uint32 key data, little-endian."""
    return int.from_bytes(np.ascontiguousarray(key_data, dtype="<u4").tobytes()[:8], "little")
