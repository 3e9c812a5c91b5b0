"""Weights and carried dictionaries from rnet's checkpoint formats.

Own copies of the parts of ``rnet/train/checkpoint.py`` that serving needs,
without orbax or JAX: ``run_dicts_path``/``load_run_dicts`` (lines 41-52,
the per-run dictionary sidecar JSON), ``load_exported_dicts`` (line 213),
the weights-only pickle of ``export_weights`` (lines 201-210), and the
``params``/``batch_stats`` of an orbax epoch directory that rnet's
``CheckpointManager.save`` writes (read by ``rnet_torch.ocdbt``), loaded
into a port model through ``rnet_torch.convert``. The pickle holds plain
dicts of numpy arrays, so it unpickles without JAX or flax.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Tuple

from torch import nn

from .convert import flax_to_state_dict, state_dict_to_flax
from .ocdbt import restore

DICTS_KEY = "dicts"


def run_dicts_path(directory: str, model_name: str) -> str:
    return os.path.join(os.path.abspath(directory), f"{model_name}_dictionaries.json")


def load_run_dicts(directory: str, model_name: str) -> Optional[Tuple[dict, dict]]:
    """Dictionaries recorded next to a run's epoch checkpoints, or None."""
    p = run_dicts_path(directory, model_name)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        d = json.load(f)
    return d["word_to_idx"], {k: int(v) for k, v in d["answer_to_idx"].items()}


def _read_pkl(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_exported_dicts(path: str) -> Optional[Tuple[dict, dict]]:
    """(word_to_idx, answer_to_idx) embedded in a weights pkl, or None."""
    d = _read_pkl(path).get(DICTS_KEY)
    return (d["word_to_idx"], d["answer_to_idx"]) if d else None


def check_match(path: str, got: dict, want: dict) -> None:
    """Raise naming every missing, unexpected or misshapen tensor (wrong --model?)."""
    problems = [f"  missing {k} (model expects {tuple(want[k].shape)})" for k in sorted(set(want) - set(got))]
    problems += [f"  unexpected {k} (checkpoint has {tuple(got[k].shape)})" for k in sorted(set(got) - set(want))]
    problems += [
        f"  {k}: checkpoint {tuple(got[k].shape)} vs model {tuple(want[k].shape)}"
        for k in sorted(set(got) & set(want))
        if tuple(got[k].shape) != tuple(want[k].shape)
    ]
    if problems:
        raise ValueError(
            f"checkpoint {path} does not match the model skeleton (wrong --model?):\n" + "\n".join(problems)
        )


def state_dict_of(variables, path: str, model: nn.Module) -> dict:
    """rnet's ``{"params", "batch_stats"}`` as ``model``'s state_dict (its
    dtypes), validated against it as rnet's ``_check_tree_match`` does."""
    sd = flax_to_state_dict(variables)
    want = model.state_dict()
    check_match(path, sd, want)
    return {k: v.to(want[k].dtype) for k, v in sd.items()}


def load_weights(model: nn.Module, checkpoint: str) -> None:
    """Load a weights-only pkl, or the weights of an rnet epoch directory,
    into ``model`` in place (dtype and device kept)."""
    ck = str(checkpoint)
    if os.path.isdir(ck):
        variables = restore(ck)
    elif ck.endswith(".pkl"):
        variables = _read_pkl(ck)
    else:
        raise ValueError(f"{ck!r} is neither a weights-only .pkl nor an rnet epoch directory")
    model.load_state_dict(state_dict_of(variables, ck, model))


def export_weights(model: nn.Module, path: str, dicts=None) -> None:
    """Write ``model`` as the pkl that rnet's ``export_weights`` writes."""
    flat = state_dict_to_flax(model.state_dict())
    if dicts is not None:
        flat[DICTS_KEY] = {
            "word_to_idx": dict(dicts.word_to_idx),
            "answer_to_idx": dict(dicts.answer_to_idx),
        }
    with open(path, "wb") as f:
        pickle.dump(flat, f)
