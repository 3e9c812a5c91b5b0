"""Weight exchange between rnet's flax variables and the port's state_dict.

No ``rnet`` counterpart module; it reads and writes the layout of the
weights-only pickle of ``rnet/train/checkpoint.py::export_weights`` (lines
201-210): ``{"params": {...}, "batch_stats": {...}}`` as nested dicts of numpy
arrays, plus an optional ``"dicts"`` entry.

The port's parameter names are the flax tree paths joined with ``.``
(``relational.g0_kernel``, ``text.wx``, ``conv.bn0.scale``; batch statistics
``conv.bn0.mean``/``var`` become buffers of the same path). The one layout
change is the conv kernel: flax HWIO <-> torch OIHW. Both directions are
exact, so flax -> torch -> flax returns the same arrays.

The Adam state maps the same way: ``torch.optim.Adam``'s per-parameter
``exp_avg``/``exp_avg_sq``/``step`` <-> optax's ``ScaleByAdamState``
(``mu``, ``nu`` as flax param trees, ``count`` int32), also exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_CONV_WEIGHT = "weight"  # port name of a flax conv "kernel"


def _is_conv_kernel(path: tuple) -> bool:
    return len(path) == 3 and path[0] == "conv" and path[1].startswith("conv") and path[2] == "kernel"


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} numpy trees -> the port's state_dict."""
    sd = {}
    for path, arr in _flatten(variables.get("params", {})).items():
        if _is_conv_kernel(path):
            path = path[:-1] + (_CONV_WEIGHT,)
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        sd[".".join(path)] = torch.tensor(arr)
    for path, arr in _flatten(variables.get("batch_stats", {})).items():
        sd[".".join(path)] = torch.tensor(arr)
    return sd


def _nest(flat: Dict[tuple, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state_dict -> {"params", "batch_stats"} numpy trees."""
    params, stats = {}, {}
    for name, t in sd.items():
        path = tuple(name.split("."))
        arr = t.detach().cpu().numpy()
        if path[-1] in ("mean", "var") and len(path) == 3 and path[1].startswith("bn"):
            stats[path] = arr
            continue
        if path[0] == "conv" and path[-1] == _CONV_WEIGHT:
            path = path[:-1] + ("kernel",)
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))  # OIHW -> HWIO
        params[path] = arr
    return {"params": _nest(params), "batch_stats": _nest(stats)}


# ---------------------------------------------------------------------------
# Adam state: torch.optim.Adam <-> optax ScaleByAdamState (mu, nu, count)
# ---------------------------------------------------------------------------


def adam_state_to_flax(model: torch.nn.Module, adam: torch.optim.Adam) -> Dict[str, Any]:
    """{"mu", "nu", "count"}: the first and second moments as flax param
    trees (the layout of optax's ScaleByAdamState) and the step count as an
    int32 scalar. A parameter Adam has not stepped yet has zero moments."""
    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = adam.state.get(p, {})
        mu[name] = st["exp_avg"] if st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(p)
        if st:
            count = int(st["step"])
    return {
        "mu": state_dict_to_flax(mu)["params"],
        "nu": state_dict_to_flax(nu)["params"],
        "count": np.asarray(count, dtype=np.int32),
    }


def flax_to_adam_state(model: torch.nn.Module, adam: torch.optim.Adam, state: Mapping[str, Any]) -> None:
    """Load {"mu", "nu", "count"} in the layout of ``adam_state_to_flax``
    into ``adam``'s state for ``model``'s parameters, in place."""
    mu = flax_to_state_dict({"params": state["mu"]})
    nu = flax_to_state_dict({"params": state["nu"]})
    step = float(np.asarray(state["count"]))
    for name, p in model.named_parameters():
        adam.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype).clone(),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype).clone(),
        }
