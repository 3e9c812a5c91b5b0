"""Train and eval steps: NLL loss, global-norm clipping, Adam.

Port of ``rnet/train/steps.py`` (``make_optimizer``, ``create_train_state``,
``train_step``, ``eval_step``) and ``rnet/train/loop.py::set_learning_rate``.

The optimizer is rnet's optax chain, step for step:

    clip_by_global_norm(clip_norm) -> add_decayed_weights(weight_decay)
        -> adam(lr, b1=0.9, b2=0.999, eps=1e-8)

The clip is optax's: gradients stay as they are when their global norm is
below ``clip_norm`` and are otherwise replaced by g / norm * clip_norm
(``torch.nn.utils.clip_grad_norm_`` would divide by norm + 1e-6). The decay
and Adam are ``torch.optim.Adam(weight_decay=...)``, which adds wd * p to the
gradient before the moments, as ``add_decayed_weights`` placed before adam
does, and whose update is optax's algebraically. ``clip_norm`` or
``weight_decay`` of 0 leaves that link out, as in rnet.

Parameters and Adam moments stay fp32; the forward runs in the config's
compute dtype (the model casts). A batch is a dict of numpy arrays or
tensors with rnet's keys: ``image`` (uint8 NHWC) or ``objects``,
``question``, ``answer``, and optionally ``n_objects``, ``valid`` and
``index``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from ..models import RN

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The optimizer chain's hyperparameters (rnet's ``make_optimizer``)."""

    lr: float
    clip_norm: float = 50.0
    weight_decay: float = 0.0


def make_optimizer(lr: float, clip_norm: float = 50.0, weight_decay: float = 0.0) -> OptimizerConfig:
    return OptimizerConfig(float(lr), float(clip_norm or 0.0), float(weight_decay or 0.0))


@dataclasses.dataclass
class TrainState:
    """The model (fp32 parameters, BatchNorm buffers), its Adam, the step
    count and the generator of every dropout draw (on the model's device)."""

    model: RN
    adam: torch.optim.Adam
    clip_norm: float
    generator: torch.Generator
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model: RN, optimizer: OptimizerConfig, seed: int = 0) -> TrainState:
    dev = next(model.parameters()).device
    adam = torch.optim.Adam(
        model.parameters(), lr=optimizer.lr, betas=ADAM_BETAS, eps=ADAM_EPS,
        weight_decay=optimizer.weight_decay,
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(model=model, adam=adam, clip_norm=optimizer.clip_norm, generator=gen)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Change the LR of the next steps; nothing is rebuilt."""
    for group in state.adam.param_groups:
        group["lr"] = float(lr)
    return state


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax.global_norm)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g if norm < max_norm else g / norm * max_norm."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _batch_tensors(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _forward(model: RN, b: Dict[str, torch.Tensor], generator=None) -> torch.Tensor:
    cfg = model.cfg
    inputs = b["objects"] if cfg.state_description else b["image"]
    n_objects = b.get("n_objects") if cfg.object_mask else None
    return model(inputs, b["question"], n_objects=n_objects, generator=generator)


def loss_and_grads(
    model: RN, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Train-mode forward and backward: (mean NLL, accuracy, the gradient of
    every parameter in ``model.parameters()`` order). The BatchNorm running
    statistics move as in a step; the parameters do not."""
    model.train()
    b = _batch_tensors(batch, next(model.parameters()).device)
    labels = b["answer"].long()
    params = list(model.parameters())
    for p in params:
        p.grad = None
    logp = _forward(model, b, generator)
    loss = -logp.gather(1, labels[:, None]).mean()
    loss.backward()
    # optax updates every leaf; a parameter the forward did not reach gets
    # a zero gradient so that its moments and step count move too
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    accuracy = (logp.detach().argmax(-1) == labels).float().mean()
    return loss.detach(), accuracy, [p.grad for p in params]


def train_step(state: TrainState, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One optimizer step in place; metrics ``loss`` (mean NLL), ``accuracy``
    and ``grad_norm`` (the global norm before clipping) as 0-d tensors."""
    loss, accuracy, grads = loss_and_grads(state.model, batch, state.generator)
    with torch.no_grad():
        norm = global_norm(grads)
        if state.clip_norm > 0:
            clip_by_global_norm_(grads, norm, state.clip_norm)
        state.adam.step()
    state.step += 1
    return {"loss": loss, "accuracy": accuracy, "grad_norm": norm}


@torch.no_grad()
def eval_step(state: TrainState, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Predictions and per-sample correctness under ``valid`` (all True when
    the batch has none), the masked NLL sum, and ``index`` passed through."""
    model = state.model.eval()
    b = _batch_tensors(batch, state.device)
    labels = b["answer"].long()
    logp = _forward(model, b)
    pred = logp.argmax(-1)
    valid = b["valid"].bool() if "valid" in b else torch.ones_like(labels, dtype=torch.bool)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    out = {
        "pred": pred,
        "label": labels,
        "correct": (pred == labels) & valid,
        "valid": valid,
        "nll_sum": (nll * valid).sum(),
    }
    if "index" in b:
        out["index"] = b["index"]
    return out
