"""Train and eval steps: NLL loss, global-norm clipping, Adam.

Port of ``rnet/train/steps.py`` (``make_optimizer``, ``create_train_state``,
``_inputs_of``, ``_fused_augment_ok``, ``_train_inputs``, ``train_step``,
``eval_step``) and ``rnet/train/loop.py::set_learning_rate``. The
device-resident counterpart of ``make_chunked_steps`` (a per-step index
gather from per-question device tensors) is ``Trainer``'s epoch loop in
``rnet_torch/train/loop.py``; ``unpack_eval_chunk``'s packing has none.

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
tensors with rnet's keys: ``image`` (uint8 NHWC, possibly a padded canvas),
``image_idx`` (rows of a device image cache passed as ``image_cache``) or
``objects``, ``question``, ``answer``, and optionally ``n_objects``,
``valid`` and ``index``.

Train-time augmentation (``_train_inputs``, as rnet's): with
``device_augment`` on a from-pixels config, the fused augment kernel
(``rnet_torch/kernels/augment.py``) gathers, crops, rotates and normalizes
the batch before the model when the batch is on CUDA (``augment_impl``
``auto`` or ``pallas``) or when ``augment_impl == "pallas"`` (on the CPU its
plain version); otherwise the model augments in its forward
(``augment_impl="xla"``, and ``auto`` on the CPU). Every draw comes from
the train state's generator: the augmentation's first, then dropout's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from ..kernels.augment import gather_augment
from ..models import RN
from ..models.rn import compute_dtype

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


def _inputs_of(b: Dict[str, torch.Tensor], cfg, image_cache: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The model's input: objects, the batch's images, or the rows of the
    device image cache named by ``image_idx`` (a gather on the device)."""
    if cfg.state_description:
        return b["objects"]
    if image_cache is not None and "image_idx" in b:
        return image_cache[b["image_idx"].long()]
    return b["image"]


def _fused_augment_ok(cfg, device: torch.device) -> bool:
    """The augment kernel applies: from-pixels with device_augment, and on
    CUDA (``auto``/``pallas``) or ``augment_impl == "pallas"`` anywhere."""
    if cfg.state_description or not cfg.device_augment or cfg.augment_impl == "xla":
        return False
    return device.type == "cuda" or cfg.augment_impl == "pallas"


def _train_inputs(b: Dict[str, torch.Tensor], cfg, image_cache, generator, device) -> Tuple[torch.Tensor, bool]:
    """(training inputs, whether they are already augmented)."""
    if not _fused_augment_ok(cfg, device):
        return _inputs_of(b, cfg, image_cache), False
    if image_cache is not None and "image_idx" in b:
        src, idx = image_cache, b["image_idx"].to(torch.int32)
    elif "image" in b and b["image"].dtype == torch.uint8 and b["image"].shape[1] > cfg.image_size:
        # padded canvases of the cached pipeline: the batch is the source
        src = b["image"]
        idx = torch.arange(src.shape[0], dtype=torch.int32, device=src.device)
    else:  # unpadded or float inputs: nothing for the kernel to crop
        return _inputs_of(b, cfg, image_cache), False
    if generator is None:
        raise ValueError("device_augment in train mode needs a torch.Generator on the batch's device")
    out = gather_augment(src, idx.contiguous(), generator, cfg.image_size, out_dtype=compute_dtype(cfg))
    return out, True


def loss_and_grads(
    model: RN,
    batch: Mapping[str, Any],
    generator: Optional[torch.Generator] = None,
    image_cache: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Train-mode forward and backward: (mean NLL, accuracy, the gradient of
    every parameter in ``model.parameters()`` order). The BatchNorm running
    statistics move as in a step; the parameters do not."""
    model.train()
    cfg = model.cfg
    dev = next(model.parameters()).device
    b = _batch_tensors(batch, dev)
    labels = b["answer"].long()
    params = list(model.parameters())
    for p in params:
        p.grad = None
    inputs, augmented = _train_inputs(b, cfg, image_cache, generator, dev)
    n_objects = b.get("n_objects") if cfg.object_mask else None
    logp = model(inputs, b["question"], n_objects=n_objects, generator=generator, augmented=augmented)
    loss = -logp.gather(1, labels[:, None]).mean()
    loss.backward()
    # optax updates every leaf; a parameter the forward did not reach gets
    # a zero gradient so that its moments and step count move too
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    accuracy = (logp.detach().argmax(-1) == labels).float().mean()
    return loss.detach(), accuracy, [p.grad for p in params]


def train_step(
    state: TrainState, batch: Mapping[str, Any], image_cache: Optional[torch.Tensor] = None
) -> Dict[str, torch.Tensor]:
    """One optimizer step in place; metrics ``loss`` (mean NLL), ``accuracy``
    and ``grad_norm`` (the global norm before clipping) as 0-d tensors."""
    loss, accuracy, grads = loss_and_grads(state.model, batch, state.generator, image_cache)
    with torch.no_grad():
        norm = global_norm(grads)
        if state.clip_norm > 0:
            clip_by_global_norm_(grads, norm, state.clip_norm)
        state.adam.step()
    state.step += 1
    return {"loss": loss, "accuracy": accuracy, "grad_norm": norm}


@torch.no_grad()
def eval_step(
    state: TrainState, batch: Mapping[str, Any], image_cache: Optional[torch.Tensor] = None
) -> Dict[str, torch.Tensor]:
    """Predictions and per-sample correctness under ``valid`` (all True when
    the batch has none), the masked NLL sum, and ``index`` passed through."""
    model = state.model.eval()
    cfg = model.cfg
    b = _batch_tensors(batch, state.device)
    labels = b["answer"].long()
    n_objects = b.get("n_objects") if cfg.object_mask else None
    logp = model(_inputs_of(b, cfg, image_cache), b["question"], n_objects=n_objects)
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
