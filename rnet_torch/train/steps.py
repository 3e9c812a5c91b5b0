"""Train and eval steps: NLL loss, global-norm clipping, Adam.

Port of ``rnet/train/steps.py`` (``make_optimizer``, ``create_train_state``,
``_inputs_of``, ``_fused_augment_ok``, ``_train_inputs``, ``train_step``,
``eval_step``, ``make_jitted_steps``, ``make_chunked_steps``) and
``rnet/train/loop.py::set_learning_rate``; ``unpack_eval_chunk``'s packing
has no counterpart.

Dispatch, as rnet's jit: ``make_jitted_steps`` gives a train and an eval
step over one batch, ``make_chunked_steps`` a train and an eval chunk over
a (K, B) block of sample indices into per-question device tensors (K steps
in one dispatch, as rnet's ``lax.scan``). Given a ``StepGraphs`` (made by
``step_graphs``; ``rnet_torch/train/graphs.py``) each is captured in a CUDA
graph at its first call for a shape and replayed after; without one (the
CPU, or ``cuda_graphs=False``) the same function runs eagerly. So the CPU
tests hold the very code that the card captures.

The optimizer is rnet's optax chain, step for step:

    clip_by_global_norm(clip_norm) -> add_decayed_weights(weight_decay)
        -> adam(lr, b1=0.9, b2=0.999, eps=1e-8)

The clip is optax's: gradients stay as they are when their global norm is
below ``clip_norm`` and are otherwise replaced by g / norm * clip_norm
(``torch.nn.utils.clip_grad_norm_`` would divide by norm + 1e-6). The decay
and Adam are ``torch.optim.Adam(weight_decay=...)``, which adds wd * p to the
gradient before the moments, as ``add_decayed_weights`` placed before adam
does, and whose update is optax's algebraically. ``clip_norm`` or
``weight_decay`` of 0 leaves that link out, as in rnet. On CUDA the Adam is
``capturable``: its step count and the LR are device tensors, so that a
captured step reads them at every replay, and ``set_learning_rate`` fills
the LR in place (rnet injects it into the optimizer state; neither
rebuilds anything). The eager CUDA step uses the same Adam, so eager and
replayed steps run the same arithmetic; the CPU keeps a float LR.

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
from .graphs import StepGraphs, shape_key, tensor_key

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
    """On CUDA a capturable Adam with the LR as a device tensor; on the CPU
    a float LR."""
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    lr = torch.tensor(optimizer.lr, dtype=torch.float32, device=dev) if cuda else optimizer.lr
    adam = torch.optim.Adam(
        model.parameters(), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
        weight_decay=optimizer.weight_decay, capturable=cuda,
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(model=model, adam=adam, clip_norm=optimizer.clip_norm, generator=gen)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Change the LR of the next steps; nothing is rebuilt (a device LR is
    filled in place, where captured steps read it)."""
    for group in state.adam.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)
    return state


def load_adam_state(adam: torch.optim.Adam, state_dict: Mapping[str, Any]) -> None:
    """``adam.load_state_dict`` that keeps each group's LR tensor (filled with
    the saved value): ``load_state_dict`` would put the saved object in its
    place, which a captured step does not read."""
    lrs = [g["lr"] for g in adam.param_groups]
    adam.load_state_dict(state_dict)
    for group, lr in zip(adam.param_groups, lrs):
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(group["lr"]))
            group["lr"] = lr


class StateRollback:
    """Snapshot and in-place restore of everything a train step changes: the
    parameters and BatchNorm buffers, the Adam state (moments and step; a
    parameter without state gets zeros, what Adam's first step starts
    from), the generator and the step count. In place, because captured
    steps read these tensors where they lie."""

    def __init__(self, state: TrainState):
        self.state = state

    @torch.no_grad()
    def snapshot(self):
        st = self.state
        model = {k: v.clone() for k, v in st.model.state_dict().items()}
        adam = {p: {k: v.clone() for k, v in s.items()} for p, s in st.adam.state.items()}
        return model, adam, st.generator.get_state(), st.step

    @torch.no_grad()
    def restore(self, snap) -> None:
        model, adam, gen, step = snap
        st = self.state
        live = st.model.state_dict()
        for k, v in model.items():
            live[k].copy_(v)
        for p, s in st.adam.state.items():
            saved = adam.get(p)
            for k, v in s.items():
                if saved is None:
                    v.zero_()
                else:
                    v.copy_(saved[k])
        st.generator.set_state(gen)
        st.step = step


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


def _update(state: TrainState, batch: Mapping[str, Any], image_cache: Optional[torch.Tensor]) -> torch.Tensor:
    """A train step's device work (forward, backward, clip, Adam); its
    (loss, accuracy, grad_norm) as one (3,) tensor. The step count is the
    caller's: a replay runs no Python."""
    loss, accuracy, grads = loss_and_grads(state.model, batch, state.generator, image_cache)
    with torch.no_grad():
        norm = global_norm(grads)
        if state.clip_norm > 0:
            clip_by_global_norm_(grads, norm, state.clip_norm)
        state.adam.step()
    return torch.stack([loss, accuracy, norm])


def _metrics(m: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"loss": m[0], "accuracy": m[1], "grad_norm": m[2]}


def train_step(
    state: TrainState, batch: Mapping[str, Any], image_cache: Optional[torch.Tensor] = None
) -> Dict[str, torch.Tensor]:
    """One optimizer step in place; metrics ``loss`` (mean NLL), ``accuracy``
    and ``grad_norm`` (the global norm before clipping) as 0-d tensors."""
    m = _update(state, batch, image_cache)
    state.step += 1
    return _metrics(m)


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


EVAL_KEYS = ("pred", "label", "valid", "index", "nll_sum")


def step_graphs(state: TrainState):
    """The ``StepGraphs`` of one train state: its generator registered, its
    rollback around every capture."""
    return StepGraphs(state.device, generators=(state.generator,), rollback=StateRollback(state))


def _dispatch(graphs, key, fn, inputs: Dict[str, torch.Tensor]):
    """``fn(inputs)``, replayed from ``graphs`` under ``key`` or run eagerly."""
    return fn(inputs) if graphs is None else graphs.run(key, fn, inputs)


def make_jitted_steps(state: TrainState, graphs=None):
    """(train_step, eval_step) over one batch (rnet's ``make_jitted_steps``):
    ``train_step(batch, image_cache=None)`` -> metrics as ``train_step``'s,
    ``eval_step(batch, image_cache=None)`` -> ``eval_step``'s outputs. The
    batch's tensors are copied into the graph's buffers (on its device);
    with ``graphs`` None they run eagerly."""

    def jitted_train(batch: Mapping[str, Any], image_cache: Optional[torch.Tensor] = None):
        b = _batch_tensors(batch, state.device)
        key = ("train", shape_key(b), tensor_key(image_cache))
        m = _dispatch(graphs, key, lambda x: _update(state, x, image_cache), b)
        state.step += 1
        return _metrics(m)

    def jitted_eval(batch: Mapping[str, Any], image_cache: Optional[torch.Tensor] = None):
        b = _batch_tensors(batch, state.device)
        key = ("eval", shape_key(b), tensor_key(image_cache))
        return _dispatch(graphs, key, lambda x: eval_step(state, x, image_cache), b)

    return jitted_train, jitted_eval


def _gather(data: Mapping[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v[idx] for k, v in data.items()}


def make_chunked_steps(state: TrainState, graphs=None):
    """(train_chunk, eval_chunk) over device-resident data (rnet's
    ``make_chunked_steps``): K steps in one dispatch, step k's batch gathered
    on the device by the (B,) sample indices ``idx_chunk[k]`` from the
    per-question tensors ``data`` (read in place, as ``image_cache``).

    * ``train_chunk(idx_chunk, data, image_cache)`` -> (K, 3) loss,
      accuracy, grad_norm per step;
    * ``eval_chunk(idx_chunk, valid_chunk, data, image_cache)`` -> ``pred``,
      ``label``, ``valid``, ``index`` (K, B) and ``nll_sum`` (K,).

    The (K, B) blocks are copied into the graph's buffers; with ``graphs``
    None the chunks run eagerly."""

    def ext_key(data, image_cache):
        return tuple(sorted((k, tensor_key(v)) for k, v in data.items())), tensor_key(image_cache)

    def train_chunk(idx_chunk: torch.Tensor, data: Mapping[str, torch.Tensor], image_cache=None) -> torch.Tensor:
        def body(x):
            return torch.stack([_update(state, _gather(data, idx), image_cache) for idx in x["idx"]])

        inputs = {"idx": idx_chunk}
        ms = _dispatch(graphs, ("train_chunk", shape_key(inputs), ext_key(data, image_cache)), body, inputs)
        state.step += idx_chunk.shape[0]
        return ms

    def eval_chunk(idx_chunk, valid_chunk, data: Mapping[str, torch.Tensor], image_cache=None):
        def body(x):
            outs = []
            for idx, valid in zip(x["idx"], x["valid"]):
                batch = _gather(data, idx)
                batch["valid"], batch["index"] = valid, idx
                outs.append(eval_step(state, batch, image_cache))
            return {k: torch.stack([o[k] for o in outs]) for k in EVAL_KEYS}

        inputs = {"idx": idx_chunk, "valid": valid_chunk}
        return _dispatch(graphs, ("eval_chunk", shape_key(inputs), ext_key(data, image_cache)), body, inputs)

    return train_chunk, eval_chunk
