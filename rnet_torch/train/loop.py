"""Epoch loop: train -> eval -> checkpoint, with LR and batch-size doubling.

Port of ``rnet/train/loop.py::Trainer`` on one device (CUDA, or the CPU when
asked for). Steps dispatch as rnet's jit does (``steps.make_jitted_steps``,
``steps.make_chunked_steps``): on CUDA each is captured in a CUDA graph at
its first call for a shape and replayed after, all of a Trainer's graphs in
one memory pool (``rnet_torch/train/graphs.py``); a batch-size change frees
them. ``cuda_graphs=False`` runs the same functions eagerly (for comparing
the two; no CLI flag sets it); on the CPU nothing is captured.
  * host batches (``pil`` and ``cached`` pipelines): ``BatchIterator`` ->
    pinned, prefetched device copies (the copy stream's event orders them
    before the step) -> one replay of the train step per batch, which first
    copies the batch into the graph's buffers; a ``cached`` batch of padded
    canvases goes through the fused augment kernel batch-locally;
  * device-resident data (``device`` pipeline, ``device_data=True``): the
    padded uint8 image cache of each split is uploaded to the card once
    (4.35 GB for CLEVR train at 144^2), with the per-question tokens,
    answers and image indices; the epoch's (steps, B) index block, rnet's
    permutation ``np.random.RandomState((seed * 1_000_003 + epoch) % 2**31)``,
    is uploaded once, and each chunk of ``log_interval`` steps is one
    replay: its rows are copied into the graph's index buffer and every
    step gathers its batch on the device, so the host sends no pixels. The
    chunk's (K, 3) metrics are fetched after the next chunk is dispatched
    (rnet's one-chunk lag). Eval runs chunks of ``log_interval`` batches
    the same way and keeps predictions, labels, the valid mask and the NLL
    sum on the device until one fetch per epoch;
  * every epoch: LR and batch size from their ``DoublingSchedule``s, eval
    with the per-answer and per-family reports, a full-state checkpoint;
  * ``int8_clip_report``: the ``pallas_int8`` calibration-drift receipt on
    one val batch (printed by ``python -m rnet_torch.evaluate``).

Several GPUs (rnet's ``mesh_spec``): one process per GPU joined in a
process group (``rnet_torch/parallel/mesh.py``), ``mesh_spec`` "data:N" or
"data:D,pairs:P". The batch size is rounded to a multiple of the world
size, every rank ``pairs`` included, as rnet rounds by its device count;
each rank takes bs // D rows of every global batch: the host pipeline's
``BatchIterator`` shards the epoch's one shuffle by the rank's ``data``
coordinate, and on device-resident data each rank holds the replicated
cache and takes its ``data`` columns of each index chunk. The step
averages gradients and metrics over ``data``; eval outputs are gathered
over ``data`` (``fetch_global``) before the ``EvalAccumulator``, so every
rank reports the same numbers. The model starts from rank 0's weights.
Rank 0 alone logs, writes scalars, traces, reports and checkpoints (a
barrier after each save). NCCL collectives are captured in the steps'
graphs; gloo's cannot be, so a gloo mesh on CUDA needs ``cuda_graphs=False``.
"""

from __future__ import annotations

import re
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..data.pipeline import BatchIterator, prefetch_to_device
from ..data.vocab import invert_questions
from ..eval.metrics import EvalAccumulator
from ..models import RN
from ..parallel import mesh as pmesh
from ..serve import resolve_device
from ..utils.profiling import ScalarWriter, profile_trace, span
from . import steps
from .checkpoint import CheckpointManager
from .schedules import DoublingSchedule


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        vocab_size: int,
        train_ds: Any,
        val_ds: Any,
        dicts: Any,
        *,
        lr: DoublingSchedule,
        bs: DoublingSchedule,
        clip_norm: float = 50.0,
        weight_decay: float = 0.0,
        seed: int = 42,
        invert: bool = True,
        num_threads: int = 8,
        checkpoint_dir: str = "model",
        keep_checkpoints: int = 0,
        log_interval: int = 10,
        log_fn=print,
        tb_dir: Optional[str] = None,
        profile_dir: Optional[str] = None,
        profile_epoch: int = 1,
        device_data: bool = False,
        watchdog=None,
        device="cuda",
        cuda_graphs: bool = True,
        mesh_spec: Optional[str] = None,
    ):
        self.cfg = cfg
        self.dicts = dicts
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.lr_sched = lr
        self.bs_sched = bs
        self.seed = seed
        self.invert = invert
        self.num_threads = num_threads
        self.log_interval = max(1, log_interval)
        # heartbeat of the stall watchdog (rnet_torch/utils/watchdog.py)
        self._beat = watchdog.beat if watchdog is not None else (lambda: None)
        self.device = resolve_device(device)
        self.mesh = pmesh.make_mesh(mesh_spec, self.device)
        self.primary = pmesh.is_primary(self.mesh)
        self.log = log_fn if self.primary else (lambda *a, **k: None)
        if cuda_graphs and self.device.type == "cuda" and self.mesh is not None and self.mesh.backend != "nccl":
            raise ValueError(
                f"a {self.mesh.backend} process group's collectives cannot be captured in a CUDA graph: "
                "pass cuda_graphs=False, or use NCCL"
            )

        model = RN(cfg, vocab_size, generator=torch.Generator().manual_seed(seed), mesh=self.mesh).to(self.device)
        pmesh.replicate_state(model, self.mesh)
        self.state = steps.create_train_state(model, steps.make_optimizer(lr.base, clip_norm, weight_decay), seed=seed)
        self.graphs = steps.step_graphs(self.state) if cuda_graphs and self.device.type == "cuda" else None
        self.train_step, self.eval_step = steps.make_jitted_steps(self.state, self.graphs)
        self.train_chunk, self.eval_chunk = steps.make_chunked_steps(self.state, self.graphs)
        self.ckpt = CheckpointManager(checkpoint_dir, cfg.name, keep=keep_checkpoints, dicts=dicts, mesh=self.mesh)

        self.train_cache = self._device_cache(train_ds)
        self._beat()  # each heavy init stage restarts the stall clock
        self.val_cache = self.train_cache if val_ds is train_ds else self._device_cache(val_ds)
        self._beat()
        self.train_data = self.val_data = None
        if device_data and getattr(train_ds, "device_arrays", None) and train_ds.device_arrays() is not None:
            self.train_data = self._device_data(train_ds, self.train_cache)
            self.val_data = self.train_data if val_ds is train_ds else self._device_data(val_ds, self.val_cache)
            self._beat()
        self.epoch = 0
        self.history: list = []
        self.scalars = ScalarWriter(tb_dir if self.primary else None)
        self.profile_dir = profile_dir if self.primary else None
        self.profile_epoch = profile_epoch
        self._last_bs = None

    # ---- device-resident data ----

    def _device_cache(self, ds) -> Optional[torch.Tensor]:
        """The split's decoded padded uint8 images on the device, for
        datasets that serve image indices (else None)."""
        if not getattr(ds, "serve_indices", False):
            return None
        with warnings.catch_warnings():  # the memmap is read-only; nothing writes through it
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            host = torch.from_numpy(ds.images)
        return host.to(self.device)

    def _device_data(self, ds, cache) -> Dict[str, torch.Tensor]:
        arrs = dict(ds.device_arrays())
        if self.invert:
            arrs["question"] = invert_questions(arrs["question"])
        if "image_idx" in arrs:
            idx = arrs["image_idx"]
            if cache is None or idx.size and not 0 <= idx.min() <= idx.max() < cache.shape[0]:
                raise ValueError("image indices of the dataset fall outside its image cache")
        return {k: pmesh.put_global(v, self.device) for k, v in arrs.items()}

    # ---- resume ----

    @staticmethod
    def _epoch_of(path_or_epoch) -> int:
        if isinstance(path_or_epoch, int):
            return path_or_epoch
        m = re.search(r"_epoch_(\d+)", str(path_or_epoch))
        return int(m.group(1)) if m else 0

    def restore_weights(self, path_or_epoch) -> int:
        """Parameters and BatchNorm buffers only (eval, inference)."""
        self.ckpt.restore_weights(self.state.model, path_or_epoch)
        self.epoch = self._epoch_of(path_or_epoch)
        return self.epoch

    def resume(self, path_or_epoch) -> int:
        self.ckpt.restore(self.state, path_or_epoch)
        if self.graphs is not None:
            self.graphs.clear()  # the restored Adam state is in new tensors
        self.epoch = self._epoch_of(path_or_epoch)
        return self.epoch

    # ---- diagnostics ----

    def int8_clip_report(self, batch_size: int = 64) -> np.ndarray:
        """(L-1,) per-layer int8 calibration clip fractions on the first val
        batch, in order (``RN.int8_clip_report``)."""
        it = BatchIterator(
            self.val_ds, min(batch_size, len(self.val_ds)), shuffle=False, invert=self.invert,
            num_threads=self.num_threads,
        )
        b = steps._batch_tensors(next(iter(it)), self.device)
        inputs = steps._inputs_of(b, self.cfg, self.val_cache)
        return self.state.model.int8_clip_report(inputs, b["question"]).cpu().numpy()

    # ---- epochs ----

    def _global_bs(self, bs: int) -> int:
        """rnet's rounding: a multiple of the world size (every rank, pairs
        included), at least one row a rank."""
        size = 1 if self.mesh is None else self.mesh.world
        return max(size, (bs // size) * size)

    def _data_shard(self):
        """(data index, data size): the BatchIterator shard of this rank."""
        return (0, 1) if self.mesh is None else (self.mesh.index("data"), self.mesh.size("data"))

    def _val_categories(self):
        fn = getattr(self.val_ds, "question_categories", None)
        return fn() if fn is not None else None

    def _log_step(self, epoch: int, done: int, nb: int, m, lr: float, bs: int, step: int) -> None:
        """Log one step's fetched (loss, accuracy, grad_norm) at train step ``step``."""
        loss, acc, gnorm = (float(x) for x in m)
        self.log(f"Train Epoch: {epoch} [{done}/{nb}] Loss: {loss:.4f} Acc: {acc:.3f} LR: {lr:.2e} BS: {bs}")
        self.scalars.write(
            step,
            {"train/loss": loss, "train/accuracy": acc, "train/grad_norm": gnorm, "train/lr": lr},
        )
        self._beat()

    def _train_steps_device(self, epoch: int, bs: int, lr: float) -> np.ndarray:
        """The epoch over device-resident data, one dispatch per chunk of
        ``log_interval`` steps; (steps, 3) loss, accuracy, grad_norm."""
        n = len(self.train_ds)
        nb = n // bs
        with span("train.order"):
            order = (
                np.random.RandomState((self.seed * 1_000_003 + epoch) % (2**31))
                .permutation(n)[: nb * bs]
                .astype(np.int32)
                .reshape(nb, bs)
            )
            order = pmesh.shard_batch(pmesh.put_global(order, self.device), self.mesh, dim=1)  # one upload an epoch
        out, pending = [], None
        for c0 in range(0, nb, self.log_interval):
            ms = self.train_chunk(order[c0 : c0 + self.log_interval], self.train_data, self.train_cache)
            # fetch the previous chunk's metrics once this one is dispatched
            if pending is not None:
                out.append(self._drain(epoch, nb, pending, lr, bs))
            pending = (ms, min(c0 + self.log_interval, nb), self.state.step)
        if pending is not None:
            out.append(self._drain(epoch, nb, pending, lr, bs))
        return np.concatenate(out) if out else np.zeros((0, 3), np.float32)

    def _drain(self, epoch: int, nb: int, pending, lr: float, bs: int) -> np.ndarray:
        ms, done, step = pending
        with span("train.fetch"):
            with span("train.fetch_wait"):
                ms = ms.cpu().numpy()
            with span("train.log"):
                self._log_step(epoch, done, nb, ms[-1], lr, bs, step)
        return ms

    def _train_steps(self, epoch: int, bs: int, lr: float) -> np.ndarray:
        """Run the epoch's steps; (steps, 3) loss, accuracy, grad_norm."""
        if self.train_data is not None:
            return self._train_steps_device(epoch, bs, lr)
        _, D = self._data_shard()
        it = BatchIterator(
            self.train_ds, bs // D, shuffle=True, seed=self.seed, epoch=epoch, drop_last=True,
            invert=self.invert, num_threads=self.num_threads, shard=self._data_shard(),
        )
        nb = len(it)
        ms = []
        for k, batch in enumerate(prefetch_to_device(iter(it), self.device)):
            m = self.train_step(batch, self.train_cache)
            ms.append(torch.stack([m["loss"], m["accuracy"], m["grad_norm"]]))
            if (k + 1) % self.log_interval == 0 or k + 1 == nb:
                self._log_step(epoch, k + 1, nb, ms[-1].tolist(), lr, bs, self.state.step)
        # one fetch per epoch: the per-step metrics stayed on the device
        return torch.stack(ms).cpu().numpy() if ms else np.zeros((0, 3), np.float32)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        lr = self.lr_sched.value(epoch)
        bs = self._global_bs(self.bs_sched.int_value(epoch))
        if self._last_bs is not None and bs != self._last_bs:
            self.log(f"BS schedule: {self._last_bs} -> {bs} at epoch {epoch}")
            if self.graphs is not None:
                self.graphs.clear()  # the old batch's graphs are not replayed again
        self._last_bs = bs
        steps.set_learning_rate(self.state, lr)
        prof_dir = self.profile_dir if epoch == self.profile_epoch else None
        t0 = time.time()
        with profile_trace(prof_dir):
            ms = self._train_steps(epoch, bs, lr)
        dt = time.time() - t0
        nan = float("nan")
        return {
            "epoch": epoch,
            "train_loss": float(ms[:, 0].mean()) if len(ms) else nan,
            "train_acc": float(ms[:, 1].mean()) if len(ms) else nan,
            "lr": lr,
            "batch_size": bs,
            "sec": dt,
            "qps": len(ms) * bs / dt if dt > 0 else 0.0,
        }

    def _eval_device(self, bs: int):
        """The val split's outputs over device-resident data, in order, in
        chunks of ``log_interval`` batches."""
        n = len(self.val_ds)
        nb = -(-n // bs)
        with span("eval.upload"):
            idx = np.zeros((nb * bs,), np.int32)
            idx[:n] = np.arange(n, dtype=np.int32)
            valid = np.zeros((nb * bs,), bool)
            valid[:n] = True
            idx_d = pmesh.shard_batch(pmesh.put_global(idx.reshape(nb, bs), self.device), self.mesh, dim=1)
            valid_d = pmesh.shard_batch(pmesh.put_global(valid.reshape(nb, bs), self.device), self.mesh, dim=1)
        for c0 in range(0, nb, self.log_interval):
            c = slice(c0, c0 + self.log_interval)
            out = self.eval_chunk(idx_d[c], valid_d[c], self.val_data, self.val_cache)
            yield {k: v.reshape(-1) for k, v in out.items()}

    def eval_epoch(self, epoch: int, batch_size: Optional[int] = None) -> Dict[str, Any]:
        bs = self._global_bs(batch_size or self.bs_sched.int_value(max(epoch, 1)))
        acc = EvalAccumulator(self.dicts, categories=self._val_categories())
        t0 = time.time()
        if self.val_data is not None:
            results = self._eval_device(bs)
        else:
            _, D = self._data_shard()
            it = BatchIterator(
                self.val_ds, bs // D, shuffle=False, drop_last=False, invert=self.invert,
                num_threads=self.num_threads, shard=self._data_shard(),
            )
            results = (self.eval_step(batch, self.val_cache) for batch in prefetch_to_device(iter(it), self.device))
        outs = {"pred": [], "label": [], "valid": [], "index": []}
        nll = torch.zeros((), dtype=torch.float32, device=self.device)
        for out in results:
            for k in outs:
                outs[k].append(out[k])
            nll = nll + out["nll_sum"].sum()
        # one fetch per epoch: everything stayed on the device until here;
        # under a mesh every data rank's rows, gathered on every rank
        packed = None
        if outs["pred"]:
            with span("eval.fetch"):
                packed = torch.stack([torch.cat(outs[k]).long() for k in outs])
                packed = pmesh.fetch_global(packed, self.mesh, dim=1).cpu().numpy()
                nll = float(pmesh.fetch_global(nll.reshape(1), self.mesh).sum())
        with span("eval.accumulate"):
            if packed is not None:
                acc.update(packed[0], packed[1], packed[2], nll, qidx=packed[3])
            dt = time.time() - t0
            self.log(f"Eval Epoch: {epoch} accuracy: {acc.accuracy:.4f} nll: {acc.mean_nll:.4f} ({acc.n / dt:.0f} q/s)")
            self._beat()
        return {
            "epoch": epoch,
            "val_acc": acc.accuracy,
            "val_nll": acc.mean_nll,
            "val_qps": acc.n / dt if dt > 0 else 0.0,
            "_accumulator": acc,
        }

    def fit(self, epochs: int, eval_every: int = 1, save_every: int = 1, results_dir: Optional[str] = None) -> list:
        for epoch in range(self.epoch + 1, epochs + 1):
            stats = self.train_epoch(epoch)
            if eval_every and epoch % eval_every == 0:
                estats = self.eval_epoch(epoch)
                acc = estats.pop("_accumulator")
                stats.update(estats)
                if results_dir and self.primary:
                    acc.dump(results_dir, tag=f"val_epoch{epoch:03d}")
            if save_every and epoch % save_every == 0:
                self.ckpt.save(self.state, epoch)
                self._beat()
            self.epoch = epoch
            self.history.append(stats)
        return self.history
