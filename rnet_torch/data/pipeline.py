"""Host input pipeline: fixed-shape numpy batches -> pinned, prefetched device copies.

Port of ``rnet/data/pipeline.py``:
  * ``BatchIterator`` with rnet's exact orders — the epoch shuffle by
    ``random.Random((seed, epoch).__hash__())``, the per-batch rng of
    vectorized datasets and the per-item rng of the others, the padding of a
    short final batch by repeating the first sample of the order with a
    ``valid`` mask and the dataset ``index`` of every row, and question
    inversion — so both packages see the same batches for the same seed
    and epoch;
  * ``prefetch_to_device`` — each batch is staged in pinned host memory and
    copied with ``non_blocking`` on a side stream, double-buffered; the
    consumer's stream waits on the copy's event before it uses the batch.
"""

from __future__ import annotations

import collections
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator

import numpy as np
import torch

from .vocab import invert_questions


def _stack(items, key):
    return np.stack([it[key] for it in items], axis=0)


class BatchIterator:
    """Yield fixed-shape numpy batches from a dataset.

    With ``drop_last=False`` (eval) the final short batch is padded by
    repeating the first sample of the order, and a boolean ``valid`` mask
    marks the real rows.
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        epoch: int = 0,
        drop_last: bool = True,
        invert: bool = True,
        num_threads: int = 8,
    ):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.drop_last = drop_last
        self.invert = invert
        self.num_threads = num_threads

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def _get(self, i: int) -> Dict[str, np.ndarray]:
        # deterministic per-(seed, epoch, item) augmentation rng
        rng = random.Random((self.seed * 1_000_003 + self.epoch) * 1_000_003 + i)
        return self.ds.__getitem__(i, rng=rng)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.ds)))
        if self.shuffle:
            random.Random((self.seed, self.epoch).__hash__()).shuffle(order)
        vectorized = hasattr(self.ds, "get_batch")
        with ThreadPoolExecutor(self.num_threads) as pool:
            for b in range(len(self)):
                idxs = order[b * self.bs : (b + 1) * self.bs]
                valid = np.zeros((self.bs,), dtype=bool)
                valid[: len(idxs)] = True
                while len(idxs) < self.bs:  # pad the short final batch
                    idxs.append(order[0] if order else 0)
                if vectorized:
                    rng = random.Random((self.seed * 1_000_003 + self.epoch) * 1_000_003 + b)
                    batch = dict(self.ds.get_batch(idxs, rng=rng))
                else:
                    items = list(pool.map(self._get, idxs))
                    batch = {key: _stack(items, key) for key in items[0]}
                if self.invert and "question" in batch:
                    batch["question"] = invert_questions(batch["question"])
                if not self.drop_last:
                    batch["valid"] = valid
                    batch["index"] = np.asarray(idxs, dtype=np.int32)
                yield batch


PREFETCH = 2  # batches in flight: one in use, one being copied


def prefetch_to_device(it: Iterator[Dict[str, np.ndarray]], device) -> Iterator[Dict[str, torch.Tensor]]:
    """Device copies of the batches of ``it``, PREFETCH in flight.

    On CUDA each array is pinned and copied with ``non_blocking`` on a side
    stream; the current stream waits for the copy before the batch is
    yielded, and the tensors are recorded on it so their memory is not
    reused while it still reads them. On the CPU the arrays become tensors.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for batch in it:
            yield {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        return
    copy_stream = torch.cuda.Stream(device)
    pending: collections.deque = collections.deque()

    def hand_over():
        batch, done = pending.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in batch.values():
            t.record_stream(consumer)
        return batch

    for batch in it:
        with torch.cuda.stream(copy_stream):
            dev = {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
                for k, v in batch.items()
            }
            done = torch.cuda.Event()
            done.record(copy_stream)
        pending.append((dev, done))
        if len(pending) >= PREFETCH:
            yield hand_over()
    while pending:
        yield hand_over()
