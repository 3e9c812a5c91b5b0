"""Steps captured in CUDA graphs and replayed: the port's compiled dispatch.

rnet never runs a step op by op from Python: ``jax.jit`` traces a step once
per shape and every later call dispatches the compiled program
(``make_jitted_steps``, ``make_chunked_steps``, the server's per-bucket
``_predict``). The counterpart here is ``torch.cuda.CUDAGraph``: a step
function is captured at its first call for a shape key and every later call
replays the graph, one launch from the host for the whole step.

A ``StepGraphs`` holds, per shape key, the graph, its static input buffers
(allocated on the device outside the graph's memory pool) and its outputs.
``run(key, fn, inputs)`` copies ``inputs`` into the key's buffers, replays
and returns copies of the outputs: a graph's own output buffers may be
reused by the next replay of any graph of the pool. Tensors that ``fn``
reads besides its inputs (the parameters, a device image cache, the
per-question data) are read where they lie: they must stay allocated, and
keep their storage, while the graph lives. Capturing a key:

  * ``fn`` runs once on a side stream first (PyTorch's recipe: cuBLAS and
    cuDNN handles and plans, the optimizer's lazy state, the kernels'
    first-use builds and shared-memory limits), then once under capture;
  * a ``rollback`` (for a train step: the parameters, BatchNorm buffers,
    Adam state, generator and step count) is taken before the warm-up and
    put back after the capture, so capturing changes no state: the first
    replay computes what the first eager step would;
  * the generators in ``generators`` are registered with the graph, so each
    replay draws fresh numbers from them, the same numbers an eager run
    from the same generator state draws;
  * the kernels' ``launches`` counters count Python calls of the wrappers,
    and a replay runs no Python. The counters' increments during the
    capture are recorded and added at every replay; the warm-up's and the
    capture's own increments are taken back (the warm-up's work is rolled
    back, and a capture launches nothing).

All graphs of one ``StepGraphs`` share one memory pool. A capture that fails
raises; nothing falls back to eager execution. ``clear()`` frees every graph
(a batch-size change, new weights).

While a ``torch.profiler`` records (``rnet_torch/utils/profiling.py``), a
dispatch is the span ``rn.graph.run``, with CUDA events on the current
stream at its edges, and in it ``rn.graph.copy_in``, ``rn.graph.replay``
(the host call that launches the graph) and ``rn.graph.copy_out``; a
capture is ``rn.graph.capture``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

import torch

from ..kernels import augment as _augment
from ..kernels import embedding as _embedding
from ..kernels import pairwise as _pairwise
from ..utils.profiling import span

# Every kernel wrapper's launch counter (chip_smoke.py's main-path proofs).
COUNTERS = (_pairwise.launches, _augment.launches, _embedding.launches)


class CudaGraphBackend:
    """``torch.cuda.CUDAGraph`` on the current device."""

    def new_pool(self):
        return torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def warmup(self):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            yield
        torch.cuda.current_stream().wait_stream(side)

    def new_graph(self):
        return torch.cuda.CUDAGraph()

    def capture(self, graph, pool, generators: Sequence[torch.Generator]):
        for gen in generators:
            graph.register_generator_state(gen)
        return torch.cuda.graph(graph, pool=pool)

    def replay(self, graph) -> None:
        graph.replay()

    def reserved_bytes(self) -> int:
        """Memory the allocator holds once free blocks are released: what
        graphs' pools hold stays (``torch.cuda.graph`` releases the free
        blocks itself when a capture begins)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


@dataclasses.dataclass
class Captured:
    """One key's graph, its static inputs and outputs, the counters'
    increments of one replay, the capture's seconds and the bytes the pool
    grew by."""

    graph: Any
    inputs: Dict[str, torch.Tensor]
    outputs: Any
    deltas: List[Dict[str, int]]
    capture_s: float
    pool_bytes: int


class StepGraphs:
    """Captured step functions per shape key, sharing one memory pool.

    ``rollback``: an object with ``snapshot()`` and ``restore(snap)``, or
    None for functions that change no state (eval, serving). ``backend``
    stands in for ``CudaGraphBackend`` (the tests' fake capture)."""

    def __init__(
        self,
        device,
        *,
        generators: Sequence[torch.Generator] = (),
        rollback=None,
        counters: Sequence[Dict[str, int]] = COUNTERS,
        backend=None,
    ):
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.rollback = rollback
        self.counters = tuple(counters)
        self.backend = backend if backend is not None else CudaGraphBackend()
        self._pool = None
        self.captured: Dict[Hashable, Captured] = {}

    def clear(self) -> None:
        """Free every graph and the pool they share."""
        self.captured.clear()
        self._pool = None

    def run(self, key: Hashable, fn: Callable[[Dict[str, torch.Tensor]], Any], inputs: Dict[str, torch.Tensor]):
        """``fn(inputs)`` by replay of the graph captured for ``key`` (captured
        now if there is none); returns copies of its outputs."""
        c = self.captured.get(key)
        if c is None:
            c = self.captured[key] = self._capture(fn, inputs)
        with span("graph.run", device=self.device.type == "cuda"):
            with span("graph.copy_in"):
                for name, t in inputs.items():
                    c.inputs[name].copy_(t)
            with span("graph.replay"):
                self.backend.replay(c.graph)
            for counter, delta in zip(self.counters, c.deltas):
                for name, d in delta.items():
                    counter[name] += d
            with span("graph.copy_out"):
                return _tree_map(torch.clone, c.outputs)

    def _capture(self, fn, inputs) -> Captured:
        with span("graph.capture"):
            static = {k: torch.empty(t.shape, dtype=t.dtype, device=self.device).copy_(t)
                      for k, t in inputs.items()}
            before = [dict(c) for c in self.counters]
            snap = self.rollback.snapshot() if self.rollback is not None else None
            try:
                with self.backend.warmup():  # one run: a chunk's is already its K steps
                    fn(static)
                if self._pool is None:
                    self._pool = self.backend.new_pool()
                graph = self.backend.new_graph()
                at_capture = [dict(c) for c in self.counters]
                reserved = self.backend.reserved_bytes()
                t0 = time.perf_counter()
                with self.backend.capture(graph, self._pool, self.generators):
                    outputs = fn(static)
                capture_s = time.perf_counter() - t0
                pool_bytes = self.backend.reserved_bytes() - reserved
                deltas = [{n: c[n] - a.get(n, 0) for n in c if c[n] != a.get(n, 0)}
                          for c, a in zip(self.counters, at_capture)]
            finally:
                for c, b in zip(self.counters, before):
                    c.clear()
                    c.update(b)
                if snap is not None:
                    self.rollback.restore(snap)
            return Captured(graph, static, outputs, deltas, capture_s, pool_bytes)


def tensor_key(t: Optional[torch.Tensor]) -> Hashable:
    """What a graph that reads ``t`` in place depends on: its storage, shape
    and dtype."""
    if t is None:
        return None
    return (t.data_ptr(), tuple(t.shape), t.dtype)


def shape_key(inputs: Dict[str, torch.Tensor]) -> Hashable:
    """What a graph depends on of the inputs it copies: names, shapes, dtypes."""
    return tuple(sorted((k, tuple(t.shape), t.dtype) for k, t in inputs.items()))
