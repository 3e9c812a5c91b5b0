"""Micro-batched inference serving of trained RN weights, on the card.

Port of ``rnet/serve.py`` (``InferenceServer``) and of the top-level
``serve.py`` (``main``, ``iter_microbatches``, lines 111-171):

- a bucket ladder of batch shapes (default 1 / 8 / max_batch): each
  micro-batch pads (by repeating its last row, sliced off after) only up to
  the smallest bucket that fits, so a B=1 request pays B=1 compute;
- per-request error isolation: a bad request yields ``{"error": ...}`` in
  its slot and the rest of the batch is served;
- dictionaries come carried by the checkpoint;
- from-pixels images and state-description scenes serve through one entry.

``answer()`` is encode, then ``serve_samples()`` on the encoded samples; the
second half is callable alone (``chip_smoke.py`` drives the batching and
bucket code with samples it made, without Pillow).

CLI (stdout is pure JSON lines, one per request; everything else goes to
stderr)::

    echo '{"image": "img.png", "question": "what color is the cube?"}' \\
        | python -m rnet_torch.serve --model original-fp --checkpoint w.pkl

Runs on CUDA unless ``--platform cpu`` (``device="cpu"``) is given. On CUDA
each bucket's forward, argmax and gather is one CUDA graph (rnet jits them
as one program per bucket): ``warmup()`` captures every bucket, and a
served batch is copied into its bucket's buffers, replayed and fetched
once (``rnet_torch/train/graphs.py``; ``cuda_graphs=False`` runs the same
function eagerly, for comparing the two). ``--rl-impl pallas_int8`` serves
through the int8 kernel (the model runs in eval mode), calibrating the int8
scales on each served batch, inside the graph.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import select
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .checkpoint import load_weights
from .config import ModelConfig
from .data.clevr import ImageTransform, scene_to_objects
from .data.vocab import Dictionaries, invert_questions
from .models import RN
from .train.graphs import StepGraphs, shape_key


class ServeError(ValueError):
    """A single request is unservable; the message is the client-facing
    explanation. Raised by encode() and isolated per request by answer()."""


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; pass "
            "device='cpu' (CLI: --platform cpu) to run on the CPU"
        )
    return dev


def _default_buckets(max_batch: int) -> tuple:
    return tuple(sorted({b for b in (1, 8, max_batch) if b <= max_batch}))


class InferenceServer:
    """Micro-batched RN inference over a bucket ladder of batch shapes.

    Weights come from ``load()`` (a weights-only pkl exported by either
    package) or ``init_weights(seed)``; serving before either raises.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        dicts: Dictionaries,
        *,
        invert: bool = True,
        max_batch: int = 64,
        buckets: Optional[Sequence[int]] = None,
        device="cuda",
        cuda_graphs: bool = True,
    ):
        self.device = resolve_device(device)
        self.graphs = StepGraphs(self.device) if cuda_graphs and self.device.type == "cuda" else None
        self.cfg = cfg
        self.dicts = dicts
        self.invert = invert
        self.max_batch = int(max_batch)
        if buckets is None:
            self.buckets = _default_buckets(self.max_batch)
        else:
            bs = sorted({int(b) for b in buckets if 0 < int(b) <= self.max_batch})
            self.buckets = tuple(bs) if bs else (self.max_batch,)
            if self.buckets[-1] != self.max_batch:
                self.buckets = self.buckets + (self.max_batch,)
        self._idx_to_answer = {i: a for a, i in dicts.answer_to_idx.items()}
        self._transform = ImageTransform(cfg.image_size)
        self.model = self._build_model(0)
        self.ready = False

    # ---- weights ----

    def _build_model(self, seed: int) -> RN:
        gen = torch.Generator().manual_seed(seed)
        return RN(self.cfg, self.dicts.vocab_size, generator=gen).eval().to(self.device)

    def load(self, checkpoint: str) -> None:
        """Load a weights-only pkl, validated against this config's skeleton."""
        load_weights(self.model, checkpoint)
        self._new_weights()

    def init_weights(self, seed: int) -> None:
        """Serve torch-default random weights drawn from ``seed``."""
        self.model = self._build_model(seed)
        self._new_weights()

    def _new_weights(self) -> None:
        if self.graphs is not None:
            self.graphs.clear()  # captured against the old weights
        self.ready = True

    def _require_weights(self) -> None:
        if not self.ready:
            raise RuntimeError("load() a checkpoint (or init_weights()) before serving")

    def _dummy_batch(self, batch: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        out = {"question": np.ones((batch, cfg.question_max_len), np.int32)}
        if cfg.state_description:
            out["inputs"] = np.zeros((batch, cfg.max_objects, cfg.object_dim), np.float32)
        else:
            out["inputs"] = np.zeros((batch, cfg.image_size, cfg.image_size, 3), np.uint8)
        return out

    # ---- request encoding ----

    def encode(self, request: Dict) -> Dict[str, np.ndarray]:
        """One request -> model-ready sample, or ServeError with a
        client-facing message.

        from-pixels: {"image": <png path>, "question": str}
        state-description: {"objects": [scene objects...], "question": str}
        """
        if not isinstance(request, dict):
            raise ServeError(f"request must be a JSON object, got {type(request).__name__}")
        question = request.get("question")
        if not isinstance(question, str) or not question.strip():
            raise ServeError("missing or empty 'question' field (string required)")
        try:
            q = self.dicts.encode_question(question, self.cfg.question_max_len)
        except KeyError as e:
            raise ServeError(
                f"out-of-vocabulary question word {e.args[0]!r} rejected under "
                "oov='error' (reference tokenizer semantics); restart with "
                "--oov unk or --oov drop to serve unknown words"
            ) from None
        if not q.any():
            raise ServeError("question has no in-vocabulary words after tokenization")
        out = {"question": q}
        if self.cfg.state_description:
            objects = request.get("objects")
            if not isinstance(objects, list) or not objects:
                raise ServeError("missing or empty 'objects' list (state-description model)")
            try:
                out["objects"] = scene_to_objects(objects, self.cfg.max_objects, self.cfg.object_dim)
            except Exception as e:
                raise ServeError(f"bad scene objects: {e}") from None
        else:
            path = request.get("image")
            if not isinstance(path, str):
                raise ServeError("missing or non-string 'image' field (from-pixels model)")
            from PIL import Image

            try:
                with Image.open(path) as im:
                    out["image"] = self._transform(im)
            except FileNotFoundError:
                raise ServeError(f"image file not found: {path!r}") from None
            except Exception as e:
                raise ServeError(f"cannot read image {path!r}: {e}") from None
        return out

    # ---- serving ----

    @torch.inference_mode()
    def log_probs(self, inputs: np.ndarray, question: np.ndarray) -> torch.Tensor:
        """(B, n_answers) fp32 log-probs on the device for an encoded batch
        (question ids already inverted if the server inverts)."""
        x = torch.from_numpy(np.ascontiguousarray(inputs)).to(self.device)
        q = torch.from_numpy(np.ascontiguousarray(question)).to(self.device)
        return self.model(x, q)

    @torch.no_grad()
    def _predict_body(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Forward, argmax and the argmax's log-prob, as one (B, 2) float64
        tensor (exact for both), so that one fetch brings both."""
        logp = self.model(b["inputs"], b["question"])
        best = logp.argmax(dim=-1)
        return torch.stack([best.double(), logp.gather(1, best[:, None])[:, 0].double()], dim=1)

    def _predict(self, inputs: np.ndarray, question: np.ndarray):
        """(answer indices, their log-probs) of one bucket-shaped batch: the
        bucket's graph replayed (captured at its first batch), or the same
        function eagerly without graphs."""
        b = {"inputs": torch.from_numpy(np.ascontiguousarray(inputs)),
             "question": torch.from_numpy(np.ascontiguousarray(question))}
        if self.graphs is None:
            out = self._predict_body({k: v.to(self.device) for k, v in b.items()})
        else:
            out = self.graphs.run(("predict", shape_key(b)), self._predict_body, b)
        out = out.cpu().numpy()
        return out[:, 0].astype(np.int64), out[:, 1].astype(np.float32)

    def warmup(self) -> None:
        """Serve every bucket shape once: on CUDA this captures each bucket's
        graph (and builds the kernels), as rnet's warm-up compiles each
        bucket, so the first real request pays none of it."""
        self._require_weights()
        for bucket in self.buckets:
            b = self._dummy_batch(bucket)
            self._predict(b["inputs"], b["question"])

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def batch_arrays(self, samples: Sequence[Dict[str, np.ndarray]], bucket: int):
        """Stack samples, pad to ``bucket`` by repeating the last one and
        invert the questions: the arrays one bucket-shaped call takes."""
        padded = list(samples) + [samples[-1]] * (bucket - len(samples))
        q = np.stack([s["question"] for s in padded])
        if self.invert:
            q = invert_questions(q)
        key = "objects" if self.cfg.state_description else "image"
        return np.stack([s[key] for s in padded]), q

    def serve_samples(self, samples: Sequence[Dict[str, np.ndarray]]) -> List[Dict]:
        """Encoded samples -> one result dict per sample, in order:
        {"answer", "log_prob", "latency_ms", "batch", "bucket"}. Chunks of up
        to max_batch, each padded only to the smallest bucket that fits."""
        self._require_weights()
        results: List[Dict] = []
        for c0 in range(0, len(samples), self.max_batch):
            chunk = samples[c0 : c0 + self.max_batch]
            n = len(chunk)
            bucket = self._bucket_for(n)
            inputs, q = self.batch_arrays(chunk, bucket)
            t0 = time.perf_counter()
            pred, logp = self._predict(inputs, q)
            ms = (time.perf_counter() - t0) * 1e3
            results += [
                {
                    "answer": self._idx_to_answer[int(pred[k])],
                    "log_prob": float(logp[k]),
                    "latency_ms": ms,
                    "batch": n,
                    "bucket": bucket,
                }
                for k in range(n)
            ]
        return results

    def answer(self, requests: Sequence[Dict]) -> List[Dict]:
        """Micro-batch of requests -> one result dict per request, in order;
        {"error": <client-facing message>} for requests that fail to encode,
        the rest served normally."""
        self._require_weights()
        results: List[Optional[Dict]] = [None] * len(requests)
        slots, samples = [], []
        for i, r in enumerate(requests):
            try:
                samples.append(self.encode(r))
                slots.append(i)
            except ServeError as e:
                results[i] = {"error": str(e)}
            except Exception as e:  # isolation backstop: no request may crash us
                results[i] = {"error": f"{type(e).__name__}: {e}"}
        for i, res in zip(slots, self.serve_samples(samples)):
            results[i] = res
        return results


# ---------------------------------------------------------------------------
# CLI: JSON lines over stdin
# ---------------------------------------------------------------------------


def parse_args(argv=None):
    from .cli import add_common_args

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p, clevr_required=False)
    p.add_argument("--checkpoint", required=True, help="weights-only .pkl export")
    p.add_argument("--checkpoint-dir", default="model")
    p.add_argument(
        "--buckets", default=None,
        help="comma-separated batch shapes, e.g. '1,8,64' (default: 1,8,--batch-size)",
    )
    return p.parse_args(argv)


def main(argv=None) -> int:
    from .cli import config_from_args, device_from_args, load_dicts, refuse_mesh

    args = parse_args(argv)
    refuse_mesh(args, "serving")
    dicts = load_dicts(args, checkpoint=args.checkpoint, checkpoint_dir=args.checkpoint_dir)
    cfg = config_from_args(args, dicts)
    buckets = [int(b) for b in args.buckets.split(",")] if args.buckets else None
    server = InferenceServer(
        cfg, dicts, invert=args.invert, max_batch=args.batch_size, buckets=buckets,
        device=device_from_args(args),
    )
    server.load(args.checkpoint)
    server.warmup()
    print(
        f"ready: {cfg.name} on {server.device} | max batch {args.batch_size} | "
        f"buckets {','.join(map(str, server.buckets))} | {dicts.n_answers} answers",
        file=sys.stderr,
        flush=True,
    )
    for batch_lines in iter_microbatches(args.batch_size):
        out: list = [None] * len(batch_lines)
        parsed = []  # (slot, request)
        for i, line in enumerate(batch_lines):
            try:
                parsed.append((i, json.loads(line)))
            except ValueError as e:
                out[i] = {"error": f"malformed JSON: {e}"}
        for (i, _), res in zip(parsed, server.answer([r for _, r in parsed])):
            out[i] = res
        for res in out:
            print(json.dumps(res), flush=True)
    return 0


def iter_microbatches(max_batch: int):
    """Yield lists of non-empty request lines: one blocking read for the
    first, then whatever the client has already written, up to max_batch.

    Reads the stdin fd raw (os.read + own line splitting): a buffered reader
    would slurp a pipelined burst into its read-ahead buffer, select() would
    then report the fd empty, and the burst would serve as B=1 batches."""
    try:
        fd = sys.stdin.fileno()
        select.select([fd], [], [], 0)
    except (OSError, ValueError, AttributeError, io.UnsupportedOperation):
        # not an OS pipe (e.g. an in-memory stream): group greedily
        pending = [line for line in sys.stdin if line.strip()]
        while pending:
            yield pending[:max_batch]
            pending = pending[max_batch:]
        return

    buf = b""
    lines: list = []
    eof = False

    def take_complete_lines():
        nonlocal buf
        while len(lines) < max_batch and b"\n" in buf:
            raw, buf = buf.split(b"\n", 1)
            if raw.strip():
                lines.append(raw.decode("utf-8", "replace"))

    while True:
        take_complete_lines()
        if len(lines) >= max_batch:
            yield lines[:max_batch]
            lines = lines[max_batch:]
            continue
        if eof:
            if buf.strip():  # final line without trailing newline
                lines.append(buf.decode("utf-8", "replace"))
                buf = b""
            if lines:
                yield lines
                lines = []
            return
        if lines:
            # batch has room: take what is already there, never block while
            # holding pending requests
            r, _, _ = select.select([fd], [], [], 0)
            if not r:
                yield lines
                lines = []
                continue
        chunk = os.read(fd, 1 << 16)
        if not chunk:
            eof = True
        else:
            buf += chunk


if __name__ == "__main__":
    sys.exit(main())
