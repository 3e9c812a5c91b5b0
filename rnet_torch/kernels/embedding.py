"""The question embedding's masked gather and its backward: CUDA kernel
wrapper + plain version.

``QuestionEmbedModel`` computes ``x = weight[tokens] * (tokens != 0)``. The
autograd backward of that expression is ``index_put_(accumulate=True)``,
which sorts the B*T indices and sums each distinct row's duplicates in one
warp, one after another: ~62 % of CLEVR's positions are pads (id 0), so one
warp sums thousands of zero rows a step. rnet has no kernel here (XLA
differentiates its gather as a scatter-add). The kernel of
``rnet_torch/csrc/embedding_bwd.cu`` sums the upstream gradient into the
(V, E) table by token in one pass, skipping the pads, in an order that
``plan`` fixes from the shape alone.

* ``plan`` — (G, W, chunk): G CTAs of W warps, each warp summing ``chunk``
  consecutive positions into a table of its own; None where one warp's
  table does not fit a CTA's shared memory.
* ``embedding_bwd_reference`` — the plain version: the CPU path and the
  oracle of the tests and ``chip_smoke.py``; it adds in the kernel's order,
  so the two agree bit for bit.
* ``embedding_bwd_cuda`` — the wrapper of the kernel; it counts its calls
  in ``launches["embedding_bwd"]``.
* ``masked_embedding`` — the gather for ``QuestionEmbedModel``: on CUDA,
  with gradients on and a table that ``plan`` takes, an autograd Function
  whose forward runs the plain expression and whose backward is the
  kernel; everywhere else (the CPU, ``no_grad`` and inference mode, large
  tables) the plain expression itself.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import build
from .pairwise import SMEM_LIMIT

KERNEL = "embedding_bwd"

CTAS = 132  # at most one CTA per SM of an H100 SXM; a constant, so the order of the adds is the shape's alone
WARPS = 8  # warps a CTA, each with its own table, while W tables fit SMEM_LIMIT
MIN_CHUNK = 16  # fewest positions a warp sums before the batch takes another CTA

# Kernel calls (one per backward) since the last reset_launches()
# (train/graphs.py carries them through replays).
launches: Dict[str, int] = {KERNEL: 0}

_libs = {}


def reset_launches() -> None:
    launches[KERNEL] = 0


def plan(N: int, V: int, E: int) -> Optional[Tuple[int, int, int]]:
    """(G, W, chunk) for N positions into a (V, E) table: warp j = g*W + w
    of the G*W sums positions [j*chunk, (j+1)*chunk), at least MIN_CHUNK
    where N allows, on at most CTAS CTAs. None where one warp's fp32 table
    exceeds SMEM_LIMIT."""
    table = V * E * 4
    if N < 1 or V < 1 or E < 1 or table > SMEM_LIMIT:
        return None
    W = min(WARPS, SMEM_LIMIT // table)
    chunk = math.ceil(N / (W * min(CTAS, math.ceil(N / (W * MIN_CHUNK)))))
    return math.ceil(N / (W * chunk)), W, chunk  # no CTA without positions


def embedding_bwd_reference(dx: torch.Tensor, tokens: torch.Tensor, vocab: int,
                            plan_: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """The (vocab, E) fp32 gradient of ``weight[tokens] * (tokens != 0)``
    given its upstream gradient ``dx`` (tokens.shape + (E,)), summed as the
    kernel sums it for ``plan_`` (default ``plan``'s): each warp's positions
    in order into its own table, ids 0 and outside [1, vocab) skipped, the
    W tables of a CTA added in warp order, the G partials in CTA order."""
    E = dx.shape[-1]
    N = tokens.numel()
    if N == 0:
        return torch.zeros((vocab, E), dtype=torch.float32, device=dx.device)
    G, W, chunk = plan_ if plan_ is not None else (plan(N, vocab, E) or (1, 1, N))
    J = G * W
    tok = tokens.reshape(N).long()
    rows = torch.full((J * chunk,), vocab, dtype=torch.long, device=dx.device)  # row `vocab`: skipped
    rows[:N] = torch.where((tok > 0) & (tok < vocab), tok, vocab)
    vals = torch.zeros((J * chunk, E), dtype=torch.float32, device=dx.device)
    vals[:N] = dx.reshape(N, E).float()
    rows, vals = rows.view(J, chunk), vals.view(J, chunk, E)
    tables = torch.zeros((J, vocab + 1, E), dtype=torch.float32, device=dx.device)
    warp = torch.arange(J, device=dx.device)
    for k in range(chunk):  # step k of every warp at once: one row a warp, so no two adds meet
        tables[warp, rows[:, k]] = tables[warp, rows[:, k]] + vals[:, k]
    tables = tables.view(G, W, vocab + 1, E)[:, :, :vocab]
    part = tables[:, 0]
    for w in range(1, W):
        part = part + tables[:, w]
    out = part[0].clone()
    for g in range(1, G):
        out = out + part[g]
    return out


def _kernel_lib() -> ctypes.CDLL:
    lib = _libs.get(KERNEL)
    if lib is None:
        lib = build.load(KERNEL)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rnet_embedding_bwd.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, vp]
        lib.rnet_embedding_bwd.restype = i32
        lib.rnet_cuda_error_string.argtypes = [i32]
        lib.rnet_cuda_error_string.restype = ctypes.c_char_p
        _libs[KERNEL] = lib
    return lib


def embedding_bwd_cuda(dx: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """Launch the kernel on the current stream: the (vocab, E) fp32
    gradient, bit for bit ``embedding_bwd_reference``'s. Raises on CPU
    tensors, on other dtypes or shapes, on a table ``plan`` does not take,
    and on a failed build or launch."""
    E = dx.shape[-1]
    if dx.dtype != torch.float32 or tokens.dtype != torch.int64:
        raise ValueError(f"embedding_bwd kernel takes fp32 dx and int64 tokens; got {dx.dtype}, {tokens.dtype}")
    if tuple(dx.shape[:-1]) != tuple(tokens.shape):
        raise ValueError(f"dx must be tokens.shape + (E,); got {tuple(dx.shape)} and {tuple(tokens.shape)}")
    dev = dx.device
    if dev.type != "cuda" or tokens.device != dev:
        raise ValueError(f"embedding_bwd kernel takes CUDA tensors on one device; got {dev} and {tokens.device}")
    N = tokens.numel()
    if N == 0:
        return torch.zeros((vocab, E), dtype=torch.float32, device=dev)
    p = plan(N, vocab, E)
    if p is None:
        raise ValueError(f"embedding_bwd kernel: a ({vocab}, {E}) fp32 table does not fit {SMEM_LIMIT} B of "
                         f"shared memory")
    G, W, chunk = p
    dx, tokens = dx.contiguous(), tokens.contiguous()
    partials = torch.empty((G, vocab, E), dtype=torch.float32, device=dev)
    grad = torch.empty((vocab, E), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_embedding_bwd(dx.data_ptr(), tokens.data_ptr(), partials.data_ptr(), grad.data_ptr(), N,
                                     vocab, E, G, W, chunk, stream)
    if err != 0:
        msg = lib.rnet_cuda_error_string(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} ({msg})")
    launches[KERNEL] += 1
    return grad


def embedding_bwd(dx: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if dx.device.type == "cpu":
        return embedding_bwd_reference(dx, tokens, vocab)
    return embedding_bwd_cuda(dx, tokens, vocab)


class _MaskedGather(torch.autograd.Function):
    """``weight[tokens] * mask[..., None]``, differentiated in ``weight``
    alone by ``embedding_bwd``; saves only ``tokens``."""

    @staticmethod
    def forward(ctx, weight, tokens, mask):
        ctx.save_for_backward(tokens)
        ctx.vocab = weight.shape[0]
        return weight[tokens] * mask[..., None]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        return embedding_bwd(g, tokens, ctx.vocab), None, None


def takes_kernel(weight: torch.Tensor) -> bool:
    """Whether ``masked_embedding`` differentiates through the kernel: a
    CUDA fp32 table that needs its gradient, with gradients on, small
    enough for one warp's shared memory (``plan``'s condition)."""
    return (weight.device.type == "cuda" and weight.dtype == torch.float32 and weight.requires_grad
            and torch.is_grad_enabled() and weight.numel() * 4 <= SMEM_LIMIT)


def masked_embedding(weight: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``weight[tokens] * mask[..., None]`` with (tokens int64, mask =
    tokens != 0): the same values on every route; on the card in training
    its backward is the kernel's."""
    if takes_kernel(weight):
        return _MaskedGather.apply(weight, tokens, mask)
    return weight[tokens] * mask[..., None]
