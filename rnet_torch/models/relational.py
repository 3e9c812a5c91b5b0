"""RelationalLayer: the O(n^2) pairwise g_theta / f_phi core.

Port of ``rnet/models/relational.py``. All ordered object pairs go through
the shared g_theta MLP, with the question joined at layer
``question_injection_position``; the pairs are sum- (or mean-) pooled, then
f_phi and a log-softmax in fp32. Three implementations share one parameter
set (flax layout: ``g{l}_kernel`` (in, out), ``g{l}_bias``, ``f{l}_*``):

  * ``naive``  — literal pair concatenation; the test oracle.
  * ``xla``    — decomposed plain torch: u = x@W[:c], v = x@W[c:2c] and a
      per-sample shift, so the pair tensor exists only as (B, n^2, H)
      activations (the name is kept from rnet for configs and flags).
  * ``pallas`` — ``rnet_torch.kernels.pairwise.fused_pairwise_g``: the
      hand-written CUDA kernels (forward and backward) on the card, their
      plain versions on the CPU. On the card they take the compute dtype
      as it is: bf16 (``csrc/pairwise_fwd.cu``, ``pairwise_bwd.cu``) or fp32
      (``csrc/pairwise_f32.cu``, 3xTF32 products).
  * ``pallas_int8`` — inference only: in eval mode the g-chain runs in int8
      (``fused_pairwise_g(int8=True)``: the int8 kernel on the card, its
      plain version on the CPU; a loud fp fallback on shapes it does not
      take); in train mode it warns and runs ``pallas``.

``auto`` is rnet's rule with "on CUDA" in place of "on TPU": the kernels,
in bf16 or fp32, for n >= 32 objects and uniform g widths that are multiples
of 128 (in fp32: a width and depth the fp32 kernels take, ``f32_supported``),
else ``xla`` (the state-description models' 12 objects). Each forward that
takes ``xla`` counts one ``launches["g_xla"]`` beside the kernels' counts.

In train mode (``module.train()``) f_phi drops its last hidden layer's units
with rate ``dropout`` (inverted, in fp32) and, with ``pair_dropout`` > 0,
whole pairs before the pool: a Bernoulli (B, n^2) mask in the naive/xla
impls, the kernels' own Philox mask (seeded per call) in the pallas impl.
Every random draw comes from the ``generator`` passed to ``forward``, on
the tensors' device.

Under a ``mesh`` (``rnet_torch/parallel/mesh.py``) the inputs are this
rank's ``data`` slice of the batch, and with a ``pairs`` axis each member
computes the pairs of its shard of the i-objects: ``pallas`` through
``pairwise_core_sharded`` (rnet's shard_map island), ``xla`` and ``naive``
on their rows of the pair tensor (rnet's ``constrain_pairs``; the result
equals the unsplit one, as GSPMD's does), their inputs' gradients summed
over the members and their partial pooled sums all-reduced.

``g_prefix_features`` is the retrieval feature of ``ir`` models: the g
layers before the question joins, summed over pairs (plain torch, as rnet's
is plain JAX).
"""

from __future__ import annotations

import math
import warnings
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..kernels.pairwise import XLA_ROUTE, f32_supported, fused_pairwise_g, launches, pairwise_clip_fractions
from ..parallel.mesh import Mesh, global_batch, local_rows, reduce_pairs, replicate_pairs
from .initializers import fan_in_uniform, linear_kernel


def dropout(y: torch.Tensor, rate: float, generator: torch.Generator, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Inverted dropout of single units: where(mask, y / keep, 0) with
    mask ~ Bernoulli(keep = 1 - rate), as rnet's f_phi dropout (under a
    mesh drawn at the global batch, this rank's rows kept)."""
    keep = 1.0 - rate
    u = torch.rand((global_batch(y.shape[0], mesh), *y.shape[1:]), generator=generator, device=y.device)
    return torch.where(local_rows(u, mesh) < keep, y / keep, 0.0)


def pair_dropout(a: torch.Tensor, rate: float, generator: torch.Generator, mesh: Optional[Mesh] = None,
                 n: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout of whole pairs of the (B, ni * n, H) activations of
    n objects (default: all n^2 pairs), in their dtype: a * mask / keep
    with mask ~ Bernoulli(keep) per (b, pair), as rnet's ``_pool``. The
    mask is drawn at the global batch over all n^2 pairs; under a mesh this
    rank keeps its ``data`` rows and the pairs of its ``pairs`` i-rows."""
    keep = 1.0 - rate
    n = n or math.isqrt(a.shape[1])
    u = torch.rand((global_batch(a.shape[0], mesh), n, n), generator=generator, device=a.device)
    u = local_rows(u, mesh)[:, slice(None) if mesh is None else mesh.pair_rows(n)].reshape(a.shape[:2])
    return a * ((u < keep)[..., None].to(a.dtype) / torch.tensor(keep, dtype=a.dtype))


def g_input_dims(obj_dim: int, q_dim: int, g_layers: Tuple[int, ...], inject: int) -> List[int]:
    """Input width of each g layer given the injection position."""
    dims = []
    for l in range(len(g_layers)):
        d = 2 * obj_dim if l == 0 else g_layers[l - 1]
        if l == inject:
            d += q_dim
        dims.append(d)
    return dims


class RelationalLayer(nn.Module):
    def __init__(
        self,
        obj_dim: int,
        q_dim: int,
        g_layers: Tuple[int, ...] = (256, 256, 256, 256),
        f_layers: Tuple[int, ...] = (256, 256),
        n_answers: int = 28,
        question_injection_position: int = 0,
        dropout: float = 0.5,
        pair_dropout: float = 0.0,
        pair_pool: str = "sum",
        object_mask: bool = False,
        impl: str = "auto",
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
        mesh: Optional[Mesh] = None,
    ):
        super().__init__()
        self.mesh = mesh
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        inject = question_injection_position
        if not 0 <= inject < len(g_layers):
            raise ValueError(
                f"question_injection_position {inject} out of range for {len(g_layers)} g layers"
            )
        if pair_pool not in ("sum", "mean"):
            raise ValueError(f"pair_pool must be 'sum' or 'mean', got {pair_pool!r}")
        self.g_layers = tuple(g_layers)
        self.inject = inject
        self.dropout = dropout
        self.pair_dropout = pair_dropout
        self.pair_pool = pair_pool
        self.object_mask = object_mask
        self.impl = impl
        self.dtype = dtype
        g_in = g_input_dims(obj_dim, q_dim, self.g_layers, inject)
        for l, (d_in, width) in enumerate(zip(g_in, self.g_layers)):
            self.register_parameter(f"g{l}_kernel", nn.Parameter(linear_kernel((d_in, width), gen)))
            self.register_parameter(f"g{l}_bias", nn.Parameter(fan_in_uniform((width,), d_in, gen)))
        f_dims = [self.g_layers[-1], *f_layers, n_answers]
        self.n_f = len(f_dims) - 1
        for l, (d_in, width) in enumerate(zip(f_dims[:-1], f_dims[1:])):
            self.register_parameter(f"f{l}_kernel", nn.Parameter(linear_kernel((d_in, width), gen)))
            self.register_parameter(f"f{l}_bias", nn.Parameter(fan_in_uniform((width,), d_in, gen)))

    @property
    def gw(self) -> List[torch.Tensor]:
        return [getattr(self, f"g{l}_kernel") for l in range(len(self.g_layers))]

    @property
    def gb(self) -> List[torch.Tensor]:
        return [getattr(self, f"g{l}_bias") for l in range(len(self.g_layers))]

    # ---- implementation selection ----

    def resolve_impl(self, n: int, device: torch.device) -> str:
        impl = self.impl
        if impl == "auto":
            uniform = len(set(self.g_layers)) == 1 and self.g_layers[0] % 128 == 0
            if self.dtype == torch.float32:  # the fp32 kernels take fewer shapes
                uniform = uniform and f32_supported(self.g_layers[0], len(self.g_layers))
            impl = "pallas" if (n >= 32 and uniform and device.type == "cuda") else "xla"
        if impl not in ("naive", "xla", "pallas", "pallas_int8"):
            raise ValueError(f"unknown relational impl {impl!r}")
        return impl

    # ---- g over all pairs: (B, n, c), (B, h) -> (B, n^2, g_out) acts ----

    # ``gw``, ``gb``: the g layers (default: the parameters); ``rows``: the
    # i-rows of the pairs computed here (all of them, or this rank's shard
    # of a ``pairs`` split); the result is (B, ni * n, g_out).

    def _g_naive(self, x, q, gw=None, gb=None, rows: slice = slice(None)):
        gw, gb = gw or self.gw, gb or self.gb
        B, n, c = x.shape
        xr = x[:, rows]
        ni = xr.shape[1]
        xi = xr[:, :, None, :].expand(B, ni, n, c)  # row i in slot 1
        xj = x[:, None, :, :].expand(B, ni, n, c)  # row j in slot 2
        a = torch.cat([xi, xj], -1).reshape(B, ni * n, 2 * c)
        for l, (w, b) in enumerate(zip(gw, gb)):
            if l == self.inject:
                qb = q[:, None, :].expand(B, ni * n, q.shape[-1])
                a = torch.cat([a, qb.to(a.dtype)], -1)
            a = torch.relu(a @ w.to(a.dtype) + b.to(a.dtype))
        return a

    def _g_xla(self, x, q, gw=None, gb=None, rows: slice = slice(None)):
        gw, gb = gw or self.gw, gb or self.gb
        B, n, c = x.shape
        dt = x.dtype
        w0 = gw[0].to(dt)
        u = x[:, rows] @ w0[:c]  # (B, ni, H0)
        v = x @ w0[c : 2 * c]
        shift0 = gb[0].to(dt)
        if self.inject == 0:
            shift0 = (shift0 + q @ w0[2 * c :])[:, None, None, :]
        a = torch.relu(u[:, :, None, :] + v[:, None, :, :] + shift0).reshape(B, -1, self.g_layers[0])
        for l in range(1, len(gw)):
            w, b = gw[l].to(dt), gb[l].to(dt)
            if l == self.inject:
                h_prev = self.g_layers[l - 1]
                a = torch.relu(a @ w[:h_prev] + (q @ w[h_prev:] + b)[:, None, :])
            else:
                a = torch.relu(a @ w + b)
        return a

    # ---- full forward ----

    def forward(
        self,
        x: torch.Tensor,
        q: torch.Tensor,
        n_objects: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """(B, n, c) objects, (B, h) question -> (B, n_answers) fp32 log-probs.

        In train mode with dropout or pair dropout, ``generator`` (on x's
        device) supplies every random draw."""
        B, n = x.shape[0], x.shape[1]
        impl = self.resolve_impl(n, x.device)
        int8 = impl == "pallas_int8" and not self.training
        if impl == "pallas_int8":
            if self.training:
                # the int8 chain has no backward: an explicit int8 request
                # must not silently train another numeric path
                warnings.warn(
                    "rl_impl='pallas_int8' is inference-only (no VJP); "
                    "training steps run the bf16 pallas kernel instead",
                    stacklevel=2,
                )
            impl = "pallas"
        f_drop = self.training and self.dropout > 0.0
        pair_drop = self.training and self.pair_dropout > 0.0
        if (f_drop or pair_drop) and generator is None:
            raise ValueError("dropout in train mode needs a torch.Generator on the input's device")
        pair_mask = None
        if self.object_mask:
            if n_objects is None:
                raise ValueError(
                    "object_mask=True but the batch has no n_objects — the mask "
                    "needs a state-description dataset"
                )
            if impl == "pallas":
                raise ValueError(
                    "object_mask needs the naive/xla impl (the fused kernel "
                    "pools in-kernel); SD shapes resolve to xla by default"
                )
            valid = torch.arange(n, device=x.device)[None, :] < n_objects.to(x.device)[:, None]
            pair_mask = (valid[:, :, None] & valid[:, None, :]).reshape(B, n * n)
        x = x.to(self.dtype)
        q = q.to(self.dtype)
        if impl == "pallas":
            keep, seed = 1.0, None
            if pair_drop:  # in-kernel inverted pair dropout
                keep = 1.0 - self.pair_dropout
                seed = torch.randint(0, 2**62, (1,), generator=generator, device=x.device)
            pooled = fused_pairwise_g(
                x, q, self.gw, self.gb, inject=self.inject, dtype=self.dtype, pair_keep=keep, seed=seed, int8=int8,
                mesh=self.mesh,
            )
        else:
            # a ``pairs`` split: this rank's i-rows, its inputs' gradients
            # summed over the members, its partial pooled sums all-reduced
            split = self.mesh is not None and self.mesh.size("pairs") > 1
            gw, gb, rows = self.gw, self.gb, slice(None)
            if split:
                L = len(gw)
                x, q, *params = replicate_pairs([x, q, *gw, *gb], self.mesh)
                gw, gb, rows = params[:L], params[L:], self.mesh.pair_rows(n)
            if impl == "xla":
                launches[XLA_ROUTE] += 1
            a = (self._g_naive if impl == "naive" else self._g_xla)(x, q, gw, gb, rows)
            if pair_mask is not None:
                a = a * pair_mask.reshape(B, n, n)[:, rows].reshape(B, -1)[..., None].to(a.dtype)
            if pair_drop:
                a = pair_dropout(a, self.pair_dropout, generator, self.mesh, n)
            pooled = a.sum(dim=1)
            if split:
                pooled = reduce_pairs(pooled, self.mesh)

        y = pooled.float()
        if self.pair_pool == "mean":
            y = y / float(n * n)
        for l in range(self.n_f - 1):
            y = torch.relu(y @ getattr(self, f"f{l}_kernel") + getattr(self, f"f{l}_bias"))
        if f_drop:
            y = dropout(y, self.dropout, generator, self.mesh)
        last = self.n_f - 1
        y = y @ getattr(self, f"f{last}_kernel") + getattr(self, f"f{last}_bias")
        return torch.log_softmax(y, dim=-1)

    def g_prefix_features(self, x: torch.Tensor) -> torch.Tensor:
        """Question-independent g prefix, sum-pooled over pairs; (B,
        g_layers[p-1]) fp32 for injection position p >= 1 (rnet's
        ``g_prefix_features``): u = x W0[:c], v = x W0[c:2c], a_0 = relu(u_i +
        v_j + b0), then layers 1 .. p-1, built as (B, n^2, H) in the compute
        dtype (rounded after every op, as rnet's are) and summed there; the
        sum is then cast to fp32. ValueError at p = 0."""
        inject = self.inject
        if inject < 1:
            raise ValueError("extraction needs question_injection_position >= 1 (an 'ir' model)")
        B, n, c = x.shape
        dt = self.dtype
        x = x.to(dt)
        w0 = self.gw[0].to(dt)
        u = x @ w0[:c]
        v = x @ w0[c : 2 * c]
        a = torch.relu(u[:, :, None, :] + v[:, None, :, :] + self.gb[0].to(dt)).reshape(B, n * n, self.g_layers[0])
        for l in range(1, inject):
            a = torch.relu(a @ self.gw[l].to(dt) + self.gb[l].to(dt))
        return a.sum(dim=1).float()

    def int8_clip_report(self, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """(L-1,) per-layer int8 calibration clip fractions on this batch
        (``pairwise_clip_fractions``; the ``pallas_int8`` eval diagnostic:
        fractions >> 1e-3 mean the calibration margin is being exceeded)."""
        return pairwise_clip_fractions(
            x.to(self.dtype), q.to(self.dtype), self.gw, self.gb, inject=self.inject, dtype=self.dtype
        )
