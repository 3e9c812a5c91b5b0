"""RN: the composition root (from-pixels / state-description switch).

Port of ``rnet/models/rn.py`` (``extract`` gives the g-prefix retrieval
features of ``ir`` models; ``int8_clip_report`` is the ``pallas_int8``
drift diagnostic):
  * from-pixels: uint8 (B, S, S, 3) -> cast to the compute dtype, then /255
    (in that order, as rnet does) -> ConvInputModel -> (B, g, g, C) flattened
    row-major over (row, col) to (B, g^2, C), each object tagged with its
    grid coordinate (cx, cy), cy varying over rows;
  * state-description: objects (B, n, object_dim) straight from the request.
Then the question LSTM and the RelationalLayer give (B, n_answers) log-probs.

Padded images (S > image_size, the cached pipeline's canvases) are cropped
before the cast: at random with per-group offsets in train mode with
``device_augment``, else at the centre ((S - image_size) // 2). In train mode
with ``device_augment`` the images are then rotated by a random small angle
(``rnet_torch/data/augment.py``, in the compute dtype). ``augmented=True``
says the inputs already went through the fused augment kernel
(``rnet_torch/kernels/augment.py``): they go straight to the conv.

``module.train()`` selects the training forward: BatchNorm batch statistics,
f_phi dropout, pair dropout and the augmentation, with every random draw
from the ``generator`` passed to ``forward`` (crop offsets, then angles,
then the relational layer's draws).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..data.augment import center_crop_batch, random_crop_batch, random_rotate_batch
from ..parallel.mesh import Mesh
from .conv import ConvInputModel
from .relational import RelationalLayer
from .text import QuestionEmbedModel

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {cfg.compute_dtype!r}") from None


def grid_coords(g: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(g*g, 2) coordinate tags in [-1, 1], row-major [(cx, cy)] order."""
    lin = torch.linspace(-1.0, 1.0, g, dtype=dtype, device=device)
    cy, cx = torch.meshgrid(lin, lin, indexing="ij")  # cy varies over rows
    return torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)


class RN(nn.Module):
    """Weights from ``generator`` (a seed-0 generator if None) until a
    checkpoint is loaded over them. Under a ``mesh``
    (``rnet_torch/parallel/mesh.py``) inputs are this rank's ``data`` slice
    of the batch: the BatchNorms take global-batch moments, the relational
    layer splits its pairs over ``pairs``, and every random draw is made at
    the global batch, this rank keeping its rows."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.mesh = mesh
        if not cfg.state_description:
            self.conv = ConvInputModel(
                channels=cfg.conv_channels, kernel=cfg.conv_kernel,
                stride=cfg.conv_stride, dtype=self.dtype, generator=gen, mesh=mesh,
            )
        self.text = QuestionEmbedModel(
            vocab_size=vocab_size, emb_dim=cfg.lstm_word_emb, hidden=cfg.lstm_hidden,
            mask_pads=cfg.lstm_mask_pads, generator=gen,
        )
        self.relational = RelationalLayer(
            obj_dim=cfg.obj_feat_dim, q_dim=cfg.lstm_hidden, g_layers=cfg.g_layers,
            f_layers=cfg.f_layers, n_answers=cfg.n_answers,
            question_injection_position=cfg.question_injection_position,
            dropout=cfg.dropout, pair_dropout=cfg.pair_dropout,
            pair_pool=cfg.pair_pool, object_mask=cfg.object_mask,
            impl=cfg.rl_impl, dtype=self.dtype, generator=gen, mesh=mesh,
        )

    def objects(self, inputs: torch.Tensor, generator: Optional[torch.Generator] = None,
                augmented: bool = False) -> torch.Tensor:
        cfg = self.cfg
        if cfg.state_description:
            return inputs
        x = inputs
        if augmented:
            return self._grid_objects(x)
        augment = self.training and cfg.device_augment
        if augment and generator is None:
            raise ValueError("device_augment in train mode needs a torch.Generator on the input's device")
        if x.shape[1] > cfg.image_size:
            if augment:
                x = random_crop_batch(x, generator, cfg.image_size, mesh=self.mesh)
            else:
                x = center_crop_batch(x, cfg.image_size)
        if x.shape[1] != cfg.image_size or x.shape[2] != cfg.image_size:
            raise ValueError(
                f"expected (B, {cfg.image_size}, {cfg.image_size}, 3) images or a larger "
                f"square canvas, got {tuple(inputs.shape)}"
            )
        if x.dtype == torch.uint8:
            x = x.to(self.dtype) / 255.0
        if augment:
            x = random_rotate_batch(x, generator, mesh=self.mesh)
        return self._grid_objects(x)

    def _grid_objects(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.conv(x)  # (B, g, g, C)
        B, g, _, C = feats.shape
        objs = feats.reshape(B, g * g, C)
        coords = grid_coords(g, dtype=objs.dtype, device=objs.device)
        return torch.cat([objs, coords[None].expand(B, g * g, 2)], dim=-1)

    def forward(
        self,
        inputs: torch.Tensor,  # (B,S,S,3) image or (B,n,obj_dim) objects
        question: torch.Tensor,  # (B, T) integer token ids
        n_objects: Optional[torch.Tensor] = None,  # (B,) SD real-object counts
        generator: Optional[torch.Generator] = None,  # train-mode random draws
        augmented: bool = False,  # inputs already cropped/rotated/normalized
    ) -> torch.Tensor:
        objects = self.objects(inputs, generator, augmented)
        return self.relational(objects, self.text(question), n_objects=n_objects, generator=generator)

    @torch.no_grad()
    def extract(self, inputs: torch.Tensor) -> torch.Tensor:
        """g-prefix relational features for image retrieval (ir-* models;
        ``RelationalLayer.g_prefix_features``), with the objects computed in
        eval mode: BatchNorm running statistics, a larger canvas centre-
        cropped, no augmentation; no question. (B, H) fp32."""
        was_training = self.training
        self.eval()
        try:
            return self.relational.g_prefix_features(self.objects(inputs))
        finally:
            self.train(was_training)

    @torch.no_grad()
    def int8_clip_report(self, inputs: torch.Tensor, question: torch.Tensor) -> torch.Tensor:
        """(L-1,) int8 calibration clip fractions on a live batch, with the
        objects computed in eval mode (``RelationalLayer.int8_clip_report``)."""
        was_training = self.training
        self.eval()
        try:
            return self.relational.int8_clip_report(self.objects(inputs), self.text(question))
        finally:
            self.train(was_training)
