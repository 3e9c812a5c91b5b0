"""QuestionEmbedModel: word embedding + mask-aware LSTM question encoder.

Port of ``rnet/models/text.py``. Embedding with pad index 0 (pad rows enter
as zero vectors), then an LSTM written as an explicit loop over T: the input
projection is hoisted out of the loop, the gate order is torch's (i, f, g,
o), there is one bias ``b`` (torch's ``bias_ih + bias_hh``), and the
recurrence runs in fp32 whatever the compute dtype. The loop takes its time
slices of the input projection from one ``xg.unbind(1)``: its backward stacks
the T slice gradients once, where each ``xg[:, t]`` would have a select
backward that zero-fills a tensor the size of all of ``xg`` and adds it into
``xg``'s gradient, T times a step.

The embedding is ``weight[tokens] * (tokens != 0)`` on every route. On the
card, in training, its gradient is summed by ``kernels/embedding.py``'s
kernel, which skips the pads, in place of ``index_put_``'s sorted
accumulate; on the CPU and without gradients the plain expression runs.

With ``mask_pads=True`` a pad step carries ``h`` and ``c`` through unchanged,
so the encoding is the state after the last real token, whether the pads
trail or (with inverted questions, the serving default) lead. ``nn.LSTM`` /
cuDNN cannot skip steps per row, hence the loop. ``mask_pads=False`` runs
the recurrence over pad steps too, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.embedding import masked_embedding
from .initializers import embedding_normal, lstm_uniform


class QuestionEmbedModel(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        emb_dim: int = 32,
        hidden: int = 128,
        mask_pads: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.hidden = hidden
        self.mask_pads = mask_pads
        self.embedding = nn.Parameter(embedding_normal((vocab_size, emb_dim), gen))
        self.wx = nn.Parameter(lstm_uniform((emb_dim, 4 * hidden), hidden, gen))
        self.wh = nn.Parameter(lstm_uniform((hidden, 4 * hidden), hidden, gen))
        self.b = nn.Parameter(lstm_uniform((4 * hidden,), hidden, gen))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) integer ids (0 = pad) -> (B, hidden) fp32."""
        B, T = tokens.shape
        tokens = tokens.long()
        mask = tokens != 0  # (B, T)
        x = masked_embedding(self.embedding, tokens, mask)  # (B, T, E)
        xg = torch.addmm(self.b, x.reshape(B * T, -1), self.wx).reshape(B, T, 4 * self.hidden)
        h = torch.zeros(B, self.hidden, device=tokens.device)
        c = torch.zeros_like(h)
        for t, xg_t in enumerate(xg.unbind(1)):
            gates = torch.addmm(xg_t, h, self.wh)
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            if self.mask_pads:
                m = mask[:, t, None]
                h = torch.where(m, h_new, h)
                c = torch.where(m, c_new, c)
            else:
                h, c = h_new, c_new
        return h
