"""Sentence tower: frozen word table -> fc1 -> ReLU -> max over words -> fc2
(port of ``milnce_tpu/models/text.py``).

The table is frozen (``requires_grad=False``; the JAX tower uses
``stop_gradient``), so the optimizer never sees it.  The max over the
word axis includes pad positions (id 0), exactly like the reference's
``th.max(x, dim=1)`` (s3dg.py:202): row 0 of the table takes part.  A
bf16 model casts the looked-up rows to bf16 (the JAX tower casts the
table, then looks up: the same bits) and runs fc1, ReLU, the max and fc2
in bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from milnce_tpu_torch.models.precision import Dense, cast


class SentenceEmbedding(nn.Module):
    compute_dtype = None

    def __init__(self, embd_dim: int = 512, vocab_size: int = 66250,
                 word_embedding_dim: int = 300, hidden_dim: int = 2048):
        super().__init__()
        self.word_embd = nn.Embedding(vocab_size, word_embedding_dim)
        self.word_embd.weight.requires_grad_(False)
        self.fc1 = Dense(word_embedding_dim, hidden_dim)
        self.fc2 = Dense(hidden_dim, embd_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, max_words) int -> (B, embd_dim)."""
        rows = cast(self.word_embd(tokens), self.compute_dtype)
        x = torch.relu(self.fc1(rows))
        return self.fc2(x.amax(dim=1))
