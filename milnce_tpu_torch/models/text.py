"""Sentence tower: frozen word table -> fc1 -> ReLU -> max over words -> fc2
(port of ``milnce_tpu/models/text.py``).

The table is frozen (``requires_grad=False``; the JAX tower uses
``stop_gradient``), so the optimizer never sees it.  The max over the
word axis includes pad positions (id 0), exactly like the reference's
``th.max(x, dim=1)`` (s3dg.py:202): row 0 of the table takes part.
"""

from __future__ import annotations

import torch
from torch import nn


class SentenceEmbedding(nn.Module):
    def __init__(self, embd_dim: int = 512, vocab_size: int = 66250,
                 word_embedding_dim: int = 300, hidden_dim: int = 2048):
        super().__init__()
        self.word_embd = nn.Embedding(vocab_size, word_embedding_dim)
        self.word_embd.weight.requires_grad_(False)
        self.fc1 = nn.Linear(word_embedding_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, embd_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, max_words) int -> (B, embd_dim)."""
        x = torch.relu(self.fc1(self.word_embd(tokens)))
        return self.fc2(x.amax(dim=1))
