"""Embedding lookup: ``sct_gan_tpu/ops/embed.py`` in PyTorch.

The JAX package rewrites the lookup's backward (a ``custom_vjp``: sort the
ids, sum each id's gradient rows once, scatter the sums with sorted
indices), because XLA's default scatter-add of duplicate, unsorted ids
serialises on a TPU. ``F.embedding`` already has that backward on CUDA: it
sorts the ids and reduces each id's rows before it writes the table's
gradient, so no colliding scatter happens. The port's lookup is therefore
``F.embedding`` itself; the forward is the same gather, and the gradient
differs from the JAX one only by the order of the f32 sums within an id.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: a (V, d) table, integer ``ids`` of any shape."""
    return F.embedding(ids.long(), table)
