"""Sequence (context) parallelism of the port: ``sct_gan_tpu/parallel/sequence.py``.

The reference caps contracts at L=1024 and is dense O(L²); this is the
scaling hook beyond that cap. Each rank of an ("sp") mesh axis encodes
S/sp consecutive tokens of every contract:

  * token and AST embedding, LayerNorm, FFN and the fusion MLP run on the
    rank's tokens alone; the positional table is read at the shard's offset
    (``SmartContractTransformer._embed``);
  * every attention of the encode path keeps Q local and all-gathers K, V
    and the key mask over the axis (``MultiheadAttention`` under
    ``shards.sp``): the flash kernel then runs S/sp queries against all S
    keys, and under autograd the backward pair at Sk = S;
  * the gradient of a gather is a reduce-scatter (``collectives.
    gather_seq``), so the same path trains: the parameter gradients of the
    ranks sum to the single-card gradient.

The JAX package runs the encode inside one ``shard_map``; here each rank
runs it on its shard (one process per rank). Memory per rank is O(S/sp)
except inside one attention, where the gathered K/V is O(S): 2·B·S·d per
layer instead of the dense B·H·S² scores.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .collectives import all_gather
from .mesh import Mesh, _build, local_slice


def make_sp_mesh(sp: Optional[int] = None, dp: int = 1,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A ("dp", "sp") mesh: batch over dp, sequence over sp.

    ``sp=None`` takes every rank dp does not. Parameters are whole on every
    rank (the win of sp is activation memory and attention bandwidth, not
    parameter storage). Without an initialised process group this is the
    1 × 1 mesh of one device."""
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if sp is None:
        sp = max(world // dp, 1)
    return _build(("dp", "sp"), (dp, sp), devices)


def _local(t, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's (dp rows, sp columns) of a (B, S) host or device array."""
    t = torch.as_tensor(t)
    rows = local_slice(t.shape[0], mesh.axis("dp"), "batch")
    cols = local_slice(t.shape[1], mesh.axis(axis), "sequence length")
    return t[rows, cols].long().to(mesh.device)


def sp_encode(model, input_ids, attention_mask, ast_input_ids,
              ast_attention_mask, mesh: Mesh, *, axis: str = "sp",
              max_length: Optional[int] = None) -> torch.Tensor:
    """Sequence-parallel ``model.encode``: this rank's shard of the fused
    memory, (B/dp, S/sp, d), rows over dp and the sequence over ``axis``.

    The inputs are the whole (B, S) arrays (host or device); each rank takes
    its shard. ``model`` is the plain SmartContractTransformer with whole
    weights on the mesh's device (the JAX signature's ``params`` are the
    model's own here); its parameters do not depend on S, so the same
    weights encode any length: past the model's ``max_length`` the
    positional table is built up to ``max(max_length, S)`` (quality beyond
    the trained length is the caller's problem; the mechanics are exact).
    The encode is deterministic (eval mode), as the JAX one is, and
    differentiable. S must divide by the axis size and B by dp."""
    sp = mesh.axis(axis)
    b, s = tuple(torch.as_tensor(input_ids).shape)
    if s % sp.size:
        raise ValueError(f"sequence length {s} not divisible by "
                         f"{axis}={sp.size}")
    pe = None
    length = max(int(max_length or model.config.max_length), s)
    if length > model._pe.shape[0]:
        from ..models.layers import sinusoidal_position_encoding
        pe = sinusoidal_position_encoding(length, model.config.d_model).to(
            model._pe.device)
    args = [_local(t, mesh, axis) for t in (input_ids, attention_mask,
                                            ast_input_ids,
                                            ast_attention_mask)]
    training = model.training
    model.eval()
    try:
        with model.sequence_parallel(sp, pe):
            return model.encode(*args)
    finally:
        model.train(training)


def _whole_memory(memory: torch.Tensor, mesh: Mesh, axis: str
                  ) -> torch.Tensor:
    """(B/dp, S/sp, d) shards → the whole (B, S, d) on every rank."""
    seq = all_gather(memory.transpose(0, 1), mesh.axis(axis))  # (S, B/dp, d)
    return all_gather(seq.transpose(0, 1), mesh.axis("dp"))


@torch.no_grad()
def sp_detect(model, batch: Dict, mesh: Mesh, *, axis: str = "sp",
              max_length: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Long-context detection forward: the sequence-parallel encode, then
    the memory all-gathered (B·S·d in the compute dtype: 50 MB in bf16 at
    B=2, S=16384, d=768) and the contract and line heads run on it whole,
    on every rank. Returns (contract_logits, line_logits), f32, as the
    JAX package's GSPMD heads do."""
    memory = sp_encode(model, batch["input_ids"], batch["attention_mask"],
                       batch["ast_input_ids"], batch["ast_attention_mask"],
                       mesh, axis=axis, max_length=max_length)
    memory = _whole_memory(memory, mesh, axis)
    ttl = torch.as_tensor(batch["token_to_line"]).long().to(mesh.device)
    training = model.training
    model.eval()
    try:
        contract_logits, _ = model.contract_head(memory)
        return contract_logits, model.line_head(memory, ttl)
    finally:
        model.train(training)
