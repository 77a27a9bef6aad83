"""Device meshes and sharding rules of the port: ``sct_gan_tpu/parallel/mesh.py``.

The JAX package is single-controller: one process drives a
``jax.sharding.Mesh`` of devices and GSPMD places the collectives. The port
is SPMD: one process per rank, each with its device, running the same
program on its own shard with explicit collectives (``collectives.py``).
The names and signatures are the JAX ones, so a reader finds the
counterpart:

    "dp" — data parallel: each rank takes its rows of the batch; every mean
           the JAX step takes over the global batch stays global (the train
           step gathers the small per-row outputs), and the parameter
           gradients are summed over dp;
    "mp" — model (tensor) parallel, Megatron-style by ``_MP_RULES``: the
           embedding tables vocab-parallel, q/k/v and ``linear1``
           column-parallel, ``out_proj`` and ``linear2`` row-parallel, the
           LM head column-parallel with a vocab-parallel log-sum-exp.

A ``Mesh`` is built on ``torch.distributed.device_mesh.init_device_mesh``
once a process group is initialised (``init_process_group`` with the
address, world size and rank given by the caller). Without one,
``make_mesh()`` is the 1 × 1 mesh of one device, which runs no collective.
A mesh of more than one rank without an initialised world raises, and so
does a mesh on a CUDA device without a card: nothing falls back to the CPU
or to one rank.
"""
from __future__ import annotations

import collections
import gc
import sys
from dataclasses import dataclass
from typing import Any, Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import resolve_device
from .collectives import SINGLE, Axis


@dataclass
class Mesh:
    """This rank's view of a mesh: the dim names, one ``Axis`` (process
    group, this rank's index, size) per dim, and the rank's device."""

    axis_names: Tuple[str, ...]
    axes: Dict[str, Axis]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {n: self.axes[n].size for n in self.axis_names}

    def axis(self, name: str) -> Axis:
        """The named dim, or a size-1 axis when the mesh has no such dim."""
        return self.axes.get(name, SINGLE)


def _rank_device(devices: Optional[Sequence], rank: int) -> torch.device:
    if devices is not None:
        return resolve_device(devices[rank])
    resolve_device("cuda")                  # raises without a card
    return torch.device("cuda", rank % torch.cuda.device_count())


def _build(names: Tuple[str, str], sizes: Tuple[int, int],
           devices: Optional[Sequence]) -> Mesh:
    n = sizes[0] * sizes[1]
    label = f"{sizes[0]}x{sizes[1]}"
    if not (dist.is_available() and dist.is_initialized()):
        if n > 1:
            raise RuntimeError(
                f"mesh {label}: torch.distributed has no initialised world; "
                f"call init_process_group (one process per rank) first")
        return Mesh(names, {nm: SINGLE for nm in names},
                    _rank_device(devices, 0))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n > world:
        raise ValueError(f"mesh {label} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh {label} covers {n} of the world's {world} "
                         f"ranks; a mesh spans the whole world")
    if devices is not None and len(devices) < n:
        raise ValueError(f"mesh {label} needs {n} devices, have "
                         f"{len(devices)}")
    device = _rank_device(devices, rank)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device.type, sizes, mesh_dim_names=names)
    axes = {nm: Axis(dm.get_group(nm), dm.get_local_rank(nm), sz)
            for nm, sz in zip(names, sizes)}
    return Mesh(names, axes, device)


def make_mesh(dp: Optional[int] = None, mp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("dp", "mp") mesh over the world's ranks.

    ``dp=None`` takes every rank mp does not. ``devices``, one per rank
    (``["cpu", "cpu"]``, or ``["cuda:0", "cuda:0"]`` for two ranks sharing
    a card under gloo), defaults to card ``rank % device_count``. Without an
    initialised process group this is the 1 × 1 mesh of one device."""
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if dp is None:
        dp = max(world // mp, 1)
    return _build(("dp", "mp"), (dp, mp), devices)


class NamedSharding(NamedTuple):
    """Where a tensor lives on a mesh: ``spec`` names the mesh dim that
    splits each leading dim (``("dp",)`` rows over dp; ``()`` replicated)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding over dp."""
    return NamedSharding(mesh, ("dp",))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def local_slice(n: int, axis: Axis, what: str = "dimension") -> slice:
    """This rank's contiguous share of ``n`` entries split over ``axis``."""
    if n % axis.size:
        raise ValueError(f"{what} {n} is not divisible by {axis.size} ranks")
    k = n // axis.size
    return slice(axis.rank * k, (axis.rank + 1) * k)


def place(x, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of a host array or tensor, on the mesh's device
    (integer arrays as int64, the model's index type)."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    if not t.is_floating_point() and t.dtype != torch.bool:
        t = t.long()
    for dim, name in enumerate(sharding.spec):
        if name is not None:
            t = t[(slice(None),) * dim + (local_slice(
                t.shape[dim], sharding.mesh.axis(name), "batch"),)]
    return t.to(sharding.mesh.device)


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Every array of the batch as this rank's dp rows on its device.

    Non-array fields (source strings) are dropped: they never reach the
    device. The batch size must divide by dp (the trainer pads to it)."""
    sh = batch_sharding(mesh)
    return {k: place(v, sh) for k, v in batch.items() if _is_array(v)}


def prefetch_to_device(batch_iter: Iterable, mesh: Mesh, size: int = 2,
                       prepare=None, on_oom=None):
    """Double-buffered host → device pipeline of sharded batches.

    Keeps up to ``size`` batches in flight: on a card, each batch's rows are
    copied into pinned host memory and sent on a side stream while the
    device runs the step on the batch before; the step's stream waits on
    the copy's event before it reads a batch.

    ``prepare``: optional host-side transform (augmentation, padding)
    applied before placement. ``on_oom``: called when a placement raises
    ``torch.OutOfMemoryError`` (e.g. to drop queued checkpoint snapshots);
    the placement is then retried once, and if it fails again that batch is
    dropped with a message on stderr and the epoch goes on."""
    cuda = mesh.device.type == "cuda"
    stream = torch.cuda.Stream(mesh.device) if cuda else None
    # this rank's rows, cut on the host before the copy
    host = batch_sharding(Mesh(mesh.axis_names, mesh.axes,
                               torch.device("cpu")))

    def put(batch):
        rows = {k: place(v, host) for k, v in batch.items() if _is_array(v)}
        if not cuda:
            return {k: v.to(mesh.device) for k, v in rows.items()}, None
        with torch.cuda.stream(stream):
            dev = {k: v.pin_memory().to(mesh.device, non_blocking=True)
                   for k, v in rows.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return dev, done

    def attempt(batch):
        try:
            return put(batch)
        except torch.OutOfMemoryError:
            if on_oom is None:
                raise
        on_oom()
        gc.collect()
        try:
            return put(batch)
        except torch.OutOfMemoryError:
            print("prefetch: dropping one batch, device memory still "
                  "exhausted after freeing snapshots", file=sys.stderr,
                  flush=True)
            return None

    def ready(item):
        dev, done = item
        if done is not None:
            current = torch.cuda.current_stream(mesh.device)
            current.wait_event(done)
            for t in dev.values():
                t.record_stream(current)
        return dev

    buf = collections.deque()
    for batch in batch_iter:
        if prepare is not None:
            batch = prepare(batch)
        placed = attempt(batch)
        if placed is None:
            continue
        buf.append(placed)
        if len(buf) > size:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())


# -- model-parallel partition rules -----------------------------------------

# Path substring → partition spec of the parameters sharded over mp, on the
# flax leaf path and the flax shape: kernels are (in_features,
# out_features), embeddings (vocab, d). Only the large matmuls are sharded;
# everything else (LayerNorms, small heads, biases not named) is replicated.
_MP_RULES = (
    # token + AST embedding tables: the vocab axis (vocab-parallel lookup)
    ("embedding/embedding", ("mp", None)),
    ("ast_embedding/embedding", ("mp", None)),
    # FFN: linear1 column-parallel over the hidden axis, linear2 row-
    # parallel on the same axis → one all-reduce per FFN
    ("ffn/linear1/kernel", (None, "mp")),
    ("ffn/linear1/bias", ("mp",)),
    ("ffn/linear2/kernel", ("mp", None)),
    # attention: q/k/v column-parallel over whole heads (nhead % mp == 0),
    # out_proj row-parallel → one all-reduce per attention
    ("q_proj/kernel", (None, "mp")),
    ("q_proj/bias", ("mp",)),
    ("k_proj/kernel", (None, "mp")),
    ("k_proj/bias", ("mp",)),
    ("v_proj/kernel", (None, "mp")),
    ("v_proj/bias", ("mp",)),
    ("out_proj/kernel", ("mp", None)),
    # the LM head over the 50k vocab: column-parallel
    ("output_layer/kernel", (None, "mp")),
)


def param_partition_spec(path: str, value, mesh=None
                         ) -> Tuple[Optional[str], ...]:
    """Partition spec of one parameter (flax leaf path and flax shape), by
    path substring: a tuple naming the mesh dim of each parameter dim, or
    ``()`` for replicated — ``tuple()`` of the JAX ``PartitionSpec``.

    A rule applies only when every named dim divides the parameter's
    dimension: the 50265-row vocab axis does not divide by mp=2 and falls
    back to replication; the padded 50304 rows shard."""
    shape = tuple(value.shape)
    for substr, spec in _MP_RULES:
        if substr in path:
            if len(shape) != len(spec):
                continue
            if mesh is not None:
                ok = all(axis is None
                         or shape[i] % mesh.shape.get(axis, 1) == 0
                         for i, axis in enumerate(spec))
                if not ok:
                    continue
            return spec
    return ()


class _Shape(NamedTuple):
    shape: Tuple[int, ...]


def param_shard_dims(config, mesh: Mesh) -> Dict[str, Optional[int]]:
    """Port parameter name → the dim of its tensor split over mp, or None
    (replicated), for the model of ``config``. A Dense weight is the
    transposed flax kernel, so a kernel's dim ``i`` is the weight's
    ``1 - i``. Every dim is None when mp is 1."""
    from ..convert import _flax_leaves, _meta_model
    shapes = {n: tuple(p.shape)
              for n, p in _meta_model(config).named_parameters()}
    mp = mesh.shape.get("mp", 1)
    dims: Dict[str, Optional[int]] = {}
    for name, (path, transposed) in _flax_leaves(config).items():
        shape = shapes[name]
        flax_shape = shape[::-1] if transposed else shape
        spec = param_partition_spec("/".join(path), _Shape(flax_shape),
                                    mesh)
        dim = None
        if mp > 1 and "mp" in spec:
            i = spec.index("mp")
            dim = len(shape) - 1 - i if transposed else i
        dims[name] = dim
    return dims


def param_shard(t: torch.Tensor, dim: Optional[int], mp: Axis
                ) -> torch.Tensor:
    """This rank's shard (a view) of the whole parameter-shaped ``t``, cut
    along ``dim`` over ``mp`` (``param_shard_dims``); ``t`` when ``dim`` is
    None."""
    if dim is None:
        return t
    n = t.shape[dim] // mp.size
    return t.narrow(dim, mp.rank * n, n)


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh, config
                 ) -> Dict[str, torch.Tensor]:
    """This rank's local shard of each parameter (the port's state dict of
    the model of ``config``), on the mesh's device. With mp == 1 every
    parameter is whole: the single-card and pure-dp placement."""
    dims = param_shard_dims(config, mesh)
    mp = mesh.axis("mp")
    return {name: param_shard(t, dims[name], mp).contiguous().to(mesh.device)
            for name, t in params.items()}
