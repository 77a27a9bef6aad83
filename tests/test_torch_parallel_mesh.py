"""The port's meshes (``sct_gan_tpu_torch/parallel``) against the JAX package's.

  * the package exports the JAX package's names;
  * ``param_partition_spec`` gives JAX's spec for every leaf of the same
    flax tree, at mp = 2 and 4, with the 50265-row vocab (not divisible:
    replicated) and the padded 50304 rows (sharded);
  * ``make_mesh`` without a world is the 1 × 1 mesh and raises for more
    ranks or for a card that is not there; in a gloo world of two it raises
    as JAX does when it is short of devices;
  * ``shard_batch`` gives each rank its rows and drops non-arrays;
    ``prefetch_to_device`` keeps the order, retries once after its OOM
    callback and drops a batch that fails again;
  * the collectives' gradients (gather → reduce-scatter, the replicated-loss
    gather → this rank's slice, Megatron's copy and reduce);
  * the dropout index origins: the plain versions draw, on a shard, the
    slice of the whole tensor's mask (rows over dp, hidden columns over mp,
    attention heads over mp).

One gloo world of two CPU ranks (``torch_parallel_worker.py``); the JAX
side runs here, on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sct_gan_tpu.parallel as jax_parallel
import sct_gan_tpu_torch.parallel as port_parallel
from sct_gan_tpu.config import ModelConfig as JaxConfig
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu.parallel.mesh import \
    param_partition_spec as jax_partition_spec
from sct_gan_tpu_torch import SmartContractTransformer
from sct_gan_tpu_torch.ops.attention import attention_keep, mha_reference
from sct_gan_tpu_torch.ops.dropout import dropout_reference
from sct_gan_tpu_torch.parallel import (make_mesh, param_partition_spec,
                                        prefetch_to_device)
from sct_gan_tpu_torch.parallel import mesh as port_mesh
from sct_gan_tpu_torch.parallel.mesh import param_shard_dims
from test_torch_model import CFG
from torch_parallel_worker import launch


class _Shape:
    """A stand-in mesh: both packages' rules read only ``mesh.shape``."""

    def __init__(self, **shape):
        self.shape = shape


def _jax_leaves(cfg):
    jm = JaxModel(cfg)
    dummy = jnp.zeros((1, cfg.max_length), jnp.int32)
    shapes = jax.eval_shape(lambda k: jm.init(
        {"params": k}, dummy, jnp.ones_like(dummy), dummy,
        jnp.ones_like(dummy), target_ids=dummy, token_to_line=dummy,
        deterministic=True)["params"], jax.random.PRNGKey(0))
    return [("/".join(str(k.key) for k in path), leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(shapes)]


def test_exports_match_jax():
    """``sct_gan_tpu_torch.parallel`` exports what the JAX package's
    ``parallel`` does, each a callable."""
    assert port_parallel.__all__ == jax_parallel.__all__
    assert all(callable(getattr(port_parallel, n))
               for n in jax_parallel.__all__)


@pytest.mark.parametrize("pad", [1, 128])
@pytest.mark.parametrize("mp", [2, 4])
def test_partition_specs_match_jax(pad, mp):
    """Every leaf of the JAX model's tree at the 50265-token vocab: the
    port's spec is JAX's, and the vocab tables replicate unpadded (50265
    rows) and shard padded (50304)."""
    cfg = JaxConfig(d_model=64, nhead=4, num_encoder_layers=1,
                    num_decoder_layers=1, dim_feedforward=128, max_length=16,
                    max_lines=16, vocab_size=50265, use_gan=True,
                    vocab_pad_multiple=pad)
    mesh = _Shape(dp=1, mp=mp)
    leaves = _jax_leaves(cfg)
    for path, leaf in leaves:
        assert param_partition_spec(path, leaf, mesh) == tuple(
            jax_partition_spec(path, leaf, mesh)), path
    emb = dict(leaves)["embedding/embedding"]
    assert emb.shape[0] == (50265 if pad == 1 else 50304)
    want = () if pad == 1 else ("mp", None)
    assert param_partition_spec("embedding/embedding", emb, mesh) == want


def test_shard_dims_follow_the_torch_layout():
    """A flax kernel's (None, "mp") is the torch weight's dim 0; LayerNorms
    and the unnamed biases stay whole."""
    dims = param_shard_dims(CFG, _Shape(dp=1, mp=2))
    layer = "encoder.layer_0."
    assert dims[layer + "self_attn.q_proj.weight"] == 0
    assert dims[layer + "self_attn.q_proj.bias"] == 0
    assert dims[layer + "self_attn.out_proj.weight"] == 1
    assert dims[layer + "self_attn.out_proj.bias"] is None
    assert dims[layer + "ffn.linear1.weight"] == 0
    assert dims[layer + "ffn.linear2.weight"] == 1
    assert dims["embedding.weight"] == 0 and dims["output_layer.weight"] == 0
    assert dims["output_layer.bias"] is None
    assert dims[layer + "norm1.weight"] is None
    assert all(d is None for d in param_shard_dims(
        CFG, _Shape(dp=2, mp=1)).values())


def test_mesh_without_a_world():
    """No process group: make_mesh() is the 1 × 1 mesh; more ranks raise,
    and so does the card's default device when there is no card."""
    mesh = make_mesh(devices=["cpu"])
    assert mesh.shape == {"dp": 1, "mp": 1}
    assert mesh.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no initialised world"):
        make_mesh(dp=2, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh()


def test_prefetch_keeps_order_and_survives_one_oom(monkeypatch):
    """Batches arrive in order, rows on the mesh's device; an OOM calls the
    callback and retries; a batch that fails twice is dropped."""
    mesh = make_mesh(devices=["cpu"])
    batches = [{"x": np.full((2, 3), i), "s": ["a", "b"]} for i in range(5)]
    real = port_mesh.place
    fails = {1: 1, 3: 2}     # batch index -> placements that fail
    calls = []

    def flaky(x, sharding):
        i = int(np.asarray(x).flat[0])
        if fails.get(i, 0) > 0:
            fails[i] -= 1
            raise torch.OutOfMemoryError("test")
        return real(x, sharding)

    monkeypatch.setattr(port_mesh, "place", flaky)
    got = [int(b["x"][0, 0]) for b in prefetch_to_device(
        iter(batches), mesh, on_oom=lambda: calls.append(1))]
    assert got == [0, 1, 2, 4]
    assert len(calls) == 2
    monkeypatch.setattr(port_mesh, "place", real)
    assert [sorted(b) for b in prefetch_to_device(iter(batches), mesh)] == [
        ["x"]] * 5
    fails[0] = 1
    monkeypatch.setattr(port_mesh, "place", flaky)
    with pytest.raises(torch.OutOfMemoryError):      # no callback: raise
        list(prefetch_to_device(iter(batches), mesh))


def test_dropout_origin_slices_the_whole_mask():
    """The plain versions on a shard draw the whole tensor's mask there:
    rows of a (4, 6, 10) tensor from origin b0·60, hidden columns [5, 10)
    with the global row length, and attention heads [2, 4) of 4 over rows
    [1, 3) of the batch."""
    x = torch.randn(4, 6, 10)
    whole = dropout_reference(x, 11, 0.3)
    got = dropout_reference(x[2:], 11, 0.3, origin=2 * 60)
    assert torch.equal(got, whole[2:])
    got = dropout_reference(x[1:3, :, 5:].contiguous(), 11, 0.3,
                            origin=1 * 60 + 5, row_len=10)
    assert torch.equal(got, whole[1:3, :, 5:])
    keep = attention_keep((4, 4, 5, 7), 9, 0.3)
    shard = attention_keep((2, 2, 5, 7), 9, 0.3, drop_shard=(1, 2, 4))
    assert torch.equal(shard, keep[1:3, 2:4])
    q, k, v = (torch.randn(4, 4, 5, 8) for _ in range(3))
    want = mha_reference(q, k, v, dropout_rate=0.3, seed=9)
    got = mha_reference(q[1:3, 2:4], k[1:3, 2:4], v[1:3, 2:4],
                        dropout_rate=0.3, seed=9, drop_shard=(1, 2, 4))
    assert torch.equal(got, want[1:3, 2:4])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = dataclasses.replace(CFG)
    weights = SmartContractTransformer(cfg, seed=0).state_dict()
    outs = launch("mesh", 2, str(tmp_path_factory.mktemp("mesh")), cfg=cfg,
                  weights=weights)
    return cfg, weights, outs


def test_world_mesh_and_short_mesh(world):
    """Two ranks: a dp=2 mesh with each rank's coordinate; a 4 × 1 mesh is
    short of devices (JAX's message) and a 1 × 1 mesh leaves a rank out."""
    _, _, outs = world
    for r, out in enumerate(outs):
        assert out["shape"] == {"dp": 2, "mp": 1}
        assert out["dp_rank"] == r
        assert out["error_4x1"] == "mesh 4x1 needs 4 devices, have 2"
        assert "covers 1 of the world's 2" in out["error_1x1"]


def test_world_shard_batch(world):
    """Each rank's rows, integers as int64, strings dropped."""
    _, _, outs = world
    whole = np.arange(8).reshape(4, 2)
    for r, out in enumerate(outs):
        assert out["batch_keys"] == ["a", "f"]
        assert out["rows_dtype"] == "torch.int64"
        np.testing.assert_array_equal(out["rows"].numpy(),
                                      whole[2 * r:2 * r + 2])


def test_world_collective_gradients(world):
    """gather_seq: the ranks' rows in order, its gradient the reduce-
    scatter (the sum over ranks); gather_rows: this rank's rows of the
    gradient; copy_to: the gradient summed; reduce_from: the sum, the
    gradient as it is."""
    _, _, outs = world
    x = [torch.arange(6.).view(3, 2) * (r + 1) for r in range(2)]
    w = torch.arange(12.).view(6, 2)
    for r, out in enumerate(outs):
        assert torch.equal(out["gather_seq"], torch.cat(x))
        assert torch.equal(out["gather_seq_grad"], 2 * w[3 * r:3 * r + 3])
        assert torch.equal(out["gather_rows_grad"], w[3 * r:3 * r + 3])
        assert torch.equal(out["copy_to_grad"], torch.full((3, 2), 3.0))
        assert torch.equal(out["reduce_from"], x[0] + x[1])
        assert torch.equal(out["reduce_from_grad"], w[:3])


def test_world_shard_params(world):
    """At mp=2 each sharded weight holds half its split dim, the rest is
    whole, and the shards gather back to the weights bit for bit."""
    cfg, weights, outs = world
    dims = param_shard_dims(cfg, _Shape(dp=1, mp=2))
    for out in outs:
        assert out["whole_again"]
        for name, shape in out["local_shapes"].items():
            want = list(weights[name].shape)
            if dims[name] is not None:
                want[dims[name]] //= 2
            assert list(shape) == want, name
