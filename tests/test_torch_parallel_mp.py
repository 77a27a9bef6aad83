"""Model parallelism of the port (gloo worlds of two and four CPU ranks,
meshes dp × mp = 1 × 2 and 2 × 2) against one rank and the JAX package.

The tiny ``CFG`` of ``test_torch_model.py`` (4 heads, FFN 128, vocab 512:
every rule of ``_MP_RULES`` applies at mp=2), the batch of 3 contracts
padded to 4 of ``test_torch_parallel_dp.py``:

  * one train step with dropout 0.1 (each rank draws the single-card masks
    of its rows, heads and hidden columns) against one rank: metrics 2e-4
    relative, the gathered moments and parameter updates by the dp test's
    ``assert_step_close``;
  * the fused optimizer against the unfused chain under mp (their clip
    norms summed over the shards): the same bars;
  * the unfused LM cross-entropy (``fused_lm_ce=False``: the logits
    gathered over mp, the gradient back through the gather) in the same
    step against one rank's: the same bars;
  * the deterministic losses and gradients, the LM cross-entropy fused and
    not, against JAX's ``compute_losses`` on a JAX 2 × 2 mesh with
    ``shard_params``: 2e-4 relative, the gradients 1e-4 with a floor at
    1e-4 of the largest;
  * the vocab-parallel LM cross-entropy against the plain one: value and
    gradients to 1e-6;
  * q_proj and the embedding table really hold half their rows;
  * checkpoints across layouts: a one-rank checkpoint restores under 2 × 2
    (each rank cuts its shards) bit for bit, and the 2 × 2 trainer's
    checkpoint (rank 0 gathers the shards) restores on one rank bit for
    bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from sct_gan_tpu.data.tokenizer import SolidityTokenizer as JaxTokenizer
from sct_gan_tpu.losses import syntax as jsyntax
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sct_gan_tpu.parallel.mesh import shard_params as jax_shard_params
from sct_gan_tpu.train import train_step as jstep
import torch

from sct_gan_tpu_torch import convert_flax_params
from sct_gan_tpu_torch.data import write_corpus_csv
from sct_gan_tpu_torch.train.checkpoint import find_checkpoint
from test_torch_model import CFG, flax_params
from test_torch_parallel_dp import (LOSS_TOL, _one_rank_trainer,
                                    assert_step_close, padded_batch)
from test_torch_train import _to_torch
from torch_parallel_worker import SCALARS, launch, model_from, train_step_run

MESHES = {2: "1x2", 4: "2x2"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = flax_params(CFG, seed=4)
    weights = convert_flax_params(params, CFG)
    batch = padded_batch()
    work = tmp_path_factory.mktemp("mp")
    corpus = str(work / "corpus.csv")
    write_corpus_csv(corpus, n=10, seed=0)
    files = dict(weights=weights, corpus=corpus)
    one_rank = _one_rank_trainer(files, seed=3)
    one_rank.train(1, checkpoint_dir=str(work / "one"))
    ckpts = {"one_rank_ckpt": find_checkpoint(str(work / "one"), "latest"),
             "corpus": corpus, "ckpt": str(work / "ckpt")}
    outs = {w: launch("mp", w, str(work / f"world{w}"), cfg=CFG,
                      weights=weights, inputs={"batch": batch,
                                               **(ckpts if w == 4 else {})})
            for w in MESHES}
    drop_cfg = dataclasses.replace(CFG, dropout=0.1)
    one = {fused: train_step_run(model_from(drop_cfg, weights),
                                 _to_torch(batch), fused=fused)
           for fused in (True, False)}
    one["ce_unfused"] = train_step_run(model_from(drop_cfg, weights),
                                       _to_torch(batch), fused_lm_ce=False)
    return dict(params=params, weights=weights, batch=batch, outs=outs,
                one=one, one_rank=one_rank, corpus=corpus,
                ckpt=str(work / "ckpt"))


def _check_step(got, want, old):
    got_m, *got_state = got
    want_m, *want_state = want
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], err_msg=k, **LOSS_TOL)
    assert_step_close(got_state, want_state, old)


@pytest.mark.parametrize("world", sorted(MESHES), ids=MESHES.get)
def test_mp_dropout_step_matches_one_rank(setup, world):
    assert setup["one"][True][0]["skipped"] == 0.0
    for out in setup["outs"][world]:
        _check_step(out["step"], setup["one"][True], setup["weights"])


@pytest.mark.parametrize("world", sorted(MESHES), ids=MESHES.get)
def test_mp_fused_matches_unfused(setup, world):
    """The unfused chain under mp against the fused optimizer under mp,
    and against the unfused chain on one rank."""
    for out in setup["outs"][world]:
        _check_step(out["step_unfused"], out["step"], setup["weights"])
        _check_step(out["step_unfused"], setup["one"][False],
                    setup["weights"])


@pytest.mark.parametrize("world", sorted(MESHES), ids=MESHES.get)
def test_mp_unfused_ce_step_matches_one_rank(setup, world):
    """The step over the unfused LM cross-entropy under mp against the same
    step on one rank."""
    assert setup["one"]["ce_unfused"][0]["skipped"] == 0.0
    for out in setup["outs"][world]:
        _check_step(out["step_ce_unfused"], setup["one"]["ce_unfused"],
                    setup["weights"])


# (world, fused_lm_ce); the fused cases keep their ids
JAX_CASES = [pytest.param(w, fused, id=MESHES[w] + ("" if fused else
                                                    "-unfused_ce"))
             for fused in (True, False) for w in sorted(MESHES)]


@pytest.mark.parametrize("world,fused_lm_ce", JAX_CASES)
def test_mp_losses_and_grads_match_jax(setup, world, fused_lm_ce):
    dp = world // 2
    jtab = jsyntax.SyntaxLossTables.from_tokenizer(
        JaxTokenizer(vocab_size=CFG.vocab_size))
    jm = JaxModel(CFG)
    js = jstep.DynamicScalars(*(jnp.float32(x) for x in SCALARS))
    mesh = jax_make_mesh(dp=dp, mp=2, devices=jax.devices()[:world])
    params = jax_shard_params(setup["params"], mesh)
    jb = jax.device_put({k: jnp.asarray(v) for k, v in
                         setup["batch"].items()},
                        NamedSharding(mesh, P("dp")))

    @jax.jit
    def losses(p, b):
        (_, (m, *_)), g = jax.value_and_grad(
            lambda p_: jstep.compute_losses(
                jm, p_, b, js, jax.random.PRNGKey(0), use_gan=True,
                use_augmentation=False, tables=jtab, deterministic=True,
                fused_lm_ce=fused_lm_ce), has_aux=True)(p)
        return m, g
    want_m, want_g = jax.device_get(losses(params, jb))
    want_g = convert_flax_params(want_g, CFG)
    scale = max(float(g.abs().max()) for g in want_g.values())
    for out in setup["outs"][world]:
        got_m, got_g = out["losses" if fused_lm_ce else "losses_ce_unfused"]
        for k, v in want_m.items():
            np.testing.assert_allclose(got_m[k], float(v), err_msg=k,
                                       **LOSS_TOL)
        for n, g in want_g.items():
            np.testing.assert_allclose(got_g[n].numpy(), g.numpy(),
                                       rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=n)


def test_vocab_parallel_ce_matches_plain(setup):
    """Each rank's share of a 64-column head (60 valid), a zero-weight row:
    the value and the gradients of hidden, its weight rows and the bias."""
    for out in setup["outs"][2]:
        got, want, errs = out["ce"]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert max(errs) < 1e-6, errs


def test_mp_really_shards(setup):
    for world in MESHES:
        for out in setup["outs"][world]:
            assert out["q_proj_shape"] == (CFG.d_model // 2, CFG.d_model)
            assert out["embedding_shape"] == (CFG.padded_vocab_size // 2,
                                              CFG.d_model)


def test_mp_checkpoints_cross_layouts(setup):
    want = dict(setup["one_rank"].model.named_parameters())
    for out in setup["outs"][4]:
        for n, p in want.items():
            assert torch.equal(out["restored"][n], p.detach()), n
    fresh = _one_rank_trainer(setup, seed=0)
    fresh.restore(find_checkpoint(setup["ckpt"], "latest"))
    trained = setup["outs"][4][0]["trained"]
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p.detach(), trained[n]), n
