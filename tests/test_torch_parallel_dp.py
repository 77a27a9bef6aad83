"""Data parallelism of the port (a gloo world of two CPU ranks) against one
rank and against the JAX package.

The tiny ``CFG`` of ``test_torch_model.py`` with the GAN on, the same
weights everywhere (``flax_params``), and a batch of 3 contracts padded to
4 (``_pad_to_dp``; the pad row carries ``row_valid=0``), so the two ranks
hold unequal counts of real rows:

  * one train step with dropout 0.1 on dp=2 against the same step on one
    rank (each rank draws its slice of the single-card masks): every metric
    (the gradient norm among them) 2e-4 relative, and the optimizer's work
    by ``assert_step_close``: Adam's moments mu and √nu (the clipped
    gradient and its magnitude) 1e-4 relative with a floor at 1e-4 of the
    largest, and each parameter's update p_new − p_old 1e-4 relative;
  * the deterministic losses and gradients on dp=2 against JAX's
    ``compute_losses`` on a JAX dp=2 mesh: 2e-4 relative, the gradients
    1e-4 with a floor at 1e-4 of the largest;
  * the unfused LM cross-entropy (``fused_lm_ce=False``: each rank's
    share of the global mean, its rows' logits only) on dp=2: the dropout
    step against one rank's by the bars above, the deterministic losses
    and gradients against the fused ones by JAX's bars;
  * ``SmartContractTrainer(mesh=...).train(1)`` against one rank's
    ``train(1)`` over the same loaders (the history 2e-4, the trained
    weights by ``assert_step_close`` over its three steps), and its
    checkpoint restored
    by a one-rank trainer, bit for bit;
  * the analyzer with dp=2 at batch 2 against one rank at batch 4 (the
    same dispatch of 4) on 11 contracts: the same results
    (``tests/test_infer.py:200-222``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from sct_gan_tpu.data.tokenizer import SolidityTokenizer as JaxTokenizer
from sct_gan_tpu.losses import syntax as jsyntax
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu.train import train_step as jstep
from sct_gan_tpu_torch import (SmartContractAnalyzer, SmartContractTrainer,
                               convert_flax_params)
from sct_gan_tpu_torch.config import TrainConfig
from sct_gan_tpu_torch.data import create_dataloaders, write_corpus_csv
from sct_gan_tpu_torch.data.synthetic import generate_corpus
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from sct_gan_tpu_torch.train.checkpoint import find_checkpoint
from test_torch_model import CFG, flax_params
from test_torch_train import _to_torch, _train_batch
from sct_gan_tpu_torch.train.optimizer import GroupLRs, leaf_meta
from torch_parallel_worker import (LR, SCALARS, deterministic_losses,
                                   launch, model_from, moments,
                                   train_step_run)

LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
STEP_RTOL = 1e-4


def assert_step_close(got, want, old, steps: int = 1):
    """Hold one optimizer's work against another's. ``got`` and ``want``
    are (parameters, moments) after ``steps`` steps from the parameters
    ``old``, by name (moments as ``train_step_run`` returns them).

    Adam's moments mu and √nu (the clipped gradient, and its magnitude,
    scaled) agree to STEP_RTOL relative with a floor at STEP_RTOL of the
    largest |mu| (√nu's largest). Each parameter's update p_new − p_old
    agrees to STEP_RTOL relative plus two f32 ulps of p (the rounding of
    p + Δp), plus a floor in units of lr·steps (lr of the element's group):

      * one step: Adam's first step moves an element by lr·g/|g|, exact but
        for the sign, so only an element whose reference |mu| is under mu's
        floor (cancellation noise; the k_proj biases: softmax ignores a
        per-query shift) gets 2, a move of ±lr either way;
      * several steps: Adam divides each element's moments by its own
        magnitude, so its update carries its gradient's relative error,
        mu's floor over its |mu|: that, at most 2."""
    got_p, got_mom = got
    want_p, want_mom = want
    mu_scale = max(float(t.abs().max()) for t in want_mom["mu"].values())
    nu_scale = max(float(t.max()) for t in want_mom["nu"].values()) ** 0.5
    lrs = GroupLRs.init(LR)
    for n, w in want_p.items():
        mu = want_mom["mu"][n].numpy()
        np.testing.assert_allclose(got_mom["mu"][n].numpy(), mu,
                                   rtol=STEP_RTOL, atol=STEP_RTOL * mu_scale,
                                   err_msg=f"mu {n}")
        np.testing.assert_allclose(got_mom["nu"][n].sqrt().numpy(),
                                   want_mom["nu"][n].sqrt().numpy(),
                                   rtol=STEP_RTOL, atol=STEP_RTOL * nu_scale,
                                   err_msg=f"sqrt(nu) {n}")
        p0 = old[n].numpy()
        want_d = w.numpy() - p0
        got_d = got_p[n].numpy() - p0
        rel_g = STEP_RTOL * mu_scale / np.maximum(np.abs(mu), 1e-30)
        slack = (np.where(rel_g > 1.0, 2.0, 0.0) if steps == 1
                 else np.minimum(rel_g, 2.0))
        lr = lrs[leaf_meta(n, True).group]
        tol = (STEP_RTOL * np.abs(want_d) + 2 * np.spacing(np.abs(p0))
               + slack * lr * steps)
        bad = np.abs(got_d - want_d) > tol
        assert not bad.any(), (
            f"update {n}: {bad.sum()} of {bad.size} elements off, "
            f"got {got_d[bad][:4]} want {want_d[bad][:4]}")


def padded_batch():
    """Three contracts padded to four by ``_pad_to_dp``."""
    a, b = _train_batch(seed=5, b=2), _train_batch(seed=6, b=1)
    three = {k: np.concatenate([a[k], b[k]]) for k in a}
    trainer = SmartContractTrainer.__new__(SmartContractTrainer)
    trainer._static_batch = 4
    out = trainer._pad_to_dp(three)
    assert out["row_valid"].tolist() == [1.0, 1.0, 1.0, 0.0]
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = flax_params(CFG, seed=2)
    weights = convert_flax_params(params, CFG)
    work = tmp_path_factory.mktemp("dp")
    corpus = str(work / "corpus.csv")
    write_corpus_csv(corpus, n=10, seed=0)
    codes = [r["source_code"] for r in generate_corpus(n=11, seed=5)]
    batch = padded_batch()
    inputs = {"batch": batch, "corpus": corpus, "ckpt": str(work / "ckpt"),
              "codes": codes}
    outs = launch("dp", 2, str(work / "world"), cfg=CFG, weights=weights,
                  inputs=inputs)
    return dict(params=params, weights=weights, batch=batch, outs=outs,
                corpus=corpus, ckpt=str(work / "ckpt"), codes=codes)


def _close(got: dict, want: dict, tol, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_dp_dropout_step_matches_one_rank(setup):
    drop_cfg = dataclasses.replace(CFG, dropout=0.1)
    want_m, *want = train_step_run(model_from(drop_cfg, setup["weights"]),
                                   _to_torch(setup["batch"]))
    assert want_m["skipped"] == 0.0
    for out in setup["outs"]:
        got_m, *got = out["step"]
        assert set(got_m) == set(want_m)
        _close(got_m, want_m, LOSS_TOL)
        assert_step_close(got, want, setup["weights"])


def test_dp_losses_and_grads_match_jax_dp(setup):
    """JAX's compute_losses with its batch sharded over a dp=2 mesh of the
    virtual devices, dropout off, against the port's two ranks."""
    batch = setup["batch"]
    jtab = jsyntax.SyntaxLossTables.from_tokenizer(
        JaxTokenizer(vocab_size=CFG.vocab_size))
    jm = JaxModel(CFG)
    js = jstep.DynamicScalars(*(jnp.float32(x) for x in SCALARS))
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("dp",))
    jb = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                        NamedSharding(mesh, P("dp")))

    @jax.jit
    def losses(p, b):
        (_, (m, *_)), g = jax.value_and_grad(
            lambda p_: jstep.compute_losses(
                jm, p_, b, js, jax.random.PRNGKey(0), use_gan=True,
                use_augmentation=False, tables=jtab, deterministic=True,
                fused_lm_ce=True), has_aux=True)(p)
        return m, g
    want_m, want_g = jax.device_get(losses(setup["params"], jb))
    want_g = convert_flax_params(want_g, CFG)
    scale = max(float(g.abs().max()) for g in want_g.values())
    for out in setup["outs"]:
        got_m, got_g = out["losses"]
        _close(got_m, {k: float(v) for k, v in want_m.items()}, LOSS_TOL)
        for n, g in want_g.items():
            np.testing.assert_allclose(got_g[n].numpy(), g.numpy(),
                                       rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=n)
    # and one rank's port agrees with both
    one_m, _ = deterministic_losses(model_from(CFG, setup["weights"]),
                                    _to_torch(batch))
    _close(one_m, {k: float(v) for k, v in want_m.items()}, LOSS_TOL)


def test_dp_unfused_ce_matches_one_rank(setup):
    """The dropout step over the unfused LM cross-entropy on dp=2 against
    the same step on one rank; its deterministic losses and gradients
    against the fused ones of the same ranks, which
    ``test_dp_losses_and_grads_match_jax_dp`` holds to JAX's (the same
    function, summed in another order; ``test_torch_parallel_mp.py`` holds
    the unfused ones to JAX's unfused at dp=2 x mp=2)."""
    drop_cfg = dataclasses.replace(CFG, dropout=0.1)
    want_m, *want = train_step_run(model_from(drop_cfg, setup["weights"]),
                                   _to_torch(setup["batch"]),
                                   fused_lm_ce=False)
    assert want_m["skipped"] == 0.0
    for out in setup["outs"]:
        got_m, *got = out["step_ce_unfused"]
        assert set(got_m) == set(want_m)
        _close(got_m, want_m, LOSS_TOL)
        assert_step_close(got, want, setup["weights"])
        (got_m, got_g), (fused_m, fused_g) = (out["losses_ce_unfused"],
                                              out["losses"])
        _close(got_m, fused_m, LOSS_TOL)
        scale = max(float(g.abs().max()) for g in fused_g.values())
        for n, g in fused_g.items():
            np.testing.assert_allclose(got_g[n].numpy(), g.numpy(),
                                       rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=n)


def _one_rank_trainer(setup, seed=7):
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    tr, va = create_dataloaders(setup["corpus"], tok, batch_size=3,
                                max_length=CFG.max_length)
    return SmartContractTrainer(
        model_from(dataclasses.replace(CFG, dropout=0.1), setup["weights"]),
        tr, va, tok, config=TrainConfig(learning_rate=LR, use_gan=True,
                                        warmup_epochs=1),
        device="cpu", seed=seed, verbose=False)


def test_dp_trainer_epoch_matches_one_rank(setup):
    """train(1) over 8 training contracts at batch 3 (batches of 3, 3, 2;
    on two ranks each padded to 4, on one the last to 3): the history and
    the trained weights of one rank."""
    one = _one_rank_trainer(setup)
    hist = one.train(1, checkpoint_dir=str(setup["ckpt"]) + "_one")
    want = ({n: p.detach() for n, p in one.model.named_parameters()},
            moments(one.state.opt_state))
    assert int(one.state.opt_state["count"]) == 3
    for out in setup["outs"]:
        for k, v in hist.items():
            np.testing.assert_allclose(out["history"][k], v, err_msg=k,
                                       **LOSS_TOL)
        assert_step_close((out["trained"], out["trained_moments"]), want,
                          setup["weights"], steps=3)


def test_dp_checkpoint_loads_on_one_rank(setup):
    """Rank 0's latest checkpoint restores into a one-rank trainer with the
    dp trainer's weights, bit for bit."""
    fresh = _one_rank_trainer(setup, seed=0)
    epoch = fresh.restore(find_checkpoint(setup["ckpt"], "latest"))
    assert epoch == 1
    trained = setup["outs"][0]["trained"]
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p.detach(), trained[n]), n


def test_dp_analyzer_matches_one_rank(setup):
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    one = SmartContractAnalyzer(model_config=CFG, tokenizer=tok,
                                params=setup["weights"], batch_size=4,
                                verbose=False, device="cpu")
    want = one.analyze_multiple_contracts(setup["codes"], threshold=0.5)
    assert len(want) == 11
    for out in setup["outs"]:
        got = out["analysis"]
        assert len(got) == 11
        for g, w in zip(got, want):
            assert g["contract_index"] == w["contract_index"]
            assert g["contract_vulnerabilities"] == w[
                "contract_vulnerabilities"]
            np.testing.assert_allclose(
                np.asarray(g["contract_probabilities"]),
                np.asarray(w["contract_probabilities"]), rtol=1e-5,
                atol=1e-6)
            assert g["line_vulnerabilities"] == w["line_vulnerabilities"]
            np.testing.assert_allclose(
                np.asarray(g["line_probabilities"]),
                np.asarray(w["line_probabilities"]), rtol=1e-5, atol=1e-6)
