"""The port's training slice against the JAX package's, on the CPU.

Same numpy inputs, weights and optimizer state on both sides, f32:

  * the fused LM-head cross-entropy, each loss of the step and their
    gradients: 1e-5 relative (the same math summed in another order);
  * ``FusedOptimizer.update`` on the same parameters, gradients and state
    (carried over with ``convert_flax_opt_state``): to f32 rounding, and
    bit for bit unchanged on a skipped step;
  * one whole deterministic step at the tiny ``CFG`` of
    ``test_torch_model.py`` (losses, metrics, grad norm, new parameters):
    1e-4 relative, the bar of the forward parity tests.

A step with dropout on cannot be held against JAX as a whole: flax derives
one key per dropout site from the step's rng, the port draws one seed per
site from a ``torch.Generator``, so the masks differ. The dropout masks
themselves are held to JAX bit for bit in ``test_torch_dropout.py`` and
``test_torch_ops.py``; here the dropout-on step is checked for finite
losses, moving parameters, the focal retune and reproducibility.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.data.synthetic import generate_corpus
from sct_gan_tpu.data.tokenizer import SolidityTokenizer as JaxTokenizer
from sct_gan_tpu.losses import focal as jfocal
from sct_gan_tpu.losses import syntax as jsyntax
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu.ops.fused_ce import \
    fused_linear_cross_entropy as jax_fused_ce
from sct_gan_tpu.train import optimizer as jopt
from sct_gan_tpu.train import train_step as jstep
from sct_gan_tpu_torch import (SmartContractTrainer,
                               SmartContractTransformer,
                               convert_flax_opt_state, convert_flax_params)
from sct_gan_tpu_torch.config import TrainConfig
from sct_gan_tpu_torch.data import create_dataloaders, write_corpus_csv
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from sct_gan_tpu_torch.losses import focal, syntax
from sct_gan_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from sct_gan_tpu_torch.train.optimizer import (FusedOptimizer, GroupLRs,
                                               leaf_meta)
from sct_gan_tpu_torch.train.train_step import (DynamicScalars, TrainState,
                                                _line_batch_metrics,
                                                compute_losses,
                                                make_eval_step,
                                                make_train_step)
from test_torch_model import CFG, _batch, flax_params

TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _port_name(path: str) -> str:
    """The port's parameter name of a flax leaf path (``convert.py``)."""
    *mods, leaf = path.split("/")
    return ".".join([*mods, "weight" if leaf in ("kernel", "scale",
                                                 "embedding") else leaf])


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_ce_matches_jax(weighted):
    """Value and the three gradients of the fused LM-head CE, with a padded
    vocab (60 of 64 columns valid) and optionally a zero-weight row."""
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 16, 8, 64
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    w = rng.normal(0, 0.3, (d, v)).astype(np.float32)
    bias = rng.normal(0, 0.1, (v,)).astype(np.float32)
    t = rng.integers(0, 60, (b, s)).astype(np.int32)
    rows = np.asarray([1.0, 0.0], np.float32) if weighted else None
    jrows = None if rows is None else jnp.asarray(rows)
    want, want_g = jax.value_and_grad(
        lambda *a: 2.0 * jax_fused_ce(*a, jnp.asarray(t), jrows, 60),
        argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, bias)))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, w.T.copy(), bias))
    got = 2.0 * fused_linear_cross_entropy(
        tx, tw, tb, torch.from_numpy(t),
        None if rows is None else torch.from_numpy(rows), 60)
    gx, gw, gb = torch.autograd.grad(got, (tx, tw, tb))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_g[0]), **TOL)
    np.testing.assert_allclose(gw.numpy().T, np.asarray(want_g[1]), **TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(want_g[2]), **TOL)
    assert np.all(gw.numpy()[60:] == 0.0)        # pad columns get nothing


@pytest.fixture(scope="module")
def loss_inputs():
    """(2, 64) logits and labels, a token→line map, a row mask, and the
    target ids of two tokenised contracts with both syntax tables."""
    rng = np.random.default_rng(1)
    b, s, c = 2, 64, 8
    pred = rng.normal(0, 2, (b, s, c)).astype(np.float32)
    target = (rng.random((b, s, c)) < 0.1).astype(np.float32)
    ttl = np.cumsum(rng.random((b, s)) < 0.2, axis=1).astype(np.int32)
    tok = JaxTokenizer(vocab_size=CFG.vocab_size)
    codes = [r["source_code"] for r in generate_corpus(n=2, seed=3)]
    ids = np.asarray(tok(codes, max_length=s, padding="max_length",
                         truncation=True, return_tensors="np")["input_ids"],
                     np.int32)
    logits = rng.normal(0, 1, (b, s, 96)).astype(np.float32)
    jtab = jsyntax.SyntaxLossTables.from_tokenizer(tok)
    ttab = syntax.SyntaxLossTables.from_tokenizer(
        SolidityTokenizer(vocab_size=CFG.vocab_size))
    assert jtab.__dict__ == ttab.__dict__
    return dict(pred=pred, target=target, ttl=ttl, raw_ids=ids,
                ids=ids % 96, logits=logits,
                row=np.asarray([1.0, 0.0], np.float32), jtab=jtab, ttab=ttab)


def _loss_pair(name, a, row):
    """(JAX function, port function) of one loss, each taking
    (pred or logits, row mask) on its own framework's arrays."""
    jrow = None if row is None else jnp.asarray(row)
    trow = None if row is None else torch.from_numpy(row)
    jt, tt = jnp.asarray(a["target"]), torch.from_numpy(a["target"])
    jl, tl = jnp.asarray(a["ttl"]), torch.from_numpy(a["ttl"])
    ji, ti = jnp.asarray(a["ids"]), torch.from_numpy(a["ids"])
    alpha, gamma, sw = 0.1, 1.5, 0.1
    return {
        "masked_mean": (lambda p: jfocal.masked_mean(p, jrow),
                        lambda p: focal.masked_mean(p, trow), "pred"),
        "focal": (lambda p: jfocal.focal_loss(p, jt),
                  lambda p: focal.focal_loss(p, tt), "pred"),
        "spatial_focal": (
            lambda p: jfocal.spatial_aware_focal_loss(
                p, jt, jl, alpha=jnp.float32(alpha),
                gamma=jnp.float32(gamma), spatial_weight=jnp.float32(sw),
                row_mask=jrow),
            lambda p: focal.spatial_aware_focal_loss(
                p, tt, tl, alpha=torch.tensor(alpha),
                gamma=torch.tensor(gamma),
                spatial_weight=torch.tensor(sw), row_mask=trow), "pred"),
        "contract_focal": (
            lambda p: jfocal.contract_level_focal_loss(p[:, 0], jt[:, 0],
                                                       row_mask=jrow),
            lambda p: focal.contract_level_focal_loss(p[:, 0], tt[:, 0],
                                                      row_mask=trow), "pred"),
        "cross_entropy": (
            lambda x: jsyntax.cross_entropy_loss(x, ji, row_mask=jrow),
            lambda x: syntax.cross_entropy_loss(x, ti, row_mask=trow),
            "logits"),
        "solidity_syntax": (
            lambda x: jsyntax.solidity_syntax_loss(
                x, ji, a["jtab"], row_mask=jrow)[0],
            lambda x: syntax.solidity_syntax_loss(
                x, ti, a["ttab"], row_mask=trow)[0], "logits"),
    }[name]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["masked_mean", "focal", "spatial_focal",
                                  "contract_focal", "cross_entropy",
                                  "solidity_syntax"])
def test_loss_and_gradient_match_jax(loss_inputs, name, masked):
    row = loss_inputs["row"] if masked else None
    jfn, tfn, arg = _loss_pair(name, loss_inputs, row)
    x = loss_inputs[arg]
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = tfn(tx)
    (got_g,) = torch.autograd.grad(got, tx)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


def test_syntax_penalty_matches_jax(loss_inputs):
    """The penalty over real tokenised contracts finds violations (so the
    comparison is not 0 == 0) and equals JAX's, with and without rows."""
    a = loss_inputs
    for row in (None, a["row"]):
        want = jsyntax.syntax_penalty(
            jnp.asarray(a["raw_ids"]), a["jtab"],
            row_mask=None if row is None else jnp.asarray(row))
        got = syntax.syntax_penalty(
            torch.from_numpy(a["raw_ids"]), a["ttab"],
            row_mask=None if row is None else torch.from_numpy(row))
        assert float(want) > 0.0
        np.testing.assert_allclose(got.item(), float(want), **TOL)


# -- the optimizer ----------------------------------------------------------

@pytest.fixture(scope="module")
def opt_setup():
    """Flax params, gradients and a non-trivial FusedOptimizer state (count
    5, random moments), and the port's copies of all three."""
    params = flax_params(CFG, seed=2)
    rng = np.random.default_rng(4)
    like = lambda f: jax.tree_util.tree_map(
        lambda p: jnp.asarray(f(p.shape), jnp.float32), params)
    grads = like(lambda s: rng.normal(0, 0.05, s))
    state = {"count": jnp.int32(5),
             "mu": like(lambda s: rng.normal(0, 0.01, s)),
             "nu": like(lambda s: np.abs(rng.normal(0, 1e-4, s)))}
    return params, grads, state


def _port_opt(params, grads, state):
    model = SmartContractTransformer(CFG, seed=None)
    model.load_state_dict(convert_flax_params(params, CFG))
    opt = FusedOptimizer(model.named_parameters(), use_gan=True)
    g = convert_flax_params(grads, CFG)
    return model, opt, [g[n] for n in opt.names], \
        convert_flax_opt_state(state, CFG)


@pytest.mark.parametrize("case", ["normal", "nan_loss", "exploding"])
def test_fused_optimizer_matches_jax(opt_setup, case):
    """One update from the same params, grads and state: new params, mu,
    nu, count, grad norm and gate equal JAX's. A NaN loss or a grad norm
    above 1000 skips the step: params and moments come back bit for bit."""
    params, grads, state = opt_setup
    if case == "exploding":
        grads = jax.tree_util.tree_map(lambda g: g * 1e4, grads)
    loss = float("nan") if case == "nan_loss" else 1.5
    jo = jopt.FusedOptimizer(params, use_gan=True)
    lrs = GroupLRs.init(1e-3)
    want_p, want_s, want_n, want_ok = jo.update(
        grads, state, params, jopt.GroupLRs.init(1e-3), jnp.float32(loss))
    model, opt, g, st = _port_opt(params, grads, state)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    mu0 = {n: t.clone() for n, t in st["mu"].items()}
    norm, ok = opt.update(g, st, lrs, torch.tensor(loss))
    assert bool(ok) == bool(want_ok) == (case == "normal")
    np.testing.assert_allclose(norm.item(), float(want_n), rtol=1e-5)
    assert int(st["count"]) == int(want_s["count"])
    want_sd = convert_flax_params(want_p, CFG)
    want_mu = convert_flax_params(want_s["mu"], CFG)
    want_nu = convert_flax_params(want_s["nu"], CFG)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(st["mu"][n].numpy(), want_mu[n].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=n)
        np.testing.assert_allclose(st["nu"][n].numpy(), want_nu[n].numpy(),
                                   rtol=1e-6, atol=1e-12, err_msg=n)
        if case != "normal":
            assert torch.equal(p.detach(), before[n]), n
            assert torch.equal(st["mu"][n], mu0[n]), n


def test_lr_groups_and_clip_sets_match_jax(opt_setup):
    """Every port parameter lands in the LR group and the clip sets of its
    flax leaf (the substring rules read the port name with '.' as '/')."""
    params = opt_setup[0]
    jo = jopt.FusedOptimizer(params, use_gan=True)
    paths = [jopt._flat_path(kp) for kp, _ in
             jax.tree_util.tree_leaves_with_path(params)]
    model = SmartContractTransformer(CFG, seed=None)
    names = {n for n, _ in model.named_parameters()}
    assert {_port_name(p) for p in paths} == names
    groups = set()
    for path, meta in zip(paths, jo._meta):
        got = leaf_meta(_port_name(path), use_gan=True)
        assert tuple(got) == tuple(meta), path
        groups.add(got.group)
    assert groups == {0, 1, 2, 3}


# -- whole steps ------------------------------------------------------------

def _train_batch(seed=5, b=2):
    bt = _batch(seed=seed, b=b)
    rng = np.random.default_rng(seed)
    s = bt["input_ids"].shape[1]
    bt["vulnerable_lines"] = (rng.random((b, 8, s)) < 0.05).astype(np.int32)
    bt["contract_vulnerabilities"] = rng.integers(0, 2, (b, 8)).astype(
        np.int32)
    return bt


def _to_torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu"
                                else v) for k, v in batch.items()}


def test_one_deterministic_step_matches_jax(opt_setup):
    """compute_losses under value_and_grad, the line metrics and
    FusedOptimizer.update, dropout off, from one converted state: every
    metric, the grad norm and the new parameters agree."""
    params, _, state = opt_setup
    batch = _train_batch()
    jtab = jsyntax.SyntaxLossTables.from_tokenizer(
        JaxTokenizer(vocab_size=CFG.vocab_size))
    jm = JaxModel(CFG)
    js = jstep.DynamicScalars(jnp.float32(5.0), jnp.float32(3.0),
                              jnp.float32(0.25), jnp.float32(2.0),
                              jnp.float32(0.2))

    @jax.jit
    def jax_loss(p):
        (total, (m, ll, lab, rm)), g = jax.value_and_grad(
            lambda p_: jstep.compute_losses(
                jm, p_, batch, js, jax.random.PRNGKey(0), use_gan=True,
                use_augmentation=False, tables=jtab, deterministic=True,
                fused_lm_ce=True), has_aux=True)(p)
        return total, {**m, **jstep._line_batch_metrics(ll, lab, rm)}, g
    total, want, g = jax_loss(params)
    # the update runs op by op: XLA's fused CPU reductions of the jitted
    # update sum the grad norm ~1e-4 off the f64 value
    want_p, _, want_n, want_ok = jopt.FusedOptimizer(
        params, use_gan=True).update(g, state, params,
                                     jopt.GroupLRs.init(1e-3), total)

    model, opt, _, st = _port_opt(params, params, state)
    tables = syntax.SyntaxLossTables.from_tokenizer(
        SolidityTokenizer(vocab_size=CFG.vocab_size))
    total, (got, ll, lab, rm) = compute_losses(
        model, _to_torch(batch), DynamicScalars.make(5.0, 3.0, 0.25, 2.0,
                                                     0.2),
        None, use_gan=True, use_augmentation=False, tables=tables,
        deterministic=True, fused_lm_ce=True)
    grads = torch.autograd.grad(total, opt.params)
    got = {**got, **_line_batch_metrics(ll.detach(), lab, rm)}
    norm, ok = opt.update(list(grads), st, GroupLRs.init(1e-3),
                          total.detach())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   err_msg=k, **STEP_TOL)
    assert bool(ok) and bool(want_ok)
    np.testing.assert_allclose(norm.item(), float(want_n), **STEP_TOL)
    want_sd = convert_flax_params(want_p, CFG)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[n].numpy(),
                                   err_msg=n, **STEP_TOL)


def test_eval_step_matches_jax():
    """The validation step (eval-mode forward, the val loss mix without the
    discriminator) gives JAX's metrics on the same weights and batch."""
    params = flax_params(CFG, seed=3)
    batch = _train_batch(seed=6)
    jtab = jsyntax.SyntaxLossTables.from_tokenizer(
        JaxTokenizer(vocab_size=CFG.vocab_size))
    js = jstep.DynamicScalars(jnp.float32(5.0), jnp.float32(3.0),
                              jnp.float32(0.25), jnp.float32(2.0),
                              jnp.float32(0.2))
    want = jstep.make_eval_step(JaxModel(CFG), jtab, use_gan=True,
                                use_augmentation=False, fused_lm_ce=True)(
        params, batch, js)
    model = SmartContractTransformer(CFG, seed=None)
    model.load_state_dict(convert_flax_params(params, CFG))
    got = make_eval_step(
        model, syntax.SyntaxLossTables.from_tokenizer(
            SolidityTokenizer(vocab_size=CFG.vocab_size)),
        use_gan=True, use_augmentation=False, fused_lm_ce=True)(
        _to_torch(batch), DynamicScalars.make(5.0, 3.0, 0.25, 2.0, 0.2))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k,
                                   **STEP_TOL)


def _two_dropout_steps(seed):
    """Two train steps with dropout on (0.1, the line heads' 0.1 and the
    line attentions' 0.02) from seed-0 weights; metrics, scalars, params."""
    cfg = CFG.__class__(**{**CFG.__dict__, "dropout": 0.1})
    model = SmartContractTransformer(cfg, seed=0)
    opt = FusedOptimizer(model.named_parameters(), use_gan=True)
    tables = syntax.SyntaxLossTables.from_tokenizer(
        SolidityTokenizer(vocab_size=cfg.vocab_size))
    step = make_train_step(model, opt, tables, use_gan=True,
                           use_augmentation=False, fused_lm_ce=True)
    state = TrainState(dict(model.named_parameters()), opt.init(), 0)
    scalars = DynamicScalars.make(5.0, 3.0, 0.25, 2.0, 0.2)
    gen = torch.Generator().manual_seed(seed)
    batch = _to_torch(_train_batch())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    history = []
    for _ in range(2):
        state, metrics, scalars = step(state, batch, scalars,
                                       GroupLRs.init(1e-4), gen)
        history.append(({k: float(v) for k, v in metrics.items()},
                         tuple(float(x) for x in scalars)))
    return history, before, model, state


def test_two_dropout_steps_train_and_reproduce():
    """Finite losses, no skipped step, moving parameters, the per-batch
    focal retune carried into the next step, and the same generator seed
    giving the same steps bit for bit."""
    history, before, model, state = _two_dropout_steps(0)
    assert state.step == 2 and int(state.opt_state["count"]) == 2
    for metrics, scalars in history:
        assert all(math.isfinite(v) for v in metrics.values())
        assert metrics["skipped"] == 0.0
        has = metrics["batch_line_vulns"] > 0
        assert scalars[2:] == pytest.approx(
            (0.1, 1.5, 0.1) if has else (0.05, 1.0, 0.05))
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    assert len(moved) > 0.9 * len(before)
    again, _, model2, _ = _two_dropout_steps(0)
    assert again == history
    for (n, p), p2 in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p, p2), n
    other, _, _, _ = _two_dropout_steps(1)
    assert other[0][0]["total_loss"] != history[0][0]["total_loss"]


def test_padded_rows_do_not_change_the_loss():
    """A batch padded with a ``row_valid=0`` row (``_pad_to_dp``) gives the
    loss of the unpadded batch."""
    tables = syntax.SyntaxLossTables.from_tokenizer(
        SolidityTokenizer(vocab_size=CFG.vocab_size))
    model = SmartContractTransformer(CFG, seed=0)
    full = _train_batch(b=2)
    one = {k: v[:1] for k, v in full.items()}
    trainer = SmartContractTrainer.__new__(SmartContractTrainer)
    trainer._static_batch = 2
    padded = trainer._pad_to_dp(one)
    assert padded["input_ids"].shape[0] == 2
    assert padded["row_valid"].tolist() == [1.0, 0.0]
    scal = DynamicScalars.make(5.0, 3.0, 0.25, 2.0, 0.2)
    kw = dict(use_gan=True, use_augmentation=False, tables=tables,
              deterministic=True, fused_lm_ce=True)
    with torch.no_grad():
        want, (wm, *_) = compute_losses(model, _to_torch(one), scal, None,
                                        **kw)
        got, (gm, *_) = compute_losses(model, _to_torch(padded), scal, None,
                                       **kw)
    for k in ("gen_loss", "contract_vuln_loss", "line_vuln_loss",
              "discriminator_loss", "total_loss"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), err_msg=k,
                                   **TOL)


def test_trainer_train_epoch_on_a_corpus(tmp_path):
    """SmartContractTrainer over 10 generated contracts at batch 4 (8 train
    rows: 2 batches), on the CPU: finite epoch losses, two steps taken."""
    path = str(tmp_path / "corpus.csv")
    write_corpus_csv(path, n=10, seed=0)
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    tr, va = create_dataloaders(path, tok, batch_size=4,
                                max_length=CFG.max_length)
    cfg = CFG.__class__(**{**CFG.__dict__, "dropout": 0.1})
    trainer = SmartContractTrainer(
        SmartContractTransformer(cfg, seed=0), tr, va, tok,
        config=TrainConfig(learning_rate=1e-5, use_gan=True,
                           warmup_epochs=1), device="cpu", verbose=False)
    out = trainer.train_epoch(0)
    assert out["batches"] == 2 and trainer.state.step == 2
    assert all(math.isfinite(out[k]) for k in (
        "gen_loss", "contract_vuln_loss", "line_vuln_loss",
        "discriminator_loss", "syntax_loss"))
