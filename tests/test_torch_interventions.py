"""The port's epoch interventions and unfused optimizer against JAX's, CPU.

  * ``_epoch_interventions`` fed one scripted sequence of train and
    validation metrics (every branch: growth, recall swing, focal retune,
    dead-line boosts under ``line_lr_max``, the emergency, the plateau,
    both LR floors, the explosion), under both ``model_select`` signals:
    the same LRs, scales and counters after every epoch, exactly (the same
    float arithmetic in the same order);
  * ``fused_optimizer=False`` (``GradientTransform``) against the JAX optax
    chain (``build_gradient_transform`` + ``apply_group_lrs`` + the step's
    keep-where) on one update, and against the port's ``FusedOptimizer``:
    to f32 rounding (rtol 1e-6), bit for bit on a skipped step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sct_gan_tpu.data.tokenizer import SolidityTokenizer as JaxTokenizer
from sct_gan_tpu.train import optimizer as jopt
from sct_gan_tpu_torch import (SmartContractTrainer,
                               SmartContractTransformer, convert_flax_params)
from sct_gan_tpu_torch.config import TrainConfig
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from sct_gan_tpu_torch.train.optimizer import (FusedOptimizer,
                                               GradientTransform, GroupLRs)
from test_torch_model import CFG
from test_torch_train import _port_opt, opt_setup  # noqa: F401 (fixture)
from test_torch_train_loop import TRAIN_KW, _Empty, _jax_trainer


# -- the epoch interventions --------------------------------------------------

# (epoch, line recall, line precision, val gen loss, val contract + line,
#  batches with predictions, patience counter, oscillation detected)
SCRIPT = [
    (0, 0.5, 0.5, 5.0, 1.0, 3, 0, False),
    (1, 0.9, 0.005, 4.0, 0.9, 3, 0, True),      # focal retune (recall high)
    (2, 0.05, 0.9, 4.5, 0.95, 3, 1, False),     # swing, the other retune
    (3, 0.9, 0.9, 4.6, 0.96, 3, 2, False),      # swing back; growth
    (6, 0.005, 0.5, 4.7, 0.97, 3, 3, False),    # low recall: line LR ×2
    (7, 0.0, 0.0, 4.8, 0.98, 0, 4, False),      # dead head + emergency
    (8, 0.0, 0.0, 4.9, 0.99, 0, 6, False),      # (line LR at its cap)
    (9, 0.2, 0.2, 5.5, 1.5, 2, 6, False),       # plateau cuts the LRs
    (10, 0.2, 0.2, 9.5, 2.5, 2, 7, False),      # val explosion: ×0.1
    (11, 0.2, 0.2, 9.6, 2.6, 2, 11, False),
    (12, 0.2, 0.2, 9.7, 2.7, 2, 12, False),     # LR floor: 5e-5
    (13, 0.2, 0.2, 9.8, 2.8, 2, 6, False),
    (14, 0.2, 0.2, 7.0, 1.7, 2, 7, False),      # LR floor: 1e-5
]

_TRACKED = ("lrs", "line_loss_scale", "stability_factor", "spatial_alpha",
            "spatial_gamma", "spatial_weight", "patience_counter",
            "prev_line_recall", "prev_line_precision", "oscillation_detected",
            "total_line_predictions", "batches_with_predictions")


INTERVENTION_KW = dict(line_lr_max=1.5e-3, learning_rate=1e-4)


@pytest.fixture(scope="module")
def jax_trainer():
    """One JAX trainer for both signals (its constructor compiles the
    model's init): each test sets its ``model_select`` and starts it from
    the constructor's control state."""
    jt = _jax_trainer((_Empty(), _Empty()),
                      JaxTokenizer(vocab_size=CFG.vocab_size),
                      **INTERVENTION_KW)
    start = {k: v for k, v in vars(jt).items()
             if isinstance(v, (int, float, bool)) or k == "lrs"}
    return jt, start


@pytest.mark.parametrize("model_select", ["gen_loss", "detection"])
def test_epoch_interventions_match_jax(jax_trainer, model_select):
    jt, start = jax_trainer
    jt.__dict__.update({k: dict(v) if isinstance(v, dict) else v
                        for k, v in start.items()})
    jt.cfg = dataclasses.replace(jt.cfg, model_select=model_select)
    jt.scheduler = type(jt.scheduler)(factor=jt.cfg.plateau_factor,
                                      patience=jt.cfg.plateau_patience,
                                      min_lr=jt.cfg.plateau_min_lr)
    pt = SmartContractTrainer(
        SmartContractTransformer(CFG, seed=0), _Empty(), _Empty(),
        SolidityTokenizer(vocab_size=CFG.vocab_size),
        config=TrainConfig(**{**TRAIN_KW, **INTERVENTION_KW,
                              "model_select": model_select}),
        device="cpu", verbose=False)
    for name in _TRACKED:
        assert getattr(pt, name) == getattr(jt, name), name
    best = 4.0 if model_select == "gen_loss" else 0.9
    bases, lines = [], []
    for epoch, rec, prec, gen, det, preds, patience, osc in SCRIPT:
        train = {"line_vuln_recall": rec, "line_vuln_precision": prec}
        val = {"gen_loss": gen, "contract_vuln_loss": det * 0.25,
               "line_vuln_loss": det * 0.75}
        for t in (jt, pt):
            t.batches_with_predictions = preds
            t.patience_counter = patience
            t.oscillation_detected = osc
            t.best_val_loss = best
            if epoch == 2:
                t.line_loss_scale, t.stability_factor = 0.5, 0.6
            t._epoch_interventions(epoch, train, val)
        for name in _TRACKED:
            assert getattr(pt, name) == getattr(jt, name), (epoch, name)
        assert pt.scheduler.state_dict() == jt.scheduler.state_dict(), epoch
        assert pt._select_val(val) == jt._select_val(val)
        bases.append(pt.lrs["base"])
        lines.append(pt.lrs["line"])
    # the branches ran: the line LR hit its cap, the plateau cut 1e-4 to
    # 3e-5, the explosion cut by 10, both LR floors fired
    assert max(lines) == 1.5e-3
    assert bases[7] == pytest.approx(3e-5) and bases[8] == pytest.approx(3e-6)
    assert 5e-6 in bases and bases[-1] == 1e-5


# -- the unfused optimizer ----------------------------------------------------

def _jax_chain_update(params, grads, state, lrs, loss):
    """The JAX trainer's ``fused_optimizer=False`` step after the loss: the
    optax chain, the group LRs, apply_updates and the skip keep-where."""
    tx = jopt.build_gradient_transform(params, use_gan=True)
    tx_state = list(tx.init(params))
    adam = next(i for i, s in enumerate(tx_state)
                if isinstance(s, optax.ScaleByAdamState))
    tx_state[adam] = optax.ScaleByAdamState(count=state["count"],
                                            mu=state["mu"], nu=state["nu"])
    tx_state = tuple(tx_state)
    fusion = jopt.fusion_mask_tree(params)
    gnorm = optax.global_norm(jax.tree_util.tree_map(
        lambda g, m: jnp.clip(g, -1.0, 1.0) if m else g, grads, fusion))
    updates, new = tx.update(grads, tx_state, params)
    updates = jopt.apply_group_lrs(updates, jopt.group_index_tree(params, True),
                                   lrs)
    new_p = optax.apply_updates(params, updates)
    ok = bool(jnp.isfinite(loss) & (gnorm <= 1000.0))
    adam_state = new[adam]
    if not ok:
        return params, state, float(gnorm), ok
    return new_p, {"count": adam_state.count, "mu": adam_state.mu,
                   "nu": adam_state.nu}, float(gnorm), ok


@pytest.mark.parametrize("case", ["normal", "nan_loss", "exploding"])
def test_gradient_transform_matches_jax_chain(opt_setup, case):  # noqa: F811
    params, grads, state = opt_setup
    if case == "exploding":
        grads = jax.tree_util.tree_map(lambda g: g * 1e4, grads)
    loss = float("nan") if case == "nan_loss" else 1.5
    want_p, want_s, want_n, want_ok = _jax_chain_update(
        params, grads, state, jopt.GroupLRs.init(1e-3), jnp.float32(loss))
    model, fused, g, st = _port_opt(params, grads, state)
    opt = GradientTransform(model.named_parameters(), use_gan=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    norm, ok = opt.update(g, st, GroupLRs.init(1e-3), torch.tensor(loss))
    assert bool(ok) == want_ok == (case == "normal")
    np.testing.assert_allclose(norm.item(), want_n, rtol=1e-5)
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


def test_fused_optimizer_matches_gradient_transform(opt_setup):  # noqa: F811
    """The port's two optimizers on the same params, grads and state: the
    fused one composes the clips analytically, the chain applies them
    stage by stage; the results agree to f32 rounding."""
    params, grads, state = opt_setup
    grads = jax.tree_util.tree_map(lambda g: g * 10.0, grads)  # clips bite
    results = []
    for cls in (FusedOptimizer, GradientTransform):
        model, _, g, st = _port_opt(params, grads, state)
        opt = cls(model.named_parameters(), use_gan=True)
        norm, ok = opt.update(g, st, GroupLRs.init(1e-3), torch.tensor(2.0))
        results.append((dict(model.named_parameters()), st, norm.item()))
    (p1, s1, n1), (p2, s2, n2) = results
    assert n1 == pytest.approx(n2, rel=1e-6) and n1 > 1.0
    assert int(s1["count"]) == int(s2["count"]) == 6
    for n in p1:
        np.testing.assert_allclose(p1[n].detach().numpy(),
                                   p2[n].detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
        np.testing.assert_allclose(s1["mu"][n].numpy(), s2["mu"][n].numpy(),
                                   rtol=1e-5, atol=1e-9, err_msg=n)


def test_trainer_takes_fused_optimizer_false():
    pt = SmartContractTrainer(
        SmartContractTransformer(CFG, seed=0), _Empty(), _Empty(),
        SolidityTokenizer(vocab_size=CFG.vocab_size),
        config=dataclasses.replace(TrainConfig(**TRAIN_KW),
                                   fused_optimizer=False),
        device="cpu", verbose=False)
    assert isinstance(pt.optimizer, GradientTransform)
