"""The port's TASC trainer against the JAX package's, on the CPU.

One whole step (multiclass ``TINY``, dropout 0, ``learning_rate=1e-6``) on
the same numpy-seeded parameters and CodeBERT embeddings, batch ids and
labels: the four losses, each submodule's Adam moments and count, and every
new parameter agree to 1e-4 relative / 1e-5 absolute, the whole-step bar of
``test_torch_train.py``.

The JAX side is the JAX trainer with its per-submodule optimizers replaced
here by ``optax.chain(optax.masked(adam, m), optax.masked(set_to_zero(),
not m))``, its states re-initialised from them and its step rebuilt from
them. The shipped ``optax.masked(adam, m)`` passes the updates of the
parameters outside ``m`` through unchanged, so the shipped G step adds the
raw gradient of the G loss to the discriminator (the reference steps each
Adam over its own submodule only); ``test_shipped_jax_g_step_leaks_...``
pins that difference against the port. Nothing of the JAX package is
edited.

Also: the PatternMatcher weak labels against JAX's, and ``train(2)`` →
a fresh trainer's ``restore``, bit for bit → ``validate``, on the port
alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sct_gan_tpu.data.tasc_dataset import TASCDataLoader as JaxLoader
from sct_gan_tpu.data.tasc_dataset import TASCDataset as JaxDataset
from sct_gan_tpu.data.tokenizer import SolidityTokenizer as JaxTokenizer
from sct_gan_tpu.variants import tasc as jtasc
from sct_gan_tpu.variants import tasc_trainer as jtrainer
from sct_gan_tpu_torch.config import CodeBERTConfig
from sct_gan_tpu_torch.convert import (_flatten, convert_flax_params,
                                       convert_tasc_opt_states,
                                       tasc_opt_states_from_torch)
from sct_gan_tpu_torch.data import (SolidityTokenizer, TASCDataLoader,
                                    TASCDataset, tasc_records_from_corpus)
from sct_gan_tpu_torch.variants import (FlaxCodeBERT,
                                        SmartContractVulnerabilityGAN,
                                        VulnerabilityDetectionTrainer)
from test_torch_tasc import (TINY, jax_config, numpy_tree, port_model,
                             tasc_flax_params)

STEP_TOL = dict(rtol=1e-4, atol=1e-5)
CFG = dataclasses.replace(TINY, dropout=0.0)
LR = 1e-6


def _codebert_tree(cfg):
    from sct_gan_tpu.variants.codebert import FlaxCodeBERT as JaxCodeBERT
    jm = JaxCodeBERT(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                     num_layers=cfg.codebert_num_layers,
                     num_heads=cfg.codebert_nhead,
                     dim_feedforward=cfg.codebert_ffn)
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda k: jm.init(
        {"params": k}, ids, jnp.ones_like(ids))["params"],
        jax.random.PRNGKey(0))
    return numpy_tree(shapes, seed=6)


def _records(multiclass=True):
    return tasc_records_from_corpus(n=6, seed=0, multiclass=multiclass)


def port_trainer(cfg=CFG, params=None, cb=None, lr=LR, loaders=None):
    tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
    if loaders is None:
        ds = TASCDataset(_records(cfg.multiclass), tok,
                         max_length=cfg.max_length,
                         multiclass=cfg.multiclass)
        loaders = (TASCDataLoader(ds, batch_size=3, shuffle=True),
                   TASCDataLoader(ds, batch_size=3))
    model = (port_model(cfg, params) if params is not None
             else SmartContractVulnerabilityGAN(cfg))
    cb_sd = (convert_flax_params(cb, CodeBERTConfig.from_tasc(cfg))
             if cb is not None else
             FlaxCodeBERT.from_config(CodeBERTConfig.from_tasc(cfg),
                                      seed=0).state_dict())
    return VulnerabilityDetectionTrainer(
        model, *loaders, learning_rate=lr, tokenizer=tok,
        codebert_params=cb_sd, verbose=False, device="cpu")


@pytest.fixture(scope="module")
def jax_trainer():
    """The JAX trainer on the numpy-seeded trees, with its shipped
    optimizers and states kept aside and replaced by the ones that update
    only their own submodule."""
    params, cb = tasc_flax_params(CFG), _codebert_tree(CFG)
    jtok = JaxTokenizer(vocab_size=CFG.vocab_size)
    ds = JaxDataset(_records(), jtok, max_length=CFG.max_length,
                    multiclass=True)
    jt = jtrainer.VulnerabilityDetectionTrainer(
        jtasc.SmartContractVulnerabilityGAN(jax_config(CFG)),
        JaxLoader(ds, 3), JaxLoader(ds, 3), learning_rate=LR,
        tokenizer=jtok, codebert_params=cb, verbose=False)
    jt.params = jax.tree_util.tree_map(jnp.asarray, params)
    shipped = ({k: jt.txs[k] for k in jt.opt_keys},
               {k: jt.txs[k].init(jt.params) for k in jt.opt_keys})
    adam = optax.adam(LR, b1=0.5, b2=0.999)
    for k in jt.opt_keys:
        m = jtrainer._subtree_mask(jt.params, k)
        jt.txs[k] = optax.chain(
            optax.masked(adam, m),
            optax.masked(optax.set_to_zero(),
                         jax.tree_util.tree_map(lambda x: not x, m)))
    jt.opt_states = {k: tx.init(jt.params) for k, tx in jt.txs.items()}
    jt._train_step = jax.jit(jt._make_train_step())
    return jt, params, cb, shipped


def _step_inputs(jt, seed=7):
    """A batch of the synthetic corpus, numpy CodeBERT-shaped embeddings
    and the JAX trainer's weak labels."""
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    ds = TASCDataset(_records(), tok, max_length=CFG.max_length,
                     multiclass=True)
    batch = next(iter(TASCDataLoader(ds, batch_size=3)))
    rng = np.random.default_rng(seed)
    shape = (3, CFG.max_length, CFG.d_model)
    ce = rng.normal(0, 1, shape).astype(np.float32)
    pe = rng.normal(0, 1, shape).astype(np.float32)
    ids = np.asarray(batch["input_ids"])
    return (ce, pe, ids, np.asarray(batch["label"], np.float32),
            np.asarray(batch["vulnerability_labels"], np.float32),
            jt._pattern_labels(ids))


def _jax_moments(opt_states, key):
    """(count, mu, nu) of submodule ``key`` from the chained masked state:
    the moments are full trees with masked-out leaves, ``key``'s subtree
    is its own."""
    st = opt_states[key][0].inner_state[0]
    return {"count": st.count, "mu": st.mu[key], "nu": st.nu[key]}


def test_whole_step_matches_jax(jax_trainer):
    jt, params, cb, _ = jax_trainer
    ce, pe, ids, labels, vuln, pattern = _step_inputs(jt)
    new_params, new_opts, metrics = jt._train_step(
        jt.params, jt.opt_states, ce, pe, ids, labels, vuln, pattern,
        jax.random.PRNGKey(0))

    pt = port_trainer(params=params, cb=cb)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = pt._train_step(t(ce), t(pe), t(ids).long(), t(labels), t(vuln),
                         {k: t(v) for k, v in pattern.items()})
    for k in ("g_loss", "d_loss", "decoder_loss", "classifier_loss"):
        np.testing.assert_allclose(got[k].item(), float(metrics[k]),
                                   **STEP_TOL, err_msg=k)

    want_opt = convert_tasc_opt_states(
        {k: _jax_moments(new_opts, k) for k in jt.opt_keys}, CFG)
    got_opt = pt.adam_states()
    assert set(got_opt) == set(want_opt) == {
        "generator", "discriminator", "decoder", "vulnerability_classifier"}
    for k, want in want_opt.items():
        assert int(got_opt[k]["count"]) == int(want["count"]) == 1
        for m in ("mu", "nu"):
            assert got_opt[k][m].keys() == want[m].keys()
            for name, w in want[m].items():
                np.testing.assert_allclose(got_opt[k][m][name].numpy(),
                                           w.numpy(), **STEP_TOL,
                                           err_msg=f"{k} {m} {name}")

    want_p = convert_flax_params(new_params, CFG)
    for name, p in pt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   **STEP_TOL, err_msg=name)

    # the Adam states' converters are each other's inverse
    back = convert_tasc_opt_states(tasc_opt_states_from_torch(got_opt, CFG),
                                   CFG)
    for k in got_opt:
        for m in ("mu", "nu"):
            assert all(torch.equal(back[k][m][n], got_opt[k][m][n])
                       for n in got_opt[k][m])


def test_shipped_jax_g_step_leaks_into_discriminator(jax_trainer):
    """The shipped JAX ``txs["generator"]`` returns the discriminator's
    gradient of the G loss as the discriminator's update, so
    ``apply_updates`` moves D by it; the port's G step leaves every D
    parameter bit for bit as it was (and does move G)."""
    jt, params, cb, (txs, opt_states) = jax_trainer
    model = jt.model
    mean = np.random.default_rng(8).normal(
        0, 1, (3, CFG.d_model)).astype(np.float32)

    def g_loss(p):     # the G loss of the JAX step (tasc_trainer.py:204-211)
        synthetic = model.apply({"params": p}, mean,
                                method=lambda m, x: m.generator(x))
        fake = model.apply({"params": p}, synthetic,
                           method=lambda m, x: m.discriminator(x))
        fake = jnp.clip(fake, 1e-7, 1 - 1e-7)
        return -jnp.log(fake).mean()

    p = jax.tree_util.tree_map(jnp.asarray, params)
    grads = jax.jit(jax.grad(g_loss))(p)
    upd, _ = txs["generator"].update(grads, opt_states["generator"], p)
    leaked = jax.tree_util.tree_leaves(upd["discriminator"])
    raw = jax.tree_util.tree_leaves(grads["discriminator"])
    assert all(np.array_equal(np.asarray(u), np.asarray(g))
               for u, g in zip(leaked, raw))
    assert any(np.abs(np.asarray(g)).max() > 0 for g in raw)

    pt = port_trainer(params=params, cb=cb)
    before = {n: q.detach().clone()
              for n, q in pt.model.named_parameters()}
    pt._g_step(torch.from_numpy(mean))
    after = dict(pt.model.named_parameters())
    for n, q in after.items():
        if n.startswith("discriminator."):
            assert torch.equal(q, before[n]), n
    assert any(not torch.equal(q, before[n]) for n, q in after.items()
               if n.startswith("generator."))
    assert all(q.grad is None for q in after.values())


def test_pattern_labels_match_jax(jax_trainer):
    jt, params, cb, _ = jax_trainer
    pt = port_trainer(params=params, cb=cb)
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    codes = [r["source_code"] for r in _records()]
    codes.append("pragma solidity ^0.4.0;\ncontract T { function f() "
                 "public { require(now > 5); msg.sender.transfer(1); "
                 "balance -= 1; x.delegatecall(d); } }")
    ids = np.asarray(tok(codes, max_length=CFG.max_length,
                         padding="max_length", truncation=True,
                         return_tensors="np")["input_ids"])
    want, got = jt._pattern_labels(ids), pt._pattern_labels(ids)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    assert any(v.any() for v in got.values())


def _state_arrays(trainer):
    return {"/".join(k): torch.as_tensor(v).detach().numpy()
            for k, v in _flatten(trainer.state_tree())}


@pytest.mark.parametrize("multiclass", [False, True],
                         ids=["binary", "multiclass"])
def test_train_restore_validate_cpu(multiclass, tmp_path):
    """``train(2)`` with dropout on writes the best checkpoint; a saved
    final state restores into a fresh trainer bit for bit (params, every
    Adam moment and count, history, best val loss) and validates to the
    same loss."""
    cfg = dataclasses.replace(TINY, multiclass=multiclass)
    t1 = port_trainer(cfg, lr=1e-3)
    hist = t1.train(2, checkpoint_dir=str(tmp_path))
    assert len(hist["g_loss"]) == 2 and len(hist["val_loss"]) == 2
    assert all(np.isfinite(hist[k]).all() for k in
               ("g_loss", "d_loss", "decoder_loss", "val_loss"))
    assert (np.asarray(hist["classifier_loss"]) > 0).all() == multiclass
    assert (tmp_path / "tasc_best.meta.json").exists()
    path = t1.save(str(tmp_path), "tasc_final")

    t2 = port_trainer(cfg, lr=1e-3)
    assert t2.restore(path) == 2
    a, b = _state_arrays(t1), _state_arrays(t2)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert int(a["opt_states/generator/count"]) == 4    # 2 epochs x 2 steps
    assert t2.best_val_loss == t1.best_val_loss
    assert t2.training_history == t1.training_history
    assert t2.validate() == t1.validate()
    assert 1 <= port_trainer(cfg).restore(str(tmp_path / "tasc_best")) <= 2
