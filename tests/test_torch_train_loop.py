"""The port's training loop against the JAX trainer's, on the CPU.

Tiny configuration of ``test_torch_model.py`` (2+2 layers, d=64, L=64,
dropout off, f32), the GAN recipe, a 10-contract corpus at batch 4:

  * ``train(2)`` of both trainers from the same initial weights (the JAX
    trainer's, carried over by ``convert.py``), the same data and the same
    loader seeds: every history entry within 1e-4 relative (the bar
    ``test_torch_train.py`` holds one step to; f32 sums in another order
    over 4 Adam steps), and the same checkpoint names;
  * ``restore`` of the best (params only: a fresh optimizer) and the
    latest (full state) checkpoint of each trainer, and of a latest
    without its sidecar: the same params (1e-4), step, LRs, scheduler and
    history on both sides;
  * a full checkpoint saved under another vocab padding restores with its
    vocab-sized leaves adapted and a fresh optimizer.

The epoch interventions and the unfused optimizer are held against JAX in
``test_torch_interventions.py``.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from sct_gan_tpu.config import TrainConfig as JaxTrainConfig
from sct_gan_tpu.data import create_dataloaders as jax_loaders
from sct_gan_tpu.data.synthetic import write_corpus_csv
from sct_gan_tpu.data.tokenizer import SolidityTokenizer as JaxTokenizer
from sct_gan_tpu.models import layers as jax_layers
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu.parallel.mesh import make_mesh
from sct_gan_tpu.train.trainer import SmartContractTrainer as JaxTrainer
from sct_gan_tpu_torch import (SmartContractTrainer,
                               SmartContractTransformer, convert_flax_params)
from sct_gan_tpu_torch.config import TrainConfig
from sct_gan_tpu_torch.data import create_dataloaders
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from sct_gan_tpu_torch.models.layers import Dropout
from test_torch_model import CFG

HIST_TOL = dict(rtol=1e-4, atol=1e-6)
TRAIN_KW = dict(learning_rate=1e-6, use_gan=True, warmup_epochs=1)


class _Empty:
    batch_size = 4

    def __iter__(self):
        return iter(())


def _jax_trainer(loaders, tok, **kw):
    return JaxTrainer(JaxModel(CFG), *loaders, tok,
                      config=JaxTrainConfig(**{**TRAIN_KW, **kw}),
                      mesh=make_mesh(dp=1, mp=1, devices=jax.devices()[:1]),
                      seed=0, verbose=False)


def _port_trainer(loaders, tok, params, **kw):
    model = SmartContractTransformer(CFG, seed=None)
    model.load_state_dict(convert_flax_params(params, CFG))
    return SmartContractTrainer(model, *loaders, tok,
                                config=TrainConfig(**{**TRAIN_KW, **kw}),
                                device="cpu", seed=0, verbose=False)


def _same_params(port_trainer, jax_params, **tol):
    want = convert_flax_params(jax.device_get(jax_params), CFG)
    for n, p in port_trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   err_msg=n, **tol)


def _no_dropout(port_trainer):
    """Dropout off in the port model, the line heads' and the
    discriminator's fixed 0.1 included (the JAX side is patched in
    ``trained``): the two frameworks draw different masks."""
    for m in port_trainer.model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return port_trainer


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both trainers after ``train(2)`` from the same weights, with their
    checkpoint directories. The model's config has dropout 0, but the line
    heads and the discriminator keep a fixed 0.1, whose masks the two
    frameworks draw differently: it is turned off on both sides."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "fast_dropout",
                   lambda x, rate, rng, deterministic=False: x)
        yield _train_both(tmp_path_factory.mktemp("loop"))


def _train_both(d):
    csv = str(d / "corpus.csv")
    write_corpus_csv(csv, n=10, seed=0)
    jtok = JaxTokenizer(vocab_size=CFG.vocab_size)
    ptok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    jt = _jax_trainer(jax_loaders(csv, jtok, batch_size=4,
                                  max_length=CFG.max_length), jtok)
    init = jax.device_get(jt.state.params)
    pt = _no_dropout(_port_trainer(
        create_dataloaders(csv, ptok, batch_size=4,
                           max_length=CFG.max_length), ptok, init))
    jhist = jt.train(2, checkpoint_dir=str(d / "jax"))
    phist = pt.train(2, checkpoint_dir=str(d / "port"))
    return dict(jt=jt, pt=pt, jhist=jhist, phist=phist, d=d, jtok=jtok,
                ptok=ptok, init=init)


def test_train_two_epochs_matches_jax(trained):
    jh, ph = trained["jhist"], trained["phist"]
    assert ph.keys() == jh.keys()
    for k in jh:
        assert len(ph[k]) == len(jh[k]) == 2, k
        np.testing.assert_allclose(ph[k], jh[k], err_msg=k, **HIST_TOL)
    jt, pt = trained["jt"], trained["pt"]
    assert pt.state.step == int(jt.state.step) == 4
    assert pt.best_val_loss == pytest.approx(jt.best_val_loss, rel=1e-4)
    assert pt.lrs == pytest.approx(jt.lrs, rel=1e-6)
    _same_params(pt, jt.state.params, rtol=1e-3, atol=1e-5)


def test_train_writes_the_jax_checkpoint_names(trained):
    d = trained["d"]
    names = sorted(os.listdir(d / "port"))
    assert names == sorted(os.listdir(d / "jax"))
    assert "latest_model_gan" in names
    assert "best_model_gan_epoch_1.meta.json" in names


@pytest.mark.parametrize("which", ["best", "latest", "latest_no_sidecar"])
def test_restore_matches_jax(trained, which, tmp_path):
    """A fresh trainer of each package restores its own checkpoint of the
    same run: params-only best (fresh optimizer, count 0), full latest
    (optimizer state and step), and latest without a sidecar (the full
    state is tried first)."""
    from sct_gan_tpu.train.checkpoint import find_checkpoint
    d = trained["d"]
    paths = {}
    for side in ("jax", "port"):
        path = find_checkpoint(str(d / side),
                               "best" if which == "best" else "latest")
        if which == "latest_no_sidecar":
            bare = str(tmp_path / side / "latest_model_gan")
            shutil.copytree(path, bare)
            path = bare
        paths[side] = path
    jt = _jax_trainer((_Empty(), _Empty()), trained["jtok"])
    pt = _port_trainer((_Empty(), _Empty()), trained["ptok"], trained["init"])
    assert pt.restore(paths["port"]) == jt.restore(paths["jax"])
    _same_params(pt, jt.state.params, rtol=1e-3, atol=1e-5)
    assert pt.state.step == int(jt.state.step)
    count = int(pt.state.opt_state["count"])
    assert count == int(jax.device_get(jt.state.opt_state["count"]))
    assert count == (0 if which == "best" else 4)
    if which != "latest_no_sidecar":
        assert pt.lrs == pytest.approx(jt.lrs, rel=1e-6)
        assert pt.training_history.keys() == jt.training_history.keys()
        for k, v in jt.training_history.items():
            np.testing.assert_allclose(pt.training_history[k], v,
                                       err_msg=k, **HIST_TOL)
        assert pt.scheduler.num_bad == jt.scheduler.num_bad
    if which == "latest":
        # the port's own round trip is exact
        src = trained["pt"]
        for n, p in src.model.named_parameters():
            assert torch.equal(p, dict(pt.model.named_parameters())[n]), n
        for n, t in src.state.opt_state["mu"].items():
            assert torch.equal(t, pt.state.opt_state["mu"][n]), n


def test_restore_adapts_another_vocab_padding(trained, tmp_path):
    """A full checkpoint of a model whose vocab is padded otherwise: the
    vocab-sized leaves are adapted and the optimizer starts fresh."""
    from sct_gan_tpu_torch.train import checkpoint as ckpt
    src = trained["pt"]
    tree = src.state_tree()
    tree["params"] = ckpt.adapt_vocab_params(
        jax.tree_util.tree_map(lambda x: x.detach().numpy(), tree["params"]),
        CFG.padded_vocab_size + 64)
    path = ckpt.save_checkpoint(str(tmp_path), "latest_model_gan", tree,
                                {"epoch": 2, "params_only": False})
    pt = _port_trainer((_Empty(), _Empty()), trained["ptok"], trained["init"])
    assert pt.restore(path) == 2
    assert int(pt.state.opt_state["count"]) == 0
    for n, p in src.model.named_parameters():
        assert torch.equal(p, dict(pt.model.named_parameters())[n]), n
