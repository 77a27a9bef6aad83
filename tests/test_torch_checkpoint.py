"""The port's checkpoints against the JAX package's, on the CPU.

  * ``checkpoint_suffix``, ``find_checkpoint`` and ``adapt_vocab_params``
    give the JAX functions' results on the same names and trees: exactly;
  * torch → flax → torch (and flax → torch → flax) of the parameters and
    the optimizer state: bit for bit;
  * a checkpoint written by ``save_checkpoint`` reads back through
    ``load_checkpoint`` and ``convert.flax_tree_from_npz`` bit for bit,
    with a shape or structure mismatch against a target named as such;
  * ``AsyncSaver``: a newer submit replaces a waiting one of its category,
    ``drop_pending`` drops the waiting snapshots and runs their
    ``on_dropped``, ``wait`` returns once everything is written, the best
    first, and a failed write does not stop the worker;
  * ``SmartContractAnalyzer(model_path)`` on a checkpoint of the tiny
    model gives the JAX analyzer's probabilities on the same params
    (1e-4 absolute, the bar of ``test_torch_analyzer.py``), and a path that
    does not exist raises.
"""
import os
import threading

import jax
import numpy as np
import pytest
import torch

from sct_gan_tpu.data.synthetic import generate_corpus
from sct_gan_tpu.data.tokenizer import SolidityTokenizer
from sct_gan_tpu.infer import SmartContractAnalyzer as JaxAnalyzer
from sct_gan_tpu.train import checkpoint as jckpt
from sct_gan_tpu_torch import (SmartContractAnalyzer,
                               SmartContractTransformer, convert_flax_params)
from sct_gan_tpu_torch.convert import (convert_flax_opt_state,
                                       flax_opt_state_from_torch,
                                       flax_params_from_torch,
                                       flax_tree_from_npz)
from sct_gan_tpu_torch.train import checkpoint as ckpt
from sct_gan_tpu_torch.train.optimizer import FusedOptimizer
from test_torch_model import CFG, flax_params

ATOL = 1e-4


def _leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("aug,gan", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_checkpoint_suffix_matches_jax(aug, gan):
    assert ckpt.checkpoint_suffix(aug, gan) == jckpt.checkpoint_suffix(aug,
                                                                       gan)


@pytest.mark.parametrize("prefer", ["best", "latest"])
def test_find_checkpoint_matches_jax(tmp_path, prefer):
    """Best by epoch number (epoch 10 over 9, a name without an epoch
    last), latest by name; sidecars and files are not checkpoints."""
    for name in ("best_model_gan_epoch_9", "best_model_gan_epoch_10",
                 "best_model_gan_epoch_x", "latest_model_gan",
                 "latest_model_augmented_gan", "other"):
        (tmp_path / name).mkdir()
        (tmp_path / (name + ".meta.json")).write_text("{}")
    (tmp_path / "best_model_gan_epoch_99").write_text("a file")
    got = ckpt.find_checkpoint(str(tmp_path), prefer)
    assert got == jckpt.find_checkpoint(str(tmp_path), prefer)
    assert os.path.basename(got) == ("best_model_gan_epoch_10"
                                     if prefer == "best"
                                     else "latest_model_gan")
    assert ckpt.find_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("vocab", [64, 512, 600])
def test_adapt_vocab_params_matches_jax(vocab):
    """Sliced (64), unchanged (512) and zero-padded (600) embedding tables
    and LM head, every other leaf untouched."""
    params = flax_params(CFG, seed=4)
    got = ckpt.adapt_vocab_params(params, vocab)
    want = jckpt.adapt_vocab_params(params, vocab)
    _assert_same_tree(got, want)
    assert np.asarray(got["output_layer"]["kernel"]).shape[1] == vocab
    assert np.asarray(got["embedding"]["embedding"]).shape[0] == vocab


def test_params_round_trip_is_exact():
    """flax → port → flax and port → flax → port give the same bits."""
    params = flax_params(CFG, seed=5)
    sd = convert_flax_params(params, CFG)
    back = flax_params_from_torch({k: v.numpy() for k, v in sd.items()}, CFG)
    _assert_same_tree(back, jax.tree_util.tree_map(np.asarray, params))
    again = convert_flax_params(flax_params_from_torch(sd, CFG), CFG)
    assert again.keys() == sd.keys()
    for k in sd:
        assert torch.equal(again[k], sd[k]), k
    with pytest.raises(ValueError, match="missing"):
        flax_params_from_torch({k: v for k, v in sd.items()
                                if k != "embedding.weight"}, CFG)


def test_opt_state_round_trip_is_exact():
    """The port's optimizer state (count, mu, nu) → the JAX FusedOptimizer
    layout → back, bit for bit."""
    model = SmartContractTransformer(CFG, seed=0)
    opt = FusedOptimizer(model.named_parameters(), use_gan=True)
    state = opt.init()
    g = torch.Generator().manual_seed(1)
    for key in ("mu", "nu"):
        for t in state[key].values():
            t.copy_(torch.randn(t.shape, generator=g))
    state["count"] = torch.tensor(7, dtype=torch.int32)
    flax = flax_opt_state_from_torch(state, CFG)
    back = convert_flax_opt_state(
        jax.tree_util.tree_map(lambda x: np.asarray(x), flax), CFG)
    assert int(back["count"]) == 7 and back["count"].dtype == torch.int32
    for key in ("mu", "nu"):
        assert back[key].keys() == state[key].keys()
        for n, t in state[key].items():
            assert torch.equal(back[key][n], t), (key, n)


def test_save_and_load_round_trip(tmp_path):
    """A wrapped state (params, opt_state, step) with its sidecar reads
    back the same, through ``load_checkpoint`` and ``flax_tree_from_npz``;
    a target with another shape or a key the file lacks raises, naming the
    mismatch."""
    params = jax.tree_util.tree_map(np.asarray, flax_params(CFG, seed=6))
    tree = {"params": params, "step": np.asarray(12, np.int32),
            "opt_state": {"count": np.asarray(3, np.int32), "mu": params,
                          "nu": params}}
    meta = {"epoch": 3, "val_loss": 1.25, "params_only": False,
            "lrs": {"base": 1e-5}, "training_history": {"val_loss": [2.0]}}
    path = ckpt.save_checkpoint(str(tmp_path), "latest_model_gan", tree, meta)
    assert path == str(tmp_path / "latest_model_gan")
    assert sorted(os.listdir(path)) == [ckpt.STATE_FILE]
    got, got_meta = ckpt.load_checkpoint(path)
    _assert_same_tree(got, tree)
    assert got_meta == meta
    _assert_same_tree(flax_tree_from_npz(os.path.join(path, ckpt.STATE_FILE)),
                      tree)
    slim, _ = ckpt.load_checkpoint(path, target={"params": params,
                                                 "step": tree["step"]})
    assert set(slim) == {"params", "step"}
    wide = ckpt.adapt_vocab_params(params, 600)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_checkpoint(path, target={"params": wide})
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load_checkpoint(path, target={"params": params,
                                           "extra": np.zeros(2)})


class _BlockingSaves:
    """Stands in for ``save_checkpoint``: records each name and holds the
    first save until ``release`` is set."""

    def __init__(self):
        self.names, self.release, self.started = [], threading.Event(), \
            threading.Event()

    def __call__(self, checkpoint_dir, name, state_tree, metadata):
        self.started.set()
        if not self.names:
            assert self.release.wait(timeout=30)
        self.names.append(name)
        return name


def _wait(saver, timeout=30):
    done = threading.Thread(target=saver.wait, daemon=True)
    done.start()
    done.join(timeout)
    assert not done.is_alive(), "AsyncSaver.wait did not return"


def test_async_saver_slots_drop_and_wait(monkeypatch):
    """While best A is being written: latest L1 waits, L2 replaces it,
    best B queues; dropping runs B's on_dropped and none of L2's
    callbacks; then only A is written and on_saved runs for it."""
    saves = _BlockingSaves()
    monkeypatch.setattr(ckpt, "save_checkpoint", saves)
    saver = ckpt.AsyncSaver()
    events = []
    snap = {"w": torch.ones(3)}
    saver.submit("d", "best_model_epoch_1", snap, {},
                 on_saved=lambda: events.append("saved A"))
    assert saves.started.wait(timeout=30)
    saver.submit("d", "latest_model", snap, {},
                 on_dropped=lambda: events.append("dropped L1"))
    saver.submit("d", "latest_model_2", snap, {},
                 on_saved=lambda: events.append("saved L2"))
    saver.submit("d", "best_model_epoch_2", snap, {},
                 on_dropped=lambda: events.append("dropped B"))
    assert saver.drop_pending() == 2
    assert events == ["dropped B"]
    saves.release.set()
    _wait(saver)
    assert saves.names == ["best_model_epoch_1"]
    assert events == ["dropped B", "saved A"]


def test_async_saver_writes_best_first_from_a_snapshot(monkeypatch, tmp_path):
    """The snapshot is taken at submit: changing the live tensor after it
    does not reach the file. With both waiting, the best is written first;
    a failing write is logged and the next one is still written."""
    saves = _BlockingSaves()
    real = ckpt.save_checkpoint
    written = []

    def save(checkpoint_dir, name, state_tree, metadata):
        saves(checkpoint_dir, name, state_tree, metadata)
        if name == "broken":
            raise OSError("disk full")
        written.append(name)
        return real(checkpoint_dir, name, state_tree, metadata)
    monkeypatch.setattr(ckpt, "save_checkpoint", save)
    logs = []
    saver = ckpt.AsyncSaver(log=logs.append)
    live = {"w": torch.zeros(4)}
    saver.submit(str(tmp_path), "broken", live, {})
    assert saves.started.wait(timeout=30)
    saver.submit(str(tmp_path), "latest_model", live, {"epoch": 1})
    saver.submit(str(tmp_path), "best_model_epoch_1", live, {"epoch": 1})
    live["w"].add_(5.0)
    saves.release.set()
    _wait(saver)
    assert written == ["best_model_epoch_1", "latest_model"]
    assert any("FAILED" in m for m in logs)
    tree, meta = ckpt.load_checkpoint(str(tmp_path / "latest_model"))
    assert np.array_equal(tree["w"], np.zeros(4, np.float32))
    assert meta == {"epoch": 1}


@pytest.fixture(scope="module")
def saved_params(tmp_path_factory):
    """Flax params of the tiny model, saved by the port as a best (params
    only) checkpoint with the vocab sliced to 500 rows, which the
    analyzer pads back."""
    params = jax.tree_util.tree_map(np.asarray, flax_params(CFG, seed=7))
    d = tmp_path_factory.mktemp("ckpt")
    path = ckpt.save_checkpoint(
        str(d), "best_model_gan_epoch_3",
        {"params": ckpt.adapt_vocab_params(params, 500),
         "step": np.asarray(9, np.int32)},
        {"epoch": 3, "val_loss": 0.5, "params_only": True})
    return params, path


def test_analyzer_model_path_matches_jax(saved_params):
    """The first positional argument is the checkpoint: detection on three
    contracts equals the JAX analyzer's on the same params."""
    params, path = saved_params
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    port = SmartContractAnalyzer(path, model_config=CFG, tokenizer=tok,
                                 device="cpu", batch_size=2, verbose=False)
    jax_an = JaxAnalyzer(model_config=CFG, tokenizer=tok, params=params,
                         batch_size=2, verbose=False)
    codes = [r["source_code"] for r in generate_corpus(n=3, seed=2)]
    for got, want in zip(port.analyze_multiple_contracts(codes),
                         jax_an.analyze_multiple_contracts(codes)):
        for key in ("contract_probabilities", "line_probabilities"):
            np.testing.assert_allclose(np.asarray(got[key]),
                                       np.asarray(want[key]), rtol=0,
                                       atol=ATOL, err_msg=key)


def test_analyzer_missing_model_path_raises(tmp_path):
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    with pytest.raises(FileNotFoundError, match="model_path"):
        SmartContractAnalyzer(str(tmp_path / "no_such_checkpoint"),
                              model_config=CFG, tokenizer=tok, device="cpu",
                              verbose=False)
