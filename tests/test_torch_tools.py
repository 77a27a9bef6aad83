"""The port's training and evaluation entry points
(``sct_gan_tpu_torch/tools``: ``train_synthetic``, ``eval_checkpoint``,
``eval_v2_infamily``, ``analyze_v2_errors``, ``time_opt``,
``run_corpus_v2``) on the CPU at a tiny size.

The corpus-v2 loaders of ``build_run`` equal, array for array and batch for
batch, the JAX package's loaders built as the JAX tool builds them. The
eval tail's matrix on weights carried from a tiny JAX model equals the JAX
harness's within the analyzer tests' 1e-4 absolute (the same weights and
contracts through the two frameworks' forwards; ``test_torch_evals.py``),
perplexity within 1e-4 relative. Asked for the card, every tool's
``main`` (the bench and step-attribution tools' too) raises without one.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from sct_gan_tpu.data.dataset import ArrayDataLoader as JaxLoader
from sct_gan_tpu.data.dataset import \
    SmartContractVulnerabilityDataset as JaxDataset
from sct_gan_tpu.data.native_tokenizer import \
    NativeSolidityTokenizer as JaxNativeTokenizer
from sct_gan_tpu.data.synthetic import _FAMILIES
from sct_gan_tpu.data.synthetic import generate_corpus as jax_corpus
from sct_gan_tpu.data.tokenizer import SolidityTokenizer as JaxTokenizer
from sct_gan_tpu.evals.harness import (BASELINE_CONTRACT_THRESHOLDS,
                                       BASELINE_LINE_THRESHOLDS)
from sct_gan_tpu.evals.harness import \
    evaluate_model_performance as jax_evaluate
from sct_gan_tpu.evals.perplexity import compute_perplexity as jax_perplexity
from sct_gan_tpu.infer import SmartContractAnalyzer as JaxAnalyzer
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from sct_gan_tpu_torch.tools import (analyze_v2_errors, bench,
                                     bench_decode, eval_checkpoint,
                                     eval_v2_infamily, peak_matmul,
                                     quick_bench, run_corpus_v2, time_decode,
                                     time_fwd, time_fwd_modules, time_opt,
                                     train_synthetic)
from sct_gan_tpu_torch.tools._common import v2_loader
from sct_gan_tpu_torch.train.checkpoint import (find_checkpoint,
                                                save_checkpoint)
from test_torch_evals import _close
from test_torch_model import CFG, flax_params

# the JAX tool's summary.json keys (tools/train_synthetic.py:203-216)
SUMMARY_KEYS = {"contracts", "train_family", "epochs_requested",
                "epochs_run", "train_minutes", "final_train_loss",
                "best_val_loss", "perplexity", "contract_overall",
                "line_overall", "matrix", "checkpoint"}
TINY = ["--device", "cpu", "--d-model", "32", "--layers", "1",
        "--seq", "128"]
RUN = [*TINY, "--contracts", "8", "--epochs", "1"]
BATCH_KEYS = ("input_ids", "attention_mask", "contract_vulnerabilities",
              "vulnerable_lines")


def _jax_v2_loaders(contracts, eval_contracts, seq, batch_size=8, fam=0):
    """The JAX tool's corpus-v2 loaders, as tools/train_synthetic.py:82-112
    builds them (train seed 0, validation 777, family f's test 10**6 + f)."""
    tok = JaxNativeTokenizer(vocab_size=50265)
    n_eval = eval_contracts or max(contracts // 5, 20)
    n_val = max(contracts // 10, 16)
    train_recs = jax_corpus(contracts, seed=0, family=fam, distractors=True)
    val_recs = jax_corpus(n_val, seed=777, family=fam, distractors=True)
    mk = lambda recs: JaxDataset(records=recs, tokenizer=tok,
                                 max_length=seq)
    train = JaxLoader(mk(train_recs), batch_size=batch_size, shuffle=True,
                      seed=0)
    val = JaxLoader(mk(val_recs), batch_size=batch_size)
    tests = {f"fam{f}": JaxLoader(mk(jax_corpus(
        n_eval, seed=10 ** 6 + f, family=f, distractors=True)),
        batch_size=batch_size) for f in sorted(_FAMILIES)}
    return train, val, tests


def _same_data(got, want, name):
    assert len(got.dataset.data) == len(want.dataset.data), name
    for i, (g, w) in enumerate(zip(got.dataset.data, want.dataset.data)):
        assert g.keys() == w.keys(), (name, i)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}/{k}")
            else:
                assert g[k] == w[k], (name, i, k)
    batches = list(zip(got, want))
    assert len(batches) == len(want), name
    for b, (g, w) in enumerate(batches):
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=f"{name} batch {b} {k}")


def test_build_run_matches_the_jax_tools_loaders(tmp_path):
    args = train_synthetic.parse_args(
        ["--corpus-v2", "--contracts", "8", "--eval-contracts", "4",
         "--seq", "128", "--device", "cpu", "--out", str(tmp_path)])
    run = train_synthetic.build_run(args)
    train, val, tests = _jax_v2_loaders(8, 4, 128)
    _same_data(run.train_loader, train, "train")    # first epoch, shuffled
    _same_data(run.val_loader, val, "val")
    assert sorted(run.test_loaders) == sorted(tests) == ["fam0", "fam1",
                                                         "fam2"]
    for name in tests:
        _same_data(run.test_loaders[name], tests[name], name)


@pytest.fixture(scope="module")
def v2_run(tmp_path_factory):
    """``run_corpus_v2.run`` at a tiny size: ``train_synthetic --corpus-v2``
    (8 contracts, 1 epoch, 4 a family), ``eval_v2_infamily`` on its best
    checkpoint and on an untrained one, ``analyze_v2_errors`` on family 2
    and ``time_opt`` both ways, each through its ``main``."""
    out = str(tmp_path_factory.mktemp("v2run"))
    secs = run_corpus_v2.run(out, 1, "cpu", contracts=8, eval_contracts=4,
                             n_infamily=4, n_errors=4, d_model=32, layers=1,
                             seq=128)
    assert list(secs) == ["train_synthetic", "eval_v2_infamily",
                          "analyze_v2_errors", "eval_v2_infamily_untrained",
                          "time_opt", "time_opt_fused"]
    return out


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_train_synthetic_main_writes_the_jax_summary(v2_run):
    summary = _load(os.path.join(v2_run, "summary.json"))
    assert set(summary) == SUMMARY_KEYS
    assert summary["epochs_run"] == 1 and summary["train_family"] == 0
    assert sorted(summary["matrix"]) == ["fam0", "fam1", "fam2"]
    for col in summary["matrix"].values():
        for level in ("contract_overall", "line_overall"):
            assert all(math.isfinite(v) for v in col[level].values()
                       if isinstance(v, float))
        for per in ("contract_per_type", "line_per_type"):
            assert len(col[per]) == 8
            assert all(math.isfinite(v) for v in col[per].values())
    assert math.isfinite(summary["perplexity"]["perplexity"])
    assert summary["checkpoint"] == find_checkpoint(
        os.path.join(v2_run, "checkpoints"))
    timing = _load(os.path.join(v2_run, "timing.json"))
    assert timing["epochs_run"] == 1 and timing["steps"] == 1


def test_eval_v2_infamily_main_on_the_run(v2_run):
    trained = _load(os.path.join(v2_run, "summary_infamily.json"))
    floor = _load(os.path.join(v2_run, "untrained", "summary_infamily.json"))
    for summary in (trained, floor):
        assert summary["n_contracts"] == 4 and summary["seed"] == 2_000_000
        assert math.isfinite(summary["contract_overall"]["pr_auc"])
    assert trained["checkpoint"] == find_checkpoint(
        os.path.join(v2_run, "checkpoints"))
    assert floor["checkpoint"].endswith("best_model_untrained_epoch_0")
    assert not os.path.exists(os.path.join(v2_run, "untrained",
                                           "checkpoints"))


def test_analyze_v2_errors_main_on_the_run(v2_run):
    got = _load(os.path.join(v2_run, "errors_fam2.json"))
    assert got["family"] == 2 and got["contracts"] == 4
    assert set(got["line_totals"]) == {"true_positives", "false_positives",
                                       "false_negatives"}
    assert set(got["line_tp_fp_fn"]) <= set(BASELINE_LINE_THRESHOLDS)
    assert got["checkpoint"] == find_checkpoint(
        os.path.join(v2_run, "checkpoints"))


def test_eval_checkpoint_main_on_a_csv_run(tmp_path):
    out = str(tmp_path)
    assert train_synthetic.main([*RUN, "--out", out]) == 0
    assert os.path.exists(os.path.join(out, "corpus.csv"))
    assert _load(os.path.join(out, "summary.json"))["matrix"] is None
    assert eval_checkpoint.main([*TINY, "--run", out]) == 0
    summary = _load(os.path.join(out, "summary.json"))
    assert summary["epoch"] == 1
    assert math.isfinite(summary["perplexity"]["perplexity"])


def test_evaluate_run_matches_the_jax_harness(tmp_path):
    """One family of 4 contracts at L=64 under the same weights: the
    port's eval tail (checkpoint written by the port, read back by its
    analyzer) against the JAX harness on the JAX analyzer."""
    params = flax_params(CFG, seed=1)
    ckdir = str(tmp_path / "checkpoints")
    save_checkpoint(ckdir, "best_model_gan_epoch_1", {"params": params},
                    {"epoch": 1})
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    loader = v2_loader(tok, 4, 10 ** 6, 0, CFG.max_length, 8)
    run = train_synthetic.Run(CFG, tok, None, loader, {"fam0": loader})
    args = train_synthetic.parse_args(
        ["--corpus-v2", "--contracts", "8", "--device", "cpu",
         "--out", str(tmp_path)])
    summary = train_synthetic.evaluate_run(
        args, run, ckdir, {"train_loss": [1.0], "val_loss": [1.0]}, 60.0)

    jax_tok = JaxTokenizer(vocab_size=CFG.vocab_size)
    jax_loader = JaxLoader(JaxDataset(
        records=jax_corpus(4, seed=10 ** 6, family=0, distractors=True),
        tokenizer=jax_tok, max_length=CFG.max_length), batch_size=8)
    jax_an = JaxAnalyzer(model_config=CFG, tokenizer=jax_tok, params=params,
                         verbose=False)
    res = jax_evaluate(val_dataloader=jax_loader, analyzer=jax_an,
                       contract_thresholds=BASELINE_CONTRACT_THRESHOLDS,
                       line_thresholds=BASELINE_LINE_THRESHOLDS,
                       verbose=False, output_file=str(tmp_path / "jax.json"))
    per = lambda level: {vt: d.get("pr_auc") for vt, d in
                         res[level]["per_vulnerability"].items()}
    want = {"contract_overall": res["contract_level"]["overall"],
            "line_overall": res["line_level"]["overall"],
            "contract_per_type": per("contract_level"),
            "line_per_type": per("line_level")}
    _close(summary["matrix"]["fam0"], want)
    _close(summary["contract_overall"], want["contract_overall"])
    ppl = jax_perplexity(jax_an.model, params, jax_loader)
    for k in ppl:
        assert math.isclose(summary["perplexity"][k], ppl[k], rel_tol=1e-4)
    assert summary["train_minutes"] == 1.0 and summary["epochs_run"] == 1


@pytest.mark.parametrize("tool", [
    train_synthetic, eval_checkpoint, eval_v2_infamily, analyze_v2_errors,
    time_opt, run_corpus_v2, bench, quick_bench, bench_decode, peak_matmul,
    time_fwd, time_decode, time_fwd_modules],
    ids=lambda m: m.__name__.rsplit(".", 1)[1])
@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_on_cuda_raises_without_a_card(tool, tmp_path):
    argv = ["--device", "cuda"]
    if tool is analyze_v2_errors:
        argv += ["--ckpt", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main(argv)


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
def test_time_opt_main_on_the_cpu(v2_run, fused):
    got = _load(os.path.join(
        v2_run, "time_opt_fused.json" if fused else "time_opt.json"))
    assert got["optimizer"] == ("FusedOptimizer" if fused
                                else "GradientTransform")
    assert got["ms"] > 0 and got["launches"] is None
    assert got["parameters"] == 195     # the 1+1-layer GAN model's leaves


def test_time_opt_stage_updates_like_a_train_step():
    """One stage moves every parameter and counts one Adam step, as the
    optimizer does inside the train step."""
    from sct_gan_tpu_torch.tools._common import bench_trainer
    trainer = bench_trainer("cpu", True, d_model=32, layers=1, seq=128)
    before = {n: p.clone() for n, p in trainer.state.params.items()}
    time_opt.stage_fn(trainer)(1.0)
    assert int(trainer.state.opt_state["count"]) == 1
    assert all(not torch.equal(before[n], p)
               for n, p in trainer.state.params.items())


def test_max_minutes_ends_the_run_after_an_epoch(tmp_path):
    """``--max-minutes`` stops ``train`` once the next epoch would not fit:
    a near-zero budget runs one epoch of the three asked for."""
    out = str(tmp_path)
    assert train_synthetic.main([*TINY, "--contracts", "8", "--epochs", "3",
                                 "--max-minutes", "0.001", "--no-aug",
                                 "--out", out]) == 0
    summary = _load(os.path.join(out, "summary.json"))
    assert summary["epochs_requested"] == 3 and summary["epochs_run"] == 1


def test_older_bests_pruner_keeps_the_two_newest(tmp_path):
    d = str(tmp_path)
    for epoch in (1, 3, 10, 12):
        name = os.path.join(d, f"best_model_augmented_gan_epoch_{epoch}")
        os.makedirs(name)
        open(name + ".meta.json", "w").close()
    run_corpus_v2.OlderBestsPruner(d, period=3600.0).close()
    assert sorted(os.listdir(d)) == [
        "best_model_augmented_gan_epoch_10",
        "best_model_augmented_gan_epoch_10.meta.json",
        "best_model_augmented_gan_epoch_12",
        "best_model_augmented_gan_epoch_12.meta.json"]
