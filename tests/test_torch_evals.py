"""The port's eval modules against the JAX package's, on the CPU.

``compute_metrics_for_threshold`` is numpy in the port and scikit-learn in
the JAX package: equal within 1e-9 (the same sums in another order).
Everything downstream of detection is held to the analyzer tests' 1e-4
(the fixtures of ``test_torch_analyzer.py``: same weights, same corpus),
perplexity to 1e-4 relative.
"""
import math

import numpy as np
import pytest

from sct_gan_tpu.data import create_dataloaders as jax_dataloaders
from sct_gan_tpu.data.synthetic import write_corpus_csv
from sct_gan_tpu.evals import collect_validation_results as jax_collect
from sct_gan_tpu.evals import compute_contract_level_metrics as jax_contract
from sct_gan_tpu.evals import compute_line_level_metrics as jax_line
from sct_gan_tpu.evals import compute_metrics_for_threshold as jax_metrics
from sct_gan_tpu.evals import evaluate_model_performance as jax_evaluate
from sct_gan_tpu.evals.perplexity import compute_perplexity as jax_perplexity
from sct_gan_tpu_torch.data import create_dataloaders
from sct_gan_tpu_torch.evals import (collect_validation_results,
                                     compute_contract_level_metrics,
                                     compute_line_level_metrics,
                                     compute_metrics_for_threshold,
                                     compute_perplexity,
                                     evaluate_model_performance,
                                     visualize_training_progress)
from sct_gan_tpu_torch.infer import analyze_contracts
from test_torch_analyzer import ATOL, analyzers, contracts  # noqa: F401
from test_torch_model import CFG


def _metric_cases():
    rng = np.random.default_rng(0)
    cases = {}
    for i in range(3):
        y = (rng.random(60) < 0.3).astype(np.int32)
        probs = np.round(rng.random(60), 1)     # ties between thresholds
        cases[f"random{i}"] = (y, (probs > 0.5).astype(np.int32), probs)
    y = np.zeros(20, np.int32)
    cases["no positive"] = (y, y, rng.random(20))
    y = np.ones(20, np.int32)
    cases["no negative"] = (y, (rng.random(20) > 0.5).astype(np.int32),
                            rng.random(20))
    cases["one sample"] = (np.ones(1, np.int32), np.ones(1, np.int32),
                           np.array([0.7]))
    cases["constant score"] = (np.array([1, 0, 1, 0]), np.array([1, 1, 0, 0]),
                               np.full(4, 0.5))
    return cases


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_metrics_equal_sklearn(case):
    y, pred, probs = _metric_cases()[case]
    got = compute_metrics_for_threshold(y, pred, probs)
    want = jax_metrics(y, pred, probs)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def loaders(analyzers, tmp_path_factory):
    """The same 12-contract corpus through both packages' loaders (their
    validation splits, batch 2)."""
    path = str(tmp_path_factory.mktemp("corpus") / "c.csv")
    write_corpus_csv(path, n=12, seed=3)
    _, port, _ = analyzers
    kw = dict(batch_size=2, max_length=CFG.max_length)
    return (jax_dataloaders(path, port.tokenizer, **kw)[1],
            create_dataloaders(path, port.tokenizer, **kw)[1])


def _close(got, want, path="", atol=ATOL):
    """Recursive comparison: numbers within ``atol``, the rest equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}", atol)
    elif isinstance(want, (list, tuple)) and want and not isinstance(
            want[0], (str, bytes)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]", atol)
    elif isinstance(want, (float, np.floating, np.ndarray, int,
                           np.integer)) and not isinstance(want, bool):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=0,
                                   atol=atol, err_msg=path)
    else:
        assert got == want, path


def test_validation_results_and_metrics_match_jax(analyzers, loaders):
    jax_an, port, _ = analyzers
    jax_val, port_val = loaders
    got = collect_validation_results(port, port_val, generate_contracts=False)
    want = jax_collect(jax_an, jax_val, generate_contracts=False)
    for level in ("contract_level", "line_level"):
        _close(got[level], want[level], level)
    meta = dict(want["metadata"], processing_time=None)
    assert dict(got["metadata"], processing_time=None) == meta
    _close(compute_contract_level_metrics(got), jax_contract(want))
    _close(compute_line_level_metrics(got), jax_line(want))


def test_evaluate_model_performance_matches_jax(analyzers, loaders, tmp_path):
    jax_an, port, _ = analyzers
    jax_val, port_val = loaders
    got = evaluate_model_performance(
        val_dataloader=port_val, analyzer=port, verbose=False,
        output_file=str(tmp_path / "port.json"))
    want = jax_evaluate(val_dataloader=jax_val, analyzer=jax_an,
                        verbose=False, output_file=str(tmp_path / "jax.json"))
    _close(got, want)
    assert (tmp_path / "port.json").stat().st_size > 0


def test_compute_perplexity_matches_jax(analyzers, loaders):
    jax_an, port, params = analyzers
    jax_val, port_val = loaders
    got = compute_perplexity(port.model, port_val, max_batches=2)
    want = jax_perplexity(jax_an.model, params, jax_val, max_batches=2)
    assert got.keys() == want.keys()
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=1e-4), (k, got, want)
    assert not port.model.training


def test_visualize_training_progress_writes_a_file(tmp_path):
    history = {"train_loss": [3.0, 2.5, 2.0, 1.8], "val_loss": [3.1, 2.7,
                                                                2.6, 2.9],
               "learning_rate": [1e-5] * 4, "line_vuln_accuracy": [0.5] * 4}
    out = tmp_path / "dash.png"
    fig = visualize_training_progress(history, save_path=str(out))
    assert out.stat().st_size > 0 and len(fig.axes) == 6


def test_analyze_contracts_main_runs(analyzers, capsys):
    _, port, _ = analyzers
    analyze_contracts.main(analyzer=port)
    out = capsys.readouterr().out
    assert "=== Vulnerability Detection ===" in out
    assert "Analyzing Generated Contract 2" in out
    res = analyze_contracts.analyze_custom_contract(
        analyze_contracts.SAMPLE_CONTRACT, analyzer=port)
    assert set(res["contract_vulnerabilities"]) == set(
        port.vulnerability_types)
    assert len(analyze_contracts.generate_from_template(
        analyze_contracts.SAMPLE_CONTRACT, num_contracts=1,
        analyzer=port)) == 1
