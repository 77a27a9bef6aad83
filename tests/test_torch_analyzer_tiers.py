"""The analyzer's fallback tiers and diagnostics against the JAX analyzer,
same weights, on the CPU (the fixtures and the 1e-4 bar of
``test_torch_analyzer.py``); and what a tier may catch: the port's own
``ValueError`` for bad input, never a ``RuntimeError`` (a kernel's, a
build's, CUDA's)."""
import numpy as np
import pytest

from test_torch_analyzer import ATOL, _same_result, analyzers, contracts  # noqa: F401


@pytest.mark.parametrize("tier", ["detect_vulnerabilities_with_fallback",
                                  "detect_vulnerabilities_safe",
                                  "_fallback_forward_pass"])
def test_tiers_match_jax(analyzers, contracts, tier):
    jax_an, port, _ = analyzers
    got = getattr(port, tier)(contracts[0])
    want = getattr(jax_an, tier)(contracts[0])
    _same_result(got, want)
    if tier != "detect_vulnerabilities_with_fallback":   # contract only
        assert not np.asarray(got["line_probabilities"]).any()


def test_full_tier_equals_detect_vulnerabilities(analyzers, contracts):
    _, port, _ = analyzers
    got = port.detect_vulnerabilities_with_fallback(contracts[1])
    want = port.detect_vulnerabilities(contracts[1])
    assert got["contract_probabilities"] == want["contract_probabilities"]
    assert got["line_probabilities"] == want["line_probabilities"]


def _raise(exc):
    def fn(*args, **kwargs):
        raise exc
    return fn


def test_a_runtime_error_propagates(analyzers, contracts, monkeypatch):
    """An error raised inside the forward, as a kernel or CUDA raises it,
    goes through every tier and through generation."""
    _, port, _ = analyzers
    monkeypatch.setattr(port.model, "encode",
                        _raise(RuntimeError("CUDA error: launch failed")))
    with pytest.raises(RuntimeError, match="launch failed"):
        port.detect_vulnerabilities_with_fallback(contracts[0])
    with pytest.raises(RuntimeError, match="launch failed"):
        port.detect_vulnerabilities_safe(contracts[0])
    with pytest.raises(RuntimeError, match="launch failed"):
        port.generate_synthetic_contract(contracts[0])
    with pytest.raises(RuntimeError, match="launch failed"):
        port.test_model_functionality()


def test_a_value_error_falls_to_the_contract_only_tier(analyzers, contracts,
                                                       monkeypatch):
    """The port's refusal of an input in the full tier falls through to the
    contract-only pass (zero line probabilities)."""
    _, port, _ = analyzers
    want = port.detect_vulnerabilities_safe(contracts[2])
    monkeypatch.setattr(port, "_detect",
                        _raise(ValueError("head dim 13: not supported")))
    got = port.detect_vulnerabilities_with_fallback(contracts[2])
    assert got == want
    assert port.test_model_functionality() == {
        "success": False, "error": "head dim 13: not supported"}


def test_diagnostics_match_jax(analyzers):
    jax_an, port, _ = analyzers
    got, want = port.test_model_functionality(), \
        jax_an.test_model_functionality()
    assert got == want and got["success"]
    got, want = port.diagnose_generation_model(), \
        jax_an.diagnose_generation_model()
    assert got.keys() == want.keys()
    for key in ("output_weight_std", "output_bias_std"):
        assert abs(got[key] - want[key]) <= 1e-6
    for key in ("healthy_weights", "first_step_top_tokens",
                "token_1_collapse"):
        assert got[key] == want[key], key
    got, want = port.test_generation_simple(), jax_an.test_generation_simple()
    assert got.keys() == want.keys() and got["success"] and want["success"]
    text = port.generate_simple_contract(max_length=32)
    assert isinstance(text, str)
    assert 1 <= port.last_decode_steps <= 31


def test_debug_forward_matches_jax_intermediates(analyzers, contracts):
    """The line head's three recorded stages: JAX's sown intermediates."""
    jax_an, port, _ = analyzers
    got = port.debug_forward(contracts[0])
    want = jax_an.debug_forward(contracts[0])
    assert set(got) == set(want) == {"line_means", "line_extracted",
                                     "line_logits"}
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in ("mean", "std", "min", "max"):
            assert abs(got[name][k] - want[name][k]) <= ATOL, (name, k)
        assert got[name]["collapsed"] == want[name]["collapsed"]
