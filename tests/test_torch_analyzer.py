"""The port's serving slice against the JAX analyzer, same weights, on the CPU.

Tiny configuration as in ``test_torch_model.py`` (f32, so the CPU runs the
kernels' plain versions). Probabilities are held to 1e-4 absolute, the bar
of the model tests (a sigmoid only shrinks logit differences). Batched
results are compared with batched results only: the line count is global
across a batch, so a batch-of-one call is a different computation.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from sct_gan_tpu.data.synthetic import generate_corpus
from sct_gan_tpu.data.tokenizer import SolidityTokenizer
from sct_gan_tpu.infer import SmartContractAnalyzer as JaxAnalyzer
from sct_gan_tpu.infer.generate import make_generate_fn as jax_generate_fn
from sct_gan_tpu.losses.syntax import SyntaxLossTables
from sct_gan_tpu_torch import (SmartContractAnalyzer, SmartContractTrainer,
                               SmartContractTransformer, convert_flax_params)
from sct_gan_tpu_torch.infer.generate import make_generate_fn
from test_torch_model import CFG, flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4


@pytest.fixture(scope="module")
def analyzers():
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    params = flax_params(CFG, seed=1)
    jax_an = JaxAnalyzer(model_config=CFG, tokenizer=tok, params=params,
                         batch_size=2, verbose=False)
    port = SmartContractAnalyzer(model_config=CFG, tokenizer=tok,
                                 params=convert_flax_params(params, CFG),
                                 device="cpu", batch_size=2, verbose=False)
    return jax_an, port, params


@pytest.fixture(scope="module")
def contracts():
    return [r["source_code"] for r in generate_corpus(n=3, seed=0)]


def _same_result(got, want):
    for key in ("contract_probabilities", "line_probabilities"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=key)
    # flags agree wherever the probability is not within tolerance of 0.5
    cp = np.asarray(want["contract_probabilities"])[0]
    for j, vt in enumerate(got["contract_vulnerabilities"]):
        if abs(cp[j] - 0.5) > ATOL:
            assert (got["contract_vulnerabilities"][vt]
                    == want["contract_vulnerabilities"][vt])
    assert got["line_vulnerabilities"].keys() == \
        want["line_vulnerabilities"].keys()


def test_detect_vulnerabilities_matches_jax(analyzers, contracts):
    jax_an, port, _ = analyzers
    _same_result(port.detect_vulnerabilities(contracts[0]),
                 jax_an.detect_vulnerabilities(contracts[0]))


def test_analyze_multiple_contracts_matches_jax(analyzers, contracts):
    """Three contracts at batch 2: the second batch is padded."""
    jax_an, port, _ = analyzers
    got = port.analyze_multiple_contracts(contracts)
    want = jax_an.analyze_multiple_contracts(contracts)
    assert [r["contract_index"] for r in got] == [0, 1, 2]
    for g, w in zip(got, want):
        _same_result(g, w)
    assert (port.get_vulnerability_summary(got).keys()
            == jax_an.get_vulnerability_summary(want).keys())


def test_npz_params_load(analyzers, contracts, tmp_path):
    """An .npz of the flattened flax tree (``/``-joined keys) reaches the
    port without orbax and gives the same detections."""
    _, port, params = analyzers
    flat = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "params.npz", **flat)
    loaded = SmartContractAnalyzer(model_config=CFG, tokenizer=port.tokenizer,
                                   params=str(tmp_path / "params.npz"),
                                   device="cpu", verbose=False)
    _same_result(loaded.detect_vulnerabilities(contracts[1]),
                 port.detect_vulnerabilities(contracts[1]))


def test_greedy_generation_matches_jax(analyzers, contracts):
    """With top-k 1 the sampler is deterministic, so the whole token loop
    (temperature, semicolon boost, EOS/PAD stop after min_length, PAD after
    finishing) must give JAX's tokens."""
    jax_an, port, params = analyzers
    tables = SyntaxLossTables.from_tokenizer(port.tokenizer)
    assert port.syntax_ids == (tables.semicolon_id, tables.return_id,
                               tables.break_id, tables.continue_id)
    batch = port._prepare_inputs(contracts[:2])
    memory = port.model.encode(batch["input_ids"], batch["attention_mask"],
                               batch["ast_input_ids"],
                               batch["ast_attention_mask"])
    got, steps = make_generate_fn(port.model, port.syntax_ids, top_k=1,
                                  min_length=10)(
        memory, batch["attention_mask"].bool(), None, 0.8)
    jb = {k: v.numpy().astype(np.int32) for k, v in batch.items()}
    jmem = jax_an.model.apply({"params": params}, jb["input_ids"],
                              jb["attention_mask"], jb["ast_input_ids"],
                              jb["ast_attention_mask"],
                              method=jax_an.model.encode)
    want = jax_generate_fn(jax_an.model, tables, top_k=1, min_length=10)(
        params, jmem, jb["attention_mask"].astype(bool),
        jax.random.PRNGKey(0), 0.8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 1 <= steps <= CFG.max_length - 1


def test_generate_synthetic_contract(analyzers, contracts):
    """Sampled generation: one string per contract from the model (not the
    template transform), reproducible from the analyzer's seed."""
    _, port, _ = analyzers
    out = port.generate_synthetic_contract(contracts[0], num_contracts=2)
    assert len(out) == 2
    assert 1 <= port.last_decode_steps <= CFG.max_length - 1
    assert not any(s.startswith("// Generated contract based on template")
                   for s in out)
    again = SmartContractAnalyzer(
        model_config=CFG, tokenizer=port.tokenizer,
        params=port.model.state_dict(), device="cpu", verbose=False)
    assert again.generate_synthetic_contract(contracts[0], 2) == out
    with pytest.raises(NotImplementedError):
        port.generate_synthetic_contract(contracts[0], use_beam_search=True)
    assert port.generate_template_based_contract(contracts[0]).startswith(
        "// Generated contract based on template")


def test_entry_points_default_to_the_card(analyzers):
    """Without ``device="cpu"`` the analyzer and the trainer run on the
    card, and without a card they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    _, port, _ = analyzers
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SmartContractAnalyzer(model_config=CFG, tokenizer=port.tokenizer,
                              verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SmartContractTrainer(SmartContractTransformer(CFG, seed=0), [], [],
                             port.tokenizer, verbose=False)


def test_port_imports_no_jax():
    """In a fresh process the port imports every one of its modules, runs
    the tiny detection and generation and two steps of the tiny training
    (``SmartContractTrainer``, dropout on) from its own config, tokenizer
    and corpus copies (the native tokenizer built from its own C++
    source), and never imports jax, flax, orbax, optax or any module of
    the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys, tempfile
        import sct_gan_tpu_torch
        for mod in pkgutil.walk_packages(sct_gan_tpu_torch.__path__,
                                         "sct_gan_tpu_torch."):
            importlib.import_module(mod.name)
        from sct_gan_tpu_torch import (SmartContractAnalyzer,
                                       SmartContractTrainer,
                                       SmartContractTransformer)
        from sct_gan_tpu_torch.config import ModelConfig, TrainConfig
        from sct_gan_tpu_torch.data import (create_dataloaders,
                                            generate_corpus, write_corpus_csv)
        from sct_gan_tpu_torch.data.native_tokenizer import (
            NativeSolidityTokenizer)
        from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
        from sct_gan_tpu_torch.native import build
        cfg = ModelConfig(d_model=64, nhead=4, num_encoder_layers=2,
                          num_decoder_layers=2, dim_feedforward=128,
                          dropout=0.1, max_length=64, max_lines=64,
                          vocab_size=512, use_gan=True,
                          compute_dtype="float32")
        tok = NativeSolidityTokenizer(vocab_size=512)
        an = SmartContractAnalyzer(model_config=cfg, tokenizer=tok,
                                   device="cpu", verbose=False)
        codes = [r["source_code"] for r in generate_corpus(n=3, seed=0)]
        # the native tokenizer is built from the port's own C++ copy
        assert tok.native_active
        assert build.load_library()._name == build.library_path()
        assert tok.encode(codes[0]) == SolidityTokenizer(
            vocab_size=512).encode(codes[0])
        assert len(an.analyze_multiple_contracts(codes)) == 3
        assert len(an.generate_synthetic_contract(codes[0], 2)) == 2
        with tempfile.TemporaryDirectory() as d:
            write_corpus_csv(d + "/c.csv", n=10, seed=0)
            train, val = create_dataloaders(d + "/c.csv", tok, batch_size=4,
                                            max_length=64)
            trainer = SmartContractTrainer(
                SmartContractTransformer(cfg, seed=0), train, val, tok,
                config=TrainConfig(learning_rate=1e-5, use_gan=True,
                                   warmup_epochs=1), device="cpu",
                verbose=False)
            out = trainer.train_epoch(0)
        assert out["batches"] == 2 and trainer.state.step == 2, out
        banned = ("jax", "jaxlib", "flax", "orbax", "optax", "sct_gan_tpu")
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
        assert not loaded, loaded
        print("NO-JAX-OK")
    """)
    env = {**os.environ, "HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO-JAX-OK" in proc.stdout
