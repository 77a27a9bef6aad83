"""The port's variant configs, factory, TASC data and compat shims against
the JAX package's, on the CPU.

  * ``TASCConfig``, ``VariantConfig`` and the variant config functions:
    field for field equal to JAX's, and ``VariantConfig.from_dict`` reads
    JAX's ``to_json``;
  * ``build_variant`` / ``build_trainer`` for all five names, at tiny
    sizes, with ``device="cpu"``;
  * ``tasc_records_from_corpus``, ``TASCDataset`` items and
    ``TASCDataLoader`` batches (shuffled, over two epochs): equal to JAX's,
    array for array (host-side numpy);
  * ``PatternMatcher`` on the synthetic corpus: equal;
  * ``load_hf_tasc_records`` with a stubbed ``datasets`` (as
    ``tests/test_tasc.py`` does);
  * the compat surface of ``tests/test_compat.py``, plus the TASC shims.
"""
import dataclasses
import importlib
import json
import sys

import numpy as np
import pytest
import torch

import sct_gan_tpu.config as jconfig
from sct_gan_tpu.data import tasc_dataset as jtasc_data
from sct_gan_tpu.data.pattern_matcher import PatternMatcher as JaxMatcher
from sct_gan_tpu.data.tokenizer import SolidityTokenizer as JaxTokenizer
from sct_gan_tpu_torch import config
from sct_gan_tpu_torch import (SmartContractTrainer, SmartContractTransformer,
                               SmartContractVulnerabilityGAN,
                               VulnerabilityDetectionTrainer)
from sct_gan_tpu_torch.data import (PatternMatcher, SolidityTokenizer,
                                    TASCDataLoader, TASCDataset,
                                    generate_corpus, tasc_records_from_corpus,
                                    write_corpus_csv)
from sct_gan_tpu_torch.data import tasc_dataset
from sct_gan_tpu_torch.variants import VARIANTS, build_trainer, build_variant
from test_torch_tasc import TINY

TINY_TASC = {k: v for k, v in dataclasses.asdict(TINY).items()
             if k not in ("multiclass", "num_vulnerability_types")}
TINY_MODEL = dict(d_model=32, nhead=2, num_encoder_layers=1,
                  num_decoder_layers=1, dim_feedforward=64, max_length=32,
                  max_lines=32, vocab_size=256, compute_dtype="float32")


@pytest.mark.parametrize("name", ["TASCConfig", "VariantConfig",
                                  "binary_tasc_config",
                                  "multiclass_tasc_config",
                                  "sct_gan_config", "model_v3_config"])
def test_configs_match_jax(name):
    got, want = getattr(config, name)(), getattr(jconfig, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__name__ == type(want).__name__


def test_variant_config_round_trips():
    cfg = config.sct_gan_config(model={"d_model": 64},
                                train={"learning_rate": 3e-5})
    assert cfg.model.use_gan and cfg.train.use_augmentation
    assert cfg.model.d_model == 64 and cfg.train.learning_rate == 3e-5
    back = config.VariantConfig.from_dict(json.loads(cfg.to_json()))
    assert back == cfg
    assert isinstance(back.data.vulnerability_types, tuple)
    # a JAX configuration's JSON reads into the port's
    jcfg = jconfig.model_v3_config(model={"nhead": 4})
    got = config.VariantConfig.from_dict(json.loads(jcfg.to_json()))
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)
    assert not got.model.use_gan and not got.train.use_augmentation
    assert config.multiclass_tasc_config(d_model=32).multiclass
    cb = config.CodeBERTConfig.from_tasc(TINY)
    assert (cb.num_heads, cb.num_layers) == (TINY.codebert_nhead,
                                             TINY.codebert_num_layers)


@pytest.fixture(scope="module")
def sct_loaders(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus") / "c.csv")
    write_corpus_csv(path, n=8, seed=0)
    from sct_gan_tpu_torch.data import create_dataloaders
    tok = SolidityTokenizer(vocab_size=256)
    return (*create_dataloaders(path, tok, batch_size=4, max_length=32), tok)


@pytest.mark.parametrize("name", VARIANTS)
def test_build_variant_and_trainer(name, sct_loaders):
    tasc = name.endswith("tasc")
    overrides = TINY_TASC if tasc else {"model": TINY_MODEL}
    model, cfg = build_variant(name.upper() if name == "sct-gan" else name,
                               overrides)
    tok = sct_loaders[2]
    if tasc:
        assert isinstance(model, SmartContractVulnerabilityGAN)
        assert cfg.multiclass == (name == "multiclass-tasc")
        assert hasattr(model, "vulnerability_classifier") == cfg.multiclass
        ds = TASCDataset(tasc_records_from_corpus(n=4, seed=0), tok,
                         max_length=32, multiclass=cfg.multiclass)
        loaders = (TASCDataLoader(ds, 2), TASCDataLoader(ds, 2))
        trainer = build_trainer(name, model, cfg, *loaders, tok,
                                device="cpu", verbose=False)
        assert isinstance(trainer, VulnerabilityDetectionTrainer)
        assert trainer.optimizers["generator"].defaults["lr"] == \
            cfg.learning_rate
        assert trainer.optimizers["generator"].defaults["betas"] == (0.5,
                                                                     0.999)
    else:
        assert isinstance(model, SmartContractTransformer)
        assert model.config.use_gan == (name != "model-v3")
        assert cfg.train.use_augmentation == (name != "model-v3")
        trainer = build_trainer(name, model, cfg, *sct_loaders[:2], tok,
                                device="cpu", verbose=False)
        assert isinstance(trainer, SmartContractTrainer)
        assert trainer.use_gan == model.config.use_gan
    with pytest.raises(ValueError, match="unknown variant"):
        build_variant("no-such-model")


@pytest.mark.parametrize("multiclass", [False, True],
                         ids=["binary", "multiclass"])
def test_tasc_data_matches_jax(multiclass):
    recs = tasc_records_from_corpus(n=8, seed=3, multiclass=multiclass)
    assert recs == jtasc_data.tasc_records_from_corpus(
        n=8, seed=3, multiclass=multiclass)
    assert {r["malicious"] for r in recs} <= {0, 1}
    ds = TASCDataset(recs, SolidityTokenizer(vocab_size=512), max_length=64,
                     multiclass=multiclass)
    jds = jtasc_data.TASCDataset(recs, JaxTokenizer(vocab_size=512),
                                 max_length=64, multiclass=multiclass)
    assert len(ds) == len(jds) == 8
    for i in range(len(ds)):
        _same(ds[i], jds[i])
    loader = TASCDataLoader(ds, batch_size=3, shuffle=True, seed=5)
    jloader = jtasc_data.TASCDataLoader(jds, batch_size=3, shuffle=True,
                                        seed=5)
    assert len(loader) == len(jloader) == 3
    for _ in range(2):                      # the shuffle moves per epoch
        batches, jbatches = list(loader), list(jloader)
        assert len(batches) == len(jbatches)
        for b, jb in zip(batches, jbatches):
            _same(b, jb)
    assert len(TASCDataLoader(ds, batch_size=3, drop_last=True)) == 2


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], (list, str)):
            assert got[k] == want[k], k
        else:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pattern_matcher_matches_jax():
    pm, jpm = PatternMatcher(), JaxMatcher()
    codes = [r["source_code"] for r in generate_corpus(n=8, seed=0)]
    for code in codes:
        assert pm.match_patterns(code) == jpm.match_patterns(code)
        assert pm.get_pattern_scores(code) == jpm.get_pattern_scores(code)
        assert pm.get_vulnerability_explanation(code) == \
            jpm.get_vulnerability_explanation(code)
        got, want = pm.get_pattern_tensor(code), jpm.get_pattern_tensor(code)
        _same(got, want)
    assert any(pm.get_vulnerability_explanation(c) for c in codes)


def test_load_hf_tasc_records_with_stubbed_datasets(monkeypatch):
    """The HF ingestion path (Binary-TASC-model/main.ipynb cells 3 and 6)
    without the network: the ``contract_source`` / ``malicious`` columns
    map into records, an empty source is dropped, ``max_records`` cuts."""
    rows = [
        {"contract_source": "pragma solidity ^0.8.0;\ncontract A {}",
         "malicious": 0},
        {"contract_source": "pragma solidity ^0.8.0;\ncontract B { "
         "function f() public { tx.origin; } }", "malicious": 1},
        {"contract_source": "", "malicious": 1},
        {"source_code": "contract C {}", "label": 1},
    ]

    class _FakeDatasets:
        @staticmethod
        def load_dataset(name, split="train"):
            assert name == "jainabh/smart_contracts_malicious"
            assert split == "train"
            return rows

    monkeypatch.setitem(sys.modules, "datasets", _FakeDatasets)
    recs = tasc_dataset.load_hf_tasc_records()
    assert recs == jtasc_data.load_hf_tasc_records()
    assert [r["malicious"] for r in recs] == [0, 1, 1]
    assert recs[2]["source_code"] == "contract C {}"
    assert len(tasc_dataset.load_hf_tasc_records(max_records=2)) == 2
    ds = TASCDataset(recs, SolidityTokenizer(vocab_size=512), max_length=64)
    assert len(ds) == 3 and ds[1]["label"] == 1.0


def test_compat_surface():
    from sct_gan_tpu_torch.compat import (analyze_contracts, binary_tasc,
                                          data_augmentation, dataset,
                                          inference, model, multiclass_tasc,
                                          notebook_utils, pattern_matcher,
                                          train)
    for mod, names in (
            (model, ["SmartContractTransformer", "PositionalEncoding"]),
            (train, ["SmartContractTrainer", "FocalLoss",
                     "SpatialAwareFocalLoss", "SoliditySyntaxLoss",
                     "ContractLevelFocalLoss"]),
            (dataset, ["create_dataloaders",
                       "SmartContractVulnerabilityDataset",
                       "custom_collate_fn", "ArrayDataLoader",
                       "inspect_dataloader", "build_token_to_line"]),
            (inference, ["SmartContractAnalyzer", "parse_solidity_to_ast"]),
            (data_augmentation, ["SmartContractAugmenter",
                                 "test_augmentation"]),
            (pattern_matcher, ["PatternMatcher"]),
            (notebook_utils, ["collect_validation_results"]),
            (analyze_contracts, ["main", "analyze_custom_contract",
                                 "generate_from_template"]),
            (binary_tasc, []), (multiclass_tasc, [])):
        jmod = importlib.import_module(
            "sct_gan_tpu.compat." + mod.__name__.rsplit(".", 1)[1])
        if hasattr(jmod, "__all__"):
            assert sorted(mod.__all__) == sorted(jmod.__all__)
        for name in [*names, *getattr(jmod, "__all__", [])]:
            assert hasattr(mod, name), (mod.__name__, name)
    assert binary_tasc.SmartContractTransformer.__name__ == "TASCEncoder"
    assert multiclass_tasc.PatternMatcher is PatternMatcher


def test_compat_model_constructor_and_losses():
    from sct_gan_tpu_torch.compat import data_augmentation, model, train
    m = model.SmartContractTransformer(
        d_model=32, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
        dim_feedforward=64, dropout=0.1, max_length=64, vocab_size=128,
        num_vulnerability_types=8, use_gan=True, compute_dtype="float32")
    assert m.config.d_model == 32 and m.config.use_gan
    assert m.config.max_lines == 64
    out = model.PositionalEncoding(16, max_len=32)(torch.zeros(2, 8, 16))
    assert out.shape == (2, 8, 16) and float(out[0, 1, 1]) != 0.0
    logits, target = torch.zeros(2, 8), torch.ones(2, 8)
    assert float(train.FocalLoss()(logits, target)) > 0
    assert float(train.ContractLevelFocalLoss()(logits, target)) > 0
    sl = train.SpatialAwareFocalLoss()
    sl.alpha, sl.gamma = 0.1, 1.5
    assert np.isfinite(float(sl(torch.zeros(2, 16, 8), torch.ones(2, 16, 8),
                                torch.zeros(2, 16, dtype=torch.long))))
    pairs = data_augmentation.test_augmentation(num_variants=2,
                                                verbose=False)
    assert all(isinstance(a, str) and isinstance(b, str) for a, b in pairs)
