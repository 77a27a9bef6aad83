"""The port's augmentation against the JAX package's, on the CPU.

The same seed gives the same variant texts (``SmartContractAugmenter``,
a copy of the JAX module) and the same augmented training batches: the
port trainer's ``_create_augmented_batch`` against the JAX trainer's on
the same batch, with the JAX trainer's random state (its ``_py_rng`` and
its augmenter) seeded as the port seeds its own. Exact: host-side Python
and numpy, no floating point.
"""
import random
import types

import numpy as np
import pytest

from sct_gan_tpu.config import TrainConfig as JaxTrainConfig
from sct_gan_tpu.data.augmentation import \
    SmartContractAugmenter as JaxAugmenter
from sct_gan_tpu.data.synthetic import generate_corpus
from sct_gan_tpu.train.trainer import SmartContractTrainer as JaxTrainer
from sct_gan_tpu_torch import SmartContractTrainer, SmartContractTransformer
from sct_gan_tpu_torch.config import TrainConfig
from sct_gan_tpu_torch.data import (SmartContractAugmenter,
                                    create_dataloaders, write_corpus_csv)
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from test_torch_model import CFG


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_variants_match_jax(seed):
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    codes = [r["source_code"] for r in generate_corpus(n=4, seed=seed)]
    port = SmartContractAugmenter(tokenizer=tok, seed=seed)
    jax_aug = JaxAugmenter(tokenizer=tok, seed=seed)
    for code in codes:
        got = port.augment_contract(code, 4)
        assert got == jax_aug.augment_contract(code, 4)
        assert got and all(v != code for _, v in got)
    got = port.create_training_batch(codes, batch_size=3)
    want = jax_aug.create_training_batch(codes, batch_size=3)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_holder(cfg, tok, seed):
    """The state the JAX trainer's augmentation methods read, seeded as
    the port trainer seeds its own (the JAX trainer's augmenter is
    unseeded); building a whole JAX trainer would compile its model."""
    h = types.SimpleNamespace(
        use_augmentation=True, cfg=cfg, tokenizer=tok, _aug_bank={},
        _py_rng=random.Random(seed),
        augmenter=JaxAugmenter(tokenizer=tok, seed=seed),
        model=types.SimpleNamespace(config=CFG))
    h._bank_variants = types.MethodType(JaxTrainer._bank_variants, h)
    return h


@pytest.mark.parametrize("bank,label_correct", [(0, True), (6, True),
                                                (6, False)])
def test_augmented_batches_match_jax(tmp_path, bank, label_correct):
    """Three epochs over a 2-batch loader: fresh variants (bank 0) or the
    bank built in the first epoch and sampled after; labels by source
    contract or by the reference's batch slot."""
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    path = str(tmp_path / "corpus.csv")
    write_corpus_csv(path, n=10, seed=1)
    train, _ = create_dataloaders(path, tok, batch_size=4,
                                  max_length=CFG.max_length)
    kw = dict(use_augmentation=True, use_gan=True, aug_bank_size=bank,
              aug_label_correct=label_correct)
    port = SmartContractTrainer(SmartContractTransformer(CFG, seed=0), train,
                                train, tok, config=TrainConfig(**kw),
                                device="cpu", seed=5, verbose=False)
    jax_side = _jax_holder(JaxTrainConfig(**kw), tok, 5)
    batches = [b for _ in range(3) for b in train]
    for i, batch in enumerate(batches):
        got = port._create_augmented_batch(batch)
        want = JaxTrainer._create_augmented_batch(jax_side, batch)
        assert got.keys() == want.keys(), i
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {k}")
        assert got["input_ids"].shape == batch["input_ids"].shape
        assert not np.array_equal(got["target_ids"], got["input_ids"])
    assert port._py_rng.random() == jax_side._py_rng.random()
