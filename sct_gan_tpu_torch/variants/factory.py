"""Variant factory: assemble any of the reference model families.

Counterpart of ``sct_gan_tpu/variants/factory.py``.

| name             | reference dir            | model / trainer |
|------------------|--------------------------|-----------------|
| "binary-tasc"    | Binary-TASC-model/       | SmartContractVulnerabilityGAN (binary) + VulnerabilityDetectionTrainer |
| "multiclass-tasc"| MultiClass-TASC-model/   | + VulnerabilityClassifier & PatternMatcher weak labels |
| "model-v3"       | Model-v3/                | SmartContractTransformer (no GAN/aug) + SmartContractTrainer |
| "sct-gan"        | SCT-GAN/ (canonical)     | SmartContractTransformer (GAN+aug) + SmartContractTrainer |

(``final-model/`` is byte-identical to SCT-GAN: the same assembly.)
Models are built with random weights from seed 0; the trainers take
``device`` (the card by default) among their keyword arguments.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..config import (binary_tasc_config, model_v3_config,
                      multiclass_tasc_config, sct_gan_config)

VARIANTS = ("binary-tasc", "multiclass-tasc", "model-v3", "sct-gan",
            "final-model")


def build_variant(name: str, overrides: Optional[Dict[str, Any]] = None
                  ) -> Tuple[Any, Any]:
    """Return (model, config) for a variant name."""
    overrides = overrides or {}
    name = name.lower()
    if name in ("sct-gan", "final-model", "model-v3"):
        cfg = (model_v3_config if name == "model-v3"
               else sct_gan_config)(**overrides)
        from ..models.sct_transformer import SmartContractTransformer
        return SmartContractTransformer(cfg.model), cfg
    if name in ("binary-tasc", "multiclass-tasc"):
        cfg = (binary_tasc_config if name == "binary-tasc"
               else multiclass_tasc_config)(**overrides)
        from .tasc import SmartContractVulnerabilityGAN
        return SmartContractVulnerabilityGAN(cfg), cfg
    raise ValueError(f"unknown variant {name!r}; choose from {VARIANTS}")


def build_trainer(name: str, model, config, train_loader, val_loader,
                  tokenizer, **kwargs):
    """Return the matching trainer for a built variant."""
    name = name.lower()
    if name in ("sct-gan", "final-model", "model-v3"):
        from ..train.trainer import SmartContractTrainer
        return SmartContractTrainer(model, train_loader, val_loader,
                                    tokenizer, config=config.train, **kwargs)
    from .tasc_trainer import VulnerabilityDetectionTrainer
    return VulnerabilityDetectionTrainer(model, train_loader, val_loader,
                                         tokenizer=tokenizer,
                                         learning_rate=config.learning_rate,
                                         beta1=config.adam_b1, **kwargs)


def generate_vulnerable_code(model, generator: torch.Generator,
                             num_samples: int = 1, tokenizer=None,
                             max_length: Optional[int] = None
                             ) -> Dict[str, Any]:
    """TASC noise→code generation (model_code_loc.py:518-553): noise through
    the Generator, decoder memory = the synthetic embedding (one key, no
    mask), KV-cached sampled decode, classifier scores on the synthetic
    embedding. ``generator`` lives on the model's device and draws the
    noise and every sample. Runs with the model in eval mode; the output
    also holds ``decode_steps``, the ``decode_step`` calls made."""
    from .tasc import make_tasc_generate_fn

    cfg = model.config
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            noise = torch.randn((num_samples, cfg.d_model),
                                generator=generator, device=dev)
            synthetic = model.generator(noise)
            gen_fn = make_tasc_generate_fn(model, max_length=max_length)
            tokens = gen_fn(synthetic[:, None, :], generator)
            out: Dict[str, Any] = {"tokens": tokens,
                                   "decode_steps": gen_fn.last_steps}
            if tokenizer is not None:
                out["code"] = tokenizer.decode(tokens[0].cpu().numpy())
            if cfg.multiclass:
                vout = model.vulnerability_classifier(synthetic)
                out["vulnerability_scores"] = vout["vulnerability_scores"]
                out["vulnerability_locations"] = vout["attention_weights"]
    finally:
        model.train(was_training)
    return out
