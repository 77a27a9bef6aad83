#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sct_gan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``sct_gan_tpu_torch/csrc`` and
holds each against its plain PyTorch version on the card at the main
paths' shapes: the flash-attention forward (with dropout and LSE) and
backward, the single-query decode attention and the hash dropout. Then it
drives both paths of the port at full width (d=768, 8 heads of 96, 6+6
layers, L=1024, vocab 50265 padded to 50304, bf16 compute, random weights
from seed 0), counting kernel launches to show each path ran through its
kernels:

  * serving: batched detection of 8 contracts and sampled generation of 2,
    cross-checked against the port on the CPU in f32;
  * training: ``SmartContractTrainer.train_step`` on the JAX bench's batch
    (B=8, L=1024, dropout 0.3, fused LM-head CE, fused optimizer), then
    ``train_epoch`` over a 16-contract corpus; the loss and gradient norms
    are cross-checked against the CPU in f32 at B=2.

It times the kernels, their plain versions, the PyTorch library call for
the same function and each path with CUDA events or synchronised host
clocks, and profiles detection, generation and one train step with
``torch.profiler`` (tables in ``profile_out/profile_*.txt``).

Every phase prints a line; any failure raises (non-zero exit). The line
before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a
CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

os.environ.setdefault("HF_HUB_OFFLINE", "1")          # no network, ever
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Tolerances, with their reasons:
# kernel vs plain, both bf16 outputs from the same bf16 inputs: each rounds
# its output to bf16 and P is rounded to bf16 in different places, so they
# may differ by a bf16 step at the output's magnitude; the bound is two
# steps at the largest |output| (kernel_tol below).
# backward kernels vs plain autograd: the kernels also round dS to bf16
# before the dK and dQ products (as the TPU kernels do), where autograd keeps
# it f32, and each gradient sums 1024 such terms: four steps at the largest
# |gradient| (kernel_tol(want, 4)).
# The max-abs bound checks the peak entries only, so every kernel result is
# also held to a norm-wise relative error ||got - want|| / ||want||: bf16
# roundings of the output and of P or dS are each ~2^-9 relative and
# independent from entry to entry, so a right kernel stays near 3e-3, while
# a slip in a share of the entries (a wrong mask bit, a lost tile) moves the
# norm by that share: 1e-2.
REL_TOL = 1e-2
# LSE: an f32 statistic from the same f32 scores: 1e-3 absolute.
LSE_TOL = 1e-3
# card (bf16 activations, kernels) vs CPU (f32, plain versions) detection
# probabilities: bf16 keeps ~3 significant digits through 6+ layers;
# sigmoid slope <= 1/4 keeps logit errors of a few 1e-2 under 2e-2.
DETECT_TOL = 2e-2
# KV-cached decode_step (f32 logits from the decode kernel) vs teacher-
# forced logits (bf16, flash kernel) for the same prefix: two bf16
# computations with different reduction shapes; logits |x| < 4 have bf16
# steps of 2^-6, and the residual stream adds a few more.
DECODE_TOL = 1e-1
# train step, card (bf16) vs CPU (f32), dropout off: the total loss is
# dominated by the LM cross-entropy, whose bf16 logits are off by ~1e-2 of
# ~10: 1e-2 relative. Gradient norms go through 12 layers of bf16
# activations forward and back (3 significant digits each way): 5e-2
# relative. A wrong backward kernel (a lost scale, a transposed tile, a
# wrong mask) moves the attention-projection norm by O(1).
LOSS_RTOL = 1e-2
GNORM_RTOL = 5e-2

# H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth) for bound_ms
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

KERNELS = {
    "flash_attention_fwd": (
        "sct_gan_tpu_torch/csrc/flash_attention_fwd.cu",
        "sct_gan_tpu/ops/flash_attention.py:205"),
    "flash_attention_bwd": (
        "sct_gan_tpu_torch/csrc/flash_attention_bwd.cu",
        "sct_gan_tpu/ops/flash_attention.py:510 (K2), :530 (K3), :550 (K4)"),
    "dropout": (
        "sct_gan_tpu_torch/csrc/dropout.cu",
        "sct_gan_tpu/ops/dropout.py:59"),
    "decode_attention": (
        "sct_gan_tpu_torch/csrc/decode_attention.cu",
        "sct_gan_tpu/ops/decode_attention.py:83"),
}
# flash-attention calls per training forward: 6 encoder + 12 decoder +
# AST and cross 2 + line heads 2 + discriminator 1 (the contract pooling
# stays dense: it returns its weights)
FLASH_PER_TRAIN_FORWARD = 23


def _counters():
    from sct_gan_tpu_torch.ops.decode_attention import decode_attention
    from sct_gan_tpu_torch.ops.dropout import dropout
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward)
    return {"flash_attention_fwd": flash_attention,
            "flash_attention_bwd": flash_attention_backward,
            "dropout": dropout, "decode_attention": decode_attention}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``iters``."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, what bounds it): operations at the bf16 peak or
    bytes (each input read once, each output written once) at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_err(a, b) -> float:
    """Norm-wise relative error ||a - b|| / ||b|| (0 when both are 0)."""
    diff = (a.float() - b.float()).norm().item()
    ref = b.float().norm().item()
    return diff / ref if ref > 0 else diff


def kernel_tol(want, steps: int = 2) -> float:
    """``steps`` bf16 steps at the largest |value| of ``want`` (bf16 keeps
    8 significant bits: the step in [2^e, 2^(e+1)) is 2^(e-7))."""
    top = max(want.float().abs().max().item(), 2.0 ** -8)
    return steps * 2.0 ** (math.floor(math.log2(top)) - 7)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("FAIL device: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card (no CPU fallback)")
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase device: {card_line()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}", flush=True)


def phase_build():
    from sct_gan_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    regs = [ln.strip() for ln in _build.ptxas_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln
            or "spill" in ln]
    print(f"phase build: {os.path.basename(path)} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds})",
          flush=True)
    for ln in regs:
        print(f"  ptxas: {ln}")


def _heads(x, h=8):
    """(B, S, H*dh) → (B, H, S, dh) view: the strides the model passes."""
    b, s, d = x.shape
    return x.view(b, s, h, d // h).transpose(1, 2)


def phase_kernels():
    """Every kernel against its plain version at the main paths' shapes."""
    import torch
    from sct_gan_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    from sct_gan_tpu_torch.ops.dropout import dropout, dropout_reference
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    scale = 96 ** -0.5
    lens = torch.tensor([1024, 900, 700, 512, 300, 1000, 64, 801], device=dev)
    worst = {name: 0.0 for name in KERNELS}
    worst_rel = {name: 0.0 for name in KERNELS}

    def check(kernel, name, got, want, tol, what=""):
        err, rel = max_err(got, want), rel_err(got, want)
        worst[kernel] = max(worst[kernel], err)
        worst_rel[kernel] = max(worst_rel[kernel], rel)
        print(f"  {kernel} {name}{what}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e}), rel_err {rel:.3e} (tol {REL_TOL})",
              flush=True)
        if not (err <= tol and rel <= REL_TOL):
            raise AssertionError(f"{kernel} {name}{what}: max_abs_err {err} "
                                 f"(tol {tol}), rel_err {rel} "
                                 f"(tol {REL_TOL})")

    def flash_case(name, sq, sk, causal, mask, rate=0.0):
        q = _heads(rnd(8, sq, 768, scale=2.0))
        k, v = _heads(rnd(8, sk, 768)), _heads(rnd(8, sk, 768))
        args = dict(key_padding_mask=mask, causal=causal, sm_scale=scale,
                    dropout_rate=rate, seed=1234, return_lse=True)
        got, lse = flash_attention(q, k, v, **args)
        want, want_lse = flash_attention_reference(q, k, v, **args)
        torch.cuda.synchronize()
        check("flash_attention_fwd", name, got, want, kernel_tol(want),
              f" q{tuple(q.shape)} k{tuple(k.shape)}")
        err = max_err(lse, want_lse)
        print(f"  flash_attention_fwd {name}: lse max_abs_err {err:.3e} "
              f"(tol {LSE_TOL})", flush=True)
        if not err <= LSE_TOL:
            raise AssertionError(f"K1 {name} lse: {err} > {LSE_TOL}")
        return got

    pad_mask = torch.arange(1024, device=dev)[None, :] < lens[:, None]
    flash_case("key mask, padded tails", 1024, 1024, False, pad_mask)
    flash_case("causal", 1024, 1024, True, None)
    flash_case("Sq != Sk", 512, 1024, False, pad_mask)
    ragged = torch.arange(1000, device=dev)[None, :] < lens[:, None]
    flash_case("ragged S=1000", 1000, 1000, True, ragged)
    flash_case("dropout 0.3, key mask", 1024, 1024, False, pad_mask, 0.3)
    flash_case("dropout 0.3, ragged causal", 1000, 1000, True, ragged, 0.3)
    empty = pad_mask.clone()
    empty[3] = False
    out = flash_case("fully-masked row", 1024, 1024, False, empty)
    if out[3].abs().max().item() != 0.0:
        raise AssertionError("K1: a fully-masked row must give zeros")

    def bwd_case(name, b, sq, sk, causal, mask, rate=0.0):
        """The backward kernel pair (through the autograd function) vs
        plain autograd through the plain forward, same dO."""
        q = _heads(rnd(b, sq, 768, scale=2.0)).requires_grad_()
        k = _heads(rnd(b, sk, 768)).requires_grad_()
        v = _heads(rnd(b, sk, 768)).requires_grad_()
        dout = _heads(rnd(b, sq, 768))
        args = dict(key_padding_mask=mask, causal=causal, sm_scale=scale,
                    dropout_rate=rate, seed=99)
        got = torch.autograd.grad(flash_attention(q, k, v, **args),
                                  (q, k, v), dout)
        want = torch.autograd.grad(flash_attention_reference(q, k, v, **args),
                                   (q, k, v), dout)
        torch.cuda.synchronize()
        for nm, gt, wt in zip(("dq", "dk", "dv"), got, want):
            check("flash_attention_bwd", name, gt, wt, kernel_tol(wt, 4),
                  f" {nm} q{tuple(q.shape)} k{tuple(k.shape)}")
        return got

    bwd_case("key mask, padded tails", 8, 1024, 1024, False, pad_mask)
    bwd_case("causal", 8, 1024, 1024, True, None)
    bwd_case("dropout 0.3", 8, 1024, 1024, False, pad_mask, 0.3)
    bwd_case("dropout 0.3, ragged causal", 8, 1000, 1000, True, ragged, 0.3)
    dq, _, _ = bwd_case("fully-masked row", 8, 1024, 1024, False, empty)
    if dq[3].abs().max().item() != 0.0:
        raise AssertionError("K2: a fully-masked row must get dq = 0")
    long_mask = (torch.arange(2048, device=dev)[None, :]
                 < 2 * lens[:4, None])
    bwd_case("Sk=2048 (the TPU's nk>1 path)", 4, 2048, 2048, False,
             long_mask, 0.3)

    for shape, dt in (((8, 1024, 768), torch.float32),
                      ((8, 1024, 2048), torch.bfloat16)):
        x = (torch.randn(*shape, generator=g, device=dev)).to(dt)
        x.requires_grad_()
        got = dropout(x, 0.3, 4321)
        want = dropout_reference(x.detach(), 4321, 0.3)
        gy = torch.randn(*shape, generator=g, device=dev).to(dt)
        dx = torch.autograd.grad(got, x, gy)[0]
        torch.cuda.synchronize()
        if not torch.equal(got != 0, want != 0):
            raise AssertionError(f"K6 {dt}: keep masks differ")
        check("dropout", f"{dt} {shape}", got, want, kernel_tol(want, 1))
        check("dropout", f"{dt} {shape}", dx,
              dropout_reference(gy, 4321, 0.3), kernel_tol(want, 1),
              " backward")

    def decode_case(name, q, k, v, mask):
        got = decode_attention(q, k, v, mask, sm_scale=scale)
        want = decode_attention_reference(q, k, v, mask, sm_scale=scale)
        torch.cuda.synchronize()
        check("decode_attention", name, got, want, kernel_tol(want),
              f" q{tuple(q.shape)} k{tuple(k.shape)} strides {k.stride()}")
        return got

    q = _heads(rnd(2, 1, 768, scale=2.0))
    mem_k, mem_v = _heads(rnd(2, 1024, 768)), _heads(rnd(2, 1024, 768))
    src = torch.arange(1024, device=dev)[None, :] < lens[:2, None] - 150
    decode_case("cross S=1024, src mask", q, mem_k, mem_v, src)
    cache_k, cache_v = rnd(2, 8, 1024, 96), rnd(2, 8, 1024, 96)
    for pos in (0, 127, 1023):
        decode_case(f"self step pos={pos}", q, cache_k[:, :, :pos + 1],
                    cache_v[:, :, :pos + 1], None)
    none = src.clone()
    none[1] = False
    out = decode_case("fully-masked row", q, mem_k, mem_v, none)
    if out[1].abs().max().item() != 0.0:
        raise AssertionError("K5: a fully-masked row must give zeros")
    print("phase kernels: worst max_abs_err / rel_err " + ", ".join(
        f"{k} {v:.3e} / {worst_rel[k]:.3e}" for k, v in worst.items()),
        flush=True)
    return worst, worst_rel


def phase_serve():
    """The serving path: detection at B=8, generation of 2 contracts, the
    card-vs-CPU check and decode_step against teacher forcing."""
    import numpy as np
    import torch
    from sct_gan_tpu_torch import SmartContractAnalyzer
    from sct_gan_tpu_torch.config import ModelConfig
    from sct_gan_tpu_torch.data.synthetic import generate_corpus

    t0 = time.perf_counter()
    an = SmartContractAnalyzer(seed=0, verbose=False)
    cfg = an.config
    print(f"phase model: d={cfg.d_model} heads={cfg.nhead}x"
          f"{cfg.d_model // cfg.nhead} layers={cfg.num_encoder_layers}+"
          f"{cfg.num_decoder_layers} L={cfg.max_length} vocab "
          f"{cfg.vocab_size}->{cfg.padded_vocab_size} {cfg.compute_dtype}; "
          f"tokenizer {type(an.tokenizer).__name__}; on {an.device}; built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    codes = [r["source_code"] for r in generate_corpus(n=8, seed=0)]

    reset_counts()
    results = an.analyze_multiple_contracts(codes)
    torch.cuda.synchronize()
    detect = read_counts()
    cp = np.asarray([r["contract_probabilities"][0] for r in results])
    lp = np.asarray([np.asarray(r["line_probabilities"]) for r in results])
    if not (len(results) == 8 and np.isfinite(cp).all()
            and np.isfinite(lp).all() and (cp >= 0).all() and (cp <= 1).all()
            and (lp >= 0).all() and (lp <= 1).all()):
        raise AssertionError("detection: probabilities not finite in [0, 1]")
    if detect["flash_attention_fwd"] != 10:
        raise AssertionError(f"detection: {detect} launches for one "
                             f"forward, expected 10 flash forwards")
    summary = an.get_vulnerability_summary(results)
    print(f"phase detect: 8 contracts, 1 forward, launches {detect} "
          f"(expected 10 flash forwards); contract probs "
          f"[{cp.min():.4f}, {cp.max():.4f}], vulnerable "
          f"{summary['vulnerable_contracts']}/8", flush=True)

    template = codes[0]
    reset_counts()
    t0 = time.perf_counter()
    generated = an.generate_synthetic_contract(template, num_contracts=2)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen = read_counts()
    steps = an.last_decode_steps
    if gen["decode_attention"] != 12 * steps or steps < 1:
        raise AssertionError(f"generation: {gen} launches for {steps} "
                             f"steps, expected {12 * steps} decode")
    if gen["flash_attention_fwd"] != 8:
        raise AssertionError(f"generation: {gen} launches, expected 8 "
                             f"flash forwards in the encode")
    if len(generated) != 2 or any(
            s.startswith("// Generated contract based on template")
            for s in generated):
        raise AssertionError("generation: output did not come from the model")
    print(f"phase generate: 2 contracts, {steps} decode steps, launches "
          f"{gen} (decode = 12 x {steps}, 8 flash in the encode); "
          f"{gen_s:.2f} s (first call); lengths "
          f"{[len(s) for s in generated]}", flush=True)

    # -- card vs CPU f32 on one contract, same weights (seed 0) --------------
    card = an.detect_vulnerabilities(codes[1])
    cpu = SmartContractAnalyzer(
        device="cpu", seed=0, verbose=False, tokenizer=an.tokenizer,
        model_config=ModelConfig(**{**cfg.__dict__,
                                    "compute_dtype": "float32"}))
    ref = cpu.detect_vulnerabilities(codes[1])
    d_c = float(np.abs(np.asarray(card["contract_probabilities"])
                       - np.asarray(ref["contract_probabilities"])).max())
    d_l = float(np.abs(np.asarray(card["line_probabilities"])
                       - np.asarray(ref["line_probabilities"])).max())
    print(f"phase cross-check: card bf16 vs CPU f32, contract probs max diff "
          f"{d_c:.3e}, line probs max diff {d_l:.3e} (tol {DETECT_TOL})",
          flush=True)
    if not (d_c <= DETECT_TOL and d_l <= DETECT_TOL):
        raise AssertionError("cross-check: card and CPU disagree")
    del cpu

    # -- decode_step vs teacher-forced logits on the card --------------------
    model = an.model
    with torch.inference_mode():
        b = an._prepare_inputs([template])
        memory = model.encode(b["input_ids"], b["attention_mask"],
                              b["ast_input_ids"], b["ast_attention_mask"])
        src = b["attention_mask"].bool()
        prefix = b["input_ids"][:, :32]
        full = model.decode_teacher_forced(prefix, memory, src).float()
        caches = model.init_decode_cache(1)
        cross = model.precompute_cross_kv(memory)
        step_err = 0.0
        for pos in range(prefix.shape[1]):
            lg = model.decode_step(prefix[:, pos:pos + 1], pos, caches, cross,
                                   src)
            step_err = max(step_err, max_err(lg, full[:, pos]))
        scale_ = full.abs().max().item()
    print(f"phase decode-vs-teacher: 32 positions, max |logit diff| "
          f"{step_err:.3e} (|logits| <= {scale_:.2f}, tol {DECODE_TOL})",
          flush=True)
    if not step_err <= DECODE_TOL:
        raise AssertionError("decode_step disagrees with teacher forcing")
    launches = {k: detect[k] + gen[k] for k in detect}
    return an, codes, template, launches


def make_batch(batch_size: int, seq: int, vocab: int):
    """The JAX package's training benchmark batch (bench.py:57-70)."""
    import numpy as np
    rng = np.random.default_rng(0)
    lines = np.minimum(np.arange(seq, dtype=np.int32) // 6, seq - 1)
    return {
        "input_ids": rng.integers(0, vocab, (batch_size, seq)).astype(np.int32),
        "attention_mask": np.ones((batch_size, seq), np.int32),
        "ast_input_ids": rng.integers(0, vocab, (batch_size, seq)).astype(np.int32),
        "ast_attention_mask": np.ones((batch_size, seq), np.int32),
        "token_to_line": np.tile(lines, (batch_size, 1)),
        "vulnerable_lines": (rng.random((batch_size, 8, seq)) < 0.01
                             ).astype(np.int32),
        "contract_vulnerabilities": rng.integers(
            0, 2, (batch_size, 8)).astype(np.int32),
    }


class _Empty:
    """A loader with no batches (the JAX bench builds its trainer so)."""
    batch_size = 8

    def __iter__(self):
        return iter(())


def _dropout_calls(model) -> list:
    """Forward hooks that count the calls of every active dropout site
    (rate > 0) of ``model``: each call is one dropout launch forward and
    one backward. Returns [count, handles]."""
    from sct_gan_tpu_torch.models.layers import Dropout
    box = [0, []]

    def hook(mod, inp, out):
        if mod.training and mod.rate > 0.0:
            box[0] += 1
    for m in model.modules():
        if isinstance(m, Dropout):
            box[1].append(m.register_forward_hook(hook))
    return box


def phase_train():
    """The training path: 5 train_steps of the JAX bench's configuration
    and batch, then train_epoch over a 16-contract corpus."""
    import torch
    from sct_gan_tpu_torch import (SmartContractTrainer,
                                   SmartContractTransformer)
    from sct_gan_tpu_torch.config import ModelConfig, TrainConfig
    from sct_gan_tpu_torch.data import create_dataloaders, write_corpus_csv
    from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer

    cfg = ModelConfig(use_gan=True, max_length=1024, max_lines=1024)
    tcfg = TrainConfig(learning_rate=1e-5, use_gan=True, warmup_epochs=1)
    tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
    t0 = time.perf_counter()
    model = SmartContractTransformer(cfg, seed=0)
    trainer = SmartContractTrainer(model, _Empty(), _Empty(), tok,
                                   config=tcfg, verbose=False)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase train model: {n_params / 1e6:.1f} M f32 parameters, "
          f"dropout {cfg.dropout}, fused_lm_ce {tcfg.fused_lm_ce}, "
          f"fused_optimizer {tcfg.fused_optimizer}; trainer built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    batch = trainer.to_device(make_batch(8, 1024, cfg.vocab_size))
    scalars = trainer._scalars(1.0)
    lrs = trainer._group_lrs()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    calls = _dropout_calls(model)
    reset_counts()
    state, history = trainer.state, []
    t0 = time.perf_counter()
    for _ in range(5):
        state, metrics, scalars = trainer.train_step(
            state, batch, scalars, lrs, trainer.generator)
        history.append(metrics)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    for h in calls[1]:
        h.remove()
    trainer.state = state
    per_step_drop = 2 * calls[0] // 5
    want = {"flash_attention_fwd": 5 * FLASH_PER_TRAIN_FORWARD,
            "flash_attention_bwd": 5 * FLASH_PER_TRAIN_FORWARD,
            "dropout": 5 * per_step_drop, "decode_attention": 0}
    if counts != want or calls[0] % 5:
        raise AssertionError(f"train: launches {counts}, expected {want}")
    rows = [{k: float(v) for k, v in m.items()} for m in history]
    losses = [r["total_loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite losses {losses}")
    if any(r["skipped"] != 0.0 for r in rows):
        raise AssertionError(f"train: a step was skipped: {rows}")
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    for n in ("embedding.weight", "output_layer.weight",
              "encoder.layer_0.self_attn.q_proj.weight",
              "disc_synthetic_head.dense_1.weight"):
        if n not in moved:
            raise AssertionError(f"train: {n} did not move")
    del before
    print(f"phase train: 5 train_steps at B=8 L=1024 in {first_s:.2f} s "
          f"(first calls); launches {counts} = per step "
          f"{FLASH_PER_TRAIN_FORWARD} flash fwd, {FLASH_PER_TRAIN_FORWARD} "
          f"flash bwd, {per_step_drop} dropout ({calls[0] // 5} sites x "
          f"fwd+bwd); total_loss {['%.4f' % x for x in losses]}; "
          f"grad_norm {['%.3f' % r['grad_norm'] for r in rows]}; skipped 0; "
          f"{len(moved)}/{len(list(model.parameters()))} parameter "
          f"tensors moved", flush=True)

    # -- train_epoch through the data pipeline -------------------------------
    out_dir = os.path.join(ROOT, "profile_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_corpus.csv")
    write_corpus_csv(path, n=16, seed=0)
    tr, va = create_dataloaders(path, tok, batch_size=8, max_length=1024)
    epoch_trainer = SmartContractTrainer(model, tr, va, tok, config=tcfg,
                                         verbose=False)
    reset_counts()
    out = epoch_trainer.train_epoch(0)
    torch.cuda.synchronize()
    epoch_counts = read_counts()
    if out["batches"] != 2 or not all(
            math.isfinite(out[k]) for k in ("gen_loss", "contract_vuln_loss",
                                            "line_vuln_loss")):
        raise AssertionError(f"train_epoch: {out}")
    if (epoch_counts["flash_attention_fwd"] != 2 * FLASH_PER_TRAIN_FORWARD
            or epoch_counts["flash_attention_bwd"]
            != 2 * FLASH_PER_TRAIN_FORWARD or epoch_counts["dropout"] == 0):
        raise AssertionError(f"train_epoch: launches {epoch_counts}")
    print(f"phase train_epoch: 16 contracts ({len(tr.dataset)} train rows, "
          f"2 batches of 8, the second padded); launches {epoch_counts}; "
          f"gen {out['gen_loss']:.4f} contract {out['contract_vuln_loss']:.4f}"
          f" line {out['line_vuln_loss']:.4f} disc "
          f"{out['discriminator_loss']:.4f}", flush=True)
    del epoch_trainer
    launches = {k: counts[k] + epoch_counts[k] for k in counts}
    return trainer, batch, launches


def _loss_and_norms(model, batch, tables, device):
    """Deterministic compute_losses with its gradients: (total loss, the
    global grad norm, the grad norm of the q/k/v projections)."""
    import torch
    from sct_gan_tpu_torch.train.train_step import (DynamicScalars,
                                                    compute_losses)
    total, _ = compute_losses(
        model, batch, DynamicScalars.make(5.0, 3.0, 0.25, 2.0, 0.2, device),
        None, use_gan=True, use_augmentation=False, tables=tables,
        deterministic=True, fused_lm_ce=True)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(total, [p for _, p in named],
                                allow_unused=True)
    sq = {n: float((g.float() ** 2).sum()) for (n, _), g in zip(named, grads)
          if g is not None}
    qkv = sum(v for n, v in sq.items()
              if any(s in n for s in ("q_proj", "k_proj", "v_proj")))
    return total.item(), math.sqrt(sum(sq.values())), math.sqrt(qkv)


def phase_train_check(trainer):
    """Same weights, dropout off, B=2: the card (bf16, kernels) against the
    CPU (f32, plain versions) on the loss and the gradient norms."""
    import torch
    from sct_gan_tpu_torch import SmartContractTransformer
    from sct_gan_tpu_torch.config import ModelConfig

    model = trainer.model
    host = make_batch(2, 1024, model.config.vocab_size)
    card = _loss_and_norms(model, trainer.to_device(host),
                           trainer.syntax_tables, trainer.device)
    cfg32 = ModelConfig(**{**model.config.__dict__,
                           "compute_dtype": "float32"})
    cpu_model = SmartContractTransformer(cfg32, seed=None)
    cpu_model.load_state_dict({k: v.detach().cpu() for k, v in
                               model.state_dict().items()})
    t0 = time.perf_counter()
    cpu_batch = {k: v.cpu() for k, v in trainer.to_device(host).items()}
    cpu = _loss_and_norms(cpu_model, cpu_batch, trainer.syntax_tables, "cpu")
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    print(f"phase train cross-check: B=2, dropout off, card bf16 vs CPU f32 "
          f"({time.perf_counter() - t0:.1f} s on the CPU): total loss "
          f"{card[0]:.5f} vs {cpu[0]:.5f} (rel {rel[0]:.2e}, tol {LOSS_RTOL}); "
          f"grad norm {card[1]:.4f} vs {cpu[1]:.4f} (rel {rel[1]:.2e}); "
          f"q/k/v grad norm {card[2]:.5f} vs {cpu[2]:.5f} (rel {rel[2]:.2e}, "
          f"tol {GNORM_RTOL})", flush=True)
    if not (rel[0] <= LOSS_RTOL and rel[1] <= GNORM_RTOL
            and rel[2] <= GNORM_RTOL):
        raise AssertionError("train cross-check: card and CPU disagree")


def phase_times(an, codes, template, trainer, batch, card):
    """Kernels vs their plain versions and the library call, by CUDA
    events; the detection, generation and train-step times."""
    import torch
    import torch.nn.functional as F
    from sct_gan_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    from sct_gan_tpu_torch.ops.dropout import dropout, dropout_reference
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rb = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    b, h, s, d = 8, 8, 1024, 96
    q, k, v = (_heads(rb(b, s, 768)) for _ in range(3))
    lens = torch.tensor([1024, 900, 700, 512, 300, 1000, 64, 801], device=dev)
    mask = torch.arange(s, device=dev)[None, :] < lens[:, None]
    sdpa_mask = mask[:, None, None, :]
    sc = 96 ** -0.5
    t = {}
    bf = 2   # bytes of a bf16 element
    qkv_bytes = b * h * s * d * bf
    with torch.inference_mode():
        t["flash_attention_fwd"] = (
            cuda_ms(lambda: flash_attention(q, k, v, key_padding_mask=mask,
                                            sm_scale=sc)),
            cuda_ms(lambda: flash_attention_reference(
                q, k, v, key_padding_mask=mask, sm_scale=sc)),
            cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, scale=sc)),
            *bound_ms(4 * b * h * s * s * d, 4 * qkv_bytes + b * s))
        qd = _heads(rb(2, 1, 768))
        kd, vd = _heads(rb(2, s, 768)), _heads(rb(2, s, 768))
        src2 = mask[:2]
        t["decode_attention"] = (
            cuda_ms(lambda: decode_attention(qd, kd, vd, src2, sm_scale=sc),
                    iters=200),
            cuda_ms(lambda: decode_attention_reference(
                qd, kd, vd, src2, sm_scale=sc), iters=200),
            cuda_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=src2[:, None, None, :], scale=sc),
                iters=200),
            *bound_ms(4 * 2 * h * s * d,
                      (2 * 2 * h * s * d + 2 * 2 * h * d) * bf + 2 * s))
        x = rb(8, 1024, 2048)
        n = x.numel()
        t["dropout"] = (
            cuda_ms(lambda: dropout(x, 0.3, 7), iters=50),
            cuda_ms(lambda: dropout_reference(x, 7, 0.3), iters=50),
            cuda_ms(lambda: F.dropout(x, 0.3, training=True), iters=50),
            *bound_ms(0, 2 * n * bf))

    # the backward: the kernel pair (with D = rowsum(dO∘O)) vs autograd
    # through the plain forward vs SDPA's backward, one dO, no dropout
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    dout = _heads(rb(b, s, 768))
    out, lse = flash_attention(qg, kg, vg, key_padding_mask=mask,
                               sm_scale=sc, return_lse=True)
    out = out.detach()
    ref = flash_attention_reference(qg, kg, vg, key_padding_mask=mask,
                                    sm_scale=sc)
    lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask,
                                         scale=sc)
    t["flash_attention_bwd"] = (
        cuda_ms(lambda: flash_attention_backward(
            q, k, v, out, lse, dout, mask, False, sc, 0.0, 0)),
        cuda_ms(lambda: torch.autograd.grad(ref, (qg, kg, vg), dout,
                                            retain_graph=True), iters=10),
        cuda_ms(lambda: torch.autograd.grad(lib, (qg, kg, vg), dout,
                                            retain_graph=True)),
        *bound_ms(5 * 2 * b * h * s * s * d,
                  7 * qkv_bytes + 2 * b * h * s * 4 + b * s))
    del ref, lib, qg, kg, vg

    for name, (ms, plain, libms, bnd, by) in t.items():
        print(f"phase times [{card}]: {name} {ms:.4f} ms vs plain "
              f"{plain:.4f} ms, library {libms:.4f} ms, bound {bnd:.4f} ms "
              f"({by})", flush=True)

    # the backward at Sk = 2048, where the TPU runs its K3/K4 pair
    b2, s2 = 4, 2048
    q2, k2, v2 = (_heads(rb(b2, s2, 768)).requires_grad_() for _ in range(3))
    mask2 = torch.arange(s2, device=dev)[None, :] < 2 * lens[:b2, None]
    dout2 = _heads(rb(b2, s2, 768))
    out2, lse2 = flash_attention(q2, k2, v2, key_padding_mask=mask2,
                                 sm_scale=sc, return_lse=True)
    out2 = out2.detach()
    ref2 = flash_attention_reference(q2, k2, v2, key_padding_mask=mask2,
                                     sm_scale=sc)
    lib2 = F.scaled_dot_product_attention(
        q2, k2, v2, attn_mask=mask2[:, None, None, :], scale=sc)
    ms2 = cuda_ms(lambda: flash_attention_backward(
        q2, k2, v2, out2, lse2, dout2, mask2, False, sc, 0.0, 0))
    plain2 = cuda_ms(lambda: torch.autograd.grad(
        ref2, (q2, k2, v2), dout2, retain_graph=True), iters=5)
    lib2_ms = cuda_ms(lambda: torch.autograd.grad(
        lib2, (q2, k2, v2), dout2, retain_graph=True))
    bnd2, by2 = bound_ms(5 * 2 * b2 * h * s2 * s2 * d,
                         7 * b2 * h * s2 * d * bf + 2 * b2 * h * s2 * 4
                         + b2 * s2)
    print(f"phase times [{card}]: flash_attention_bwd at (4, 8, 2048, 96) "
          f"(the TPU's K3/K4 blocking) {ms2:.4f} ms vs plain {plain2:.4f} "
          f"ms, library {lib2_ms:.4f} ms, bound {bnd2:.4f} ms ({by2})",
          flush=True)
    del ref2, lib2, q2, k2, v2

    # -- the paths --------------------------------------------------------------
    with torch.inference_mode():
        dbatch = an._prepare_inputs(codes)
        det_ms = cuda_ms(lambda: an._detect(dbatch), iters=10, warmup=2)
    t0 = time.perf_counter()
    an.analyze_multiple_contracts(codes)
    api_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    an.generate_synthetic_contract(template, num_contracts=2)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    steps = an.last_decode_steps
    print(f"phase times [{card}]: detection B=8 L=1024 device forward "
          f"{det_ms:.2f} ms/batch, analyze_multiple_contracts(8) with host "
          f"prep {api_ms:.1f} ms; generation 2 x {steps} steps in "
          f"{gen_s:.2f} s = {2 * steps / gen_s:.1f} tokens/s "
          f"({gen_s / steps * 1e3:.2f} ms/step)", flush=True)

    box = {"state": trainer.state,
           "scalars": trainer._scalars(1.0)}
    lrs = trainer._group_lrs()

    def step():
        box["state"], _, box["scalars"] = trainer.train_step(
            box["state"], batch, box["scalars"], lrs, trainer.generator)
    train_ms = cuda_ms(step, iters=6, warmup=2)
    trainer.state = box["state"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase times [{card}]: train step B=8 L=1024 {train_ms:.2f} "
          f"ms/step = {8 * 1024 / train_ms * 1e3:.0f} tokens/s (CUDA events "
          f"over 6 steps after 2 warm-up); peak device memory {peak:.1f} GiB",
          flush=True)
    return t, det_ms, gen_s / steps * 1e3, train_ms, step


def profile_device(fn, name: str, wall_ms: float, card: str):
    """Run ``fn()``, which returns how many units it ran, under
    ``torch.profiler`` (device activity only); print device time and
    launches per unit against ``wall_ms``, the unprofiled time of one unit,
    and the top kernels; write every kernel to
    ``profile_out/profile_<name>.txt``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        per = fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    total_us = sum(e.self_device_time_total for e in evs)
    dev_ms = total_us / per / 1e3
    out_dir = os.path.join(ROOT, "profile_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_{name}.txt")
    with open(path, "w") as f:
        f.write(f"# {name}: {per} units, {card}\n# share  us/unit  "
                f"launches/unit  kernel\n")
        for e in evs:
            f.write(f"{e.self_device_time_total / total_us:6.1%} "
                    f"{e.self_device_time_total / per:10.2f} "
                    f"{e.count / per:8.2f}  {e.key}\n")
    print(f"phase profile {name} [{card}]: device {dev_ms:.3f} ms and "
          f"{sum(e.count for e in evs) / per:.1f} launches per unit, against "
          f"{wall_ms:.3f} ms unprofiled: busy {dev_ms / wall_ms:.1%}; "
          f"table in {os.path.relpath(path, ROOT)}", flush=True)
    for e in evs[:8]:
        print(f"  {e.self_device_time_total / total_us:6.1%} "
              f"{e.self_device_time_total / per / 1e3:.4f} ms x"
              f"{e.count / per:.1f}  {e.key[:90]}")


def main() -> int:
    phase_device()
    import torch
    phase_build()
    worst, worst_rel = phase_kernels()
    an, codes, template, serve_launches = phase_serve()
    trainer, batch, train_launches = phase_train()
    phase_train_check(trainer)
    card = card_line()
    t, det_ms, gen_ms, train_ms, step = phase_times(an, codes, template,
                                                    trainer, batch, card)

    def detect5():
        with torch.inference_mode():
            dbatch = an._prepare_inputs(codes)
            for _ in range(5):
                an._detect(dbatch)
        return 5

    def generate():
        an.generate_synthetic_contract(template, num_contracts=2)
        return an.last_decode_steps

    def train1():
        step()
        return 1
    profile_device(detect5, "detect", det_ms, card)
    profile_device(generate, "generate", gen_ms, card)
    profile_device(train1, "train", train_ms, card)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        ms, plain, libms, bnd, by = t[name]
        launches = serve_launches[name] + train_launches[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": worst[name], "max_rel_err": worst_rel[name],
            "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": libms})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
