#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sct_gan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``sct_gan_tpu_torch/csrc`` (and
fails if ``ptxas`` reports a spill in any instance of the flash forward or
backward or the decode attention), and holds each kernel against its plain
PyTorch version on the card at the main paths' shapes: the flash-attention
forward (with dropout and LSE) and backward, the single-query decode
attention (split-K, at the edges of its tiles and splits) and the hash
dropout; K1 also under whole masked key tiles (which it skips) with a row
that attends no key; K1's, the backward's and the decode attention's two
runs must give the same bits. The flash forward, the backward pair and the decode attention
are held so at each head-dim instance (64, 96, 128, 192, and 256 for the
flash kernels), at head dims between them (the flash kernels' padded
route at 80; the decode attention in place on a wider instance at 80 and
160, with no padded copy) and over them (the flash kernels' chunked route
at 384 and 320; the decode attention's wide-head route, in place, at 224,
256, 320 and 384), also under
``encode_concat``'s key mask with its hole. It holds every mode of the
kernel-timing tools'
kernels (K7-K10, ``sct_gan_tpu_torch/tools``) against its plain version at
the tools' shapes (K8 also over one to six blocks of key slices, K9 at
head dims 64, 96 and 128, B 1, 4 and 32, S 300, 1000 and 1024, with a
fully masked row), then runs the four tools' ``time_modes`` (their main
path), counting launches. Then it drives the paths of the port at full
width (d=768, L=1024, vocab 50265 padded to 50304, bf16 compute, random
weights from seed 0), counting kernel launches around each path to show it
ran through its kernels:

  * serving (8 heads of 96, 6+6 layers): batched detection of 8 contracts
    and sampled generation of 2, cross-checked against the port on the CPU
    in f32;
  * beam search (``beam``, the same model): ``generate_synthetic_contract(
    use_beam_search=True, beam_size=3)`` over the full length, its best
    hypothesis re-scored teacher-forced against the beam's own score;
  * the analyzer (``analyzer``): the fallback tiers, the diagnostics,
    ``debug_forward`` and ``generate_simple_contract``;
  * evaluation (``evals``): ``evaluate_model_performance``,
    ``collect_validation_results`` and ``compute_perplexity`` over 16
    contracts, held to ``analyze_multiple_contracts``;
  * training (the same): ``SmartContractTrainer.train_step`` on the JAX
    bench's batch (B=8, L=1024, dropout 0.3, fused LM-head CE, fused
    optimizer), then ``train_epoch`` over a 16-contract corpus; the loss
    and gradient norms are cross-checked against the CPU in f32 at B=2;
  * the training loop (``loop``, the same model, augmentation on):
    ``train(2)`` over 16 training and 8 validation contracts with best and
    latest checkpoints, a fresh trainer's ``restore`` of the latest held
    bit for bit, and ``SmartContractAnalyzer(model_path=best)`` held to
    detection on the trained weights;
  * the training and evaluation tools (``tools``, the same model;
    ``sct_gan_tpu_torch/tools/run_corpus_v2.py``): ``train_synthetic
    --corpus-v2`` over 16 family-0 contracts for 2 epochs with 8 test
    contracts a family (the summary with the JAX tool's keys and a finite
    fam0-fam2 matrix), ``eval_v2_infamily`` on its best checkpoint and on
    an untrained model's, ``analyze_v2_errors`` on family 2, and
    ``time_opt`` unfused and fused;
  * the other head dims (``heads``): ModelConfig(nhead=12) (head dim 64),
    ModelConfig(nhead=6) (128), ModelConfig(nhead=4) (192),
    ModelConfig(nhead=3) (256) and ModelConfig(nhead=2) (384), depth cut to
    2+2 layers (nhead=4: 2+6, so that generation launches the decode
    attention's 192 instance 12 times a step): one detection forward, one
    train step and 16 generation steps each, with no padded copy in the
    decode attention;
  * the TASC variants (``tasc``) at ``TASCConfig()`` width (d=768, 8 heads
    of 96, 6+6 layers, decoder vocab 50000, L=512, bf16 compute; CodeBERT
    12 layers of 12 heads of 64 in f32, the f32 decode caches, as in the
    JAX package), binary and multiclass, built by
    ``build_variant`` / ``build_trainer``: ``train(2)`` over 16 training
    and 8 validation records with a best checkpoint, a fresh trainer's
    ``restore`` held bit for bit, ``validate``, 512-token
    ``generate_vulnerable_code`` and (multiclass) ``detect_vulnerabilities``;
    a deterministic B=2 step and the CodeBERT embedding (1e-4
    norm-wise) cross-checked against the CPU in f32; and one
    ``build_variant("model-v3")`` train step on the bench's batch. K1,
    the pair and K5 are also held to their plain versions at the TASC
    shapes;
  * the parallel paths (``parallel``, the serving and training width,
    ``sct_gan_tpu_torch/parallel``): on an NCCL world of one, the 1 x 1
    mesh's train step and ``analyze_multiple_contracts`` held bit for bit
    to mesh=None's, ``sp_detect`` at S=16384 (16x the configured length,
    B=2, a ragged key mask) and the gradient of ``sp_encode`` at S=8192
    (the backward pair at Sk=8192); then two gloo ranks sharing the card
    (``python3 chip_smoke.py --parallel-rank <dir>``, started by the
    script): ``sp_encode`` and its gradient at sp=2, and a dp=2 and an mp=2
    train step, each against the world of one. K1, the pair and K6 are
    held to their plain versions at the meshes' index origins and at
    Sk=16384 and 8192 first;
  * the driver entry points (``entry``; ``sct_gan_tpu_torch/entry.py``, the
    port of the root ``__graft_entry__.py``): ``entry()``'s full-size
    forward once, its probabilities against the CPU in f32, then
    ``dryrun_multichip(1)`` over NCCL and ``dryrun_multichip(2)`` as two
    gloo ranks sharing the card (a GAN train step on the dp x mp mesh and
    the sp encode, at the JAX file's tiny config in f32), the two losses
    held to each other;
  * the f32 paths (``f32``, after ``entry``): the f32 instances of K1,
    the pair and K5 (3xTF32 products) against their plain f32 versions
    (forward 1e-5, backward 1e-4 norm-wise, the dropout keep bits exactly),
    then ``ModelConfig(compute_dtype="float32")`` at full width: 3 train
    steps of the bench's configuration with the peak device memory and a
    B=2 check against the CPU, a detection batch of 8 and generation of 2
    contracts, each held to the CPU or to teacher forcing, and the f32
    kernels' times;
  * the bench (``bench``, the training width; ``sct_gan_tpu_torch/tools/
    bench.py``, the port of the JAX repo's ``bench.py``): its line at the
    JAX bench's configuration and counts (the fused step, decode at B=64,
    the f32 dense-attention naive leg), the launches of each leg held to
    the config, then ``peak_matmul``, ``time_fwd``, ``time_decode`` and
    ``time_fwd_modules --grad`` once each;
  * the attribution tools (``attribution``, after the bench):
    ``time_lmce``, ``time_lmce_parts``, ``time_flash_real``,
    ``time_layer``, ``time_decode_parts`` and ``time_host_prep`` once each
    at the JAX tools' shapes, each tool's launches held to the config;
  * the step tools (``step tools``, after the attribution tools):
    ``profile_step``, ``time_opt_ab``, ``time_lmce_ab``,
    ``time_opt_megaleaf``, ``ablate_step``, ``time_dispatch`` (with its
    CUDA graph of 8 train steps held to 8 eager steps), ``ab_aug_labels``
    and ``ab_contract_dilution`` once each at the JAX tools'
    configurations with fewer repeats, each tool's launches held to the
    config.

It times the kernels (every head-dim instance), their plain versions, the
PyTorch library call for the same function and each path with CUDA events
or synchronised host clocks, and profiles detection, generation, 127 beam
steps and one train step with ``torch.profiler`` (tables in
``profile_out/profile_*.txt``), every trace read through
``utils.profiling.trace_device`` (primed, held to the launch counters).

Every phase prints a line; any failure raises (non-zero exit). The line
before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a
CUDA device it exits 1 and prints no result.

    python3 chip_smoke.py --k1-times <checkout> [<checkout> ...]
    python3 chip_smoke.py --variants-times <checkout> [<checkout> ...]

time K1, or the tools' K7, K8 and K9, against those of other checkouts (a
parent unpacked by ``git archive``, or a changed copy of ``csrc/``), built
from their own sources, in turns.

    python3 chip_smoke.py --profiler-probe

shows where ``torch.profiler`` loses records (a session's first, once the
process is a minute or two old) and that a primed trace keeps them.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

os.environ.setdefault("HF_HUB_OFFLINE", "1")          # no network, ever
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# the card's name and power limit, CUDA-event timing and the H100's peaks
from sct_gan_tpu_torch.utils.profiling import (  # noqa: E402
    GRAPH_REPLAYS, bound_ms, card_line, cuda_ms, ring_inputs, ring_ms)
# the port's one table of kernel launch counters
from sct_gan_tpu_torch.utils.profiling import (  # noqa: E402
    kernel_launches as read_counts, reset_kernel_launches as reset_counts)
# SDPA's backward, the backward pair's yardstick (timed, never called by
# the port)
from sct_gan_tpu_torch.tools._common import sdpa_backward_ms  # noqa: E402
# the JAX bench's training batch (bench.py:57-70), from the port's bench
from sct_gan_tpu_torch.tools.bench import make_batch  # noqa: E402

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
    # the f32 instances (phase_f32): K1, the pair and K5 on f32 operands
    "flash_attention_fwd_f32": (
        "sct_gan_tpu_torch/csrc/flash_attention_fwd_f32.cu",
        "sct_gan_tpu/ops/flash_attention.py:205"),
    "flash_attention_bwd_f32": (
        "sct_gan_tpu_torch/csrc/flash_attention_bwd_f32.cu",
        "sct_gan_tpu/ops/flash_attention.py:510 (K2), :530 (K3), :550 (K4)"),
    "decode_attention_f32": (
        "sct_gan_tpu_torch/csrc/decode_attention_f32.cu",
        "sct_gan_tpu/ops/decode_attention.py:83"),
}
# the bf16 kernels, whose line entries come per head-dim instance
BF16_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "dropout",
                "decode_attention")
F32_KERNELS = ("flash_attention_fwd_f32", "flash_attention_bwd_f32",
               "decode_attention_f32")


def launch_dict(fwd: int = 0, bwd: int = 0, dropout: int = 0,
                decode: int = 0, f32: bool = False, **named) -> dict:
    """A whole count of ``read_counts()``'s kernels: ``fwd`` K1, ``bwd``
    pair, ``dropout`` K6 and ``decode`` K5 launches (of the f32 instances
    when ``f32``), others by name in ``named``, 0 elsewhere."""
    sfx = "_f32" if f32 else ""
    want = dict.fromkeys(KERNELS, 0)
    want.update({"flash_attention_fwd" + sfx: fwd,
                 "flash_attention_bwd" + sfx: bwd, "dropout": dropout,
                 "decode_attention" + sfx: decode}, **named)
    return want
# The kernel-timing tools' kernels (sct_gan_tpu_torch/tools): name ->
# (source, TPU kernel replaced, the mode the kernels line reports at its top
# level: the one closest to the shipped kernel)
VARIANTS = {
    "flash_parts": ("sct_gan_tpu_torch/csrc/flash_parts.cu",
                    "tools/time_flash_parts.py:81", "full"),
    "flash_variants": ("sct_gan_tpu_torch/csrc/flash_variants.cu",
                       "tools/time_flash_variants.py:75", "nk1"),
    "decode_variants": ("sct_gan_tpu_torch/csrc/decode_variants.cu",
                        "tools/time_decode_kernel_variants.py:77 (v2), "
                        ":113 (v3)", "v2"),
    "dropout_variants": ("sct_gan_tpu_torch/csrc/dropout_variants.cu",
                         "tools/time_dropout_kernel.py:76", "drop"),
}
# flash-attention calls per training forward: 6 encoder + 12 decoder +
# AST and cross 2 + line heads 2 + discriminator 1 (the contract pooling
# stays dense: it returns its weights)
FLASH_PER_TRAIN_FORWARD = 23


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
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_seconds or 'not run: built before'})", flush=True)
    for entry, lines in main_path_reports(_build.ptxas_log):
        print(f"  ptxas {entry}: " + "; ".join(lines))
    for ln in _build.ptxas_log.splitlines():   # serialized wgmma, setmaxnreg
        if "(C75" in ln:
            print(f"  ptxas note: {ln.strip()}")
    if not all(any(name in ln for ln in regs) for name in NO_SPILL):
        raise AssertionError(f"build: no ptxas report of {NO_SPILL} beside "
                             f"{path}")
    spilled = kernel_spills(_build.ptxas_log)
    if spilled:
        raise AssertionError(f"build: kernels spill registers: {spilled}")


# the kernels whose ptxas report must show no spill (their designs' budgets
# allow none): the flash forward (every instance: flash_fwd_hopper_kernel
# at 64-128, flash_fwd_kernel over them, chunked too), the backward pair
# (every instance: flash_bwd_{dkv,dq}_hopper_kernel at 64-128, the wgmma
# kernels above), the decode attention (every instance; the 192 one, by its
# mangled name, must be in the report) with its wide-head route, the f32
# instances of the three, and the tools' K7, K8 and K9 (every mode and head
# dim)
NO_SPILL = ("flash_fwd_hopper_kernel", "flash_fwd_kernel", "flash_bwd_",
            "decode_splitk_kernel", "decode_splitk_kernelILi192E",
            "decode_wide_kernel", "flash_parts_hopper_kernel",
            "flash_variants_kernel", "decode_perbatch_kernel",
            "flash_f32_fwd_kernel", "flash_f32_dkv_kernel",
            "flash_f32_dq_kernel", "decode_f32_kernel")


def main_path_reports(log: str) -> list:
    """(entry, [report lines]) of each ``NO_SPILL`` kernel instance in the
    ``ptxas -v`` log: its registers, shared memory and spills."""
    out, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            entry = name if any(k in name for k in NO_SPILL) else None
            if entry is not None:
                out.append((entry, []))
        elif entry is not None and ("Used" in ln or "spill" in ln):
            out[-1][1].append(ln.replace("ptxas info    :", "").strip())
    return out


def kernel_spills(log: str) -> list:
    """The ``NO_SPILL`` kernels whose ``ptxas -v`` report shows spill
    stores or loads."""
    bad, entry = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "spill" in ln and any(name in entry for name in NO_SPILL):
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            if any(nums[1:]):        # stack frame, spill stores, spill loads
                bad.append(f"{entry}: {ln.strip()}")
    return bad


def _heads(x, h=8):
    """(B, S, H*dh) → (B, H, S, dh) view: the strides the model passes."""
    b, s, d = x.shape
    return x.view(b, s, h, d // h).transpose(1, 2)


def check_close(errs: dict, kernel: str, name: str, got, want, tol: float,
                what: str = "", rel_tol: float = REL_TOL) -> None:
    """Hold ``got`` to ``want`` within ``tol`` (max abs) and ``rel_tol``
    (norm-wise); keep the worst of each in ``errs[kernel]``; print a line."""
    err, rel = max_err(got, want), rel_err(got, want)
    a, r = errs.get(kernel, (0.0, 0.0))
    errs[kernel] = (max(a, err), max(r, rel))
    print(f"  {kernel} {name}{what}: max_abs_err {err:.3e} "
          f"(tol {tol:.3e}), rel_err {rel:.3e} (tol {rel_tol})", flush=True)
    if not (err <= tol and rel <= rel_tol):
        raise AssertionError(f"{kernel} {name}{what}: max_abs_err {err} "
                             f"(tol {tol}), rel_err {rel} (tol {rel_tol})")


def k1_skip_checks(case, label: str) -> None:
    """K1 under ``skip_mask`` (whole masked key tiles; row 2 attends no
    key): with dropout 0.3 and LSE, and causal over the same mask. ``case(
    name, causal, rate)`` runs one case against the plain version and
    returns (out, lse); row 2 must give exact zeros and lse = -1e30."""
    for name, causal, rate in (
            ("whole masked key tiles, dropout 0.3", False, 0.3),
            ("whole masked key tiles, causal", True, 0.0)):
        out, lse = case(name, causal, rate)
        if out[2].abs().max().item() != 0.0 or not bool(
                (lse[2] == -1e30).all()):
            raise AssertionError(f"{label} {name}: the row with no "
                                 f"attended key must give zeros and "
                                 f"lse = -1e30")


def k1_determinism(q, k, v, mask, scale, what: str) -> None:
    """Two runs of K1 (causal, dropout 0.3, LSE) give the same bits."""
    import torch
    from sct_gan_tpu_torch.ops.flash_attention import flash_attention
    runs = [flash_attention(q, k, v, key_padding_mask=mask, causal=True,
                            sm_scale=scale, dropout_rate=0.3, seed=5,
                            return_lse=True) for _ in range(2)]
    torch.cuda.synchronize()
    same = (torch.equal(runs[0][0].view(torch.int16),
                        runs[1][0].view(torch.int16))
            and torch.equal(runs[0][1], runs[1][1]))
    print(f"  flash_attention_fwd determinism, two runs at {what}, dropout "
          f"0.3: out and lse bit-identical {same}", flush=True)
    if not same:
        raise AssertionError(f"K1 {what}: two runs differ")


def phase_kernels():
    """Every kernel against its plain version at the main paths' shapes."""
    import torch
    from sct_gan_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    from sct_gan_tpu_torch.ops.dropout import dropout, dropout_reference
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    scale = 96 ** -0.5
    lens = torch.tensor([1024, 900, 700, 512, 300, 1000, 64, 801], device=dev)
    errs = {}

    def check(kernel, name, got, want, tol, what=""):
        check_close(errs, kernel, name, got, want, tol, what)

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
        return got, lse

    pad_mask = torch.arange(1024, device=dev)[None, :] < lens[:, None]
    flash_case("key mask, padded tails", 1024, 1024, False, pad_mask)
    flash_case("causal", 1024, 1024, True, None)
    flash_case("Sq != Sk", 512, 1024, False, pad_mask)
    ragged = torch.arange(1000, device=dev)[None, :] < lens[:, None]
    flash_case("ragged S=1000", 1000, 1000, True, ragged)
    flash_case("Sq=200, Sk=1000, key mask", 200, 1000, False, ragged)
    flash_case("dropout 0.3, key mask", 1024, 1024, False, pad_mask, 0.3)
    flash_case("dropout 0.3, ragged causal", 1000, 1000, True, ragged, 0.3)
    empty = pad_mask.clone()
    empty[3] = False
    out, _ = flash_case("fully-masked row", 1024, 1024, False, empty)
    if out[3].abs().max().item() != 0.0:
        raise AssertionError("K1: a fully-masked row must give zeros")
    k1_skip_checks(lambda name, causal, rate: flash_case(
        name, 1024, 1024, causal, skip_mask(dev), rate), "K1")
    k1_determinism(_heads(rnd(8, 1000, 768, scale=2.0)),
                   _heads(rnd(8, 1000, 768)), _heads(rnd(8, 1000, 768)),
                   ragged, scale, "(8, 8, 1000, 96) ragged causal")

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
    bwd_case("whole masked key blocks and tiles", 8, 1024, 1024, False,
             skip_mask(dev), 0.3)
    bwd_case("causal", 8, 1024, 1024, True, None)
    bwd_case("dropout 0.3", 8, 1024, 1024, False, pad_mask, 0.3)
    bwd_case("dropout 0.3, ragged causal", 8, 1000, 1000, True, ragged, 0.3)
    bwd_case("Sq=200, Sk=1000, key mask", 8, 200, 1000, False, ragged, 0.3)
    dq, _, _ = bwd_case("fully-masked row", 8, 1024, 1024, False, empty)
    if dq[3].abs().max().item() != 0.0:
        raise AssertionError("K2: a fully-masked row must get dq = 0")
    long_mask = (torch.arange(2048, device=dev)[None, :]
                 < 2 * lens[:4, None])
    bwd_case("Sk=2048 (the TPU's nk>1 path)", 4, 2048, 2048, False,
             long_mask, 0.3)

    # determinism: no atomics, so two runs give the same bits
    q, k, v = (_heads(rnd(8, 1000, 768)) for _ in range(3))
    dout = _heads(rnd(8, 1000, 768))
    out, lse = flash_attention(q, k, v, key_padding_mask=ragged, causal=True,
                               sm_scale=scale, dropout_rate=0.3, seed=5,
                               return_lse=True)
    runs = [flash_attention_backward(q, k, v, out, lse, dout, ragged, True,
                                     scale, 0.3, 5) for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a.view(torch.int16), b.view(torch.int16))
            for a, b in zip(*runs)]
    print(f"  flash_attention_bwd determinism, two runs at (8, 8, 1000, 96) "
          f"ragged causal dropout 0.3: dq, dk, dv bit-identical {same}",
          flush=True)
    if not all(same):
        raise AssertionError(f"K2: the backward is not deterministic: {same}")

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

    # K5 splits the keys of a (b, h) over up to 8 blocks of 64-key tiles:
    # 8 splits of 2 tiles at B=2, S=1024; 1 split from B*H = 132 up
    q = _heads(rnd(2, 1, 768, scale=2.0))
    mem_k, mem_v = _heads(rnd(2, 1024, 768)), _heads(rnd(2, 1024, 768))
    # lens 874 and 750: row 1's last two splits attend no key
    src = torch.arange(1024, device=dev)[None, :] < lens[:2, None] - 150
    first = decode_case("cross S=1024, src mask", q, mem_k, mem_v, src)
    again = decode_attention(q, mem_k, mem_v, src, sm_scale=scale)
    torch.cuda.synchronize()
    same = torch.equal(first.view(torch.int16), again.view(torch.int16))
    print(f"  decode_attention determinism, two runs of the cross case: "
          f"bit-identical {same}", flush=True)
    if not same:
        raise AssertionError("K5: two runs differ")
    cache_k, cache_v = rnd(2, 8, 1024, 96), rnd(2, 8, 1024, 96)
    for pos in (0, 63, 64, 65, 127, 1023):   # the tile edges
        decode_case(f"self step pos={pos}", q, cache_k[:, :, :pos + 1],
                    cache_v[:, :, :pos + 1], None)
    last = src.clone()
    last[0] = False
    last[0, -1] = True
    decode_case("row 0 keeps only the last key", q, mem_k, mem_v, last)
    none = src.clone()
    none[1] = False
    out = decode_case("fully-masked row", q, mem_k, mem_v, none)
    if out[1].abs().max().item() != 0.0:
        raise AssertionError("K5: a fully-masked row must give zeros")
    decode_case("B=1 (8 splits), cross, src mask", q[:1], mem_k[:1],
                mem_v[:1], src[:1])
    lens64 = torch.randint(1, 1025, (64, 1), generator=g, device=dev)
    decode_case("B=64 (1 split), cross, ragged src mask",
                _heads(rnd(64, 1, 768, scale=2.0)), _heads(rnd(64, 1024, 768)),
                _heads(rnd(64, 1024, 768)),
                torch.arange(1024, device=dev)[None, :] < lens64)
    # one split of 64 tiles: the mask is read in two windows of 32 tiles,
    # whole dead tiles in both are skipped
    keys = torch.arange(4096, device=dev)[None, :]
    sparse = ((keys < 100) | ((keys >= 3000) & (keys < 3070))
              | (keys == 4095)).expand(17, 4096).clone()
    sparse[5] = keys[0] == 2100
    decode_case("B=17 (1 split), S=4096, sparse mask",
                _heads(rnd(17, 1, 768, scale=2.0)), rnd(17, 8, 4096, 96),
                rnd(17, 8, 4096, 96), sparse)
    long_k, long_v = rnd(2, 8, 16384, 96), rnd(2, 8, 16384, 96)
    decode_case("self S=16384 (past the old 8192-key limit)", q, long_k,
                long_v, None)
    del long_k, long_v
    print("phase kernels: worst max_abs_err / rel_err " + ", ".join(
        f"{k} {a:.3e} / {r:.3e}" for k, (a, r) in errs.items()), flush=True)
    return errs


# The head dims of the kernels' other instances, each with the heads that
# make it at d=768 (ModelConfig(nhead=12) and ModelConfig(nhead=6)), and a
# head dim without an instance (the flash kernels' padded route to 128; K5
# runs it in place on its 96 instance), held at 8 heads.
HEAD_DIMS = {64: 12, 128: 6}
PADDED_DIM = 80
# Head dims over 128, with their heads at d=768: ModelConfig(nhead=4)
# (192), nhead=3 (256) and nhead=2 (384). K1 and the pair run 192 and 256
# on instances of their own and over 256 chunks of their 192 instance (the
# chunked route); K5 runs 192 on its instance and over 192 its wide-head
# route. Both routes are named ``<name>_wide``. A ``_wide`` entry of the
# kernels line carries 384's times at its top level (``WIDE_TOP``) and
# every head dim's beside them.
WIDE_DIMS = {192: 4, 256: 3, 384: 2}
WIDE_TOP = 384
# a head dim the flash kernels' chunked route takes on a padded copy (320
# runs as 384); K5's wide-head route takes it in place
CHUNK_PADDED_DIM = 320
# the wide head dims the heads phase runs as models
WIDE_MODELS = (192, 256, 384)
# head dims K5 runs in place where its route is wider (80 on 96, 160 on
# 192, 224 in two chunks of the wide-head route), with their heads; the
# kernels line gives their errors beside the route's, as ``tail_dh<d>``
# on an instance and under ``head_dims`` on the wide-head route
DECODE_TAILS = {80: 8, 160: 4, 224: 3}
# the widest head dim K5 runs on an instance of its own
DECODE_TOP = 192
# the heads phase runs ModelConfig(nhead=4)'s decoder at the reference's
# depth, so its 16 decode steps launch K5's 192 instance 12 times a step
FULL_DECODER_DIM = 192


def instance(kernel: str, d: int) -> str:
    """The kernels line's name of ``kernel``'s head-dim-``d`` instance (96
    keeps the bare name); over 256 (K5: over 192) the route in chunks,
    ``<kernel>_wide``."""
    if d > (DECODE_TOP if kernel == "decode_attention" else 256):
        return f"{kernel}_wide"
    return kernel if d == 96 else f"{kernel}_dh{d}"


def err_key(kernel: str, d: int) -> str:
    """Where ``phase_head_kernels`` keeps the worst errors of ``kernel`` at
    head dim ``d``: the instance's name, ``<name>_dh128:padded80`` for the
    flash kernels' padded route, ``<instance>:tail<d>`` for K5 in place on
    a wider instance and ``<name>_wide:dh<d>`` on a route in chunks."""
    from sct_gan_tpu_torch.ops.decode_attention import decode_route
    if (kernel == "decode_attention" and d in DECODE_TAILS
            and d <= DECODE_TOP):
        return f"{instance(kernel, decode_route(d)[0])}:tail{d}"
    if d == PADDED_DIM:
        return f"{kernel}_dh128:padded{d}"
    name = instance(kernel, d)
    return f"{name}:dh{d}" if name.endswith("_wide") else name


def concat_mask(dev, b: int = 8, s: int = 1024):
    """The key mask ``encode_concat`` makes: the contract's first s/2
    tokens, padded after its length, then the AST's, padded after its own:
    a hole in the middle of each row whose contract is short."""
    import torch
    half = s // 2
    lc = torch.tensor([512, 450, 350, 256, 150, 500, 32, 400][:b], device=dev)
    la = torch.tensor([512, 300, 420, 100, 512, 60, 200, 450][:b], device=dev)
    pos = torch.arange(half, device=dev)[None, :]
    return torch.cat([pos < lc[:, None], pos < la[:, None]], dim=1)


def skip_mask(dev, b: int = 8, s: int = 1024):
    """A key mask whose rows hold whole masked 64-key tiles, which K1 and
    the backward pair skip (a K1 walk step, a dKV block, a dQ walk step):
    128-key spans whose first or second half has no attended key, rows
    with one or two live tiles, a fully masked row (row 2), every third
    tile, and every key (row 7)."""
    import torch
    keys = torch.arange(s, device=dev)
    rows = [(keys >= 64) & (keys < 128) | (keys >= s - 124),
            keys < 10,
            torch.zeros_like(keys, dtype=torch.bool),
            (keys >= 192) & (keys < 256) | (keys >= 640) & (keys < 700),
            (keys // 64) % 3 == 0,
            keys % 128 >= 64,
            keys % 128 < 64,
            torch.ones_like(keys, dtype=torch.bool)]
    return torch.stack(rows[:b])


def phase_head_kernels():
    """K1, the K2-K4 pair and K5 against their plain versions at full
    width, H * d = 768 (640 or 672 where d does not divide 768): the flash
    kernels at (8, H, 1024, d), K5 at (2, H, 1024, d), (8, H, 1024, d) and
    (64, H, 1024, d), every head dim also under ``encode_concat``'s mask
    with its hole.

    * K1 and the pair at head dims 64, 128, 192 and 256 (their instances),
      80 (their padded route, which runs the 128 instances) and 384 and 320
      (their chunked route, 320 on a copy padded to 384); each also
      causal and at Sk = 2048 under a shard origin of the dropout grid;
      the pair at 64 and 128 also with dropout, whole masked tiles, a
      fully masked row (dq = 0) and Sk = 8192 at B = 1.
    * K5 at its instances 64, 128 and 192, in place on a wider instance
      at 80 and 160, and in place on its wide-head route at 224, 256, 384
      and 320. At 192 two runs must give the same bits, and at every head
      dim the call at B=64 must allocate nothing on the card but its
      output: no padded copy.

    Returns the worst errors by ``err_key``, and each wide route's worst
    under its name."""
    import torch
    from sct_gan_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    errs = {}
    lens = torch.tensor([1024, 900, 700, 512, 300, 1000, 64, 801], device=dev)
    pad_mask = torch.arange(1024, device=dev)[None, :] < lens[:, None]
    ragged = torch.arange(1000, device=dev)[None, :] < lens[:, None]
    hole = concat_mask(dev)

    def check(kernel, d, name, got, want, tol, what):
        key = err_key(kernel, d)
        check_close(errs, key, name, got, want, tol, what)
        if key.endswith(f"_wide:dh{d}"):   # the route's worst over its dims
            a, r = errs[key]
            wa, wr = errs.get(instance(kernel, d), (0.0, 0.0))
            errs[instance(kernel, d)] = (max(a, wa), max(r, wr))

    def heads_rnd(h, d):
        def rnd(b, s, sd=1.0):
            x = torch.randn(b, s, h * d, generator=g, device=dev) * sd
            return _heads(x.to(torch.bfloat16), h)
        return rnd

    for d, h in [*HEAD_DIMS.items(), (PADDED_DIM, 8), *WIDE_DIMS.items(),
                 (CHUNK_PADDED_DIM, 2)]:
        scale = d ** -0.5
        rnd = heads_rnd(h, d)

        def fwd(name, sq, sk, causal, mask, rate=0.0, shard=None, b=8):
            q, k, v = rnd(b, sq, 2.0), rnd(b, sk), rnd(b, sk)
            args = dict(key_padding_mask=mask, causal=causal, sm_scale=scale,
                        dropout_rate=rate, seed=1234, return_lse=True,
                        drop_shard=shard)
            got, lse = flash_attention(q, k, v, **args)
            want, want_lse = flash_attention_reference(q, k, v, **args)
            torch.cuda.synchronize()
            check("flash_attention_fwd", d, name, got, want,
                  kernel_tol(want), f" q{tuple(q.shape)}")
            err = max_err(lse, want_lse)
            if not err <= LSE_TOL:
                raise AssertionError(f"K1 d={d} {name} lse: {err}")
            return got, lse

        def bwd(name, sq, sk, causal, mask, rate=0.0, shard=None, b=8):
            q, k, v = (rnd(b, s_, sd).requires_grad_()
                       for s_, sd in ((sq, 2.0), (sk, 1.0), (sk, 1.0)))
            dout = rnd(b, sq)
            args = dict(key_padding_mask=mask, causal=causal, sm_scale=scale,
                        dropout_rate=rate, seed=99, drop_shard=shard)
            got = torch.autograd.grad(flash_attention(q, k, v, **args),
                                      (q, k, v), dout)
            want = torch.autograd.grad(
                flash_attention_reference(q, k, v, **args), (q, k, v), dout)
            torch.cuda.synchronize()
            for nm, gt, wt in zip(("dq", "dk", "dv"), got, want):
                check("flash_attention_bwd", d, name, gt, wt,
                      kernel_tol(wt, 4), f" {nm} q{tuple(q.shape)}")
            return got

        fwd("key mask, padded tails", 1024, 1024, False, pad_mask)
        fwd("causal", 1024, 1024, True, None)
        fwd("dropout 0.3, ragged causal", 1000, 1000, True, ragged, 0.3)
        fwd("Sq=200, Sk=1000, key mask", 200, 1000, False, ragged)
        fwd("encode_concat mask (a hole), dropout 0.3", 1024, 1024, False,
            hole, 0.3)
        k1_skip_checks(lambda name, causal, rate: fwd(
            name, 1024, 1024, causal, skip_mask(dev), rate), f"K1 d={d}")
        if d in HEAD_DIMS:          # K1's other Hopper instances
            k1_determinism(rnd(8, 1000, 2.0), rnd(8, 1000), rnd(8, 1000),
                           ragged, scale, f"(8, {h}, 1000, {d}) ragged causal")
        bwd("key mask, padded tails", 1024, 1024, False, pad_mask)
        bwd("dropout 0.3, ragged causal", 1000, 1000, True, ragged, 0.3)
        bwd("Sq=200, Sk=1000, key mask, dropout 0.3", 200, 1000, False,
            ragged, 0.3)
        bwd("encode_concat mask (a hole), dropout 0.3", 1024, 1024, False,
            hole, 0.3)
        bwd("causal", 1024, 1024, True, None)
        long = torch.arange(2048, device=dev)[None, :] < 2 * lens[:4, None]
        long[3] = False             # a fully masked row
        for run in (fwd, bwd):
            run("Sk=2048, key mask, shard origin (1, 1, H+2), dropout 0.3",
                300, 2048, False, long, 0.3, (1, 1, h + 2), 4)
        if d in HEAD_DIMS:          # the pair's other Hopper instances
            bwd("dropout 0.3, key mask", 1024, 1024, False, pad_mask, 0.3)
            bwd("whole masked key blocks and tiles, dropout 0.3", 1024, 1024,
                False, skip_mask(dev), 0.3)
            empty = pad_mask.clone()
            empty[3] = False
            dq = bwd("fully-masked row", 1024, 1024, False, empty)[0]
            if dq[3].abs().max().item() != 0.0:
                raise AssertionError(f"K2 d={d}: a fully-masked row must "
                                     f"get dq = 0")
            bwd("Sk=8192, B=1, ragged key mask", 8192, 8192, False,
                torch.arange(8192, device=dev)[None, :] < 8192 - 3000, b=1)

    for d, h in [*HEAD_DIMS.items(), *DECODE_TAILS.items(),
                 *WIDE_DIMS.items(), (CHUNK_PADDED_DIM, 2)]:
        scale = d ** -0.5
        rnd = heads_rnd(h, d)

        def dec(name, b, k, v, mask):
            q = rnd(b, 1, 2.0)
            got = decode_attention(q, k, v, mask, sm_scale=scale)
            want = decode_attention_reference(q, k, v, mask, sm_scale=scale)
            torch.cuda.synchronize()
            check("decode_attention", d, name, got, want,
                  kernel_tol(want), f" k{tuple(k.shape)}")
            return got

        src = torch.arange(1024, device=dev)[None, :] < lens[:2, None] - 150
        mk, mv = rnd(2, 1024), rnd(2, 1024)
        dec("cross S=1024, src mask (8 splits)", 2, mk, mv, src)
        none = src.clone()
        none[1] = False
        if dec("fully-masked row", 2, mk, mv, none)[1].abs().max().item():
            raise AssertionError(f"K5 d={d}: a fully-masked row must give 0")
        cache = torch.randn(2, 2, h, 1024, d, generator=g, device=dev).to(
            torch.bfloat16)
        for pos in (0, 63, 64, 65, 1023):
            dec(f"self step pos={pos}", 2, cache[0, :, :, :pos + 1],
                cache[1, :, :, :pos + 1], None)
        lens64 = torch.randint(1, 1025, (64, 1), generator=g, device=dev)
        k64, v64 = rnd(64, 1024), rnd(64, 1024)
        dec("B=64 (1 split), ragged src mask", 64, k64, v64,
            torch.arange(1024, device=dev)[None, :] < lens64)
        dec("B=8, padded tails", 8, rnd(8, 1024), rnd(8, 1024), pad_mask)
        dec("B=8, encode_concat mask (a hole)", 8, rnd(8, 1024),
            rnd(8, 1024), hole)
        if d == 192:                # the split-order combine, bit for bit
            q = rnd(2, 1, 2.0)
            runs = [decode_attention(q, mk, mv, src, sm_scale=scale)
                    for _ in range(2)]
            torch.cuda.synchronize()
            same = torch.equal(runs[0].view(torch.int16),
                               runs[1].view(torch.int16))
            print(f"  decode_attention_dh192 determinism, two runs of the "
                  f"cross case: bit-identical {same}", flush=True)
            if not same:
                raise AssertionError("K5 d=192: two runs differ")
        # no padded copy at any head dim: only o is new
        q, every = rnd(64, 1, 2.0), torch.ones(64, 1024, dtype=torch.bool,
                                               device=dev)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = decode_attention(q, k64, v64, every, sm_scale=scale)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - before
        out_bytes = -(-got.numel() * got.element_size() // 512) * 512
        print(f"  decode_attention d={d} at {tuple(k64.shape)}: the "
              f"call allocated {grown} bytes, its output {out_bytes}",
              flush=True)
        if grown > out_bytes:
            raise AssertionError(f"K5 d={d}: {grown} bytes allocated, "
                                 f"more than the output's {out_bytes}")
        del cache, k64, v64
    print("phase head kernels: worst max_abs_err / rel_err " + ", ".join(
        f"{k} {a:.3e} / {r:.3e}" for k, (a, r) in errs.items()), flush=True)
    return errs


# K8's extra key counts (beside the tool's 1024) and K9's shapes held
# against the plain versions
K8_SEQS = (64, 320, 1536)
# K7's key lengths beside the tool's 1024: one key tile and half a block
# of query rows (64), and two, sixteen and twenty-four tiles
K7_SEQS = (64, 256, 1536)
K9_SHAPES = {"dh": (64, 96, 128), "b": (1, 4, 32), "s": (300, 1000, 1024)}


def k9_checks(check) -> None:
    """K9 v2 and v3 at every head dim, B and S of ``K9_SHAPES`` (at S = 300
    a v3 chunk straddles heads), with every key attended and under the
    tool's mask with a fully-masked row (which must give exact zeros),
    then over whole dead 64-key tiles and the model's head view. ``check``
    is ``phase_variants``'s (keeps the worst error of each mode)."""
    import torch
    from sct_gan_tpu_torch.tools import time_decode_kernel_variants as k9
    dev = torch.device("cuda")
    for dh in K9_SHAPES["dh"]:
        for b in K9_SHAPES["b"]:
            for s in K9_SHAPES["s"]:
                q, k, v, mask = k9.make_inputs(b, 8, s, dh, b + s + dh, dev)
                if b > 1:                         # a fully-masked row
                    mask[-1] = False
                for m in (None, mask):
                    want = k9.decode_variants_reference(q, k, v, m,
                                                        sm_scale=dh ** -0.5)
                    for mode in ("v2", "v3"):
                        got = k9.decode_variants(q, k, v, m, mode,
                                                 sm_scale=dh ** -0.5)
                        check("decode_variants", mode, got, want,
                              f" k({b}, 8, {s}, {dh}), "
                              + ("every key" if m is None else
                                 "~10% keys masked"
                                 + (", the last row all" if b > 1 else "")))
                        if (m is not None and b > 1
                                and got[-1].abs().max().item() != 0):
                            raise AssertionError(
                                f"K9 {mode}: a fully-masked row must give "
                                f"zeros")
    q, k, v, mask = k9.make_inputs(4, 8, 1000, 96, 5, dev)
    keys = torch.arange(1000, device=dev)
    mask[0] = (keys >= 64) & (keys < 128) | (keys >= 900)
    mask[2] = keys % 128 < 64
    mask[3] = keys == 999
    heads = torch.randn(2, 1000, 8 * 96, device=dev).to(torch.bfloat16)
    view = _heads(heads)                         # (2, 8, 1000, 96), strided
    qv = torch.randn(2, 8, 1, 96, device=dev).to(torch.bfloat16)
    for mode in ("v2", "v3"):
        check("decode_variants", mode,
              k9.decode_variants(q, k, v, mask, mode, sm_scale=0.1),
              k9.decode_variants_reference(q, k, v, mask, sm_scale=0.1),
              " k(4, 8, 1000, 96), whole dead 64-key tiles")
        check("decode_variants", mode,
              k9.decode_variants(qv, view, view, None, mode, sm_scale=0.1),
              k9.decode_variants_reference(qv, view, view, None,
                                           sm_scale=0.1),
              " the head view of (2, 1000, 768)")


def phase_variants(card: str) -> list:
    """K7-K10, the kernel-timing tools. Every mode against its plain version
    at the tool's shape (K7 and K8 at D = 96 and 128, K7 also at
    ``K7_SEQS`` keys and ``full`` on ``rising_max``'s input, which rescales
    O at most tiles), then the tools' ``time_modes`` at D = 96, the main
    path of this slice, with the launches counted. Returns the tools'
    entries of the kernels line."""
    import torch
    from sct_gan_tpu_torch.tools import time_decode_kernel_variants as k9
    from sct_gan_tpu_torch.tools import time_dropout_kernel as k10
    from sct_gan_tpu_torch.tools import time_flash_parts as k7
    from sct_gan_tpu_torch.tools import time_flash_variants as k8
    from sct_gan_tpu_torch.tools._common import summary_line
    tools = {"flash_parts": (k7, k7.flash_parts),
             "flash_variants": (k8, k8.flash_variants),
             "decode_variants": (k9, k9.decode_variants),
             "dropout_variants": (k10, k10.dropout_variants)}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    errs = {name: {} for name in VARIANTS}      # name -> mode -> (abs, rel)

    def check(name, mode, got, want, what="", exact=False):
        torch.cuda.synchronize()
        err, rel = max_err(got, want), rel_err(got, want)
        a, r = errs[name].get(mode, (0.0, 0.0))
        errs[name][mode] = (max(a, err), max(r, rel))
        if exact:     # bf16 bit patterns: a dropped negative x stays -0
            ok = torch.equal(got.view(torch.int16), want.view(torch.int16))
            bar = "bit for bit"
        else:
            tol = kernel_tol(want)
            ok = err <= tol and rel <= REL_TOL
            bar = f"tol {tol:.3e}, rel tol {REL_TOL}"
        print(f"  {name} {mode}{what}: max_abs_err {err:.3e}, rel_err "
              f"{rel:.3e} ({bar})", flush=True)
        if not ok:
            raise AssertionError(f"{name} {mode}{what}: max_abs_err {err}, "
                                 f"rel_err {rel} ({bar})")

    with torch.inference_mode():
        b, h, s = k7.SHAPE
        for dh in k7.HEAD_DIMS:
            x = (torch.randn(b, h, s, dh, generator=g, device=dev)
                 * 0.5).to(torch.bfloat16)
            for mode in k7.MODES:
                check("flash_parts", mode, k7.flash_parts(x, mode),
                      k7.flash_parts_reference(x, mode), f" {tuple(x.shape)}")
            for sk in (*K7_SEQS, s):
                xs = (torch.randn(2, 8, sk, dh, generator=g, device=dev)
                      * 0.5).to(torch.bfloat16)
                if sk != s:
                    for mode in k7.MODES:
                        check("flash_parts", mode, k7.flash_parts(xs, mode),
                              k7.flash_parts_reference(xs, mode),
                              f" {tuple(xs.shape)}")
                xr = k7.rising_max(xs)
                check("flash_parts", "full", k7.flash_parts(xr, "full"),
                      k7.flash_parts_reference(xr, "full"),
                      f" {tuple(xs.shape)}, rising maxima")
            for mode in k8.MODES:
                check("flash_variants", mode, k8.flash_variants(x, mode),
                      k8.flash_variants_reference(x, mode),
                      f" {tuple(x.shape)}")
            # K8's cluster of key slices: one block (64), a ragged last
            # slice (320), twelve blocks, past the portable eight (1536)
            for sk in K8_SEQS:
                xs = (torch.randn(2, 8, sk, dh, generator=g, device=dev)
                      * 0.5).to(torch.bfloat16)
                for mode in k8.MODES:
                    check("flash_variants", mode, k8.flash_variants(xs, mode),
                          k8.flash_variants_reference(xs, mode),
                          f" {tuple(xs.shape)}")
        k9_checks(check)
        x = torch.randn(*k10.SHAPE, generator=g, device=dev).to(
            torch.bfloat16)
        for mode in k10.MODES:
            check("dropout_variants", mode,
                  k10.dropout_variants(x, mode, k10.RATE, 17),
                  k10.dropout_variants_reference(x, mode, k10.RATE, 17),
                  f" {tuple(x.shape)} rate {k10.RATE}", exact=True)

    # -- the main path: the four tools' timing entry points ------------------
    for _, fn in tools.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = {"flash_parts": k7.time_modes(),
               "flash_variants": k8.time_modes(),
               "decode_variants": k9.time_modes(),
               "dropout_variants": k10.time_modes()}
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (_, fn) in tools.items()}
    # each timed mode: one eager call, then its calls captured in a CUDA
    # graph; K9's v2 and v3 also run once in the parity gate
    captured = {"flash_parts": k7.CHAIN * len(k7.MODES),
                "flash_variants": k8.CHAIN * len(k8.MODES),
                "decode_variants": 256 * 2,
                "dropout_variants": k10.CHAIN * len(k10.MODES)}
    eager = {"flash_parts": len(k7.MODES), "flash_variants": len(k8.MODES),
             "decode_variants": 2 + 2, "dropout_variants": len(k10.MODES)}
    want = {name: captured[name] + eager[name] for name in captured}
    if launches != want:
        raise AssertionError(f"variants: launches {launches}, expected "
                             f"{want}")
    print(f"phase variants: the four tools' time_modes in "
          f"{time.perf_counter() - t0:.1f} s, launches {launches}",
          flush=True)
    print("phase variants: K9's rate a batch row's block (bytes / ms / B): "
          + ", ".join(f"{m} {r['per_sm_gbs']:.1f} GB/s"
                      for m, r in results["decode_variants"].items()),
          flush=True)
    entries = []
    for name, (source, replaces, primary) in VARIANTS.items():
        res = results[name]
        tool = tools[name][0].__name__.rsplit(".", 1)[1]
        print(f"phase variants {summary_line(tool, res, card)}", flush=True)
        modes = {}
        for mode, r in res.items():
            a, rl = errs[name].get(mode, (None, None))
            modes[mode] = {"ms": r["ms"], "plain_ms": r["plain_ms"],
                           "library_ms": r["library_ms"],
                           "bound_ms": r["bound_ms"], "max_abs_err": a,
                           "max_rel_err": rl}
            if "per_sm_gbs" in r:
                modes[mode]["per_sm_gbs"] = r["per_sm_gbs"]
        top = res[primary]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            # a graph replay reruns the captured launches without calling
            # the wrapper: the kernel's runs beyond ``launches``
            "replayed_runs": GRAPH_REPLAYS * captured[name],
            "max_abs_err": errs[name][primary][0],
            "max_rel_err": errs[name][primary][1],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "mode": primary,
            "modes": modes})
    return entries


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
    want = launch_dict(5 * FLASH_PER_TRAIN_FORWARD,
                       5 * FLASH_PER_TRAIN_FORWARD, 5 * per_step_drop)
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


def _loader(tok, n: int, seed: int, shuffle: bool):
    """A batch-8 loader over ``n`` generated contracts at L=1024."""
    from sct_gan_tpu_torch.data.dataset import (
        ArrayDataLoader, SmartContractVulnerabilityDataset)
    from sct_gan_tpu_torch.data.synthetic import generate_corpus
    return ArrayDataLoader(SmartContractVulnerabilityDataset(
        tokenizer=tok, max_length=1024,
        records=generate_corpus(n=n, seed=seed)), 8, shuffle=shuffle)


def phase_loop() -> dict:
    """The full training loop at the reference geometry: the JAX bench's
    configuration with augmentation on, ``train(2)`` over 16 training and
    8 validation contracts (2 steps and 1 validation step an epoch), best
    and latest checkpoints; a fresh trainer restores the latest bit for
    bit; the analyzer serves the best by ``model_path`` and agrees with
    detection on the trained weights. Returns the launches of the two
    paths (the training loop, the served detection)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from sct_gan_tpu_torch import (SmartContractAnalyzer,
                                   SmartContractTrainer,
                                   SmartContractTransformer)
    from sct_gan_tpu_torch.config import ModelConfig, TrainConfig
    from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
    from sct_gan_tpu_torch.train.checkpoint import (find_checkpoint,
                                                    load_checkpoint,
                                                    save_checkpoint)

    cfg = ModelConfig(use_gan=True, max_length=1024, max_lines=1024)
    tcfg = TrainConfig(learning_rate=1e-5, use_gan=True, warmup_epochs=1,
                       use_augmentation=True)
    tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
    t0 = time.perf_counter()
    train, val = _loader(tok, 16, 0, True), _loader(tok, 8, 1, False)
    # verbose: the trainer prints each epoch's losses and host times
    trainer = SmartContractTrainer(SmartContractTransformer(cfg, seed=0),
                                   train, val, tok, config=tcfg)
    print(f"phase loop: 16 train / 8 val contracts, augmentation and GAN on; "
          f"data and trainer in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ckdir = tempfile.mkdtemp(prefix="loop_ckpt_", dir=ROOT)
    try:
        reset_counts()
        t0 = time.perf_counter()
        hist = trainer.train(2, checkpoint_dir=ckdir)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_counts()
        # per epoch 2 train steps (23 flash calls forward and backward
        # each) and 1 validation forward (23)
        want_flash = (2 * 3 * FLASH_PER_TRAIN_FORWARD,
                      2 * 2 * FLASH_PER_TRAIN_FORWARD)
        if ((counts["flash_attention_fwd"], counts["flash_attention_bwd"])
                != want_flash or counts["dropout"] == 0
                or counts["decode_attention"] != 0):
            raise AssertionError(f"loop: launches {counts}, expected flash "
                                 f"{want_flash} and dropout > 0")
        finite = all(math.isfinite(x) for k in ("train_loss", "val_loss")
                     for x in hist[k])
        names = sorted(os.listdir(ckdir))
        best, latest = (find_checkpoint(ckdir, "best"),
                        find_checkpoint(ckdir, "latest"))
        if (not finite or trainer.state.step != 4 or best is None
                or not latest.endswith("latest_model_augmented_gan")):
            raise AssertionError(f"loop: history {hist}, step "
                                 f"{trainer.state.step}, checkpoints {names}")
        state = trainer.state_tree()
        t0 = time.perf_counter()
        save_checkpoint(ckdir, "probe", state, {})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_checkpoint(os.path.join(ckdir, "probe"))
        load_s = time.perf_counter() - t0
        nbytes = sum(x.numel() * x.element_size() for x in
                     trainer.state.params.values()) * 3
        print(f"phase loop: train(2) in {train_s:.1f} s of host time "
              f"(epochs {hist['train_loss']} train, {hist['val_loss']} val "
              f"gen loss), launches {counts}; checkpoints {names}; a full "
              f"state ({nbytes / 2 ** 30:.2f} GiB) saves in {save_s:.1f} s "
              f"and loads in {load_s:.1f} s", flush=True)

        # -- a fresh trainer restores the latest checkpoint bit for bit -----
        fresh = SmartContractTrainer(SmartContractTransformer(cfg, seed=1),
                                     _Empty(), _Empty(), tok, config=tcfg,
                                     verbose=False)
        epoch = fresh.restore(latest)
        same = {
            "params": all(torch.equal(p, fresh.state.params[n])
                          for n, p in trainer.state.params.items()),
            "opt_state": all(
                torch.equal(trainer.state.opt_state[key][n],
                            fresh.state.opt_state[key][n])
                for key in ("mu", "nu") for n in trainer.state.params)
            and int(trainer.state.opt_state["count"])
            == int(fresh.state.opt_state["count"]),
            "step": fresh.state.step == trainer.state.step,
            "lrs": fresh.lrs == trainer.lrs,
            "scheduler": (fresh.scheduler.state_dict()
                          == trainer.scheduler.state_dict()),
            "history": fresh.training_history == trainer.training_history,
            "epoch": epoch == 2}
        print(f"phase loop: restore({os.path.basename(latest)}) into a "
              f"fresh trainer: bit for bit {same}", flush=True)
        if not all(same.values()):
            raise AssertionError(f"loop: restore differs: {same}")
        del fresh

        # -- serve the best checkpoint by model_path ------------------------
        best_epoch = int(best.rsplit("_", 1)[1])
        if best_epoch != 2:     # the trained weights of the best epoch
            trainer.restore(best)
        codes = [r["source_code"] for r in val.dataset.data]
        direct = SmartContractAnalyzer(
            params={n: p.detach() for n, p in trainer.state.params.items()},
            model_config=cfg, tokenizer=tok, verbose=False)
        reset_counts()
        served_an = SmartContractAnalyzer(best, model_config=cfg,
                                          tokenizer=tok, verbose=False)
        served = served_an.analyze_multiple_contracts(codes)
        torch.cuda.synchronize()
        serve_counts = read_counts()
        want = direct.analyze_multiple_contracts(codes)
        diff = max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
                   for a, b in zip(served, want)
                   for k in ("contract_probabilities", "line_probabilities"))
        print(f"phase loop: SmartContractAnalyzer({os.path.basename(best)}) "
              f"on the 8 validation contracts: launches {serve_counts}; "
              f"probabilities against detection on the trained weights of "
              f"epoch {best_epoch}: max diff {diff:.3e} (tol {DETECT_TOL})",
              flush=True)
        if not diff <= DETECT_TOL or serve_counts["flash_attention_fwd"] == 0:
            raise AssertionError("loop: the served checkpoint disagrees")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del trainer, direct, served_an
    torch.cuda.empty_cache()
    return {k: counts[k] + serve_counts[k] for k in counts}


TOOLS_RUN = dict(epochs=2, contracts=16, eval_contracts=8, n_infamily=8,
                 n_errors=8)
# summary.json's keys: the JAX tool's (tools/train_synthetic.py:203-216)
SUMMARY_KEYS = {"contracts", "train_family", "epochs_requested",
                "epochs_run", "train_minutes", "final_train_loss",
                "best_val_loss", "perplexity", "contract_overall",
                "line_overall", "matrix", "checkpoint"}


def phase_tools() -> dict:
    """The training and evaluation entry points at the reference width
    (``sct_gan_tpu_torch/tools``, through ``run_corpus_v2.run``, each
    tool's ``main`` in turn): ``train_synthetic --corpus-v2`` over 16
    family-0 contracts for 2 epochs (2 steps and 2 validation batches an
    epoch) with 8 test contracts a family, ``eval_v2_infamily --n 8`` on its
    best checkpoint and on an untrained model's, ``analyze_v2_errors
    --family 2 --contracts 8``, and ``time_opt`` unfused and fused. The
    summary must have the JAX tool's keys and a finite fam0-fam2 matrix.
    Returns the launches."""
    import shutil
    import tempfile

    import torch
    from sct_gan_tpu_torch.config import ModelConfig
    from sct_gan_tpu_torch.tools import run_corpus_v2
    out = tempfile.mkdtemp(prefix="tools_run_", dir=ROOT)
    try:
        reset_counts()
        t0 = time.perf_counter()
        secs = run_corpus_v2.run(out, **TOOLS_RUN)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = read_counts()

        def load(name):
            with open(os.path.join(out, name)) as f:
                return json.load(f)
        summary, infamily = load("summary.json"), load("summary_infamily.json")
        floor = load(os.path.join("untrained", "summary_infamily.json"))
        errors = load("errors_fam2.json")
        opt = [load("time_opt.json"), load("time_opt_fused.json")]
        timing = load("timing.json")
        matrix = summary["matrix"] or {}
        pr_aucs = [matrix[f][level]["pr_auc"] for f in matrix
                   for level in ("contract_overall", "line_overall")]
        pr_aucs += [s[level]["pr_auc"] for s in (infamily, floor)
                    for level in ("contract_overall", "line_overall")]
        # 2 epochs of 2 train steps (23 flash calls forward and backward,
        # 69 dropout sites each way) and 2 validation forwards; a full
        # forward in each of the three trainers' dimension tests
        # (train_synthetic's, time_opt's two) and in perplexity's 2
        # batches; a detection forward (10) a batch of 8 in the three
        # family columns, the in-family, floor and error stages
        cfg = ModelConfig(use_gan=True)
        want_bwd = 2 * 2 * FLASH_PER_TRAIN_FORWARD
        want_fwd = (want_bwd + (2 * 2 + 3 + 2) * flash_per_forward(cfg)
                    + 6 * flash_per_detect(cfg))
        want_drop = 2 * 2 * 2 * 69
        ok = {
            "summary keys": set(summary) == SUMMARY_KEYS,
            "matrix": sorted(matrix) == ["fam0", "fam1", "fam2"],
            "finite": all(math.isfinite(x) for x in pr_aucs)
            and math.isfinite(summary["perplexity"]["perplexity"]),
            "epochs": summary["epochs_run"] == 2 and len(timing["epochs"]) == 2,
            "errors": errors["contracts"] == 8 and errors["family"] == 2,
            "time_opt": all(o["ms"] > 0 and o["launches"] > 0 for o in opt),
            "launches": counts == launch_dict(want_fwd, want_bwd,
                                              want_drop)}
        print(f"phase tools: run_corpus_v2 {TOOLS_RUN} in {total_s:.1f} s "
              f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}); "
              f"epochs {[round(e['train_s'], 2) for e in timing['epochs']]} "
              f"s, {timing['step_ms']:.1f} ms a step; fam0/fam1/fam2 "
              f"contract PR-AUC "
              f"{[round(matrix[f]['contract_overall']['pr_auc'], 4) for f in sorted(matrix)]}"
              f", in-family {infamily['contract_overall']['pr_auc']:.4f} "
              f"(untrained {floor['contract_overall']['pr_auc']:.4f}); "
              f"perplexity {summary['perplexity']['perplexity']:.1f}; "
              f"time_opt {[(o['optimizer'], round(o['ms'], 3), o['launches']) for o in opt]}; "
              f"launches {counts} (expected flash {want_fwd} forward, "
              f"{want_bwd} backward, dropout {want_drop}); "
              f"checks {ok}", flush=True)
        if not all(ok.values()):
            raise AssertionError(f"tools: failed checks {ok}")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    # the block sweep of the backward pair (A11) at the model's head dim,
    # after the launches above are read: its timing calls are no main path
    from sct_gan_tpu_torch.tools import sweep_flash_blocks
    t0 = time.perf_counter()
    print(sweep_flash_blocks.table(sweep_flash_blocks.sweep(96), card_line()),
          flush=True)
    print(f"phase tools: sweep_flash_blocks at head dim 96 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return counts


def flash_per_detect(cfg) -> int:
    """K1 calls of a detection forward: the encoder's layers, the AST and
    cross attentions, the two line-head attentions (10 at 6 layers)."""
    return cfg.num_encoder_layers + 4


def flash_per_forward(cfg) -> int:
    """K1 calls of the full forward with targets: detection's, the
    decoder's self and cross attentions, the discriminator (23 at 6+6)."""
    return flash_per_detect(cfg) + 2 * cfg.num_decoder_layers + 1


# the beam's own score of its best hypothesis against the same tokens
# re-scored teacher-forced over encode_concat's memory: both are sums of
# bf16-path log-probs (decode_step's through K5, teacher forcing's through
# K1), each token's within a few bf16 steps of the logits (|logits| < 4:
# steps of 2^-6); the sum over n tokens is held to n * 2^-5.
BEAM_LOGP_TOL_PER_TOKEN = 2.0 ** -5


def phase_beam(an, template: str) -> dict:
    """Beam search at the reference width: ``generate_synthetic_contract(
    use_beam_search=True, beam_size=3)`` over the full length, counting
    its launches (K1 in ``encode_concat``, K5 at B*K = 3 rows a step); K5
    at (3, 8, 1024, 96) under the concatenated mask against its plain
    version; the best hypothesis re-scored teacher-forced against the
    beam's own score (the reindex of tokens and caches, held on the
    card). Returns the launches of the beam."""
    import torch
    from sct_gan_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    cfg = an.config
    reset_counts()
    t0 = time.perf_counter()
    out = an.generate_synthetic_contract(template, num_contracts=2,
                                         use_beam_search=True, beam_size=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps = an.last_decode_steps
    beam = an._beam_fns[3]
    layers = cfg.num_decoder_layers
    if (counts["flash_attention_fwd"] != cfg.num_encoder_layers
            or counts["decode_attention"] != 2 * layers * steps
            or len(out) != 2 or out[0] != out[1]):
        raise AssertionError(f"beam: launches {counts} for {steps} steps, "
                             f"outputs {len(out)}")
    print(f"phase beam: K=3 over {steps} steps (of {cfg.max_length - 1}) in "
          f"{wall:.2f} s = {wall / steps * 1e3:.2f} ms/step (first call); "
          f"launches {counts} = {cfg.num_encoder_layers} flash in "
          f"encode_concat, {2 * layers} decode a step at B*K = 3 rows",
          flush=True)

    # -- the reindex, held on the card: re-score the best hypothesis ---------
    b = an._prepare_inputs([template])
    with torch.inference_mode():
        memory, src_mask = an.model.encode_concat(
            b["input_ids"], b["attention_mask"], b["ast_input_ids"],
            b["ast_attention_mask"])
        tokens = beam.last_tokens[:, 0]      # the best, as decoded above
        score = float(beam.last_scores[0, 0])
        logits = an.model.decode_teacher_forced(tokens, memory, src_mask)
        logp = torch.log_softmax(logits.float() / 0.8, dim=-1)[0, :-1]
        picked = logp.gather(-1, tokens[0, 1:, None])[:, 0]
        eos = (tokens[0, 1:] == 2).nonzero()
        n = int(eos[0]) + 1 if len(eos) else picked.numel()
        rescored = float(picked[:n].sum())
    tol = n * BEAM_LOGP_TOL_PER_TOKEN
    print(f"phase beam re-score: best hypothesis, {n} tokens: beam score "
          f"{score:.4f}, teacher-forced {rescored:.4f} (|diff| "
          f"{abs(score - rescored):.4f}, tol {tol:.4f} = n x 2^-5)",
          flush=True)
    if not abs(score - rescored) <= tol:
        raise AssertionError("beam: the beam's score and the teacher-forced "
                             "re-score disagree")

    # -- K5 at the beam's rows under the concatenated mask --------------------
    dev = an.device
    g = torch.Generator(device=dev).manual_seed(11)
    errs = {}
    rb = lambda *sh: torch.randn(*sh, generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = (_heads(rb(3, s_, 768)) for s_ in (1, 1024, 1024))
    mask = concat_mask(dev, b=3)
    got = decode_attention(q, k, v, mask, sm_scale=96 ** -0.5)
    want = decode_attention_reference(q, k, v, mask, sm_scale=96 ** -0.5)
    torch.cuda.synchronize()
    check_close(errs, "decode_attention", "beam rows (3, 8, 1024, 96), "
                "encode_concat mask", got, want, kernel_tol(want))
    return counts


def phase_analyzer(an, codes) -> dict:
    """The analyzer's tiers and diagnostics at the reference width: the
    fallback chain and the contract-only tier on one contract (the full
    tier's probabilities equal ``detect_vulnerabilities``'), the four
    diagnostics, ``debug_forward`` and ``generate_simple_contract(256)``.
    Returns the launches."""
    import numpy as np
    import torch
    reset_counts()
    t0 = time.perf_counter()
    full = an.detect_vulnerabilities_with_fallback(codes[1])
    plain = an.detect_vulnerabilities(codes[1])
    safe = an.detect_vulnerabilities_safe(codes[1])
    head, _ = an._detect(an._prepare_inputs([codes[1]]))
    torch.cuda.synchronize()
    c_tiers = read_counts()
    same = (full["contract_probabilities"] == plain["contract_probabilities"]
            and full["line_probabilities"] == plain["line_probabilities"])
    safe_cp = np.asarray(safe["contract_probabilities"][0])
    per = flash_per_detect(an.config)
    if not (same and np.array_equal(safe_cp, head[0].cpu().numpy())
            and not np.asarray(safe["line_probabilities"]).any()
            and c_tiers["flash_attention_fwd"] == 3 * per + per - 2):
        raise AssertionError(f"analyzer tiers: full == detect {same}, "
                             f"launches {c_tiers}")
    print(f"phase analyzer tiers: the fallback chain's full tier equals "
          f"detect_vulnerabilities bit for bit; the contract-only tier "
          f"{[round(float(x), 4) for x in safe_cp]} with zero line "
          f"probabilities; launches {c_tiers} ({per} flash a full forward, "
          f"{per - 2} contract-only); {time.perf_counter() - t0:.2f} s",
          flush=True)

    reset_counts()
    t0 = time.perf_counter()
    func = an.test_model_functionality()
    diag = an.diagnose_generation_model()
    dbg = an.debug_forward(codes[1])
    simple = an.test_generation_simple()
    text = an.generate_simple_contract(max_length=256)
    simple_steps = an.last_decode_steps
    torch.cuda.synchronize()
    c_diag = read_counts()
    stats_ok = set(dbg) == {"line_means", "line_extracted", "line_logits"} \
        and all(math.isfinite(x) for s_ in dbg.values()
                for k, x in s_.items() if k != "collapsed")
    if not (func["success"] and simple["success"] and stats_ok
            and math.isfinite(diag["output_weight_std"])
            and len(diag["first_step_top_tokens"]) == 5
            and isinstance(text, str) and 1 <= simple_steps <= 255):
        raise AssertionError(f"analyzer diagnostics: {func}, {diag}, {dbg}, "
                             f"{simple}, steps {simple_steps}")
    print(f"phase analyzer diagnostics: test_model_functionality {func}; "
          f"diagnose_generation_model top tokens "
          f"{diag['first_step_top_tokens']}, weight std "
          f"{diag['output_weight_std']:.4f}; debug_forward "
          + ", ".join(f"{k} std {v['std']:.4f}" for k, v in dbg.items())
          + f"; test_generation_simple length {simple['generated_length']}; "
          f"generate_simple_contract(256) {simple_steps} steps, "
          f"{len(text)} chars; launches {c_diag}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {k: c_tiers[k] + c_diag[k] for k in c_tiers}


def phase_evals(an) -> dict:
    """The eval modules at the reference width over 16 synthetic contracts
    (``generate_corpus(n=16, seed=1)``, two batches of 8):
    ``evaluate_model_performance(analyzer=...)``,
    ``collect_validation_results(generate_contracts=False)`` and
    ``compute_perplexity`` over the two batches. The harness's and the
    validation's probabilities are held to ``analyze_multiple_contracts``'
    on the same contracts. Returns the launches."""
    import numpy as np
    import torch
    from sct_gan_tpu_torch.evals import (collect_validation_results,
                                         compute_metrics_for_threshold,
                                         compute_perplexity,
                                         evaluate_model_performance)
    from sct_gan_tpu_torch.evals.harness import _best_f1_sweep
    loader = _loader(an.tokenizer, 16, 1, False)
    data = loader.dataset.data
    codes = [r["source_code"] for r in data]
    out_dir = os.path.join(ROOT, "profile_out")
    os.makedirs(out_dir, exist_ok=True)
    reset_counts()
    t0 = time.perf_counter()
    res = evaluate_model_performance(
        val_dataloader=loader, analyzer=an, verbose=False,
        output_file=os.path.join(out_dir, "evaluation_results.json"))
    torch.cuda.synchronize()
    harness_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    val = collect_validation_results(an, loader, generate_contracts=False)
    val_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppl = compute_perplexity(an.model, loader, max_batches=2)
    torch.cuda.synchronize()
    ppl_s = time.perf_counter() - t0
    counts = read_counts()

    direct = an.analyze_multiple_contracts(codes, threshold=0.0)
    probs = np.stack([np.asarray(r["contract_probabilities"][0])
                      for r in direct])
    truth = np.stack([np.asarray(r["contract_vulnerabilities"])
                      for r in data])
    thr = res["model_info"]["contract_thresholds"]
    pred = np.stack([[int(p[j] > thr[vt]) for j, vt in
                      enumerate(an.vulnerability_types)] for p in probs])
    want = dict(compute_metrics_for_threshold(truth, pred, probs),
                best_f1=_best_f1_sweep(truth, probs))
    got_val = np.stack(val["contract_level"]["predicted_probs"])
    # detection (10 flash) on 2 batches of 8 in the harness and in the
    # validation; the perplexity forward (23) on 2 batches
    want_flash = (4 * flash_per_detect(an.config)
                  + 2 * flash_per_forward(an.config))
    ok = (res["contract_level"]["overall"] == want
          and np.array_equal(got_val, probs)
          and all(math.isfinite(ppl[k]) for k in ppl)
          and counts["flash_attention_fwd"] == want_flash
          and res["model_info"]["total_contracts"] == 16)
    print(f"phase evals: 16 contracts; evaluate_model_performance "
          f"{harness_s:.2f} s (contract PR-AUC "
          f"{res['contract_level']['overall']['pr_auc']:.4f}, line PR-AUC "
          f"{res['line_level']['overall']['pr_auc']:.4f}); "
          f"collect_validation_results {val_s:.2f} s; compute_perplexity "
          f"(2 batches of 8) {ppl_s:.2f} s, perplexity "
          f"{ppl['perplexity']:.1f} over {ppl['tokens']:.0f} tokens; the "
          f"harness's and the validation's probabilities equal "
          f"analyze_multiple_contracts' {ok}; launches {counts} (expected "
          f"{want_flash} flash)", flush=True)
    if not ok:
        raise AssertionError(f"evals: {res['contract_level']['overall']} vs "
                             f"{want}, launches {counts}")
    return counts


def phase_heads() -> dict:
    """ModelConfig(nhead=12) (head dim 64), ModelConfig(nhead=6) (head dim
    128), ModelConfig(nhead=4) (192) and ModelConfig(nhead=3) (256) (every
    kernel's instances, but K5 runs 256 on its wide-head route) and
    ModelConfig(nhead=2) (384: the flash kernels' chunked route, K5's
    wide-head route) at full width (d=768, L=1024,
    B=8), depth cut to 2+2 layers (nhead=4: 2+6, the reference's decoder,
    so that its 16 decode steps launch K5's 192 instance 12 times a
    step): one detection forward, one train step and 16 generation steps
    each, the counts read around each. The decode steps must make no
    padded copy (``pad_head_dim`` is counted around them). Returns the
    launches by instance name."""
    import numpy as np
    import torch
    from sct_gan_tpu_torch import (SmartContractAnalyzer,
                                   SmartContractTrainer,
                                   SmartContractTransformer)
    from sct_gan_tpu_torch.config import ModelConfig, TrainConfig
    from sct_gan_tpu_torch.data.synthetic import generate_corpus
    from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
    from sct_gan_tpu_torch.ops import decode_attention as k5
    codes = [r["source_code"] for r in generate_corpus(n=8, seed=0)]
    launches = {}
    models = [*HEAD_DIMS.items(), *((d, WIDE_DIMS[d]) for d in WIDE_MODELS)]
    enc = 2
    for d, h in models:
        dec = 6 if d == FULL_DECODER_DIM else 2
        cfg = ModelConfig(use_gan=True, max_length=1024, max_lines=1024,
                          nhead=h, num_encoder_layers=enc,
                          num_decoder_layers=dec)
        tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
        an = SmartContractAnalyzer(model_config=cfg, tokenizer=tok, seed=0,
                                   verbose=False)
        reset_counts()
        det = an.analyze_multiple_contracts(codes)
        torch.cuda.synchronize()
        c_det = read_counts()
        cp = np.asarray([r["contract_probabilities"][0] for r in det])

        trainer = SmartContractTrainer(
            SmartContractTransformer(cfg, seed=0), _Empty(), _Empty(), tok,
            config=TrainConfig(learning_rate=1e-5, use_gan=True,
                               warmup_epochs=1), verbose=False)
        batch = trainer.to_device(make_batch(8, 1024, cfg.vocab_size))
        reset_counts()
        trainer.state, metrics, _ = trainer.train_step(
            trainer.state, batch, trainer._scalars(1.0),
            trainer._group_lrs(), trainer.generator)
        torch.cuda.synchronize()
        c_train = read_counts()
        loss = float(metrics["total_loss"])

        model = an.model
        with torch.inference_mode():
            b = an._prepare_inputs(codes[:2])
            memory = model.encode(b["input_ids"], b["attention_mask"],
                                  b["ast_input_ids"], b["ast_attention_mask"])
            src = b["attention_mask"].bool()
            caches = model.init_decode_cache(2)
            cross = model.precompute_cross_kv(memory)
            tokens = b["input_ids"][:, :16]
            copies, pad = [], k5.pad_head_dim

            def counted(t, dk):     # the wrapper's padded copy, counted
                copies.append(dk)
                return pad(t, dk)
            k5.pad_head_dim = counted
            try:
                reset_counts()
                for pos in range(16):
                    logits = model.decode_step(tokens[:, pos:pos + 1], pos,
                                               caches, cross, src)
                torch.cuda.synchronize()
                c_gen = read_counts()
            finally:
                k5.pad_head_dim = pad
        # detection: enc encoder + AST/cross 2 + line heads 2 flash
        # forwards; a train step: enc + 2 x dec decoder (self + cross) + 2
        # + 2 + 1 forward and backward; 16 steps x dec layers x (self +
        # cross) decode calls, each on K5's decode_route(d) with no copy
        ok = (c_det["flash_attention_fwd"] == enc + 4
              and c_train["flash_attention_fwd"] == enc + 2 * dec + 5
              and c_train["flash_attention_bwd"] == enc + 2 * dec + 5
              and c_train["dropout"] > 0
              and c_gen["decode_attention"] == 16 * 2 * dec and not copies
              and np.isfinite(cp).all() and math.isfinite(loss)
              and bool(torch.isfinite(logits).all()))
        print(f"phase heads: ModelConfig(nhead={h}), head dim {d}, "
              f"{enc}+{dec} layers at d=768 L=1024 B=8: detection launches "
              f"{c_det}, contract probs [{cp.min():.4f}, {cp.max():.4f}]; "
              f"train step launches {c_train}, total_loss {loss:.4f}; 16 "
              f"decode steps at B=2 launches {c_gen} "
              f"({c_gen['decode_attention'] // 16} a step on K5's "
              f"{k5.decode_route(d)}, padded copies {len(copies)})",
              flush=True)
        if not ok:
            raise AssertionError(f"heads d={d}: launches or outputs wrong")
        for kernel in BF16_KERNELS:
            name = instance(kernel, d)
            launches[name] = launches.get(name, 0) + (
                c_det[kernel] + c_train[kernel] + c_gen[kernel])
        del an, trainer, model, caches, cross
        torch.cuda.empty_cache()
    return launches


# -- the TASC variants (sct_gan_tpu_torch/variants) -----------------------------
# card (bf16 CodeBERT and TASC, kernels) vs CPU (f32, plain versions), on
# the same weights and batch, dropout off:
# the four losses of a TASC step: BCEs of sigmoid scores near 0.7 and the
# decoder's CE of ~10.8 over 50000 logits, each from bf16 activations with
# ~3 significant digits: 1e-2 relative. A wrong kernel (a lost causal
# mask, a wrong scale) moves the decoder loss by O(1).
TASC_LOSS_RTOL = 1e-2
# the detection scores (sigmoids, slope <= 1/4, of bf16 activations with
# ~3 significant digits): 2e-2 absolute.
TASC_SCORE_TOL = 2e-2
# the CodeBERT embedding (12 post-norm layers, LayerNorm outputs of unit
# scale) computes in f32 on both sides, the card's attention in the f32
# flash kernel (3xTF32 products) and its matmuls in full f32 (TF32 off):
# only the order of sums differs, ~1e-6 relative a layer, so the card is
# held to 1e-4 norm-wise. A kernel fault (a wrong mask bit, a lost tile)
# moves whole rows by O(1).
TASC_EMBED_TOL = 1e-4


def tasc_per_path(cfg) -> dict:
    """Kernel launches of each TASC path per unit, from the config: the f32
    K1 of one CodeBERT embedding (one stream, head dim 64), and per step or
    batch the TASC model's K1 (head dim 96), the backward pair, K6 and K5
    (the self attention's over the f32 caches, the cross attention's over
    the memory's K/V in the compute dtype)."""
    n = cfg.num_layers
    return {"embed": cfg.codebert_num_layers,
            # the encoder in training mode (K1 with dropout, 3 K6 sites a
            # layer, forward only), the decoder loss's causal self and
            # cross attentions forward and backward
            "train_fwd": 3 * n, "train_bwd": 2 * n, "train_drop": 3 * n,
            # the full forward of validation: encoder and decoder
            "val_fwd": 3 * n,
            "detect_fwd": n,
            # a decode step: self (S = pos + 1, the f32 caches) and cross
            # (S = 1) a layer
            "decode_self": n, "decode_cross": n}


def _forward_calls(module) -> list:
    """[calls, handle]: a forward hook counting ``module``'s calls."""
    box = [0, None]

    def hook(mod, inp, out):
        box[0] += 1
    box[1] = module.register_forward_hook(hook)
    return box


def _tasc_loaders(tok, cfg, n_train=16, n_val=8, batch_size=4):
    from sct_gan_tpu_torch.data import (TASCDataLoader, TASCDataset,
                                        tasc_records_from_corpus)

    def make(n, seed):
        return TASCDataset(tasc_records_from_corpus(
            n=n, seed=seed, multiclass=cfg.multiclass), tok,
            max_length=cfg.max_length, multiclass=cfg.multiclass)
    return (TASCDataLoader(make(n_train, 0), batch_size, shuffle=True),
            TASCDataLoader(make(n_val, 1), batch_size))


def _same_state(a, b) -> bool:
    """Two trainers' ``state_tree()``s equal bit for bit."""
    import numpy as np
    import torch
    from sct_gan_tpu_torch.convert import _flatten
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    if fa.keys() != fb.keys():
        return False
    return all(torch.equal(x, fb[k]) if torch.is_tensor(x)
               else np.array_equal(np.asarray(x), np.asarray(fb[k]))
               for k, x in fa.items())


def _tasc_variant(name: str, card: str, overrides=None, device="cuda"):
    """One TASC variant at ``TASCConfig()`` width through its entry points:
    ``train(2)`` with a best checkpoint, a final state restored into a
    fresh trainer bit for bit, ``validate``, 512-token
    ``generate_vulnerable_code`` and, for multiclass,
    ``detect_vulnerabilities``; the launches of each part held to the
    config's counts; the multiclass variant is also timed. Returns the
    launches by instance name."""
    import shutil
    import tempfile

    import torch
    from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
    from sct_gan_tpu_torch.variants import (SmartContractVulnerabilityGAN,
                                            build_trainer, build_variant,
                                            generate_vulnerable_code)
    t0 = time.perf_counter()
    model, cfg = build_variant(name, overrides)
    tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
    train, val = _tasc_loaders(tok, cfg)
    trainer = build_trainer(name, model, cfg, train, val, tok, verbose=False,
                            device=device)
    per = tasc_per_path(cfg)
    count = lambda m: sum(p.numel() for p in m.parameters()) / 1e6
    print(f"phase tasc {name}: {count(model):.1f} M f32 parameters + "
          f"CodeBERT {count(trainer.codebert):.1f} M (compute "
          f"{cfg.compute_dtype}), {len(train.dataset)} train / "
          f"{len(val.dataset)} val contracts at L={cfg.max_length}, batch "
          f"{train.batch_size}; built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = dict.fromkeys(KERNELS, 0)

    def run(label, fn, want, tr=trainer):
        """Run ``fn`` with the counts set to 0 and ``tr``'s CodeBERT calls
        hooked; hold the launches to ``want`` (K1 of the TASC model, pair,
        K6) plus CodeBERT's f32 K1 per call; add them up."""
        calls = _forward_calls(tr.codebert)
        reset_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = read_counts()
        calls[1].remove()
        cb = calls[0] * per["embed"]
        expect = launch_dict(*want, flash_attention_fwd_f32=cb)
        print(f"phase tasc {name} {label}: {secs:.2f} s, launches {counts} "
              f"({calls[0]} CodeBERT calls: {cb} f32 K1 launches at head "
              f"dim 64)", flush=True)
        if counts != expect:
            raise AssertionError(f"tasc {name} {label}: launches {counts}, "
                                 f"expected {expect}")
        for k, v in counts.items():
            launches[k] += v
        return out, calls[0], secs

    steps, vals = len(train), len(val)
    ckdir = tempfile.mkdtemp(prefix="tasc_ckpt_", dir=ROOT)
    try:
        hist, cb_calls, train_s = run(
            "train(2)", lambda: trainer.train(2, checkpoint_dir=ckdir),
            (2 * steps * per["train_fwd"] + 2 * vals * per["val_fwd"],
             2 * steps * per["train_bwd"], 2 * steps * per["train_drop"]))
        finite = all(math.isfinite(x) for k in ("g_loss", "d_loss",
                                                 "decoder_loss", "val_loss")
                     for x in hist[k])
        cls_on = all(x > 0 for x in hist["classifier_loss"])
        if (cb_calls != 2 * 2 * (steps + vals) or not finite
                or cls_on != cfg.multiclass
                or not os.path.exists(os.path.join(ckdir, "tasc_best"))):
            raise AssertionError(f"tasc {name} train(2): history {hist}, "
                                 f"CodeBERT calls {cb_calls}, checkpoints "
                                 f"{os.listdir(ckdir)}")
        print(f"phase tasc {name} train(2): G {hist['g_loss']}, D "
              f"{hist['d_loss']}, decoder {hist['decoder_loss']}, classifier "
              f"{hist['classifier_loss']}, val {hist['val_loss']}; "
              f"{2 * steps} steps, {train_s / (2 * steps):.3f} s a step with "
              f"its share of validation, CodeBERT and the checkpoint",
              flush=True)

        # -- the final state, restored into a fresh trainer -----------------
        t0 = time.perf_counter()
        path = trainer.save(ckdir, "tasc_final")
        save_s = time.perf_counter() - t0
        fresh = build_trainer(
            name, SmartContractVulnerabilityGAN(cfg, seed=1), cfg, _Empty(),
            val, tok, verbose=False, device=device,
            codebert_params=trainer.codebert.state_dict())
        t0 = time.perf_counter()
        epochs = fresh.restore(path)
        load_s = time.perf_counter() - t0
        same = {"state": _same_state(trainer.state_tree(),
                                     fresh.state_tree()),
                "history": fresh.training_history == trainer.training_history,
                "best_val_loss": fresh.best_val_loss == trainer.best_val_loss,
                "epochs": epochs == 2}
        print(f"phase tasc {name}: restore(tasc_final) into a fresh trainer: "
              f"bit for bit {same}; saved in {save_s:.1f} s, loaded in "
              f"{load_s:.1f} s", flush=True)
        if not all(same.values()):
            raise AssertionError(f"tasc {name}: restore differs: {same}")
        val_loss, _, _ = run("validate (restored)", fresh.validate,
                             (vals * per["val_fwd"],), fresh)
        if val_loss != trainer.validate():
            raise AssertionError(f"tasc {name}: the restored trainer "
                                 f"validates to {val_loss}")
        del fresh

        gen = torch.Generator(device=device).manual_seed(0)
        reset_counts()        # the steps, and so K5's count, show after
        t0 = time.perf_counter()
        out = generate_vulnerable_code(trainer.model, gen, num_samples=2,
                                       tokenizer=tok,
                                       max_length=cfg.max_gen_length)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = read_counts()
        n_steps = out["decode_steps"]
        tokens = out["tokens"]
        ok = (tuple(tokens.shape) == (2, cfg.max_gen_length)
              and bool((tokens[:, 0] == 0).all())
              and counts == launch_dict(
                  decode=n_steps * per["decode_cross"],
                  decode_attention_f32=n_steps * per["decode_self"])
              and (n_steps == cfg.max_gen_length - 1
                   or bool((tokens[:, 1:n_steps + 1] == 0).any(1).all())))
        if cfg.multiclass:
            ok &= bool(torch.isfinite(out["vulnerability_scores"]).all())
        print(f"phase tasc {name} generate_vulnerable_code(num_samples=2, "
              f"max_length={cfg.max_gen_length}): {n_steps} steps in "
              f"{gen_s:.2f} s, launches {counts}; code[:60] "
              f"{out['code'][:60]!r}", flush=True)
        if not ok:
            raise AssertionError(f"tasc {name}: generation {counts}, "
                                 f"tokens {tuple(tokens.shape)}")
        for k, v in counts.items():
            launches[k] += v

        if cfg.multiclass:
            batch = next(iter(val))

            def detect():
                with torch.inference_mode():
                    return trainer.model.detect_vulnerabilities(
                        trainer._embed(batch["input_ids"],
                                       batch["attention_mask"]))
            det, _, _ = run("detect_vulnerabilities", detect,
                            (per["detect_fwd"],))
            scores = det["vulnerability_scores"]
            if (tuple(scores.shape) != (len(batch["label"]),
                                        cfg.num_vulnerability_types)
                    or not bool(torch.isfinite(scores).all())):
                raise AssertionError(f"tasc {name}: detection {scores}")
            print(f"phase tasc {name} detect_vulnerabilities: scores "
                  f"{scores.float().cpu().numpy().round(4).tolist()}",
                  flush=True)
            _tasc_times(trainer, batch, detect, gen, tok, cfg, card)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del trainer, model
    torch.cuda.empty_cache()
    return launches


def _tasc_times(trainer, batch, detect, gen, tok, cfg, card) -> None:
    """The multiclass variant's times at B=4, L=512: the train step on
    precomputed CodeBERT embeddings, one CodeBERT embedding (one stream),
    detection (embedding + ``detect_vulnerabilities``) by CUDA events
    around eager calls, so the host's dispatch is in them as a user meets
    it; 512-token generation of 2 rows on the host clock after a
    synchronise. Then the train step and the generation under
    ``torch.profiler`` (``profile_out/profile_tasc_*.txt``)."""
    import numpy as np
    import torch
    from sct_gan_tpu_torch.variants import generate_vulnerable_code
    ids, mask = batch["input_ids"], batch["attention_mask"]
    ce = trainer._embed(ids, mask)
    pe = trainer._embed(batch["path_input_ids"], batch["path_attention_mask"])
    labels, vuln, pattern = trainer._batch_labels(batch, np.asarray(ids))
    tids = trainer._t(ids)
    step_ms = cuda_ms(lambda: trainer._train_step(ce, pe, tids, labels, vuln,
                                                  pattern), iters=6, warmup=2)
    embed_ms = cuda_ms(lambda: trainer._embed(ids, mask), iters=10, warmup=2)
    det_ms = cuda_ms(detect, iters=10, warmup=2)
    t0 = time.perf_counter()
    out = generate_vulnerable_code(trainer.model, gen, num_samples=2,
                                   tokenizer=tok,
                                   max_length=cfg.max_gen_length)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    steps = out["decode_steps"]
    b = len(labels)
    print(f"phase tasc times [{card}]: multiclass-tasc at B={b} "
          f"L={cfg.max_length}: train step {step_ms:.2f} ms (CodeBERT "
          f"embeddings precomputed; CUDA events over 6 steps after 2), "
          f"CodeBERT embedding {embed_ms:.2f} ms a batch and stream, "
          f"detection {det_ms:.2f} ms a batch (embedding + "
          f"detect_vulnerabilities); generation 2 x {steps} steps in "
          f"{gen_s:.2f} s = {2 * steps / gen_s:.1f} tokens/s "
          f"({gen_s / steps * 1e3:.2f} ms/step); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB",
          flush=True)

    def train1():
        trainer._train_step(ce, pe, tids, labels, vuln, pattern)
        return 1

    def generate():
        return generate_vulnerable_code(
            trainer.model, gen, num_samples=2,
            max_length=cfg.max_gen_length)["decode_steps"]
    profile_device(train1, "tasc_train", step_ms, card)
    profile_device(generate, "tasc_generate", gen_s / steps * 1e3, card)


def _tasc_cpu_check(overrides=None, device="cuda") -> None:
    """A deterministic multiclass TASC step at B=2 (dropout 0) from the same
    weights and batch on the card (bf16, kernels) and on the CPU (f32,
    plain versions): the CodeBERT embedding of the batch, the detection
    scores and the four losses."""
    import dataclasses

    import numpy as np
    import torch
    from sct_gan_tpu_torch.config import multiclass_tasc_config
    from sct_gan_tpu_torch.data import (TASCDataLoader, TASCDataset,
                                        tasc_records_from_corpus)
    from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
    from sct_gan_tpu_torch.variants import (SmartContractVulnerabilityGAN,
                                            VulnerabilityDetectionTrainer)
    cfg = dataclasses.replace(multiclass_tasc_config(**(overrides or {})),
                              dropout=0.0)
    tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
    ds = TASCDataset(tasc_records_from_corpus(n=2, seed=2, multiclass=True),
                     tok, max_length=cfg.max_length, multiclass=True)
    batch = next(iter(TASCDataLoader(ds, batch_size=2)))
    card = VulnerabilityDetectionTrainer(
        SmartContractVulnerabilityGAN(cfg), _Empty(), _Empty(),
        tokenizer=tok, verbose=False, device=device)
    cpu_model = SmartContractVulnerabilityGAN(
        dataclasses.replace(cfg, compute_dtype="float32"), seed=None)
    cpu_model.load_state_dict(card.model.state_dict())
    cpu = VulnerabilityDetectionTrainer(
        cpu_model, _Empty(), _Empty(), tokenizer=tok, verbose=False,
        device="cpu", codebert_params=card.codebert.state_dict())

    def run(tr):
        ids = np.asarray(batch["input_ids"])
        ce = tr._embed(ids, batch["attention_mask"])
        pe = tr._embed(batch["path_input_ids"], batch["path_attention_mask"])
        with torch.no_grad():
            det = tr.model.detect_vulnerabilities(ce)
        scores = {"types": det["vulnerability_scores"],
                  **det["pattern_scores"]}
        labels, vuln, pattern = tr._batch_labels(batch, ids)
        m = tr._train_step(ce, pe, tr._t(ids), labels, vuln, pattern)
        return (ce.float().cpu(), {k: v.float().cpu() for k, v in
                                   scores.items()},
                {k: float(v) for k, v in m.items()})
    t0 = time.perf_counter()
    got = run(card)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = run(cpu)
    cpu_s = time.perf_counter() - t0
    embed_err, embed_rel = max_err(got[0], want[0]), rel_err(got[0], want[0])
    score_err = max(max_err(got[1][k], want[1][k]) for k in want[1])
    rel = {k: abs(got[2][k] - want[2][k]) / abs(want[2][k]) for k in want[2]}
    print(f"phase tasc card vs cpu: multiclass step at B=2 L="
          f"{cfg.max_length}, dropout 0 (card {card_s:.1f} s, CPU f32 "
          f"{cpu_s:.1f} s): CodeBERT embedding (f32 on both) max_abs_err "
          f"{embed_err:.3e}, rel_err {embed_rel:.3e} (tol "
          f"{TASC_EMBED_TOL}); detection scores "
          f"max_abs_err {score_err:.3e} (tol {TASC_SCORE_TOL}); losses card "
          f"{got[2]} cpu {want[2]}, rel "
          f"{ {k: float('%.3e' % v) for k, v in rel.items()} } (tol "
          f"{TASC_LOSS_RTOL})", flush=True)
    if not (embed_rel <= TASC_EMBED_TOL and score_err <= TASC_SCORE_TOL
            and all(v <= TASC_LOSS_RTOL for v in rel.values())):
        raise AssertionError("tasc: the card disagrees with the CPU")
    del card, cpu
    torch.cuda.empty_cache()


def _model_v3_step(overrides=None, device="cuda") -> dict:
    """One ``build_variant("model-v3")`` train step on the JAX bench's
    batch (B=8, L=1024): ``use_gan=False``, so one flash call fewer a
    forward than sct-gan (no discriminator). Returns its launches."""
    import torch
    from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
    from sct_gan_tpu_torch.variants import build_trainer, build_variant
    model, cfg = build_variant("model-v3", overrides)
    mc = cfg.model
    tok = SolidityTokenizer(vocab_size=mc.vocab_size)
    trainer = build_trainer("model-v3", model, cfg, _Empty(), _Empty(), tok,
                            verbose=False, device=device)
    batch = trainer.to_device(make_batch(8, mc.max_length, mc.vocab_size))
    reset_counts()
    t0 = time.perf_counter()
    trainer.state, metrics, _ = trainer.train_step(
        trainer.state, batch, trainer._scalars(1.0), trainer._group_lrs(),
        trainer.generator)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    loss = float(metrics["total_loss"])
    n = flash_per_forward(mc) - 1
    print(f"phase tasc model-v3: one train step at B=8 L={mc.max_length} "
          f"(use_gan {mc.use_gan}, augmentation "
          f"{cfg.train.use_augmentation}) in {secs:.2f} s (first call), "
          f"launches {counts}, total_loss {loss:.4f}", flush=True)
    if (mc.use_gan or counts["flash_attention_fwd"] != n
            or counts["flash_attention_bwd"] != n or counts["dropout"] == 0
            or counts["decode_attention"] != 0 or not math.isfinite(loss)):
        raise AssertionError(f"model-v3: launches {counts} (expected {n} "
                             f"flash calls each way), loss {loss}")
    del trainer, model
    torch.cuda.empty_cache()
    return counts


def tasc_kernel_checks(errs: dict) -> None:
    """K1, the pair and K5 against their plain versions at the shapes the
    TASC path gives them: CodeBERT's (4, 12, 512, 64) under the key mask of
    padded tails, the encoder's (4, 8, 512, 96) with dropout 0.1 and no
    mask, the decoder's causal (4, 8, 512, 96) forward and backward, and
    generation's cross attention against a one-key memory, no mask."""
    import torch
    from sct_gan_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    def qkv(h, d, grad=False):
        return [_heads(rnd(4, 512, h * d, scale=2.0 if i == 0 else 1.0),
                       h).requires_grad_(grad) for i in range(3)]

    lens = torch.tensor([512, 204, 143, 77], device=dev)
    mask = torch.arange(512, device=dev)[None, :] < lens[:, None]
    for kernel, label, h, d, m, causal, rate in (
            ("flash_attention_fwd_dh64", "12 heads of 64, key mask", 12, 64,
             mask, False, 0.0),
            ("flash_attention_fwd", "TASC encoder, dropout 0.1", 8, 96, None,
             False, 0.1),
            ("flash_attention_fwd", "TASC decoder self, causal", 8, 96, None,
             True, 0.0)):
        q, k, v = qkv(h, d)
        args = dict(key_padding_mask=m, causal=causal, sm_scale=d ** -0.5,
                    dropout_rate=rate, seed=77)
        got = flash_attention(q, k, v, **args)
        want = flash_attention_reference(q, k, v, **args)
        torch.cuda.synchronize()
        check_close(errs, kernel, label, got, want, kernel_tol(want),
                    f" q{tuple(q.shape)}")
    q, k, v = qkv(8, 96, grad=True)
    dout = _heads(rnd(4, 512, 768))
    args = dict(causal=True, sm_scale=96 ** -0.5)
    got = torch.autograd.grad(flash_attention(q, k, v, **args), (q, k, v),
                              dout)
    want = torch.autograd.grad(flash_attention_reference(q, k, v, **args),
                               (q, k, v), dout)
    torch.cuda.synchronize()
    for nm, gt, wt in zip(("dq", "dk", "dv"), got, want):
        check_close(errs, "flash_attention_bwd", "TASC decoder self, causal",
                    gt, wt, kernel_tol(wt, 4), f" {nm} q{tuple(q.shape)}")
    q, k, v = (_heads(rnd(2, 1, 768, scale=2.0 if i == 0 else 1.0))
               for i in range(3))
    got = decode_attention(q, k, v, None, sm_scale=96 ** -0.5)
    want = decode_attention_reference(q, k, v, None, sm_scale=96 ** -0.5)
    torch.cuda.synchronize()
    check_close(errs, "decode_attention", "TASC generation cross, one key",
                got, want, kernel_tol(want), f" q{tuple(q.shape)} "
                f"k{tuple(k.shape)}")


def phase_tasc(card: str, overrides=None, v3_overrides=None,
               device="cuda"):
    """The TASC variants at ``TASCConfig()`` width (binary and multiclass,
    each through ``_tasc_variant``), the card against the CPU, and the
    Model-v3 step. Returns the launches by instance name."""
    launches = {}
    for name in ("binary-tasc", "multiclass-tasc"):
        for k, v in _tasc_variant(name, card, overrides, device).items():
            launches[k] = launches.get(k, 0) + v
    _tasc_cpu_check(overrides, device)
    for k, v in _model_v3_step(v3_overrides, device).items():
        launches[k] += v
    print(f"phase tasc: launches over the TASC paths and the Model-v3 step "
          f"{launches}", flush=True)
    return launches


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


def phase_train_check(trainer, loss_rtol: float = LOSS_RTOL,
                      gnorm_rtol: float = GNORM_RTOL):
    """Same weights, dropout off, B=2: the card (the trainer's compute
    dtype, kernels) against the CPU (f32, plain versions) on the loss and
    the gradient norms, within ``loss_rtol`` and ``gnorm_rtol``."""
    import torch
    from sct_gan_tpu_torch import SmartContractTransformer
    from sct_gan_tpu_torch.config import ModelConfig

    model = trainer.model
    host = make_batch(2, model.config.max_length, model.config.vocab_size)
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
    print(f"phase train cross-check: B=2, dropout off, card "
          f"{model.config.compute_dtype} vs CPU f32 "
          f"({time.perf_counter() - t0:.1f} s on the CPU): total loss "
          f"{card[0]:.5f} vs {cpu[0]:.5f} (rel {rel[0]:.2e}, tol {loss_rtol}); "
          f"grad norm {card[1]:.4f} vs {cpu[1]:.4f} (rel {rel[1]:.2e}); "
          f"q/k/v grad norm {card[2]:.5f} vs {cpu[2]:.5f} (rel {rel[2]:.2e}, "
          f"tol {gnorm_rtol})", flush=True)
    if not (rel[0] <= loss_rtol and rel[1] <= gnorm_rtol
            and rel[2] <= gnorm_rtol):
        raise AssertionError("train cross-check: card and CPU disagree")


# -- parallel: meshes of ranks (sct_gan_tpu_torch/parallel) -----------------

# two-rank results against one rank's. The dp=2 step splits only the batch
# rows: each rank's products are the one-rank products of its rows, and the
# sums over the global batch change their order only (2e-7 on the loss, 8e-6
# on the grad norm, H100): 1e-4 both, twelve times the larger reading.
# mp=2 and sp=2 split the products themselves and round them in bf16
# otherwise (1.4e-3 on mp=2's grad norm): the train check's bars, 1e-2 on
# the loss and 5e-2 on gradient norms. The sequence-
# parallel memory: each rank's projections run at half the rows, so cuBLAS
# may pick other tilings and round bf16 otherwise; through 6+2 layers of
# bf16 activations that moves the memory by ~1e-2 norm-wise: 2e-2.
SP_REL_TOL = 2e-2
DP_RTOL = 1e-4
SP_SEQ, SP_GRAD_SEQ = 16384, 8192   # sp_detect's and sp_encode's gradient's


def _sp_batch(cfg, s: int, seed: int = 0) -> dict:
    """Two (s,)-token contracts of random ids, row 1 ragged (its last 3/16
    of keys padded), lines of 16 tokens up to the configuration's line
    slots."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mask = np.ones((2, s), np.int64)
    mask[1, s - 3 * s // 16:] = 0
    lines = np.minimum(np.arange(s) // 16, cfg.max_lines - 1)
    return {"input_ids": rng.integers(4, cfg.vocab_size, (2, s)),
            "attention_mask": mask,
            "ast_input_ids": rng.integers(4, cfg.vocab_size, (2, s)),
            "ast_attention_mask": np.ones((2, s), np.int64),
            "token_to_line": np.tile(lines, (2, 1))}


def parallel_kernel_checks(errs: dict) -> dict:
    """K1, the pair and K6 against their plain versions at the shapes and
    index origins the meshes give them: a shard of rows [4, 8) and heads
    [4, 8) of a (8, 8, 1024, 96) dropout grid (the dp x mp train step); the
    FFN hidden's dropout on batch rows [4, 8) and columns [1024, 2048) of
    (8, 1024, 2048); K1 at sp_detect's (2, 8, 16384, 96) under a ragged key
    mask (the first 256 query rows against the plain version) and the pair
    at the sp_encode gradient's (2, 8, 8192, 96). Returns the long-key
    timings for the kernels line."""
    import torch
    from sct_gan_tpu_torch.ops.dropout import dropout, dropout_reference
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    sc = 96 ** -0.5
    lens = torch.tensor([1024, 700, 300, 1000], device=dev)
    mask = torch.arange(1024, device=dev)[None, :] < lens[:, None]
    shard = (4, 4, 8)
    q = _heads(rnd(4, 1024, 384, scale=2.0), 4).requires_grad_()
    k = _heads(rnd(4, 1024, 384), 4).requires_grad_()
    v = _heads(rnd(4, 1024, 384), 4).requires_grad_()
    dout = _heads(rnd(4, 1024, 384), 4)
    args = dict(key_padding_mask=mask, sm_scale=sc, dropout_rate=0.3,
                seed=321, drop_shard=shard)
    got = flash_attention(q, k, v, **args)
    want = flash_attention_reference(q, k, v, **args)
    torch.cuda.synchronize()
    check_close(errs, "flash_attention_fwd", "dp x mp shard (b0 4, h0 4 of "
                "8), dropout 0.3", got, want, kernel_tol(want),
                f" q{tuple(q.shape)}")
    gots = torch.autograd.grad(got, (q, k, v), dout)
    wants = torch.autograd.grad(want, (q, k, v), dout)
    torch.cuda.synchronize()
    for nm, gt, wt in zip(("dq", "dk", "dv"), gots, wants):
        check_close(errs, "flash_attention_bwd", "dp x mp shard, dropout 0.3",
                    gt, wt, kernel_tol(wt, 4), f" {nm} q{tuple(q.shape)}")
    x = rnd(4, 1024, 1024).requires_grad_()
    origin = 4 * 1024 * 2048 + 1024
    got = dropout(x, 0.3, 4321, origin, 2048)
    want = dropout_reference(x.detach(), 4321, 0.3, origin, 2048)
    gy = rnd(4, 1024, 1024)
    (gx,) = torch.autograd.grad(got, x, gy)
    torch.cuda.synchronize()
    check_close(errs, "dropout", "FFN hidden shard (rows 4-8, columns "
                "1024-2048 of 2048)", got, want, 0.0)
    check_close(errs, "dropout", "FFN hidden shard, backward", gx,
                dropout_reference(gy, 4321, 0.3, origin, 2048), 0.0)
    del q, k, v, dout, gots, wants, x, gx, gy

    # K1 at sp_detect's shape: every query row against 16384 keys
    s = SP_SEQ
    keys = torch.arange(s, device=dev)[None, :] < torch.tensor(
        [s, s - 3000], device=dev)[:, None]
    q, k, v = (_heads(rnd(2, s, 768, scale=2.0 if i == 0 else 1.0))
               for i in range(3))
    got = flash_attention(q, k, v, key_padding_mask=keys, sm_scale=sc)
    want = flash_attention_reference(q[:, :, :256], k, v,
                                     key_padding_mask=keys, sm_scale=sc)
    torch.cuda.synchronize()
    check_close(errs, "flash_attention_fwd", f"sp_detect's Sk={s}, ragged "
                "key mask (query rows 0-255)", got[:, :, :256], want,
                kernel_tol(want), f" q{tuple(q.shape)}")
    fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, key_padding_mask=keys,
                                             sm_scale=sc), iters=5)
    attended = int(keys.sum())
    fwd_flops = 4 * 8 * s * attended * 96
    fwd = {"shape": [2, 8, s, 96], "ms": fwd_ms,
           "plain_ms": "not measured (the plain version's (2, 8, 16384, "
                       "16384) f32 scores take 17 GB)",
           "library_ms": ring_ms(lambda _: torch.nn.functional.
                                 scaled_dot_product_attention(
                                     q, k, v, attn_mask=keys[:, None, None, :],
                                     scale=sc), [None], 5),
           "tflops": fwd_flops / fwd_ms / 1e9}
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(
        fwd_flops, 2 * 2 * 8 * s * 96 * 2 + 2 * 8 * attended * 96 * 2 * 2)
    del q, k, v, got, want

    # the pair at the sp_encode gradient's shape: K3/K4's role (Sk > 1024)
    s = SP_GRAD_SEQ
    keys = torch.arange(s, device=dev)[None, :] < torch.tensor(
        [s, s - 3000], device=dev)[:, None]
    q, k, v = (_heads(rnd(2, s, 768, scale=2.0 if i == 0 else 1.0)
                      ).requires_grad_() for i in range(3))
    dout = _heads(rnd(2, s, 768))
    out, lse = flash_attention(q, k, v, key_padding_mask=keys, sm_scale=sc,
                               return_lse=True)
    out = out.detach()
    gots = flash_attention_backward(q, k, v, out, lse, dout, keys, False, sc,
                                    0.0, 0)
    ref = flash_attention_reference(q, k, v, key_padding_mask=keys,
                                    sm_scale=sc)
    wants = torch.autograd.grad(ref, (q, k, v), dout, retain_graph=True)
    torch.cuda.synchronize()
    for nm, gt, wt in zip(("dq", "dk", "dv"), gots, wants):
        check_close(errs, "flash_attention_bwd", f"sp_encode's Sk={s}, ragged "
                    "key mask", gt, wt, kernel_tol(wt, 4),
                    f" {nm} q{tuple(q.shape)}")
    attended = int(keys.sum())
    bwd_flops = 10 * 8 * s * attended * 96
    qkv_bytes = 2 * 8 * s * 96 * 2
    bwd = {"shape": [2, 8, s, 96],
           "ms": cuda_ms(lambda: flash_attention_backward(
               q, k, v, out, lse, dout, keys, False, sc, 0.0, 0), iters=5),
           "plain_ms": cuda_ms(lambda: torch.autograd.grad(
               ref, (q, k, v), dout, retain_graph=True), iters=2, warmup=1),
           "library_ms": sdpa_backward_ms(q, k, v, keys, dout, sc)}
    bwd["tflops"] = bwd_flops / bwd["ms"] / 1e9
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(
        bwd_flops, 6 * qkv_bytes + 2 * 8 * attended * 96 * 2
        + 2 * 8 * s * 4 + 2 * s)
    del q, k, v, dout, out, lse, gots, ref, wants
    torch.cuda.empty_cache()
    for name, t in (("flash_attention_fwd", fwd), ("flash_attention_bwd",
                                                   bwd)):
        print(f"  parallel kernel times: {name} at {tuple(t['shape'])} "
              f"{t['ms']:.3f} ms ({t['tflops']:.1f} TFLOP/s of the attended "
              f"keys' products), library {t['library_ms']:.3f} ms, bound "
              f"{t['bound_ms']:.3f} ms ({t['bound_by']})", flush=True)
    return {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd}


def _events_ms(fn, device: str = "cuda"):
    """(fn(), its ms by CUDA events (the host clock on the CPU), the ms of
    its collectives, each bracketed by synchronisations when
    ``stats.timed``, and their count)."""
    import torch
    from sct_gan_tpu_torch.parallel.collectives import stats
    stats.reset()
    if device == "cpu":
        t0 = time.perf_counter()
        out = fn()
        return (out, (time.perf_counter() - t0) * 1e3, stats.seconds * 1e3,
                stats.calls)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), stats.seconds * 1e3, stats.calls


def _sp_grad_run(model, batch, mesh):
    """sp_encode at SP_GRAD_SEQ and the gradient of mean(memory²); the
    ranks' gradients summed over the sequence axis. Returns (the whole
    memory, the loss, grad norms by parameter name)."""
    import torch
    from sct_gan_tpu_torch.parallel import sp_encode
    from sct_gan_tpu_torch.parallel.collectives import all_reduce_
    from sct_gan_tpu_torch.parallel.sequence import _whole_memory
    sp = mesh.axis("sp")
    mem = sp_encode(model, batch["input_ids"], batch["attention_mask"],
                    batch["ast_input_ids"], batch["ast_attention_mask"], mesh)
    n = mem.numel() * sp.size
    loss = (mem.float() ** 2).sum() / n
    named = [(k, p) for k, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    norms = {}
    for (k, _), gr in zip(named, grads):
        if gr is not None:
            norms[k] = all_reduce_(gr, sp).float().norm().item()
    total = all_reduce_(loss.detach().clone(), sp).item()
    return _whole_memory(mem.detach(), mesh, "sp"), total, norms


def _parallel_cfg(overrides=None):
    from sct_gan_tpu_torch.config import ModelConfig, TrainConfig
    return (ModelConfig(**{"use_gan": True, "max_length": 1024,
                           "max_lines": 1024, **(overrides or {})}),
            TrainConfig(learning_rate=1e-5, use_gan=True, warmup_epochs=1))


def phase_parallel(card: str, overrides=None, device: str = "cuda") -> dict:
    """The parallel paths at full width (d=768, 8 heads of 96, 6+6 layers,
    FFN 2048, vocab 50265 padded to 50304, bf16 over f32 parameters,
    dropout 0.3; random weights from seed 0, built here and handed to every
    rank as a state dict).

    NCCL, a world of one: the 1 x 1 mesh's train step (B=8, L=1024), its
    ``train_epoch`` over 12 contracts (through ``prefetch_to_device``) and
    ``analyze_multiple_contracts`` of 8 contracts, each bit for bit the
    mesh=None run; ``sp_detect`` at S=16384, B=2 with a ragged key mask
    against the unsharded encode and heads at that length; the gradient of
    ``sp_encode`` at S=8192. Gloo, two ranks sharing the card
    (``--parallel-rank``): ``sp_encode`` and its gradient at S=8192 at
    sp=2, and one train step at dp=2 and at mp=2 (B=8), each against the
    world of one. Returns the kernels' launches of the world of one's
    paths.

    It rehearses on the CPU: ``phase_parallel(card, tiny_overrides,
    device="cpu")`` runs every part on gloo CPU ranks at a tiny width and
    sequences of 16 and 8 times its ``max_length``; the CPU counts no
    kernel launch, so the launch checks run on the card only."""
    import tempfile

    import torch
    import torch.distributed as dist
    from sct_gan_tpu_torch import (SmartContractAnalyzer,
                                   SmartContractTrainer,
                                   SmartContractTransformer)
    from sct_gan_tpu_torch.data.synthetic import generate_corpus
    from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
    from sct_gan_tpu_torch.models.layers import sinusoidal_position_encoding
    from sct_gan_tpu_torch.parallel import (make_mesh, make_sp_mesh,
                                            shard_batch, sp_detect)
    from sct_gan_tpu_torch.parallel.collectives import SINGLE
    from sct_gan_tpu_torch.parallel.launch import run_world

    cfg, tcfg = _parallel_cfg(overrides)
    tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
    state = SmartContractTransformer(cfg, seed=0).state_dict()
    os.makedirs(os.path.join(ROOT, "profile_out"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="parallel_",
                            dir=os.path.join(ROOT, "profile_out"))
    with open(os.path.join(work, "setup.json"), "w") as f:
        json.dump({"overrides": overrides or {}, "device": device}, f)
    cuda = device == "cuda"
    sp_seq, sp_grad_seq = 16 * cfg.max_length, 8 * cfg.max_length
    if cuda:
        torch.cuda.empty_cache()

    def fresh():
        m = SmartContractTransformer(cfg, seed=None)
        m.load_state_dict(state)
        return m

    totals = dict.fromkeys(KERNELS, 0)
    refs, report = {}, {}

    def count(part, counts, want):
        for k, v in counts.items():
            totals[k] += v
        bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
        if bad and cuda:
            raise AssertionError(f"parallel {part}: launches {counts}, "
                                 f"expected {want}")

    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method="file://" + os.path.join(work, "rdv_nccl"),
        rank=0, world_size=1, timeout=__import__("datetime").timedelta(
            seconds=120))
    try:
        mesh = make_mesh(dp=1, mp=1, devices=[device])
        # -- a train step, mesh=None and 1 x 1 ------------------------------
        batch = make_batch(8, cfg.max_length, cfg.vocab_size)
        runs = {}
        for name in ("plain", "mesh"):
            tr = SmartContractTrainer(
                fresh(), _Empty(), _Empty(), tok, config=tcfg, verbose=False,
                device=device, mesh=mesh if name == "mesh" else None)
            dev_batch = (shard_batch(batch, mesh) if name == "mesh"
                         else tr.to_device(batch))
            reset_counts()
            (_, m, _), ms, coll_ms, calls = _events_ms(
                lambda: tr.train_step(tr.state, dev_batch, tr._scalars(1.0),
                                      tr._group_lrs(), tr.generator), device)
            runs[name] = ({k: float(v) for k, v in m.items()},
                          {k: p.detach().clone() for k, p in
                           tr.model.named_parameters()}, read_counts(), ms,
                          calls)
            del tr
        (pm, pp, pc, _, _), (mm, mp_, mc, ms, calls) = runs["plain"], runs[
            "mesh"]
        same = pm == mm and all(torch.equal(pp[k], mp_[k]) for k in pp)
        if not same or calls:
            raise AssertionError(f"parallel train step: the 1 x 1 mesh is not "
                                 f"the mesh=None step bit for bit ({same}) "
                                 f"or ran {calls} collectives")
        count("train step 1x1", mc, pc)
        refs["train"] = mm
        report["train_1x1"] = {"ms": ms, "launches": mc, "collective_ms": 0.0,
                               "total_loss": mm["total_loss"],
                               "grad_norm": mm["grad_norm"]}
        del runs, pp, mp_
        # -- train_epoch over 12 contracts (8 + 4 padded): mesh=None, and
        # 1 x 1 through prefetch_to_device's pinned copies on a side stream
        from sct_gan_tpu_torch.data.dataset import (
            ArrayDataLoader, SmartContractVulnerabilityDataset)
        epochs = {}
        for name in ("plain", "mesh"):
            loader = ArrayDataLoader(SmartContractVulnerabilityDataset(
                tokenizer=tok, max_length=cfg.max_length,
                records=generate_corpus(n=12, seed=0)), 8, shuffle=True)
            tr = SmartContractTrainer(
                fresh(), loader, _Empty(), tok, config=tcfg, verbose=False,
                device=device, mesh=mesh if name == "mesh" else None)
            reset_counts()
            out, ms, _, calls = _events_ms(lambda: tr.train_epoch(0), device)
            epochs[name] = ({k: v for k, v in out.items() if k not in (
                "tokens_per_sec", "step_time_ms")}, read_counts(), ms, calls)
            del tr
        if epochs["plain"][0] != epochs["mesh"][0] or epochs["mesh"][3]:
            raise AssertionError(f"parallel train_epoch: the 1 x 1 mesh gave "
                                 f"{epochs['mesh'][0]}, mesh=None "
                                 f"{epochs['plain'][0]}")
        count("train_epoch 1x1", epochs["mesh"][1], epochs["plain"][1])
        report["train_epoch_1x1"] = {"ms": epochs["mesh"][2],
                                     "launches": epochs["mesh"][1],
                                     "batches": epochs["mesh"][0]["batches"]}
        del epochs
        # -- analyze_multiple_contracts of 8 ---------------------------------
        codes = [r["source_code"] for r in generate_corpus(n=8, seed=3)]
        res = {}
        for name in ("plain", "mesh"):
            an = SmartContractAnalyzer(
                model_config=cfg, tokenizer=tok, params=state, verbose=False,
                device=device, mesh=mesh if name == "mesh" else None)
            reset_counts()
            out, ms, _, calls = _events_ms(
                lambda: an.analyze_multiple_contracts(codes), device)
            res[name] = (out, read_counts(), ms)
            del an
        if res["plain"][0] != res["mesh"][0]:
            raise AssertionError("parallel analyzer: the 1 x 1 mesh's results "
                                 "differ from mesh=None's")
        count("analyzer 1x1", res["mesh"][1], res["plain"][1])
        report["analyze_1x1"] = {"ms": res["mesh"][2],
                                 "launches": res["mesh"][1]}
        del res

        # -- sp_detect at S=16384, B=2 ---------------------------------------
        model = fresh().to(device).eval()
        sp_mesh = make_sp_mesh(sp=1, dp=1, devices=[device])
        b16 = _sp_batch(cfg, sp_seq)
        reset_counts()
        (c, l), ms, _, calls = _events_ms(
            lambda: sp_detect(model, b16, sp_mesh), device)
        detect_counts = read_counts()
        count("sp_detect", detect_counts, {
            "flash_attention_fwd": flash_per_detect(cfg),
            "flash_attention_bwd": 0, "dropout": 0, "decode_attention": 0})
        pe = sinusoidal_position_encoding(sp_seq, cfg.d_model).to(device)
        t = {k: torch.as_tensor(v).to(device) for k, v in b16.items()}
        with torch.no_grad(), model.sequence_parallel(SINGLE, pe):
            mem = model.encode(t["input_ids"], t["attention_mask"],
                               t["ast_input_ids"], t["ast_attention_mask"])
            c_ref, _ = model.contract_head(mem)
            l_ref = model.line_head(mem, t["token_to_line"])
        ok = (torch.equal(c, c_ref) and torch.equal(l, l_ref)
              and bool(torch.isfinite(c).all()) and bool(
                  torch.isfinite(l).all()))
        if not ok or c.shape != (2, 8) or l.shape != (2, cfg.max_lines, 8):
            raise AssertionError(f"parallel sp_detect: {tuple(c.shape)} "
                                 f"{tuple(l.shape)}, equal to the unsharded "
                                 f"encode and heads: {ok}")
        report[f"sp_detect_{sp_seq}"] = {"ms": ms, "launches": detect_counts}
        del mem, c_ref, l_ref, c, l, t
        # -- the gradient of sp_encode at S=8192 ------------------------------
        b8 = _sp_batch(cfg, sp_grad_seq, seed=1)
        reset_counts()
        (mem, loss, norms), ms, _, calls = _events_ms(
            lambda: _sp_grad_run(model, b8, sp_mesh), device)
        count("sp_encode gradient", read_counts(), {
            "flash_attention_fwd": cfg.num_encoder_layers + 2,
            "flash_attention_bwd": cfg.num_encoder_layers + 2,
            "dropout": 0, "decode_attention": 0})
        if not math.isfinite(loss) or not all(
                math.isfinite(x) for x in norms.values()):
            raise AssertionError("parallel sp_encode gradient: not finite")
        refs["sp"] = {"mem": mem.cpu(), "loss": loss, "norms": norms}
        report[f"sp_encode_grad_{sp_grad_seq}"] = {
            "ms": ms, "launches": read_counts(), "loss": loss}
        del model, mem
    finally:
        dist.destroy_process_group()
    if cuda:
        torch.cuda.empty_cache()

    # -- gloo: two ranks on the card -------------------------------------------
    torch.save(state, os.path.join(work, "state.pt"))
    torch.save(refs, os.path.join(work, "refs.pt"))
    t0 = time.perf_counter()
    outs = run_world([os.path.abspath(__file__), "--parallel-rank", work], 2,
                     os.path.join(work, "logs"), timeout_s=600)
    wall = time.perf_counter() - t0
    ranks = [json.loads(o.rsplit("PARALLEL_RESULT ", 1)[1].splitlines()[0])
             for o in outs]
    for r, res in enumerate(ranks):
        if not res["ok"]:
            raise AssertionError(f"parallel gloo rank {r}: {res}")
    report["gloo"] = ranks[0]["parts"]
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    for part, rec in report.items():
        print(f"phase parallel [{card}]: {part} "
              f"{json.dumps(rec, sort_keys=True)}", flush=True)
    print(f"phase parallel: two gloo ranks ran in {wall:.1f} s; launches of "
          f"the world-of-one paths {totals}", flush=True)
    return totals


def parallel_rank(work: str) -> int:
    """One rank of phase_parallel's gloo world (two ranks on one card):
    sp_encode and its gradient at sp=2, a dp=2 and an mp=2 train step;
    each against the world of one's results in ``work``. Prints
    ``PARALLEL_RESULT {json}``."""
    import torch
    import torch.distributed as dist
    from sct_gan_tpu_torch import SmartContractTrainer, SmartContractTransformer
    from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
    from sct_gan_tpu_torch.parallel import (make_mesh, make_sp_mesh,
                                            shard_batch)
    from sct_gan_tpu_torch.parallel.collectives import stats
    from sct_gan_tpu_torch.parallel.launch import init_rank

    rank = init_rank(os.path.join(work, "rdv_gloo"), "gloo", 300.0)
    with open(os.path.join(work, "setup.json")) as f:
        setup = json.load(f)
    device = setup["device"]
    cfg, tcfg = _parallel_cfg(setup["overrides"])
    tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
    state = torch.load(os.path.join(work, "state.pt"))
    refs = torch.load(os.path.join(work, "refs.pt"))
    devices = [device] * 2
    cuda = device == "cuda"
    parts, failures = {}, []

    def fresh():
        m = SmartContractTransformer(cfg, seed=None)
        m.load_state_dict(state)
        return m

    def close(what, got, want, rtol):
        if not abs(got - want) <= rtol * abs(want):
            failures.append(f"{what}: {got} vs one rank's {want} (rtol "
                            f"{rtol})")

    stats.timed = True
    # -- sp_encode and its gradient at sp=2 -----------------------------------
    mesh = make_sp_mesh(sp=2, devices=devices)
    model = fresh().to(device)
    sp_grad_seq = 8 * cfg.max_length
    b8 = _sp_batch(cfg, sp_grad_seq, seed=1)
    reset_counts()
    (mem, loss, norms), ms, coll_ms, calls = _events_ms(
        lambda: _sp_grad_run(model, b8, mesh), device)
    ref = refs["sp"]
    rel = rel_err(mem.cpu(), ref["mem"])
    if not rel <= SP_REL_TOL:
        failures.append(f"sp_encode memory rel_err {rel} > {SP_REL_TOL}")
    close("sp_encode loss", loss, ref["loss"], LOSS_RTOL)
    total = math.sqrt(sum(x * x for x in norms.values()))
    close("sp_encode grad norm", total, math.sqrt(sum(
        x * x for x in ref["norms"].values())), GNORM_RTOL)
    last = cfg.num_encoder_layers - 1
    for name in ("encoder.layer_0.self_attn.k_proj.weight",
                 f"encoder.layer_{last}.ffn.linear1.weight",
                 "embedding.weight", "cross_attention.v_proj.weight"):
        close(f"sp_encode grad norm {name}", norms[name], ref["norms"][name],
              GNORM_RTOL)
    parts[f"sp_encode_grad_{sp_grad_seq}_sp2"] = {
        "ms": ms, "collective_ms": coll_ms, "collectives": calls,
        "collective_share": coll_ms / ms, "launches": read_counts(),
        "memory_rel_err": rel, "loss": loss}
    del model, mem
    # -- dp=2 and mp=2 train steps at B=8 -----------------------------------
    batch = make_batch(8, cfg.max_length, cfg.vocab_size)
    for name, (dp, mp) in (("train_dp2", (2, 1)), ("train_mp2", (1, 2))):
        mesh = make_mesh(dp=dp, mp=mp, devices=devices)
        tr = SmartContractTrainer(fresh(), _Empty(), _Empty(), tok,
                                  config=tcfg, verbose=False, mesh=mesh)
        dev_batch = shard_batch(batch, mesh)
        reset_counts()
        (_, m, _), ms, coll_ms, calls = _events_ms(
            lambda: tr.train_step(tr.state, dev_batch, tr._scalars(1.0),
                                  tr._group_lrs(), tr.generator), device)
        m = {k: float(v) for k, v in m.items()}
        counts = read_counts()
        per_forward = flash_per_forward(cfg)
        if cuda and (counts["flash_attention_fwd"] != per_forward
                     or counts["flash_attention_bwd"] != per_forward
                     or counts["dropout"] == 0):
            failures.append(f"{name}: launches {counts}")
        close(f"{name} total_loss", m["total_loss"],
              refs["train"]["total_loss"], DP_RTOL if mp == 1 else LOSS_RTOL)
        close(f"{name} grad_norm", m["grad_norm"], refs["train"]["grad_norm"],
              DP_RTOL if mp == 1 else GNORM_RTOL)
        if m["skipped"] != 0.0:
            failures.append(f"{name}: the step was skipped")
        parts[name] = {"ms": ms, "collective_ms": coll_ms,
                       "collectives": calls, "collective_share": coll_ms / ms,
                       "launches": counts, "total_loss": m["total_loss"],
                       "grad_norm": m["grad_norm"]}
        del tr, dev_batch
    print("PARALLEL_RESULT " + json.dumps(
        {"rank": rank, "ok": not failures, "failures": failures,
         "parts": parts}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


# dryrun_multichip's world of two against its world of one: the bound of
# the dp losses in tests/test_torch_parallel_dp.py (f32 and bf16 alike:
# dropout masks keyed by the global row, the loss means taken globally)
DRYRUN_LOSS_RTOL = 2e-4


def _by_instance(counts: dict, head_dim: int) -> dict:
    """A model's launches by the kernels line's names: the bf16 flash
    kernels' at the instance its head dim takes (the f32 instances have
    one entry each)."""
    from sct_gan_tpu_torch.ops.flash_attention import kernel_route
    d = kernel_route(head_dim)[0]
    return {(instance(k, d) if k.startswith("flash") and k in BF16_KERNELS
             else k): v for k, v in counts.items()}


def _dryrun_expected(cfg):
    """(the launches of each leg of a dry-run rank at ``cfg`` with mp=1,
    the world of one's loss on the CPU in f32): the step's K1 and pair
    ``flash_per_forward`` times and K6 twice for each call of an active
    dropout site, counted by hooks on the same step run on the CPU; the sp
    encode's K1 once for each encoder, AST and cross attention."""
    import dataclasses
    from sct_gan_tpu_torch.entry import dryrun_trainer
    trainer, batch = dryrun_trainer(
        dataclasses.replace(cfg, compute_dtype="float32"), 1, device="cpu")
    calls = _dropout_calls(trainer.model)
    _, metrics, _ = trainer.train_step(
        trainer.state, trainer.to_device(batch), trainer._scalars(1.0),
        trainer._group_lrs(), trainer.generator)
    for h in calls[1]:
        h.remove()
    fwd = flash_per_forward(cfg)
    f32 = cfg.compute_dtype == "float32"
    return ({"step": launch_dict(fwd, fwd, 2 * calls[0], f32=f32),
             "sp_encode": launch_dict(cfg.num_encoder_layers + 2, f32=f32)},
            float(metrics["total_loss"]))


def phase_entry(card: str, cfg=None, device: str = "cuda") -> dict:
    """The driver entry points (``sct_gan_tpu_torch/entry.py``, the port of
    the root ``__graft_entry__.py``).

    ``entry()`` (``cfg=None``: the full-size ``ModelConfig(use_gan=True)``,
    B=2, L=1024): its ``fn`` once, counted: four finite outputs of the JAX
    file's shapes, K1 ``flash_per_forward(cfg)`` times (23) and no other
    kernel; the contract, line and discriminator probabilities within
    ``DETECT_TOL`` of the same ``fn`` on the CPU in f32, on the same
    weights and batch; then its ms over 5 more calls, by CUDA events and by
    the host clock. ``dryrun_multichip(1)`` (NCCL, a world of one) and
    ``dryrun_multichip(2)`` (two gloo ranks sharing the card), at the JAX
    file's tiny config in f32 (head dim 16, the f32 flash kernels' padded
    route to 64): each rank's launches in each leg held to
    ``_dryrun_expected``, the world of two's loss within
    ``DRYRUN_LOSS_RTOL`` of the world of one's, and that within
    ``LOSS_RTOL`` of the same step on the CPU in f32. Returns the launches
    by the kernels line's names.

    It rehearses on the CPU: ``phase_entry(card, tiny_cfg,
    device="cpu")``; the launch checks run on the card only."""
    import dataclasses

    import torch
    from sct_gan_tpu_torch.config import ModelConfig
    from sct_gan_tpu_torch.entry import dryrun_multichip, entry, tiny_config
    from sct_gan_tpu_torch.tools.bench import timed_ms
    cuda = device == "cuda"
    cfg = cfg or ModelConfig(use_gan=True)
    fn, (params, batch) = entry(cfg, device=device)
    reset_counts()
    out = fn(params, batch)
    if cuda:
        torch.cuda.synchronize()
    counts = read_counts()
    want = launch_dict(flash_per_forward(cfg),
                       f32=cfg.compute_dtype == "float32")
    if cuda and counts != want:
        raise AssertionError(f"entry: launches {counts}, expected {want}")
    # the root entry()'s outputs at B=2: contract logits, line logits, the
    # shifted LM logits, the discriminator's
    t = cfg.num_vulnerability_types
    want_shapes = [(2, t), (2, cfg.max_lines, t),
                   (2, cfg.max_length - 1, cfg.vocab_size), (2, 1)]
    shapes = [tuple(o.shape) for o in out]
    if shapes != want_shapes or not all(
            bool(torch.isfinite(o.float()).all()) for o in out):
        raise AssertionError(f"entry: outputs {shapes}, expected "
                             f"{want_shapes}, finite")
    calls = 5
    ev, host = timed_ms(lambda: [fn(params, batch) for _ in range(calls)],
                        torch.device(device))
    cpu_fn, _ = entry(dataclasses.replace(cfg, compute_dtype="float32"),
                      device="cpu")
    ref = cpu_fn({k: v.cpu() for k, v in params.items()},
                 {k: v.cpu() for k, v in batch.items()})
    diffs = {name: (torch.sigmoid(out[i].float().cpu())
                    - torch.sigmoid(ref[i].float())).abs().max().item()
             for i, name in ((0, "contract"), (1, "line"),
                             (3, "discriminator"))}
    if not all(d <= DETECT_TOL for d in diffs.values()):
        raise AssertionError(f"entry: card vs CPU probabilities {diffs} "
                             f"(tol {DETECT_TOL})")
    timing = ("" if ev is None else f"{ev / calls:.3f} ms by CUDA events, ")
    print(f"phase entry [{card}]: entry() forward at B=2, L="
          f"{cfg.max_length}: {timing}{host / calls:.3f} ms by the host "
          f"clock (mean of {calls} calls); launches {counts}; card vs CPU "
          f"f32 probabilities max diff {json.dumps(diffs)} (tol "
          f"{DETECT_TOL})", flush=True)
    totals = _by_instance(counts, cfg.d_model // cfg.nhead)
    del out, ref, cpu_fn, fn, params, batch
    if cuda:
        torch.cuda.empty_cache()

    tiny = tiny_config(device)
    legs, cpu_loss = _dryrun_expected(tiny)
    runs = {}
    for n in (1, 2):
        t0 = time.perf_counter()
        res = dryrun_multichip(n, device=device)
        secs = time.perf_counter() - t0
        for r, got in enumerate(res["launches"]):
            if cuda and got != legs:
                raise AssertionError(f"entry: dryrun_multichip({n}) rank {r} "
                                     f"launches {got}, expected {legs}")
            for leg in got.values():
                for k, v in _by_instance(leg, tiny.d_model // tiny.nhead
                                         ).items():
                    totals[k] = totals.get(k, 0) + v
        shape = [2, tiny.max_length, tiny.d_model]
        if (res["dp"], res["mp"], res["sp"]) != (n, 1, n) or res[
                "memory_shape"] != shape:
            raise AssertionError(f"entry: dryrun_multichip({n}) gave {res}")
        runs[n] = res
        print(f"phase entry [{card}]: dryrun_multichip({n}) in {secs:.1f} s, "
              f"loss {res['loss']!r}, launches per rank {res['launches']}",
              flush=True)
    one, two = runs[1]["loss"], runs[2]["loss"]
    if not abs(two - one) <= DRYRUN_LOSS_RTOL * abs(one):
        raise AssertionError(f"entry: dryrun_multichip(2) loss {two} vs the "
                             f"world of one's {one} (rtol "
                             f"{DRYRUN_LOSS_RTOL})")
    if not abs(one - cpu_loss) <= LOSS_RTOL * abs(cpu_loss):
        raise AssertionError(f"entry: dryrun_multichip(1) loss {one} vs the "
                             f"CPU's f32 {cpu_loss} (rtol {LOSS_RTOL})")
    print(f"phase entry: dry-run losses {one!r} (one rank), {two!r} (two), "
          f"CPU f32 {cpu_loss!r}; launches {totals}", flush=True)
    return totals


# -- the f32 paths (phase_f32) ------------------------------------------------
# The f32 kernels against their plain f32 versions on the card (full f32
# products: TF32 off, phase_device). The kernels run every product in
# 3xTF32 (~2^-22 relative each) and sum in another order, so they sit
# ~1e-6 from the plain versions norm-wise: the forward and K5 are held to
# 1e-5, the gradients (one more softmax, dS, and dK and dV summed over 1024
# queries) to 1e-4, both norm-wise. A wrong mask bit or a lost tile moves
# the norm by its share of the entries, 1e-3 and up. Dropout keep bits are
# compared exactly.
F32_FWD_TOL = 1e-5
F32_BWD_TOL = 1e-4
# card (f32, the f32 kernels, full f32 matmuls) vs CPU (f32, plain
# versions), same weights and inputs: only the order of sums differs, ~1e-6
# relative a layer. Detection probabilities 1e-4 absolute (sigmoids, slope
# <= 1/4); the cached decode step against teacher-forced logits on the
# card 1e-3 absolute (|logits| < 10); the train step's loss 1e-4 and its
# gradient norms 1e-3 relative (12 layers each way).
F32_DETECT_TOL = 1e-4
F32_DECODE_TOL = 1e-3
F32_LOSS_RTOL = 1e-4
F32_GNORM_RTOL = 1e-3
F32_TRAIN_STEPS = 3
# the smoke's key mask over (8, 1024): 5301 of 8192 keys attended
SMOKE_LENS = (1024, 900, 700, 512, 300, 1000, 64, 801)
CODEBERT_LENS = (512, 204, 143, 77)


def f32_keep_bits(b: int = 2, h: int = 8, s: int = 1024, rate: float = 0.3,
                  seed: int = 11) -> None:
    """The f32 K1's and the f32 pair's dropout keep bits, held exactly to
    the plain version's mask (``attention_keep``), at head dim 64 (the
    hash index does not depend on the head dim). q = 0 makes P uniform
    over the attended keys. Forward: a key mask of one 64-key window at a
    time and V = the 64 x 64 identity on it give O[i][c] = keep(i, 64 w +
    c) / 64 / (1 - rate) or 0. Backward at Sq = 64: dO = the identity gives
    dV[j][c] = keep(c, j) / Sk / (1 - rate) or 0."""
    import torch
    from sct_gan_tpu_torch.ops.attention import attention_keep
    from sct_gan_tpu_torch.ops.flash_attention import flash_attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    eye = torch.eye(64, device=dev)
    q = torch.zeros(b, h, s, 64, device=dev)
    k = torch.randn(b, h, s, 64, generator=g, device=dev)
    v = eye.repeat(s // 64, 1).expand(b, h, s, 64).contiguous()
    want = attention_keep((b, h, s, s), seed, rate, None, dev)
    got = torch.empty_like(want)
    for w in range(s // 64):
        mask = torch.zeros(b, s, dtype=torch.bool, device=dev)
        mask[:, 64 * w:64 * (w + 1)] = True
        out = flash_attention(q, k, v, key_padding_mask=mask, sm_scale=0.125,
                              dropout_rate=rate, seed=seed)
        got[..., 64 * w:64 * (w + 1)] = out > 0
    fwd_bad = int((got != want).sum())
    qg = torch.zeros(b, h, 64, 64, device=dev, requires_grad=True)
    kg = k.detach().requires_grad_()
    vg = torch.randn(b, h, s, 64, generator=g, device=dev).requires_grad_()
    dout = eye.expand(b, h, 64, 64).contiguous()
    out = flash_attention(qg, kg, vg, sm_scale=0.125, dropout_rate=rate,
                          seed=seed)
    dv = torch.autograd.grad(out, vg, dout)[0]
    want_b = attention_keep((b, h, 64, s), seed, rate, None, dev)
    bwd_bad = int(((dv.transpose(-1, -2) > 0) != want_b).sum())
    torch.cuda.synchronize()
    print(f"  f32 dropout keep bits, rate {rate}: K1 at ({b}, {h}, {s}, {s}) "
          f"{fwd_bad} of {want.numel()} differ; the pair's dV at ({b}, {h}, "
          f"64, {s}) {bwd_bad} of {want_b.numel()} differ", flush=True)
    if fwd_bad or bwd_bad:
        raise AssertionError("f32 dropout keep bits differ from the plain "
                             "version's")


def f32_kernel_checks(errs: dict) -> None:
    """The f32 K1, pair and K5 against their plain f32 versions at the f32
    paths' shapes: K1 at (8, 8, 1024, 96) under the smoke's key mask with
    dropout 0.3 and LSE, at CodeBERT's (4, 12, 512, 64) under its masks,
    causal (4, 8, 512, 96), at (8, 6, 1024, 128), at the dry run's head dim
    16 (padded to 64) and over whole masked key tiles (a row with no
    attended key gives zeros and lse = -1e30); the pair at (8, 8, 1024, 96)
    (key mask, dropout 0.3; causal), (4, 12, 512, 64) and (8, 6, 1024,
    128); K5 at (2, 8, 1024, 96) under a source mask with f32 and bf16
    queries (its output in the query's dtype), (64, 8, 1024, 96) every key,
    a self step over a cache cut to 513 keys, head dims 64, 128 and 80
    (padded); then the keep bits (``f32_keep_bits``)."""
    import torch
    from sct_gan_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    rf = lambda *shape: torch.randn(*shape, generator=g, device=dev)

    def lens_mask(lens, s):
        return (torch.arange(s, device=dev)[None, :]
                < torch.tensor(lens, device=dev)[:, None])

    smoke = lens_mask(SMOKE_LENS, 1024)
    for label, (b, h, s, d), mask, causal, rate in (
            ("smoke key mask, dropout 0.3", (8, 8, 1024, 96), smoke, False,
             0.3),
            ("CodeBERT key mask", (4, 12, 512, 64),
             lens_mask(CODEBERT_LENS, 512), False, 0.0),
            ("causal", (4, 8, 512, 96), None, True, 0.0),
            ("key mask, dropout 0.3", (8, 6, 1024, 128), smoke, False, 0.3),
            ("dry-run head dim 16, dropout 0.1", (8, 4, 128, 16), None, True,
             0.1),
            ("whole masked key tiles, dropout 0.3", (8, 8, 1024, 96),
             skip_mask(dev), False, 0.3)):
        q, k, v = (_heads(rf(b, s, h * d), h) for _ in range(3))
        args = dict(key_padding_mask=mask, causal=causal, sm_scale=d ** -0.5,
                    dropout_rate=rate, seed=7, return_lse=True)
        out, lse = flash_attention(q, k, v, **args)
        ref, ref_lse = flash_attention_reference(q, k, v, **args)
        torch.cuda.synchronize()
        what = f" q{tuple(q.shape)}"
        check_close(errs, "flash_attention_fwd_f32", label, out, ref,
                    math.inf, what, F32_FWD_TOL)
        live = ref_lse > -1e29       # rows that attend a key
        check_close(errs, "flash_attention_fwd_f32", label + " (lse)",
                    lse[live], ref_lse[live], math.inf, what, F32_FWD_TOL)
        if out.dtype != torch.float32:
            raise AssertionError(f"f32 K1 gave {out.dtype}")
        if label.startswith("whole") and (out[2].abs().max().item() != 0.0
                                          or not bool((lse[2] == -1e30)
                                                      .all())):
            raise AssertionError("f32 K1: the row with no attended key must "
                                 "give zeros and lse = -1e30")

    for label, (b, h, s, d), mask, causal, rate in (
            ("smoke key mask, dropout 0.3", (8, 8, 1024, 96), smoke, False,
             0.3),
            ("causal", (8, 8, 1024, 96), None, True, 0.0),
            ("CodeBERT key mask", (4, 12, 512, 64),
             lens_mask(CODEBERT_LENS, 512), False, 0.0),
            ("key mask, dropout 0.3", (8, 6, 1024, 128), smoke, False, 0.3)):
        q, k, v = (_heads(rf(b, s, h * d), h).requires_grad_()
                   for _ in range(3))
        dout = _heads(rf(b, s, h * d), h)
        args = dict(key_padding_mask=mask, causal=causal, sm_scale=d ** -0.5,
                    dropout_rate=rate, seed=9)
        got = torch.autograd.grad(flash_attention(q, k, v, **args),
                                  (q, k, v), dout)
        want = torch.autograd.grad(flash_attention_reference(q, k, v, **args),
                                   (q, k, v), dout)
        torch.cuda.synchronize()
        for nm, gt, wt in zip(("dq", "dk", "dv"), got, want):
            check_close(errs, "flash_attention_bwd_f32", label, gt, wt,
                        math.inf, f" {nm} q{tuple(q.shape)}", F32_BWD_TOL)

    for label, (b, h, s, d), qdt, mask, cut in (
            ("cross, source mask, f32 query", (2, 8, 1024, 96), torch.float32,
             lens_mask((1024, 900), 1024), None),
            ("cross, source mask, bf16 query", (2, 8, 1024, 96),
             torch.bfloat16, lens_mask((1024, 900), 1024), None),
            ("every key", (64, 8, 1024, 96), torch.float32, None, None),
            ("self step, bf16 query", (2, 8, 1024, 96), torch.bfloat16, None,
             513),
            ("12 heads of 64", (2, 12, 1024, 64), torch.float32, None, None),
            ("6 heads of 128", (2, 6, 1024, 128), torch.float32,
             lens_mask((1024, 900), 1024), None),
            ("head dim 80 (padded)", (2, 8, 300, 80), torch.float32, None,
             None)):
        q = _heads(rf(b, 1, h * d), h).to(qdt)
        k, v = (_heads(rf(b, s, h * d), h) for _ in range(2))
        if cut is not None:           # the cache view the decode step passes
            k, v = k[:, :, :cut], v[:, :, :cut]
        got = decode_attention(q, k, v, mask, sm_scale=d ** -0.5)
        want = decode_attention_reference(q, k, v, mask, sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        if got.dtype != qdt or want.dtype != qdt:
            raise AssertionError(f"f32 K5 gave {got.dtype} for a {qdt} query")
        # a bf16 output is held at the bf16 kernels' bound: both round the
        # same f32 value once
        tol = F32_FWD_TOL if qdt == torch.float32 else REL_TOL
        check_close(errs, "decode_attention_f32", label, got, want, math.inf,
                    f" q{tuple(q.shape)} k{tuple(k.shape)}", tol)
    f32_keep_bits()


def f32_times(card: str) -> dict:
    """The f32 kernels at the f32 paths' shapes against their plain
    versions, the library call (f32, TF32 off) and the bound at 3xTF32's
    165 TFLOP/s or the HBM rate: K1 and the pair at (8, 8, 1024, 96) under
    the smoke's key mask, K1 also at CodeBERT's (4, 12, 512, 64) under its
    masks; K5 at (2, 8, 1024, 96) under a source mask (1924 keys) and at
    (64, 8, 1024, 96) with every key. Kernels and library calls replayed
    from CUDA graphs over inputs twice the L2 (``ring_ms``). A bound counts
    the attended keys only. Returns name -> (ms, plain ms, library ms,
    bound ms, bound by), the CodeBERT row under ``<name>:codebert``, K5's
    B=64 row under ``<name>:b64``."""
    import torch
    import torch.nn.functional as F
    from sct_gan_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_reference)
    from sct_gan_tpu_torch.utils.profiling import PEAK_3XTF32_FLOPS
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rf = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    t = {}
    el = 4                               # bytes of an f32 element

    def bound(flops, nbytes):
        return bound_ms(flops, nbytes, PEAK_3XTF32_FLOPS)

    for label, (b, h, s, d), lens in (
            ("", (8, 8, 1024, 96), SMOKE_LENS),
            (":codebert", (4, 12, 512, 64), CODEBERT_LENS)):
        q, k, v = (_heads(rf(b, s, h * d), h) for _ in range(3))
        mask = (torch.arange(s, device=dev)[None, :]
                < torch.tensor(lens, device=dev)[:, None])
        sc, keys = d ** -0.5, sum(lens)
        qkv_bytes, kv_bytes = b * h * s * d * el, h * keys * d * el
        with torch.inference_mode():
            qkv = ring_inputs((q, k, v))
            t["flash_attention_fwd_f32" + label] = (
                ring_ms(lambda a: flash_attention(*a, key_padding_mask=mask,
                                                  sm_scale=sc), qkv, 20),
                cuda_ms(lambda: flash_attention_reference(
                    q, k, v, key_padding_mask=mask, sm_scale=sc), iters=5),
                ring_ms(lambda a: F.scaled_dot_product_attention(
                    *a, attn_mask=mask[:, None, None, :], scale=sc), qkv, 20),
                # Q read, O written; the attended K and V rows; the mask
                *bound(4 * h * s * keys * d,
                       2 * qkv_bytes + 2 * kv_bytes + b * s))
            del qkv
        if label:
            continue
        dout = _heads(rf(b, s, h * d), h)
        out, lse = flash_attention(q, k, v, key_padding_mask=mask,
                                   sm_scale=sc, return_lse=True)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        ref = flash_attention_reference(qg, kg, vg, key_padding_mask=mask,
                                        sm_scale=sc)
        t["flash_attention_bwd_f32"] = (
            ring_ms(lambda _: flash_attention_backward(
                q, k, v, out, lse, dout, mask, False, sc, 0.0, 0), [None], 10),
            cuda_ms(lambda: torch.autograd.grad(ref, (qg, kg, vg), dout,
                                                retain_graph=True), iters=5),
            sdpa_backward_ms(q, k, v, mask, dout, sc),
            # Q, O, dO read, dQ written; the attended K and V rows; dK, dV
            # written in full; lse; the mask
            *bound(10 * h * s * keys * d, 6 * qkv_bytes + 2 * kv_bytes
                   + b * h * s * el + b * s))
        del ref, qg, kg, vg, out, lse, dout

    for label, b, lens in (("", 2, (1024, 900)), (":b64", 64, None)):
        h, s, d = 8, 1024, 96
        q = _heads(rf(b, 1, h * d), h)
        k, v = (_heads(rf(b, s, h * d), h) for _ in range(2))
        mask = (None if lens is None else
                torch.arange(s, device=dev)[None, :]
                < torch.tensor(lens, device=dev)[:, None])
        keys = b * s if lens is None else sum(lens)
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        with torch.inference_mode():
            qkv = ring_inputs((q, k, v))
            t["decode_attention_f32" + label] = (
                ring_ms(lambda a: decode_attention(*a, mask,
                                                   sm_scale=d ** -0.5),
                        qkv, 20),
                cuda_ms(lambda: decode_attention_reference(
                    q, k, v, mask, sm_scale=d ** -0.5), iters=5),
                ring_ms(lambda a: F.scaled_dot_product_attention(
                    *a, attn_mask=sdpa_mask, scale=d ** -0.5), qkv, 20),
                # q read, o written; the attended keys' K and V rows; mask
                *bound(4 * h * keys * d, 2 * b * h * d * el
                       + 2 * h * keys * d * el + (0 if lens is None
                                                  else b * s)))
            del qkv
    for name, (ms, plain, lib, bnd, by) in t.items():
        print(f"phase f32 times [{card}]: {name} {ms:.4f} ms vs plain "
              f"{plain:.4f} ms, library (f32, TF32 off) {lib:.4f} ms, bound "
              f"{bnd:.4f} ms ({by})", flush=True)
    return t


def phase_f32(card: str, overrides=None, device: str = "cuda") -> tuple:
    """The f32 paths at the reference width (``compute_dtype="float32"``,
    d=768, 8 heads of 96, 6+6 layers, L=1024, random weights from seed 0):
    the f32 kernels against their plain versions (``f32_kernel_checks``),
    then, counted, ``F32_TRAIN_STEPS`` train steps on the JAX bench's batch
    (B=8, dropout 0.3, fused LM-head CE, fused optimizer; K1 and the pair
    23 a step, K6 as its dropout sites are called), the card's peak memory
    beside them, and the same step's loss and gradient norms against the
    CPU at B=2 with dropout off; an f32 detection batch of 8 (10 K1) held
    to the CPU on one contract; f32 generation of 2 contracts (12 f32 K5 a
    step, 8 in the encode) and 32 cached decode steps against
    teacher-forced logits. Then ``f32_times``. Returns (launches by the
    kernels line's names, worst errors by kernel, times).

    It rehearses on the CPU: ``phase_f32(card, tiny_overrides,
    device="cpu")`` runs the paths at ``overrides`` on the plain versions
    (no kernel checks, times or launch checks)."""
    import numpy as np
    import torch
    from sct_gan_tpu_torch import (SmartContractAnalyzer,
                                   SmartContractTrainer,
                                   SmartContractTransformer)
    from sct_gan_tpu_torch.config import ModelConfig, TrainConfig
    from sct_gan_tpu_torch.data.synthetic import generate_corpus
    from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    errs = {}
    if cuda:
        f32_kernel_checks(errs)
        print(f"phase f32: kernel checks in {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
    launches = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # -- train steps ----------------------------------------------------------
    cfg = ModelConfig(**{"use_gan": True, "max_length": 1024,
                         "max_lines": 1024, **(overrides or {}),
                         "compute_dtype": "float32"})
    tcfg = TrainConfig(learning_rate=1e-5, use_gan=True, warmup_epochs=1)
    tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
    model = SmartContractTransformer(cfg, seed=0)
    trainer = SmartContractTrainer(model, _Empty(), _Empty(), tok,
                                   config=tcfg, verbose=False, device=device)
    batch = trainer.to_device(make_batch(8, cfg.max_length, cfg.vocab_size))
    scalars, lrs = trainer._scalars(1.0), trainer._group_lrs()
    calls = _dropout_calls(model)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, losses = trainer.state, []
    t0 = time.perf_counter()
    for _ in range(F32_TRAIN_STEPS):
        state, metrics, scalars = trainer.train_step(
            state, batch, scalars, lrs, trainer.generator)
        losses.append(float(metrics["total_loss"]))
    sync()
    step_s = (time.perf_counter() - t0) / F32_TRAIN_STEPS
    counts = read_counts()
    for hnd in calls[1]:
        hnd.remove()
    trainer.state = state
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    n = F32_TRAIN_STEPS
    want = launch_dict(n * FLASH_PER_TRAIN_FORWARD,
                       n * FLASH_PER_TRAIN_FORWARD, 2 * calls[0], f32=True)
    print(f"phase f32 train: {n} steps at B=8 L={cfg.max_length} (dropout "
          f"{cfg.dropout}, fused_lm_ce {tcfg.fused_lm_ce}, fused_optimizer "
          f"{tcfg.fused_optimizer}), {step_s:.3f} s a step (the first "
          f"included); losses {losses}; launches {counts}; peak "
          f"torch.cuda.max_memory_allocated {peak:.2f} GiB", flush=True)
    if ((cuda and counts != want) or calls[0] % n or calls[0] == 0
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"f32 train: launches {counts}, expected "
                             f"{want}; losses {losses}")
    add(counts)
    phase_train_check(trainer, F32_LOSS_RTOL, F32_GNORM_RTOL)
    del trainer, model, state, batch
    if cuda:
        torch.cuda.empty_cache()

    # -- detection and generation ----------------------------------------------
    an = SmartContractAnalyzer(seed=0, verbose=False, model_config=cfg,
                               tokenizer=tok, device=device)
    codes = [r["source_code"] for r in generate_corpus(n=8, seed=0)]
    reset_counts()
    results = an.analyze_multiple_contracts(codes)
    sync()
    detect = read_counts()
    cp = np.asarray([r["contract_probabilities"][0] for r in results])
    if (cuda and detect != launch_dict(flash_per_detect(cfg), f32=True)) or \
            not (len(results) == 8 and np.isfinite(cp).all()):
        raise AssertionError(f"f32 detection: launches {detect}, probs {cp}")
    add(detect)
    card_r = an.detect_vulnerabilities(codes[1])
    cpu = SmartContractAnalyzer(device="cpu", seed=0, verbose=False,
                                tokenizer=an.tokenizer, model_config=cfg)
    ref = cpu.detect_vulnerabilities(codes[1])
    del cpu
    d_c = float(np.abs(np.asarray(card_r["contract_probabilities"])
                       - np.asarray(ref["contract_probabilities"])).max())
    d_l = float(np.abs(np.asarray(card_r["line_probabilities"])
                       - np.asarray(ref["line_probabilities"])).max())
    print(f"phase f32 detect: 8 contracts, launches {detect}; card f32 vs "
          f"CPU f32 on one contract: contract probs max diff {d_c:.3e}, "
          f"line probs {d_l:.3e} (tol {F32_DETECT_TOL})", flush=True)
    if not (d_c <= F32_DETECT_TOL and d_l <= F32_DETECT_TOL):
        raise AssertionError("f32 detection: card and CPU disagree")

    reset_counts()
    t0 = time.perf_counter()
    generated = an.generate_synthetic_contract(codes[0], num_contracts=2)
    sync()
    gen_s = time.perf_counter() - t0
    gen = read_counts()
    steps = an.last_decode_steps
    if (cuda and gen != launch_dict(cfg.num_encoder_layers + 2,
                                    decode=2 * cfg.num_decoder_layers * steps,
                                    f32=True)) or steps < 1 or \
            len(generated) != 2:
        raise AssertionError(f"f32 generation: launches {gen} for {steps} "
                             f"steps")
    add(gen)
    model = an.model
    with torch.inference_mode():
        b = an._prepare_inputs([codes[0]])
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
    if caches[0][0].dtype != torch.float32:
        raise AssertionError(f"f32 generation: caches {caches[0][0].dtype}")
    print(f"phase f32 generate: 2 contracts, {steps} decode steps in "
          f"{gen_s:.2f} s, launches {gen}; 32 cached decode steps vs "
          f"teacher-forced logits max |diff| {step_err:.3e} (tol "
          f"{F32_DECODE_TOL})", flush=True)
    if not step_err <= F32_DECODE_TOL:
        raise AssertionError("f32 decode_step disagrees with teacher forcing")
    del an, model, memory, caches, cross
    if not cuda:
        return launches, errs, {}
    torch.cuda.empty_cache()
    times = f32_times(card)
    return launches, errs, times


def decode_times(card: str, h: int = 8, d: int = 96) -> dict:
    """K5 at head dim ``d`` with ``h`` heads (its instance, in place on a
    wider one, or its wide-head route) at the generation path's shapes, each
    against its plain version, SDPA and its bound; prints a line each.
    Returns label -> (ms, plain ms, SDPA ms, bound ms, bound by); the first
    row is the kernels line's.

    * the cross-attention at B=2: head views of (2, 1024, h*d) under the
      source mask of lens (1024, 900), 1924 attended keys;
    * the JAX bench's decode batch, (64, h, 1024, d), every key attended:
      the cross layout under an all-True source mask;
    * at d = 96, a self-attention step: the contiguous (2, 8, 1024, 96)
      cache cut to 512 keys, no mask.

    The kernel and SDPA are replayed from CUDA graphs round inputs twice
    the L2 (``ring_ms``), so K and V come from HBM; the plain version is
    timed eagerly. A bound counts the attended keys' K and V rows, q read
    and o written, and the mask's bytes."""
    import torch
    import torch.nn.functional as F
    from sct_gan_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rb = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    sc, bf, width = d ** -0.5, 2, h * d
    rows = {}

    def row(label, q, k, v, mask, keep, n):
        """``keep`` cuts the cache to the live length inside the call."""
        b, s = q.shape[0], keep
        keys = int(mask.sum()) if mask is not None else b * s
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        ring = ring_inputs((q, k, v))
        cut = lambda a: (a[0], a[1][:, :, :s], a[2][:, :, :s])
        with torch.inference_mode():
            ms = ring_ms(lambda a: decode_attention(*cut(a), mask, sm_scale=sc),
                         ring, n)
            lib = ring_ms(lambda a: F.scaled_dot_product_attention(
                *cut(a), attn_mask=sdpa_mask, scale=sc), ring, n)
            plain = cuda_ms(lambda: decode_attention_reference(
                *cut((q, k, v)), mask, sm_scale=sc), iters=50)
        del ring
        bnd, by = bound_ms(4 * h * keys * d,
                           (2 * h * keys * d + 2 * b * h * d) * bf
                           + (0 if mask is None else b * s))
        rows[label] = (ms, plain, lib, bnd, by)
        print(f"phase times [{card}]: {err_key('decode_attention', d)} "
              f"{label}, {keys} attended (b, key) pairs: {ms:.4f} ms "
              f"({ms / bnd:.2f}x the bound) vs plain {plain:.4f} ms, library "
              f"{lib:.4f} ms, bound {bnd:.4f} ms ({by})", flush=True)

    lens = torch.tensor([1024, 900], device=dev)
    src = torch.arange(1024, device=dev)[None, :] < lens[:, None]
    row(f"cross (2, {h}, 1024, {d}), source mask lens (1024, 900)",
        _heads(rb(2, 1, width), h), _heads(rb(2, 1024, width), h),
        _heads(rb(2, 1024, width), h), src, 1024, 64)
    row(f"cross (64, {h}, 1024, {d}), every key attended",
        _heads(rb(64, 1, width), h), _heads(rb(64, 1024, width), h),
        _heads(rb(64, 1024, width), h),
        torch.ones(64, 1024, dtype=torch.bool, device=dev), 1024, 20)
    if d == 96:
        row("self (2, 8, 512 of a 1024-key cache, 96), no mask",
            _heads(rb(2, 1, 768)), rb(2, 8, 1024, 96), rb(2, 8, 1024, 96),
            None, 512, 64)
    return rows


def k1_library(cu: str, tag: str):
    """(library, ``ptxas -v`` report) of the K1 source ``cu`` alone, built
    as the main library is (``_build.build_library``), its
    ``flash_attention_fwd_bf16`` declared: another checkout's K1 (a parent
    commit's ``csrc/flash_attention_fwd.cu``, which includes its own
    headers, or a copy with a candidate change). Timed beside the port's
    K1, never called by the port."""
    import ctypes
    from sct_gan_tpu_torch.ops import _build
    path, report, _ = _build.build_library([cu], tag)
    lib = ctypes.CDLL(path)
    fn = lib.flash_attention_fwd_bf16
    fn.argtypes = _build._SIGNATURES["flash_attention_fwd_bf16"]
    fn.restype = ctypes.c_int
    return lib, report


def k1_call(lib, q, k, v, mask, scale: float):
    """One launch of ``lib``'s K1 (a ``k1_library``) as the port's wrapper
    makes it (``ops/flash_attention.py::_forward``: no dropout, no LSE, not
    causal); its output."""
    import ctypes
    import torch
    from sct_gan_tpu_torch.ops import _build
    from sct_gan_tpu_torch.ops import flash_attention as fa
    b, h, sq, sk, d = fa._check_shapes(q, k, v, 0.0)
    out = fa._heads_like(q, sq)
    mptr, msb, _keep = fa._mask_arg(mask, b, sk, q.device)
    err = lib.flash_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, out.data_ptr(), None,
        b, h, sq, sk, d, *fa._strides(q, "q", 16), *fa._strides(k, "k", 16),
        *fa._strides(v, "v", 16), *fa._strides(out, "out", 4), msb, 0,
        ctypes.c_float(scale), *fa._dropout_args(0.0, 0, None),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd_bf16 (timed beside K1)")
    return out


# K1's instances timed by ``k1_times``: head dim -> heads at d=768
K1_TIMED = {64: 12, 96: 8, 128: 6, 192: 4, 256: 3, 384: 2}


def k1_times(checkouts) -> int:
    """``python3 chip_smoke.py --k1-times <checkout> [<checkout> ...]``: K1
    of this tree against the K1 of each other checkout (a parent commit
    unpacked by ``git archive``, or a copy with a candidate change), named
    by its directory and built from its own sources, one ``nvcc`` each, all
    at once: in turns at every instance (``flash_times``) and at CodeBERT's
    shapes (``k1_codebert_times``), then the rate over rows of 1024 and
    4096 keys against the first checkout (``k1_row_lengths``). Needs the
    card; prints the lines and nothing else."""
    import concurrent.futures as cf
    phase_device()
    phase_build()
    card = card_line()
    names = [os.path.basename(os.path.normpath(c)) for c in checkouts]
    with cf.ThreadPoolExecutor(len(checkouts)) as pool:
        libs = list(pool.map(lambda c: k1_library(os.path.join(
            c, "sct_gan_tpu_torch", "csrc", "flash_attention_fwd.cu"),
            "k1_" + os.path.basename(os.path.normpath(c))), checkouts))
    for name, (_, report) in zip(names, libs):
        for entry, lines in main_path_reports(report):
            if "flash_fwd" in entry:
                print(f"  ptxas [{name}] {entry}: " + "; ".join(lines))
    others = dict(zip(names, libs))
    for d, h in K1_TIMED.items():
        flash_times(card, h, d, others=others)
    k1_codebert_times(card, others)
    k1_row_lengths(card, libs[0][0])
    print(card)
    return 0


# the tools' sources that ``--variants-times`` builds from each checkout,
# and their C entry points
VARIANT_SOURCES = {"flash_parts.cu": "flash_parts_bf16",
                   "flash_variants.cu": "flash_variants_bf16",
                   "decode_variants.cu": "decode_variants_bf16"}


def variants_library(checkout: str):
    """(library, ``ptxas -v`` report) of another checkout's K7, K8 and K9
    (its ``csrc/flash_parts.cu``, ``csrc/flash_variants.cu`` and
    ``csrc/decode_variants.cu``, each including its own headers), built as
    the main library is (``_build.build_library``), their C entry points
    declared. Timed beside the port's K7, K8 and K9, never called by the
    port."""
    import ctypes
    from sct_gan_tpu_torch.ops import _build
    csrc = os.path.join(checkout, "sct_gan_tpu_torch", "csrc")
    name = os.path.basename(os.path.normpath(checkout))
    path, report, _ = _build.build_library(
        [os.path.join(csrc, src) for src in VARIANT_SOURCES],
        "variants_" + name)
    lib = ctypes.CDLL(path)
    for fn in VARIANT_SOURCES.values():
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, report


def self_attention_call(lib, fn: str, tool, x, mode: str):
    """One launch of ``lib``'s K7 or K8 entry ``fn`` as ``tool``'s wrapper
    makes it (q = k = v = x, contiguous); its output."""
    import ctypes
    import torch
    from sct_gan_tpu_torch.ops import _build
    b, h, s, d = x.shape
    out = torch.empty_like(x)
    err = getattr(lib, fn)(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(), b * h, s,
        d, tool.MODES.index(mode), ctypes.c_float(tool.SCALE),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"{fn} (timed beside this tree's)")
    return out


def self_attention_turns(card: str, label: str, tool, fn: str, ours,
                         reference, x0, seqs, others) -> None:
    """Every mode of ``tool`` (K7 or K8) on ``x0`` against each of
    ``others`` (name -> library) in turns (other, tree, tree, other), each
    a chain replayed from a CUDA graph, after holding the other's output
    to this tree's plain version ``reference`` on random x at ``seqs``
    keys; a line a mode and other."""
    import torch
    from sct_gan_tpu_torch.utils.profiling import chain_ms
    g = torch.Generator(device=x0.device).manual_seed(3)
    xr = [(torch.randn(2, 8, sk, tool.DH, generator=g, device=x0.device)
           * 0.5).to(torch.bfloat16) for sk in seqs]
    for mode in tool.MODES:
        mine = lambda x, m=mode: ours(x, m)
        for name, lib in others.items():
            theirs = lambda x, m=mode, lb=lib: self_attention_call(
                lb, fn, tool, x, m)
            errs = []
            for x in xr:
                want = reference(x, mode)
                got = theirs(x)
                errs.append(f"{max_err(got, want):.2e} (tol "
                            f"{kernel_tol(want):.2e}, rel "
                            f"{rel_err(got, want):.1e})")
            o1, p1, p2, o2 = (chain_ms(f, x0, tool.CHAIN)
                              for f in (theirs, mine, mine, theirs))
            print(f"{label} {mode} {tuple(x0.shape)} [{card}]: {name} "
                  f"{o1:.4f} / {o2:.4f} ms -> tree {p1:.4f} / {p2:.4f} ms "
                  f"({name} max_abs_err at S = "
                  f"{', '.join(map(str, seqs))}: {', '.join(errs)})",
                  flush=True)


def k9_call(lib, q, k, v, mask, mode: str, scale: float):
    """One launch of ``lib``'s K9 v2 or v3 as the tool's wrapper makes it on
    contiguous (B, H, S, dh) inputs; its output."""
    import ctypes
    import torch
    from sct_gan_tpu_torch.ops import _build
    from sct_gan_tpu_torch.ops.flash_attention import _mask_arg
    b, h, s, d = k.shape
    out = torch.empty_like(q)
    ks, vs = k.stride()[:3], v.stride()[:3]
    if mode == "v3":                           # the (B, H*S, dh) slab's
        ks, vs = (ks[0], 0, d), (vs[0], 0, d)
    mptr, msb, _keep = _mask_arg(mask, b, s, q.device)
    err = lib.decode_variants_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, out.data_ptr(),
        2 if mode == "v2" else 3, b, h, s, d, q.stride(0), q.stride(1), *ks,
        *vs, out.stride(0), out.stride(1), msb, ctypes.c_float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_variants_bf16 (timed beside K9)")
    return out


def variants_times(checkouts) -> int:
    """``python3 chip_smoke.py --variants-times <checkout> [...]``: K7, K8
    and K9 of this tree against those of each other checkout (a parent
    commit unpacked by ``git archive``, or a copy with a candidate change),
    named by its directory and built from its own sources, one ``nvcc``
    each, all at once. At the tools' shapes, in turns (other, tree, tree,
    other), each a chain replayed from a CUDA graph (``chain_ms``): every
    mode of K7 and K8 at (8, 8, 1024, 96) on the tool's x = 0.01, with
    K1, SDPA and ``bmm`` in the same call, and K9's v2 and v3 at (32, 8,
    1024, 96) under the tool's mask, with K5 (v1) and SDPA. Each other
    checkout's output is first held to this tree's plain version. Needs
    the card; prints the lines and nothing else."""
    import concurrent.futures as cf
    import torch
    import torch.nn.functional as F
    from sct_gan_tpu_torch.ops import _build
    from sct_gan_tpu_torch.ops.flash_attention import flash_attention
    from sct_gan_tpu_torch.tools import time_decode_kernel_variants as k9
    from sct_gan_tpu_torch.tools import time_flash_parts as k7
    from sct_gan_tpu_torch.tools import time_flash_variants as k8
    from sct_gan_tpu_torch.tools._common import self_attention_library
    from sct_gan_tpu_torch.utils.profiling import chain_ms
    phase_device()
    phase_build()
    card = card_line()
    names = [os.path.basename(os.path.normpath(c)) for c in checkouts]
    with cf.ThreadPoolExecutor(len(checkouts)) as pool:
        libs = list(pool.map(variants_library, checkouts))
    for name, (_, report) in zip(names, libs):
        for entry, lines in main_path_reports(report):
            print(f"  ptxas [{name}] {entry}: " + "; ".join(lines))
    for entry, lines in main_path_reports(_build.ptxas_log):
        if any(k in entry for k in ("parts", "variants", "perbatch")):
            print(f"  ptxas [tree] {entry}: " + "; ".join(lines))
    dev = torch.device("cuda")
    steps = 256
    with torch.inference_mode():
        b, h, s = k7.SHAPE
        x0 = torch.full((b, h, s, k7.DH), 0.01, dtype=torch.bfloat16,
                        device=dev)
        k1_ms = chain_ms(lambda x: flash_attention(x, x, x,
                                                   sm_scale=k7.SCALE),
                         x0, k7.CHAIN)
        k7_lib = {kind: chain_ms(self_attention_library(kind, k7.SCALE), x0,
                                 k7.CHAIN)
                  for kind in sorted(set(k7.LIBRARY.values()))}
        print(f"K7 (8, 8, 1024, 96) [{card}]: k1 {k1_ms:.4f} ms, library "
              + ", ".join(f"{kind} {ms:.4f} ms" for kind, ms in k7_lib.items()),
              flush=True)
        others = {name: lib for name, (lib, _) in zip(names, libs)}
        self_attention_turns(card, "K7", k7, "flash_parts_bf16",
                             k7.flash_parts, k7.flash_parts_reference, x0,
                             (256, 1024), others)
        b, h, s = k8.SHAPE
        x0 = torch.full((b, h, s, k8.DH), 0.01, dtype=torch.bfloat16,
                        device=dev)
        for kind in sorted(set(k8.LIBRARY.values())):
            lib_ms = chain_ms(self_attention_library(kind, k8.SCALE), x0,
                              k8.CHAIN)
            print(f"K8 library {kind}: {lib_ms:.4f} ms", flush=True)
        self_attention_turns(card, "K8", k8, "flash_variants_bf16",
                             k8.flash_variants, k8.flash_variants_reference,
                             x0, (320, 1024), others)
        q, k, v, mask = k9.make_inputs(32, 8, 1024, 96, 0, dev)
        scale = 96 ** -0.5
        rows = int(mask.sum().item()) * 8
        nbytes = (2 * rows * 96 + 2 * q.numel()) * 2 + mask.numel()
        want = k9.decode_variants_reference(q, k, v, mask, sm_scale=scale)
        v1 = chain_ms(lambda x: x + k9.decode_variants(
            x, k, v, mask, "v1", sm_scale=scale) * 0, q, steps)
        sdpa = chain_ms(lambda x: x + F.scaled_dot_product_attention(
            x, k, v, attn_mask=mask[:, None, None, :], scale=scale) * 0,
            q, steps)
        print(f"K9 (32, 8, 1024, 96) [{card}]: v1 (K5) {v1:.4f} ms, SDPA "
              f"{sdpa:.4f} ms, bound {bound_ms(4 * rows * 96, nbytes)[0]:.4f}"
              f" ms ({nbytes / 1e6:.1f} MB)", flush=True)
        for mode in ("v2", "v3"):
            ours = lambda x, m=mode: x + k9.decode_variants(
                x, k, v, mask, m, sm_scale=scale) * 0
            for name, (lib, _) in zip(names, libs):
                theirs = lambda x, m=mode, lb=lib: x + k9_call(
                    lb, x, k, v, mask, m, scale) * 0
                err = max_err(k9_call(lib, q, k, v, mask, mode, scale), want)
                o1, p1, p2, o2 = (chain_ms(f, q, steps)
                                  for f in (theirs, ours, ours, theirs))
                print(f"K9 {mode} [{card}]: {name} {o1:.4f} / {o2:.4f} ms "
                      f"-> tree {p1:.4f} / {p2:.4f} ms; a batch row's block "
                      f"{k9.per_sm_gbs(nbytes, o1, 32):.1f} -> "
                      f"{k9.per_sm_gbs(nbytes, p1, 32):.1f} GB/s ({name} "
                      f"max_abs_err {err:.3e})", flush=True)
        for dh in (64, 128):                  # the tree's other instances
            q, k, v, mask = k9.make_inputs(32, 8, 1024, dh, 0, dev)
            rows = int(mask.sum().item()) * 8
            nbytes = (2 * rows * dh + 2 * q.numel()) * 2 + mask.numel()
            line = []
            for mode in ("v1", "v2", "v3"):
                ms = chain_ms(lambda x, m=mode: x + k9.decode_variants(
                    x, k, v, mask, m, sm_scale=dh ** -0.5) * 0, q, steps)
                line.append(f"{mode} {ms:.4f} ms "
                            f"({k9.per_sm_gbs(nbytes, ms, 32):.1f} GB/s)")
            print(f"K9 (32, 8, 1024, {dh}) [{card}]: " + ", ".join(line)
                  + f", bound {bound_ms(4 * rows * dh, nbytes)[0]:.4f} ms",
                  flush=True)
    print(card)
    return 0


def k1_codebert_masks(dev):
    """The key masks that CodeBERT's K1 gets on the TASC path, (4, 512)
    each: the first four training contracts' tokens and their path
    tokens, as ``_tasc_loaders`` makes them at ``TASCConfig()``."""
    import numpy as np
    import torch
    from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
    from sct_gan_tpu_torch.variants import build_variant
    _, cfg = build_variant("binary-tasc", None)
    train, _ = _tasc_loaders(SolidityTokenizer(vocab_size=cfg.vocab_size),
                             cfg)
    rows = [train.dataset[i] for i in range(4)]
    return {key: torch.as_tensor(np.stack(
        [np.asarray(r[key]) for r in rows]), device=dev).bool()
        for key in ("attention_mask", "path_attention_mask")}


def k1_codebert_times(card: str, others) -> None:
    """K1 at CodeBERT's (4, 12, 512, 64) under its two key masks on the
    TASC path (``k1_codebert_masks``: contracts of 105-229 tokens, paths of
    12-51) and with every key (a contract of 512 tokens or more), against
    each of ``others`` (name -> ``k1_library``) in turns (other, port,
    port, other), beside SDPA with the same mask and the bound over the
    attended keys; a line each."""
    import torch
    import torch.nn.functional as F
    from sct_gan_tpu_torch.ops.flash_attention import flash_attention
    dev = torch.device("cuda")
    b, h, s, d = 4, 12, 512, 64
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (_heads(torch.randn(b, s, h * d, generator=g, device=dev)
                      .to(torch.bfloat16), h) for _ in range(3))
    sc = d ** -0.5
    masks = k1_codebert_masks(dev)
    masks["every key"] = torch.ones(b, s, dtype=torch.bool, device=dev)
    for label, mask in masks.items():
        keys = int(mask.sum())
        lens = mask.sum(1).tolist()
        with torch.inference_mode():
            qkv = ring_inputs((q, k, v))
            ours = lambda a: flash_attention(*a, key_padding_mask=mask,
                                             sm_scale=sc)
            lib_ms = ring_ms(lambda a: F.scaled_dot_product_attention(
                *a, attn_mask=mask[:, None, None, :], scale=sc), qkv, 20)
            bnd, by = bound_ms(4 * h * s * keys * d,
                               2 * 2 * b * h * s * d + 2 * 2 * h * keys * d
                               + b * s)
            for name, (lib, _) in others.items():
                theirs = lambda a: k1_call(lib, *a, mask, sc)
                o1, p1, p2, o2 = (ring_ms(f, qkv, 20)
                                  for f in (theirs, ours, ours, theirs))
                print(f"phase times [{card}]: flash_attention_fwd_dh64 at "
                      f"CodeBERT's ({b}, {h}, {s}, {d}), {label} (lengths "
                      f"{lens}), {name} -> this tree, in turns: {o1:.4f} / "
                      f"{o2:.4f} -> {p1:.4f} / {p2:.4f} ms; library "
                      f"{lib_ms:.4f} ms, bound {bnd:.4f} ms ({by})",
                      flush=True)
            del qkv


def k1_row_lengths(card: str, other) -> None:
    """K1 at 96 with every key over the same number of scores in rows of
    1024 and of 4096 keys, (8, 8, 1024, 96) and (2, 8, 4096, 96): the
    longer rows give a block 4x the tiles for one start and one end
    (mask scan, Q load, O store), so the gap between the two rates is
    what those cost. ``other``, a ``k1_library``, is timed beside."""
    import torch
    from sct_gan_tpu_torch.ops.flash_attention import flash_attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    for b, s in ((8, 1024), (2, 4096)):
        qkv = ring_inputs(tuple(_heads(torch.randn(
            b, s, 768, generator=g, device=dev).to(torch.bfloat16))
            for _ in range(3)))
        with torch.inference_mode():
            ours = ring_ms(lambda a: flash_attention(*a, sm_scale=0.1),
                           qkv, 10)
            theirs = ring_ms(lambda a: k1_call(other, *a, None, 0.1), qkv, 10)
        del qkv
        flops = 4 * b * 8 * s * s * 96
        print(f"phase k1 rows [{card}]: K1 at ({b}, 8, {s}, 96) every key "
              f"{ours:.4f} ms, {flops / ours / 1e9:.1f} TFLOP/s (the other "
              f"build {theirs:.4f} ms, {flops / theirs / 1e9:.1f})",
              flush=True)


def flash_times(card: str, h: int = 8, d: int = 96, others=None) -> dict:
    """K1 and the K2-K4 pair's ``h`` x ``d`` instance at the training
    shape (8, h, 1024, d) under the key mask of padded tails (lens 1024,
    900, 700, 512, 300, 1000, 64, 801: 5301 of 8192 keys): kernel
    (``ring_ms``), plain version, SDPA (its backward less its forward) and
    the bound; prints a line each. K1 also with every key attended.
    Returns name -> (ms, plain ms, library ms, bound ms, bound by), K1's
    every-key row under ``<name>:every_key``, and at d <= 128 the pair's
    kernels apart (``pair_parts_ms``) under ``<name>:parts``.

    ``others``: name -> a ``k1_library`` (a parent commit's K1, say), timed
    in turns with the port's K1 (other, port, port, other) under the mask
    and with every key; its rows, (other ms, other ms, port ms, port ms),
    are ``<name>:<other>`` and ``<name>:<other>:every_key``.

    A bound counts the work this run's inputs need: under the key mask a
    masked key adds nothing to the output or to dQ and gets dK = dV = 0, so
    the products count only the attended keys, and only their K and V rows
    must be read."""
    import torch
    import torch.nn.functional as F
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_reference,
        kernel_head_dim, pad_head_dim)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rb = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    b, s = 8, 1024
    q, k, v = (_heads(rb(b, s, h * d), h) for _ in range(3))
    lens = torch.tensor([1024, 900, 700, 512, 300, 1000, 64, 801], device=dev)
    mask = torch.arange(s, device=dev)[None, :] < lens[:, None]
    sdpa_mask = mask[:, None, None, :]
    sc = d ** -0.5
    t = {}
    bf = 2   # bytes of a bf16 element
    qkv_bytes = b * h * s * d * bf
    keys = int(lens.sum())          # attended (b, key) pairs: 5301 of 8192
    kv_bytes = h * keys * d * bf    # the attended keys' rows of K or of V
    # the products' flops over the attended keys: Q K^T and P V; the
    # backward's 5 (7 as run); and the same counting every key
    flops = {"fwd": 4 * h * s * keys * d, "bwd": 10 * h * s * keys * d}
    dense = {"fwd": 4 * b * h * s * s * d, "bwd": 10 * b * h * s * s * d}
    with torch.inference_mode():
        qkv = ring_inputs((q, k, v))
        t["fwd"] = (
            ring_ms(lambda a: flash_attention(*a, key_padding_mask=mask,
                                              sm_scale=sc), qkv, 20),
            cuda_ms(lambda: flash_attention_reference(
                q, k, v, key_padding_mask=mask, sm_scale=sc)),
            ring_ms(lambda a: F.scaled_dot_product_attention(
                *a, attn_mask=sdpa_mask, scale=sc), qkv, 20),
            # Q read, O written; the attended K and V rows; the mask
            *bound_ms(flops["fwd"], 2 * qkv_bytes + 2 * kv_bytes + b * s))
        t["fwd:every_key"] = (
            ring_ms(lambda a: flash_attention(*a, sm_scale=sc), qkv, 20),
            cuda_ms(lambda: flash_attention_reference(q, k, v, sm_scale=sc)),
            ring_ms(lambda a: F.scaled_dot_product_attention(*a, scale=sc),
                    qkv, 20),
            *bound_ms(dense["fwd"], 4 * qkv_bytes))
        turns = {}
        for other, (lib, _) in (others or {}).items():
            for label, m in (("", mask), (":every_key", None)):
                theirs = lambda a: k1_call(lib, *a, m, sc)
                ours = lambda a: flash_attention(*a, key_padding_mask=m,
                                                 sm_scale=sc)
                o1, p1, p2, o2 = (ring_ms(f, qkv, 20)
                                  for f in (theirs, ours, ours, theirs))
                turns[f":{other}{label}"] = (o1, o2, p1, p2)
        del qkv

    # the backward: the kernel pair (with D = rowsum(dO∘O)) vs autograd
    # through the plain forward vs SDPA's backward, one dO, no dropout
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    dout = _heads(rb(b, s, h * d), h)
    out, lse = flash_attention(qg, kg, vg, key_padding_mask=mask,
                               sm_scale=sc, return_lse=True)
    out = out.detach()
    ref = flash_attention_reference(qg, kg, vg, key_padding_mask=mask,
                                    sm_scale=sc)
    # a head dim without an instance or a multiple of 128: the pair runs on
    # the zero-padded copies autograd hands it (made outside the timing)
    dk = kernel_head_dim(d)
    bq, bk, bv, bo, bd = ((q, k, v, out, dout) if dk == d else
                          (pad_head_dim(x, dk) for x in (q, k, v, out, dout)))
    t["bwd"] = (
        ring_ms(lambda _: flash_attention_backward(
            bq, bk, bv, bo, lse, bd, mask, False, sc, 0.0, 0), [None], 10),
        cuda_ms(lambda: torch.autograd.grad(ref, (qg, kg, vg), dout,
                                            retain_graph=True), iters=10),
        sdpa_backward_ms(q, k, v, mask, dout, sc),
        # Q, O, dO read and dQ written; the attended K and V rows; dK, dV
        # written in full (zeros at masked keys); lse; the mask
        *bound_ms(flops["bwd"],
                  6 * qkv_bytes + 2 * kv_bytes + b * h * s * 4 + b * s))
    # the Hopper pair's D, dKV and dQ kernels apart: which one leads
    split = pair_parts_ms(lambda: flash_attention_backward(
        bq, bk, bv, bo, lse, bd, mask, False, sc, 0.0, 0)) if d <= 128 else None
    del ref, qg, kg, vg, bq, bk, bv, bo, bd
    named = {}
    fwd_name = instance("flash_attention_fwd", d)
    for suffix, (o1, o2, p1, p2) in turns.items():
        named[fwd_name + suffix] = (o1, o2, p1, p2)
        print(f"phase times [{card}]: {fwd_name} at ({b}, {h}, {s}, {d})"
              f"{' every key' if 'every_key' in suffix else ''}, "
              f"{suffix.split(':')[1]} -> this tree, in turns: {o1:.4f} / "
              f"{o2:.4f} -> {p1:.4f} / {p2:.4f} ms", flush=True)
    for part, (ms, plain, libms, bnd, by) in t.items():
        if part == "fwd:every_key":
            named[f"{fwd_name}:every_key"] = t[part]
            print(f"phase times [{card}]: {fwd_name} at ({b}, {h}, {s}, {d}) "
                  f"every key attended {ms:.4f} ms "
                  f"({dense['fwd'] / ms / 1e9:.1f} TFLOP/s) vs plain "
                  f"{plain:.4f} ms, library {libms:.4f} ms, bound {bnd:.4f} "
                  f"ms ({by})", flush=True)
            continue
        name = instance(f"flash_attention_{part}", d)
        named[name] = t[part]
        parts = ""
        if part == "bwd" and split is not None:
            named[f"{name}:parts"] = split
            parts = (f" (D {split['dvec']:.4f} ms + dKV {split['dkv']:.4f} ms"
                     f" + dQ {split['dq']:.4f} ms by torch.profiler)")
        print(f"phase times [{card}]: {name} at ({b}, {h}, {s}, {d}) "
              f"{ms:.4f} ms{parts} ({flops[part] / ms / 1e9:.1f} TFLOP/s of "
              f"the attended keys' products, {dense[part] / ms / 1e9:.1f} "
              f"counting every key) vs plain {plain:.4f} ms, library "
              f"{libms:.4f} ms, bound {bnd:.4f} ms ({by})", flush=True)
    return named


def pair_parts_ms(fn, n: int = 10) -> dict:
    """Device ms a call of the backward's D, dKV and dQ kernels apart:
    ``fn()`` (one launch of the pair) ``n`` times in a whole
    ``torch.profiler`` trace (``utils.profiling.trace_device``) after one
    warm-up call, each kernel's mean device time a launch."""
    import torch
    from sct_gan_tpu_torch.utils.profiling import trace_device
    fn()
    torch.cuda.synchronize()
    trace = trace_device(lambda: [fn() for _ in range(n)])
    total = {"dvec": 0.0, "dkv": 0.0, "dq": 0.0}
    for key, _, us in trace.rows:
        for part in total:
            if f"flash_bwd_{part}_" in key:
                total[part] += us
    return {part: total[part] / n / 1e3 for part in total}


def head_dim_times(card: str) -> dict:
    """The 64, 128, 192 and 256 head dims of every kernel (K5 runs 256 on
    its wide-head route), the routes over 256 at 384 (K1's and the pair's
    chunked route, K5's wide-head route), and K5 at 80 in place on its 96
    instance, at the shapes of
    ``flash_times`` and ``decode_times``: the kernels line's (ms, plain,
    library, bound, bound by) by ``err_key``. K5's row is (2, H, 1024, d),
    and its (64, H, 1024, d) row stands under ``<key>:b64``."""
    t = {}
    for d, h in [*HEAD_DIMS.items(), *WIDE_DIMS.items(), (PADDED_DIM, 8)]:
        rows = {} if d == PADDED_DIM else flash_times(card, h, d)
        b2, b64 = list(decode_times(card, h, d).values())[:2]
        rows[err_key("decode_attention", d)] = b2
        rows[err_key("decode_attention", d) + ":b64"] = b64
        for name, row in rows.items():
            t[name + (f":dh{d}" if name.endswith("_wide") else "")] = row
    return t


# the attribution tools' repeat counts in this run (the tools' defaults
# are the JAX tools': 10 steps, 3 generation rounds, 4 and 44 calls)
BENCH_TOOLS = (
    ("peak_matmul", []),
    ("time_fwd", ["--steps", "4"]),
    ("time_decode", ["--rounds", "2"]),
    ("time_fwd_modules", ["--grad", "--calls", "2", "10"]),
)


def _numbers(res: dict) -> list:
    """(key, value) of every number in a tool's JSON (nested dicts and
    lists included; bools and the launch counts, which may be 0, left
    out)."""
    out, stack = [], [("", res)]
    while stack:
        key, x = stack.pop()
        if isinstance(x, dict):
            stack += [(f"{key}.{k}", v) for k, v in x.items()
                      if k != "launches"]
        elif isinstance(x, list):
            stack += [(f"{key}[{i}]", v) for i, v in enumerate(x)]
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            out.append((key, x))
    return out


def bad_numbers(res: dict) -> list:
    """The numbers of a tool's JSON that are not finite and positive
    (a max error may be 0)."""
    return [(k, v) for k, v in _numbers(res) if not math.isfinite(v)
            or v < 0 or (v == 0 and not k.endswith("_err"))]


def run_tool(name: str, argv: list) -> tuple:
    """``sct_gan_tpu_torch.tools.<name>.main(argv)`` with its JSON written
    to ``profile_out/<name>.json``: (the JSON, seconds). Raises if it fails
    or prints a number that is not finite and positive."""
    import importlib
    out_dir = os.path.join(ROOT, "profile_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    t0 = time.perf_counter()
    tool = importlib.import_module(f"sct_gan_tpu_torch.tools.{name}")
    if tool.main([*argv, "--out", path]) != 0:
        raise AssertionError(f"{name} failed")
    with open(path) as f:
        res = json.load(f)
    bad = bad_numbers(res)
    if bad:
        raise AssertionError(f"{name} printed {bad}")
    return res, time.perf_counter() - t0


def phase_bench(card: str, size=(), device: str = "cuda") -> dict:
    """The port's bench (``sct_gan_tpu_torch/tools/bench.py``) at the JAX
    bench's configuration (``size`` appends the tools' size options), its
    counts (2 + 2 x 10 fused steps, 1 + 1 + 3 decode rounds at B=64, 2 + 2 x
    4 naive steps), then ``peak_matmul``, ``time_fwd``, ``time_decode`` and
    ``time_fwd_modules --grad`` once each with ``BENCH_TOOLS``' counts.
    Every tool prints its lines; every number of every JSON must be finite
    and positive. On the card the bench's launches are held to
    ``read_counts()`` and to the config: per fused step ``flash_per_forward``
    K1 and pair launches and some dropout; per naive step no K1 and no pair,
    and the fused step's dropout; per decode step 2 x the decoder's layers
    K5 launches and per round one encode's K1. On the card one naive step
    is then profiled (``profile_naive_step``). Returns every launch of the
    phase and the measured peaks (FLOP/s, bytes/s) of ``peak_matmul``.
    Rehearse it on the CPU at a tiny size with ``device="cpu"`` (the
    launch counts are checked on the card only)."""
    from sct_gan_tpu_torch.tools._common import model_config
    size = ["--device", device, *size]
    # peak_matmul takes no model size: on the CPU a small one of its own
    matmul = ["--device", device] + (["--sizes", "64", "--copy-mb", "2"]
                                     if device == "cpu" else [])

    def run(name, argv):
        head = matmul if name == "peak_matmul" else size
        return run_tool(name, [*head, *argv])

    reset_counts()
    res, secs = run("bench", [])
    counts = read_counts()
    legs = res["launches"]
    step, naive, dec = legs["step"], legs["naive_step"], legs["decode"]
    if device == "cuda":
        args = dict(zip(size[::2], size[1::2]))
        cfg = model_config(int(args.get("--seq", 1024)),
                           int(args.get("--d-model", 768)),
                           int(args.get("--layers", 6)))
        fwd = flash_per_forward(cfg)
        drop = step["dropout"] // step["steps"]
        want = {
            "step": launch_dict(fwd * step["steps"], fwd * step["steps"],
                                drop * step["steps"]),
            "naive_step": launch_dict(dropout=drop * naive["steps"]),
            "decode": launch_dict(
                (cfg.num_encoder_layers + 2) * dec["rounds"],
                decode=2 * cfg.num_decoder_layers * dec["steps"])}
        got = {leg: {k: legs[leg][k] for k in counts} for leg in want}
        if counts != legs["total"] or got != want or drop == 0:
            raise AssertionError(f"bench: launches {legs}, read_counts "
                                 f"{counts}, expected {want}")
    print(f"phase bench [{card}]: {res['value']:.1f} tokens/s/chip "
          f"({res['step_ms']} ms a step by {res['timing']}, "
          f"{res['step_host_ms']:.2f} by the host clock), vs_baseline "
          f"{res['vs_baseline']:.3f} (naive {res['naive_step_ms']} ms, f32 "
          f"dense attention, tf32 {res['tf32']}), decode at B="
          f"{res['decode_batch']} {res['decode_contracts_per_sec']:.3f} "
          f"contracts/s, {res['decode_tokens_per_sec']:.1f} tokens/s; "
          f"launches per leg {legs} in {secs:.1f} s", flush=True)
    if device == "cuda":
        from sct_gan_tpu_torch.tools.bench import free_memory
        profile_naive_step(card, res["naive_step_ms"])
        free_memory()               # the naive trainer's f32 state
    peaks = None
    for name, argv in BENCH_TOOLS:
        out, secs = run(name, argv)
        print(f"phase bench: {name} {' '.join(argv)} in {secs:.1f} s",
              flush=True)
        if name == "peak_matmul":
            peaks = (max(r["tflops_bf16"] for r in out["matmul"]) * 1e12,
                     out["hbm"]["gb_per_s"] * 1e9)
    return read_counts(), peaks


# The last six attribution tools, after the bench: on the card at the JAX
# tools' shapes with fewer repeats (time_flash_real 20 steps a chain, not
# 100; time_decode_parts 64 steps a loop, not 256; time_host_prep one epoch
# of 32 contracts, not 3 of 500); on the CPU, to rehearse, at a tiny size.
ATTRIBUTION_CARD = (
    ("time_lmce", ["--with-chunked"]),
    ("time_lmce_parts", []),
    ("time_flash_real", ["--steps", "20"]),
    ("time_layer", []),
    ("time_decode_parts", ["--steps", "64"]),
    ("time_host_prep", ["--contracts", "32", "--epochs", "1"]),
)
ATTRIBUTION_CPU = (
    ("time_lmce", ["--batch", "2", "--seq", "17", "--d-model", "32",
                   "--vocab", "300", "--with-chunked", "--chunks", "3"]),
    ("time_lmce_parts", ["--batch", "2", "--seq", "16", "--d-model", "32",
                         "--vocab", "300"]),
    ("time_flash_real", ["--batch", "1", "--heads", "2", "--seq", "64",
                         "--dh", "32", "--steps", "2"]),
    ("time_layer", ["--batch", "2", "--seq", "64", "--d-model", "32",
                    "--heads", "4", "--ffn", "64", "--layers", "2"]),
    ("time_decode_parts", ["--batch", "2", "--steps", "4", "--d-model", "32",
                           "--seq", "64"]),
    ("time_host_prep", ["--contracts", "24", "--epochs", "1", "--seq",
                        "128"]),
)
# hash-dropout sites an encoder layer's forward runs (the two residual
# sites and the FFN's); the backward runs each once more
DROPOUT_SITES_PER_ENCODER_LAYER = 3


def attribution_launch_errors(name: str, res: dict, total: dict,
                              on_card: bool) -> list:
    """Where a tool's launches (``total``, counted around its run, and
    each row's in ``res``) leave the config: ``time_flash_real`` one K1 a
    call and one pair call an ``fb`` call; ``time_layer`` a K1 and a pair
    call a layer a step in its flash variants, none in the dense one and
    the floor, the dropout sites' forward and backward only at 0.3;
    ``time_decode_parts`` 2 L K5 a step in the layers-only loops, none in
    the others, and one encode's K1 for each loop's model;
    ``time_host_prep`` none over its epochs, and each trainer's start-up
    forward's f32 K1; ``time_lmce`` and ``time_lmce_parts`` none. On the CPU
    every count is 0."""
    from sct_gan_tpu_torch.tools.time_decode_parts import LAYERS
    want = lambda **kw: {k: kw.get(k, 0) * int(on_card) for k in KERNELS}
    errs, rows_total = [], dict.fromkeys(KERNELS, 0)

    def row(label, got, expected):
        if got != expected:
            errs.append(f"{name} {label}: launches {got}, expected "
                        f"{expected}")
        for k in KERNELS:
            rows_total[k] += got[k]

    if name == "time_flash_real":
        for label, r in res["rows"].items():
            row(label, r["launches"], want(
                flash_attention_fwd=r["calls"],
                flash_attention_bwd=r["calls"] * label.startswith("fb")))
    elif name == "time_layer":
        nl = res["layers"]
        for label, r in res["variants"].items():
            flash = "flash" in label
            drop = 2 * DROPOUT_SITES_PER_ENCODER_LAYER * label.startswith(
                "drop0.3")
            row(label, r["launches"], want(
                flash_attention_fwd=nl * r["steps"] * flash,
                flash_attention_bwd=nl * r["steps"] * flash,
                dropout=nl * r["steps"] * drop))
    elif name == "time_decode_parts":
        for label, r in res["rows"].items():
            layers = int(label[6:]) if label.startswith("layers") else 0
            row(label, r["launches"]["total"],
                want(decode_attention=2 * layers * r["steps"]))
        rows_total["flash_attention_fwd"] += int(on_card) * len(LAYERS) * (
            res["encoder_layers"] + 2)
    elif name == "time_host_prep":      # each trainer's start-up forward
        from sct_gan_tpu_torch.tools.time_host_prep import prep_config
        for label, r in res["banks"].items():
            row(label, r["launches"], want())
        rows_total["flash_attention_fwd_f32"] += int(on_card) * len(
            res["banks"]) * flash_per_forward(prep_config(res["seq"]))
    if total != rows_total:
        errs.append(f"{name}: launches {total}, expected {rows_total}")
    return errs


def phase_attribution(card: str, tools=ATTRIBUTION_CARD,
                      device: str = "cuda") -> dict:
    """The last six attribution tools (``sct_gan_tpu_torch/tools``), once
    each with ``tools``' options on ``device``: every number of every JSON
    finite and positive (``run_tool``), each tool's launches held to the
    config (``attribution_launch_errors``). Returns the phase's launches.
    Rehearse it on the CPU with ``phase_attribution("cpu",
    ATTRIBUTION_CPU, device="cpu")``."""
    reset_counts()
    for name, argv in tools:
        before = read_counts()
        res, secs = run_tool(name, ["--device", device, *argv])
        total = {k: v - before[k] for k, v in read_counts().items()}
        errs = attribution_launch_errors(name, res, total,
                                         device == "cuda")
        if errs:
            raise AssertionError("; ".join(errs))
        print(f"phase attribution [{card}]: {name} {' '.join(argv)} in "
              f"{secs:.1f} s, launches {total}", flush=True)
    return read_counts()


# The eight step tools, after the attribution tools: on the card at
# the JAX tools' configurations with fewer repeats (profile_step 2 steps,
# not 6; the A/Bs 2 steps a run, not 10; ablate_step 1, not 8; the quality
# A/Bs 40 contracts for 2 epochs, not 300 for 30); on the CPU, to rehearse,
# at a tiny size.
STEP_TOOLS_CARD = (
    ("profile_step", ["--steps", "2", "--topk", "12"]),
    ("time_opt_ab", ["--steps", "2"]),
    ("time_lmce_ab", ["--steps", "2"]),
    ("time_opt_megaleaf", []),
    ("ablate_step", ["--steps", "1"]),
    ("time_dispatch", ["--k", "8"]),
    ("ab_aug_labels", ["--contracts", "40", "--epochs", "2"]),
    ("ab_contract_dilution", ["--contracts", "40", "--epochs", "2"]),
)
_TINY = ["--d-model", "32", "--layers", "1", "--seq", "64", "--vocab",
         "512"]
_TINY_STEP = [*_TINY, "--batch", "2", "--heads", "4"]
STEP_TOOLS_CPU = (
    ("profile_step", [*_TINY, "--batch", "2", "--steps", "1", "--topk",
                      "5"]),
    ("time_opt_ab", [*_TINY, "--batch", "2", "--steps", "1"]),
    ("time_lmce_ab", [*_TINY, "--batch", "2", "--steps", "1"]),
    ("time_opt_megaleaf", _TINY),
    ("ablate_step", [*_TINY_STEP, "--steps", "1"]),
    ("time_dispatch", [*_TINY_STEP, "--k", "2", "--calls", "5",
                       "--matmul", "64"]),
    ("ab_aug_labels", ["--contracts", "24", "--epochs", "1", "--seq", "64",
                       "--vocab", "512"]),
    ("ab_contract_dilution", ["--contracts", "24", "--epochs", "1", "--seq",
                              "64", "--vocab", "512"]),
)
# the backward pair's calls a step of each ablation, against K1's forward
# calls F (flash_per_forward): the flash calls whose output the loss reads
# (the line head's two and the discriminator's one drop out with their
# losses)
ABLATION_BWD = {"full": 0, "no_embed_grad": 0, "ce_only_loss": 3,
                "no_line_loss": 2, "no_heads": 3, "no_dropout": 0}


def step_tool_launch_errors(name: str, res: dict, total: dict,
                            on_card: bool) -> list:
    """Where a step tool's launches (``total``, counted around its run, and
    its rows') leave the config, at ``_common.model_config()``'s F =
    ``flash_per_forward`` K1 calls a step: a train step runs F K1 and F
    pair calls (``ablate_step``: F less the line head's two without heads,
    and the pair ``ABLATION_BWD`` fewer) and a fixed number of K6 launches
    (0 with dropout off), no K5, and each trainer built adds its start-up
    forward's F K1; ``time_dispatch`` counts its eager steps,
    the warm-up, capture and parity steps; ``time_opt_megaleaf`` none; the
    quality A/Bs train and score a 2+2-layer f32 model: the f32 K1 and
    pair, K1 at least as often, K6, nothing else. On the CPU every count
    is 0."""
    from sct_gan_tpu_torch.tools._common import model_config
    f = flash_per_forward(model_config())
    errs = []

    def steps_of(label, launches, steps, bwd_less=0, fwd_less=0,
                 dropout_on=True):
        want = {"flash_attention_fwd": (f - fwd_less) * steps,
                "flash_attention_bwd": (f - bwd_less) * steps,
                "decode_attention": 0}
        drop = launches["dropout"]
        got = {k: launches[k] for k in want}
        bad_drop = (drop % steps or (drop > 0) != (dropout_on and on_card))
        if got != {k: v * on_card for k, v in want.items()} or bad_drop:
            errs.append(f"{name} {label}: launches {launches} over {steps} "
                        f"steps, expected {want} a run and K6 "
                        f"{'a multiple of the steps' if dropout_on else 0}")
        return drop // steps

    # each SmartContractTrainer's start-up forward (its dimension test)
    startup = {k: f * on_card * (k == "flash_attention_fwd")
               for k in KERNELS}
    if name == "profile_step":
        steps_of("trace", {k: v - startup[k] for k, v in total.items()},
                 res["warmup"] + res["steps"] * (1 + res["traced_runs"]))
    elif name in ("time_opt_ab", "time_lmce_ab"):
        drops = {steps_of(arm, r["launches"], r["steps"])
                 for arm, r in res["arms"].items()}
        rows = {k: sum(r["launches"][k] + startup[k]
                       for r in res["arms"].values()) for k in KERNELS}
        if len(drops) != 1 or rows != total:
            errs.append(f"{name}: K6 a step {drops} across arms, arms' "
                        f"launches {rows} against {total}")
    elif name == "ablate_step":
        rows = dict.fromkeys(KERNELS, 0)
        for label, r in res["ablations"].items():
            steps_of(label, r["launches"], r["steps"], ABLATION_BWD[label],
                     2 * (label == "no_heads"), label != "no_dropout")
            for k in KERNELS:
                rows[k] += r["launches"][k]
        if rows != total:
            errs.append(f"{name}: rows' launches {rows} against {total}")
    elif name == "time_dispatch":
        e = res["eager"]
        per = steps_of("eager", e["launches"], e["steps"])
        steps_of("all step calls", total, res["step_calls"])
        if on_card:
            steps_of("capture", res["graph"]["launches"], res["k"])
            if per * res["step_calls"] != total["dropout"]:
                errs.append(f"{name}: K6 {total} over {res['step_calls']} "
                            f"step calls, {per} a step")
    elif name == "time_opt_megaleaf":
        if any(total.values()):
            errs.append(f"{name}: launches {total}, expected none")
    else:           # the quality A/Bs: an f32 model, as the JAX tools'
        fwd = total["flash_attention_fwd_f32"]
        bwd = total["flash_attention_bwd_f32"]
        ok = (min(fwd, bwd, total["dropout"]) > 0 and fwd >= bwd
              and total == launch_dict(fwd, bwd, total["dropout"], f32=True))
        if not ok if on_card else any(total.values()):
            errs.append(f"{name}: launches {total}")
    return errs


def phase_step_tools(card: str, tools=STEP_TOOLS_CARD,
                     device: str = "cuda") -> dict:
    """The eight step tools (``sct_gan_tpu_torch/tools``: ``profile_step``,
    ``time_opt_ab``, ``time_lmce_ab``, ``time_opt_megaleaf``,
    ``ablate_step``, ``time_dispatch``, ``ab_aug_labels``,
    ``ab_contract_dilution``), once each with ``tools``' options on
    ``device``: every number of every JSON finite and positive
    (``run_tool``), each tool's launches held to the config
    (``step_tool_launch_errors``), and ``time_dispatch``'s K-step CUDA
    graph held to K eager steps from the same state and seeds (inside the
    tool: bit for bit, or the update norm-wise within its
    ``PARITY_RTOL``). Returns the phase's launches. Rehearse it on the CPU
    with ``phase_step_tools("cpu", STEP_TOOLS_CPU, device="cpu")``."""
    from sct_gan_tpu_torch.tools.bench import free_memory
    reset_counts()
    t0 = time.perf_counter()
    for name, argv in tools:
        before = read_counts()
        res, secs = run_tool(name, ["--device", device, *argv])
        total = {k: v - before[k] for k, v in read_counts().items()}
        errs = step_tool_launch_errors(name, res, total, device == "cuda")
        if errs:
            raise AssertionError("; ".join(errs))
        print(f"phase step tools [{card}]: {name} {' '.join(argv)} in "
              f"{secs:.1f} s, launches {total}", flush=True)
        free_memory()
    print(f"phase step tools: {len(tools)} tools in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return read_counts()


def profile_naive_step(card: str, wall_ms: float) -> None:
    """One step of the bench's naive leg (f32, dense attention) under
    ``torch.profiler``, after one warm-up step: where its time goes
    (``profile_out/profile_naive.txt``)."""
    import torch
    from sct_gan_tpu_torch.tools import bench
    trainer = bench.build_trainer("float32", True)
    batch = trainer.to_device(make_batch(8, 1024, trainer.model.config
                                         .vocab_size))
    box = {"state": trainer.state, "scalars": trainer._scalars(1.0)}
    lrs = trainer._group_lrs()

    def step():
        box["state"], _, box["scalars"] = trainer.train_step(
            box["state"], batch, box["scalars"], lrs, trainer.generator)
        return 1
    step()
    torch.cuda.synchronize()
    profile_device(step, "naive", wall_ms, card)


def f32_entries(t: dict, errs: dict, *launch_counts) -> list:
    """The kernels line's entries of the f32 instances: launches summed over
    ``launch_counts`` (the f32 paths', the TASC paths' and the entry
    points'), the worst errors of ``f32_kernel_checks``, the times of
    ``f32_times`` (K1's CodeBERT row under ``codebert``, K5's B=64 row under
    ``b64``) and the 3xTF32 peak its operations bound is taken at."""
    from sct_gan_tpu_torch.utils.profiling import PEAK_3XTF32_FLOPS
    out = []
    for name in F32_KERNELS:
        source, replaces = KERNELS[name]
        launches = sum(c.get(name, 0) for c in launch_counts)
        if launches == 0:
            raise AssertionError(f"{name}: no launch on its main path")
        ms, plain, libms, bnd, by = t[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": libms, "f32_peak_flops": PEAK_3XTF32_FLOPS}
        for sub_row in ("codebert", "b64"):
            if f"{name}:{sub_row}" in t:
                ms, plain, libms, bnd, by = t[f"{name}:{sub_row}"]
                entry[sub_row] = dict(ms=ms, plain_ms=plain, library_ms=libms,
                                      bound_ms=bnd, bound_by=by)
        out.append(entry)
    return out


def add_measured_bounds(entry, peaks, by=None, f32=False) -> None:
    """Beside every ``bound_ms`` in ``entry`` (a kernels-line entry, its
    nested rows included), ``bound_measured_ms``: the same bound at the
    card's measured peaks (``peak_matmul``: (FLOP/s, bytes/s)) in place of
    the data sheet's, rescaling the term that bounds it (a nested row
    without ``bound_by`` is bound as its parent). The measured peak is a
    bf16 product's, so an f32 kernel's (``f32_peak_flops``) operations
    bound gets none; its bytes bound does."""
    from sct_gan_tpu_torch.utils.profiling import PEAK_BF16_FLOPS, PEAK_BYTES
    if isinstance(entry, list):
        for e in entry:
            add_measured_bounds(e, peaks, by, f32)
        return
    if not isinstance(entry, dict):
        return
    by = entry.get("bound_by", by)
    f32 = f32 or "f32_peak_flops" in entry
    for v in list(entry.values()):
        add_measured_bounds(v, peaks, by, f32)
    if "bound_ms" in entry and not (f32 and by == "operations"):
        scale = (PEAK_BF16_FLOPS / peaks[0] if by == "operations"
                 else PEAK_BYTES / peaks[1])
        entry["bound_measured_ms"] = entry["bound_ms"] * scale


def phase_times(an, codes, template, trainer, batch, card, variants):
    """Kernels vs their plain versions and the library call, by CUDA
    events; the detection, generation and train-step times. ``variants``
    (phase_variants' entries) gives K1 re-timed on K7's input.

    The kernels and the library calls are captured in CUDA graphs and
    replayed (``ring_ms``), which times the device alone: an eager loop
    times the host's dispatch wherever that is the slower, and the host's
    speed moves from run to run. The plain versions, tens of launches and
    milliseconds each, are timed eagerly."""
    import torch
    import torch.nn.functional as F
    from sct_gan_tpu_torch.ops.dropout import dropout, dropout_reference
    from sct_gan_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rb = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    b, h, s, d = 8, 8, 1024, 96
    lens = torch.tensor([1024, 900, 700, 512, 300, 1000, 64, 801], device=dev)
    sc = 96 ** -0.5
    bf = 2   # bytes of a bf16 element
    t = flash_times(card)
    with torch.inference_mode():
        x = rb(8, 1024, 2048)
        n = x.numel()
        xs = ring_inputs(x)
        t["dropout"] = (
            ring_ms(lambda y: dropout(y, 0.3, 7), xs, 50),
            cuda_ms(lambda: dropout_reference(x, 7, 0.3), iters=50),
            ring_ms(lambda y: F.dropout(y, 0.3, training=True), xs, 50),
            *bound_ms(0, 2 * n * bf))
        del xs
    ms, plain, libms, bnd, by = t["dropout"]
    print(f"phase times [{card}]: dropout {ms:.4f} ms vs plain {plain:.4f} "
          f"ms, library {libms:.4f} ms, bound {bnd:.4f} ms ({by})",
          flush=True)
    t["decode_attention"], t["decode_attention:b64"] = list(
        decode_times(card).values())[:2]

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
    ms2 = ring_ms(lambda _: flash_attention_backward(
        q2, k2, v2, out2, lse2, dout2, mask2, False, sc, 0.0, 0), [None], 10)
    plain2 = cuda_ms(lambda: torch.autograd.grad(
        ref2, (q2, k2, v2), dout2, retain_graph=True), iters=5)
    lib2_ms = sdpa_backward_ms(q2, k2, v2, mask2, dout2, sc)
    keys2 = int(mask2.sum())        # 6272 of 8192
    flops2 = 10 * h * s2 * keys2 * d
    bnd2, by2 = bound_ms(flops2, 6 * b2 * h * s2 * d * bf
                         + 2 * h * keys2 * d * bf + b2 * h * s2 * 4 + b2 * s2)
    print(f"phase times [{card}]: flash_attention_bwd at (4, 8, 2048, 96) "
          f"(the TPU's K3/K4 blocking) {ms2:.4f} ms "
          f"({flops2 / ms2 / 1e9:.1f} TFLOP/s of the attended keys' "
          f"products, {10 * b2 * h * s2 * s2 * d / ms2 / 1e9:.1f} counting "
          f"every key) vs plain {plain2:.4f} ms, library {lib2_ms:.4f} ms, "
          f"bound {bnd2:.4f} ms ({by2})", flush=True)
    del ref2, q2, k2, v2
    k7 = next(e for e in variants if e["name"] == "flash_parts")["modes"]
    k1_ms = k7["k1"]["ms"]
    print(f"phase times [{card}]: K1 on K7's input (the reference row: "
          f"(8, 8, 1024, 96), x = 0.01, a chain of x = f(x)) {k1_ms:.4f} ms "
          f"({4 * b * h * s * s * d / k1_ms / 1e9:.1f} TFLOP/s) against K7 "
          f"full {k7['full']['ms']:.4f} ms, noexp {k7['noexp']['ms']:.4f} "
          f"ms, mmonly {k7['mmonly']['ms']:.4f} ms (K1's pipeline, every "
          f"key tile, the body swapped)", flush=True)

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
    ``torch.profiler`` (device activity only), through the port's one
    reading of its records (``utils.profiling.trace_device``: primed, held
    to the launch counters, taken again when short); print device time and
    launches per unit against ``wall_ms``, the unprofiled time of one unit,
    and the top kernels (``tools/profile_step.py``'s rows); write every
    kernel to ``profile_out/profile_<name>.txt``."""
    from sct_gan_tpu_torch.tools.profile_step import print_top
    from sct_gan_tpu_torch.utils.profiling import trace_device
    trace = trace_device(fn)
    per, total_us = trace.value, trace.total_us
    dev_ms = total_us / per / 1e3
    out_dir = os.path.join(ROOT, "profile_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_{name}.txt")
    with open(path, "w") as f:
        f.write(f"# {name}: {per} units, {card}\n# share  us/unit  "
                f"launches/unit  kernel\n")
        for key, count, us in trace.rows:
            f.write(f"{us / total_us:6.1%} {us / per:10.2f} "
                    f"{count / per:8.2f}  {key}\n")
    print(f"phase profile {name} [{card}]: device {dev_ms:.3f} ms and "
          f"{trace.records / per:.1f} launches per unit, against "
          f"{wall_ms:.3f} ms unprofiled: busy {dev_ms / wall_ms:.1%} "
          f"(whole trace after {trace.runs} run(s)); table in "
          f"{os.path.relpath(path, ROOT)}", flush=True)
    print_top(trace.rows, 8, card, per=per)


def profiler_probe(rounds: int = 10, idle_s: float = 90.0) -> int:
    """C7, where ``torch.profiler`` loses device records: a chain of 20 K1
    calls, each times 0.999 (40 kernels), traced bare, fresh and after
    ``idle_s`` seconds of process life, against the same chain through
    ``trace_device`` (64 primer kernels first), in turns, ``rounds``
    times. Prints one JSON line a trace: the chain's K1 launches, its K1
    and total records, and the runs the primed trace took to come back
    whole. Diagnostic only: the port reads the profiler through
    ``trace_device`` alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sct_gan_tpu_torch.tools.time_flash_real import fwd_chain
    from sct_gan_tpu_torch.utils.profiling import trace_device
    phase_device()
    phase_build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(8, 8, 1024, 96, generator=g, device=dev).to(
        torch.bfloat16) * 0.05
    mask = torch.ones(8, 1024, dtype=torch.bool, device=dev)
    chain = lambda: fwd_chain(q, mask, 0.0, 20)
    chain()
    torch.cuda.synchronize()

    def report(label, launches, rows, runs=1):
        k1 = sum(c for k, c, *_ in rows if "flash_fwd" in k)
        print("probe " + json.dumps({
            "trace": label, "k1_launches": launches, "k1_records": k1,
            "records": sum(r[1] for r in rows), "runs": runs}), flush=True)

    def bare(label):
        before = read_counts()["flash_attention_fwd"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            chain()
            torch.cuda.synchronize()
        rows = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        report(label, read_counts()["flash_attention_fwd"] - before, rows)

    def primed(label):
        before = read_counts()["flash_attention_fwd"]
        trace = trace_device(chain)
        report(label, (read_counts()["flash_attention_fwd"] - before)
               // trace.runs, trace.rows, trace.runs)
    bare("bare, fresh")
    time.sleep(idle_s)
    for i in range(rounds):
        bare(f"bare {i}")
        primed(f"primed {i}")
    return 0


def main() -> int:
    phase_device()
    import torch
    phase_build()
    errs = phase_kernels()
    errs.update(phase_head_kernels())
    tasc_kernel_checks(errs)
    long_keys = parallel_kernel_checks(errs)
    card = card_line()
    variants = phase_variants(card)
    an, codes, template, serve_launches = phase_serve()
    beam_launches = phase_beam(an, template)
    analyzer_launches = phase_analyzer(an, codes)
    eval_launches = phase_evals(an)
    trainer, batch, train_launches = phase_train()
    phase_train_check(trainer)
    loop_launches = phase_loop()
    tools_launches = phase_tools()
    head_launches = phase_heads()
    tasc_launches = phase_tasc(card)
    parallel_launches = phase_parallel(card)
    entry_launches = phase_entry(card)
    f32_launches, f32_errs, f32_t = phase_f32(card)
    bench_launches, peaks = phase_bench(card)
    attribution_launches = phase_attribution(card)
    step_tool_launches = phase_step_tools(card)
    t, det_ms, gen_ms, train_ms, step = phase_times(an, codes, template,
                                                    trainer, batch, card,
                                                    variants)
    t.update(head_dim_times(card))

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

    def beam127():              # 127 beam steps (K=3) on the template
        from sct_gan_tpu_torch.infer.generate import beam_search
        b = an._prepare_inputs([template])
        return beam_search(an.model, b["input_ids"], b["attention_mask"],
                           b["ast_input_ids"], b["ast_attention_mask"],
                           beam_size=3, max_length=128, temperature=0.8)[3]
    t0 = time.perf_counter()
    beam_steps = beam127()
    torch.cuda.synchronize()
    beam_ms = (time.perf_counter() - t0) * 1e3 / beam_steps
    profile_device(detect5, "detect", det_ms, card)
    profile_device(generate, "generate", gen_ms, card)
    profile_device(beam127, "beam", beam_ms, card)
    profile_device(train1, "train", train_ms, card)

    kernels = []
    names = list(dict.fromkeys(
        (k, instance(k, d)) for k in BF16_KERNELS
        for d in ((96, *HEAD_DIMS, *WIDE_DIMS) if k != "dropout" else (96,))))
    for kernel, name in names:
        source, replaces = KERNELS[kernel]
        key = name + (f":dh{WIDE_TOP}" if name.endswith("_wide") else "")
        ms, plain, libms, bnd, by = t[key]
        if name == kernel:          # head dim 96: every path of the model
            launches = sum(p[name] for p in (
                serve_launches, beam_launches, analyzer_launches,
                eval_launches, train_launches, loop_launches,
                tools_launches, bench_launches, attribution_launches,
                step_tool_launches))
        else:
            launches = head_launches[name]
        # the TASC paths: head dim 96, and CodeBERT's K1 at 64; the
        # parallel paths (the world of one's); the entry points (the
        # full-size forward at 96, the dry runs' ranks at 64)
        launches += tasc_launches.get(name, 0)
        launches += parallel_launches.get(name, 0)
        launches += entry_launches.get(name, 0)
        launches += f32_launches.get(name, 0)   # K6 on the f32 step
        if launches == 0:
            raise AssertionError(f"{name}: no launch on its main path")
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": libms}
        if name in long_keys:       # sp_detect's / sp_encode's long keys
            entry["long_keys"] = long_keys[name]
        if f"{key}:parts" in t:     # the pair's D, dKV and dQ kernels apart
            for part, ms in t[f"{key}:parts"].items():
                entry[f"{part}_ms"] = ms
        padded = errs.get(f"{name}:padded{PADDED_DIM}")
        if padded is not None:      # the padded route runs this instance
            entry[f"padded_dh{PADDED_DIM}_max_abs_err"] = padded[0]
            entry[f"padded_dh{PADDED_DIM}_max_rel_err"] = padded[1]
        def times(row):
            ms, plain, libms, bnd, by = row
            return dict(ms=ms, plain_ms=plain, library_ms=libms,
                        bound_ms=bnd, bound_by=by)
        if f"{key}:b64" in t:       # K5 at (64, H, 1024, d), every key
            entry["b64"] = times(t[f"{key}:b64"])
        if f"{name}:every_key" in t:  # K1 with every key attended
            entry["every_key"] = times(t[f"{name}:every_key"])
        for d in DECODE_TAILS:      # K5 in place on this instance
            if f"{name}:tail{d}" in errs:
                a, r = errs[f"{name}:tail{d}"]
                tail = entry[f"tail_dh{d}"] = {"max_abs_err": a,
                                               "max_rel_err": r}
                if f"{name}:tail{d}" in t:
                    tail.update(times(t[f"{name}:tail{d}"]))
                    tail["b64"] = times(t[f"{name}:tail{d}:b64"])
        if name.endswith("_wide"):  # the top level is WIDE_TOP's head dim
            entry["head_dim"] = WIDE_TOP
            entry["head_dims"] = {}
            for d in sorted({*WIDE_DIMS, *DECODE_TAILS, CHUNK_PADDED_DIM}):
                if f"{name}:dh{d}" not in errs:
                    continue
                a, r = errs[f"{name}:dh{d}"]
                row = entry["head_dims"][str(d)] = {
                    "max_abs_err": a, "max_rel_err": r}
                if f"{name}:dh{d}" in t:      # 224 and 320 are held, not timed
                    row.update(times(t[f"{name}:dh{d}"]))
                if f"{name}:dh{d}:b64" in t:  # K5 at (64, H, 1024, d)
                    row["b64"] = times(t[f"{name}:dh{d}:b64"])
        kernels.append(entry)
    kernels += f32_entries(f32_t, f32_errs, f32_launches, tasc_launches,
                           entry_launches)
    kernels += variants
    add_measured_bounds(kernels, peaks)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-rank":
        sys.exit(parallel_rank(sys.argv[2]))
    if len(sys.argv) >= 3 and sys.argv[1] == "--k1-times":
        sys.exit(k1_times(sys.argv[2:]))
    if len(sys.argv) >= 3 and sys.argv[1] == "--variants-times":
        sys.exit(variants_times(sys.argv[2:]))
    if sys.argv[1:] == ["--profiler-probe"]:
        sys.exit(profiler_probe())
    sys.exit(main())
