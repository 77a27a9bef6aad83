"""What the tools share. The kernel-timing tools: mode lookup, the q = k = v
attention launch of K7 and K8, and the one-line report of a ``time_modes``
result. The training and evaluation tools: the JAX tools' model
configuration and tokenizer, the corpus-v2 loaders, the best checkpoint,
the analyzer on it and the reference protocol's scoring."""
from __future__ import annotations

import ctypes
import json
from typing import Dict, Optional, Sequence

import torch

from ..ops import _build


def mode_index(mode: str, modes: Sequence[str]) -> int:
    if mode not in modes:
        raise ValueError(f"mode {mode!r}: expected one of {tuple(modes)}")
    return modes.index(mode)


def device_kind(x: torch.Tensor, name: str) -> str:
    """``"cpu"`` (plain version) or ``"cuda"`` (kernel); anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got one on "
                         f"{x.device}")
    return x.device.type


def launch_self_attention(fn_name: str, x: torch.Tensor, mode: int,
                          scale: float, head_dims: Sequence[int],
                          max_seq: Optional[int] = None) -> torch.Tensor:
    """Launch a K7/K8 kernel with q = k = v = x: a contiguous bf16 CUDA
    tensor (B, H, S, D), D in ``head_dims``, S a multiple of 64 (at most
    ``max_seq``). Returns the (B, H, S, D) output."""
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{fn_name}: expected a contiguous bf16 (B, H, S, D) "
                         f"tensor, got {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()}")
    b, h, s, d = x.shape
    if (d not in head_dims or s <= 0 or s % 64
            or (max_seq is not None and s > max_seq)):
        raise ValueError(f"{fn_name}: head dim {d} / keys {s} not supported "
                         f"(head dims {tuple(head_dims)}; keys a multiple of "
                         f"64{'' if max_seq is None else f' up to {max_seq}'})")
    if x.data_ptr() % 16:
        x = x.clone()                   # the kernels read 16 bytes a thread
    out = torch.empty_like(x)
    ptr = x.data_ptr()
    err = getattr(_build.load(), fn_name)(
        ptr, ptr, ptr, out.data_ptr(), b * h, s, d, mode,
        ctypes.c_float(scale), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, fn_name)
    return out


def self_attention_library(kind: str, scale: float):
    """A step ``x -> f(x)`` by a PyTorch library call computing a K7/K8
    mode's function of x (q = k = v), timed beside the kernel as a chain;
    the port never calls it.

    ``"sdpa"``: softmax attention; ``"sdpa_mask"``: the same through SDPA's
    key-mask path (an all-True mask); ``"bmm"``: the products alone,
    ``(scale x x^T) x`` by ``baddbmm`` (beta 0, so its input is not read)
    and ``bmm``."""
    import torch.nn.functional as F
    if kind == "sdpa":
        return lambda x: F.scaled_dot_product_attention(x, x, x, scale=scale)
    if kind == "sdpa_mask":
        def masked(x):
            b, _, s, _ = x.shape
            mask = torch.ones(b, 1, 1, s, dtype=torch.bool, device=x.device)
            return F.scaled_dot_product_attention(x, x, x, attn_mask=mask,
                                                  scale=scale)
        return masked
    if kind == "bmm":
        def products(x):
            b, h, s, d = x.shape
            x3 = x.reshape(b * h, s, d)
            zero = torch.zeros(1, 1, 1, dtype=x.dtype, device=x.device)
            return torch.bmm(torch.baddbmm(zero, x3, x3.transpose(1, 2),
                                           beta=0.0, alpha=scale),
                             x3).view(b, h, s, d)
        return products
    raise ValueError(f"library call {kind!r}")


def sdpa_backward_ms(q, k, v, mask, dout, scale: float,
                     causal: bool = False) -> float:
    """SDPA's backward alone, in device ms, under the key mask ``mask``
    (B, Sk) or None, causal or not: its forward and backward captured
    together and replayed (``ring_ms``), less its forward replayed alone.
    An eager loop of ``autograd.grad`` times the host's dispatch, which
    moves from run to run. The port never calls SDPA: it is the yardstick
    of the backward pair."""
    import torch.nn.functional as F

    from ..utils.profiling import ring_ms
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    attn_mask = None if mask is None else mask[:, None, None, :]

    def fwd(_):
        return F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=attn_mask, is_causal=causal, scale=scale)
    both = ring_ms(lambda _: torch.autograd.grad(fwd(_), (qs, ks, vs), dout),
                   [None], 10)
    return both - ring_ms(fwd, [None], 10)


def timing_row(ms: float, plain_ms: float, library_ms: Optional[float],
               bound: tuple) -> Dict[str, object]:
    """One mode's times: the kernel, its plain version, the library call
    (None where no one PyTorch call computes the function) and the bound."""
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


def summary_line(title: str, result: Dict[str, dict], card: str) -> str:
    """``time_modes``'s result as one line, with the card it ran on."""
    parts = []
    for mode, r in result.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        parts.append(f"{mode} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                     f"library {lib}, bound {r['bound_ms']:.4f} "
                     f"{r['bound_by']})")
    return f"{title} [{card}]: " + "; ".join(parts)


# -- what the training and evaluation entry points share ----------------------

def model_config(seq: int = 1024, d_model: int = 768, layers: int = 6,
                 compute_dtype: str = "bfloat16"):
    """The JAX tools' ``ModelConfig``: the GAN model at L = ``seq`` with
    ``seq`` line slots, FFN 2048 at the reference width (else 8/3 of
    d_model), ``layers`` encoder and decoder layers, computing in
    ``compute_dtype``."""
    from ..config import ModelConfig
    return ModelConfig(use_gan=True, max_length=seq, max_lines=seq,
                       d_model=d_model,
                       dim_feedforward=(2048 if d_model == 768
                                        else d_model * 8 // 3),
                       num_encoder_layers=layers, num_decoder_layers=layers,
                       compute_dtype=compute_dtype)


def tokenizer_for(cfg):
    """The tools' tokenizer: the C++ encode path where it builds (the same
    ids either way)."""
    from ..data.native_tokenizer import NativeSolidityTokenizer
    return NativeSolidityTokenizer(vocab_size=cfg.vocab_size)


def v2_loader(tok, n: int, seed: int, family: int, seq: int,
              batch_size: int, shuffle: bool = False, loader_seed: int = 0):
    """A loader over ``n`` corpus-v2 contracts of ``family`` (with the
    near-miss distractors) drawn from ``seed``."""
    from ..data.dataset import (ArrayDataLoader,
                                SmartContractVulnerabilityDataset)
    from ..data.synthetic import generate_corpus
    recs = generate_corpus(n, seed=seed, family=family, distractors=True)
    ds = SmartContractVulnerabilityDataset(records=recs, tokenizer=tok,
                                           max_length=seq)
    return ArrayDataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                           seed=loader_seed)


def best_checkpoint(checkpoint_dir: str) -> str:
    """The newest best checkpoint of a run (the latest where none was
    written); raises when the directory holds neither."""
    from ..train.checkpoint import find_checkpoint
    ckpt = find_checkpoint(checkpoint_dir, "best")
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    return ckpt


def load_analyzer(ckpt: str, cfg, tok, device: str, verbose: bool = False):
    from ..infer.analyzer import SmartContractAnalyzer
    return SmartContractAnalyzer(model_path=ckpt, use_gan=True, tokenizer=tok,
                                 model_config=cfg, device=device,
                                 verbose=verbose)


def score(analyzer, ckpt: str, loader, output_file: str,
          max_contracts: Optional[int] = None) -> Dict:
    """The reference protocol on one loader: per-type thresholds of the
    baseline run, the comprehensive evaluation written to
    ``output_file``, its summary printed."""
    from ..evals.harness import (BASELINE_CONTRACT_THRESHOLDS,
                                 BASELINE_LINE_THRESHOLDS,
                                 evaluate_model_performance,
                                 print_evaluation_summary)
    res = evaluate_model_performance(
        model_path=ckpt, val_dataloader=loader,
        contract_thresholds=BASELINE_CONTRACT_THRESHOLDS,
        line_thresholds=BASELINE_LINE_THRESHOLDS,
        max_contracts=max_contracts, output_file=output_file,
        analyzer=analyzer)
    print_evaluation_summary(res)
    return res


def matrix_column(res: Dict) -> Dict:
    """One column of the corpus-v2 matrix: the overall contract and line
    metrics and the PR-AUC of each type."""
    per = lambda level: {vt: d.get("pr_auc") for vt, d in
                         res[level].get("per_vulnerability", {}).items()}
    return {"contract_overall": res["contract_level"]["overall"],
            "line_overall": res["line_level"]["overall"],
            "contract_per_type": per("contract_level"),
            "line_per_type": per("line_level")}


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=float)


class _NoBatches:
    """A loader of batch size ``batch_size`` with no batches."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size

    def __iter__(self):
        return iter(())


def bench_trainer(device: str, fused: bool, d_model: int = 768,
                  layers: int = 6, seq: int = 1024, batch_size: int = 8,
                  compute_dtype: str = "bfloat16"):
    """The JAX bench's trainer (``bench.build_trainer("bfloat16", True, 8,
    1024)``): ``ModelConfig(use_gan=True)`` at L=1024, B=8, learning rate
    1e-5, one warm-up epoch, no loaders; ``fused`` picks
    ``FusedOptimizer`` or the unfused chain (``GradientTransform``).
    ``d_model`` and ``layers`` shrink it for tests."""
    from ..config import TrainConfig
    from ..models.sct_transformer import SmartContractTransformer
    from ..train.trainer import SmartContractTrainer
    cfg = model_config(seq, d_model, layers, compute_dtype)
    tok = tokenizer_for(cfg)
    return SmartContractTrainer(
        SmartContractTransformer(cfg, seed=0), _NoBatches(batch_size),
        _NoBatches(batch_size), tok,
        config=TrainConfig(learning_rate=1e-5, use_gan=True, warmup_epochs=1,
                           fused_optimizer=fused),
        device=device, verbose=False)
