"""Entry points of the port: the JAX repo's ``tools/`` scripts.

Kernel timing, the JAX repo's ``tools/time_*`` kernel decompositions, one
hand-written CUDA kernel each (``csrc/``):

  time_flash_parts            K7: flash forward, full vs noexp vs mmonly
  time_flash_variants         K8: single-pass softmax variants
  time_decode_kernel_variants K9: decode-attention blocking, v1 v2 v3
  time_dropout_kernel         K10: dropout draws against a copy

Each module holds its kernel's wrapper (a CPU tensor runs the plain
PyTorch version, a CUDA tensor the kernel), the plain version,
``time_modes()`` and ``main()``. They measure the card and raise without
one.

Training and evaluation, with the JAX tools' flags plus ``--device``:

  train_synthetic    train on the synthetic corpus (``--corpus-v2``: one
                     template family), score the best checkpoint
  eval_checkpoint    the eval tail of a CSV-mode run, on its own
  eval_v2_infamily   a corpus-v2 checkpoint on fresh family-0 contracts
  analyze_v2_errors  per-type TP/FP/FN, score separations, confusions
  time_opt           the optimizer stage alone, unfused or ``--fused``
  run_corpus_v2      the corpus-v2 Run B recipe through all five

The benchmark and step attribution, the JAX repo's root ``bench.py`` and
its measurement tools, with the JAX tools' options plus ``--device`` and
the model's size (``--d-model``, ``--layers``, ``--seq``, ``--batch``):

  bench             the headline: fused train step tokens/s, vs_baseline
                    against an in-run f32 dense-attention step, decode at
                    B=64
  quick_bench       the fused step and decode only
  bench_decode      full-length KV-cached generation throughput
  peak_matmul       the card's achievable bf16 TFLOP/s and HBM GB/s
  time_fwd          the train step against the eval (forward-only) step
  time_decode       one decode step alone against full-length generation
  time_fwd_modules  forward (and ``--grad`` backward) ms of each stage
  time_lmce         the LM head + mean CE: dense, chunked, fused
  time_lmce_parts   the fused CE's backward in pieces (products, dlogits)
  time_flash_real   K1 and the backward pair at training shape, with and
                    without dropout
  time_layer        one encoder layer's forward + backward under variants
                    and its matmul floor
  time_decode_parts the decode loop's step: decoder layers, LM head and
                    sampler, embedding; host ms and launches a step
  time_host_prep    the trainer's host preparation per epoch, with and
                    without the augmentation bank

They run on the card by default and raise without one; ``--device cpu``
runs the plain versions. Run any of them as

    python3 -m sct_gan_tpu_torch.tools.<name>
"""

__all__ = [
    "time_flash_parts", "time_flash_variants", "time_decode_kernel_variants",
    "time_dropout_kernel",
    "train_synthetic", "eval_checkpoint", "eval_v2_infamily",
    "analyze_v2_errors", "time_opt", "run_corpus_v2", "sweep_flash_blocks",
    "bench", "quick_bench", "bench_decode", "peak_matmul", "time_fwd",
    "time_decode", "time_fwd_modules", "time_lmce", "time_lmce_parts",
    "time_flash_real", "time_layer", "time_decode_parts", "time_host_prep",
]
