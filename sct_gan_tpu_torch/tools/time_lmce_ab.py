"""A/B on the card: the full train step with the fused LM-head +
cross-entropy (``TrainConfig.fused_lm_ce``) against the materialised
logits.

Port of the JAX repo's ``tools/time_lmce_ab.py``: each arm is the JAX
bench's trainer at full size (``ModelConfig(use_gan=True)``, d=768, 6+6
layers, B=8, L=1024, ``FusedOptimizer``), ``fused_lm_ce`` on or off,
built fresh and timed as the bench times its step (``bench.time_step``:
two warm-up steps, the best of two runs of ``--steps`` chained steps by
CUDA events), with the kernels' device time over one more run beside it
(``utils.profiling.trace_device``) and the port kernels' launches. Prints
the JAX tool's lines, each with the card's name and power limit, then one
JSON line whose ``speedup`` is the materialised arm's ms over the fused
one's.

    python -m sct_gan_tpu_torch.tools.time_lmce_ab [--steps 10]

``--device cpu`` with ``--d-model``, ``--layers``, ``--seq``, ``--batch``
and ``--vocab`` runs the plain versions at a small size.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from .bench import STEPS, add_size_args, emit, time_arms

ARMS = (("fused_lm_ce", dict(fused=True, fused_lm_ce=True)),
        ("materialized", dict(fused=True, fused_lm_ce=False)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_size_args(ap, vocab=True)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    res = time_arms(args, ARMS, "TrainConfig.fused_lm_ce")
    fused, dense = (res["arms"][name]["ms"] for name, _ in ARMS)
    print(f"delta: fused_lm_ce saves {dense - fused:+.1f} ms/step "
          f"[{res['card']}]", flush=True)
    res["speedup"] = dense / fused
    emit(res, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
