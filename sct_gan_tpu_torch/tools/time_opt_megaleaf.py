"""How much of the optimizer stage is per-leaf launch overhead: the same
chain over one leaf of the model's whole element count.

Port of the JAX repo's ``tools/time_opt_megaleaf.py``. The chain is the
JAX tool's: clip by global norm 1.0, Adam (β = (0.9, 0.98), ε = 1e-9),
+ 0.1·p, × −5e-5, and keep the old state unless the norm is finite and
at most 1000. It runs as the port's ``GradientTransform`` stages over
leaves whose names put them in no clip set, the group learning rate 5e-5:
the vulnerability set's clip then sees a zero norm and passes every
gradient unchanged, so the stages compute the JAX chain
(``tests/test_torch_step_tools.py`` holds them to optax's).

  * mega: one f32 leaf of ones x 1e-3 holding as many elements as the
    port model's parameters, counted at run time (the JAX tool fixes
    139 M, its tree's size on the TPU);
  * tree: the same chain over the model's parameters (405 leaves at the
    JAX tools' width), each under a neutral name;
  * fused: ``FusedOptimizer`` over the same parameters as the trainer
    builds it (their names, groups and clip sets), for reference.

Each stage synthesises its gradients from the parameters (``p * 1e-3 +
seed * 1e-9``, ``time_opt.optimizer_stage``) and is timed as
``time_opt`` times one (``time_opt.time_stages``: one warm-up stage, the
best of 2 runs of 10 by CUDA events; the launches, the device kernels of
one stage in a whole ``torch.profiler`` trace). The JAX tool compares
the mega-leaf with 18.5 ms, its tree's time on the TPU; here the tree's
time is measured in the same run.

    python -m sct_gan_tpu_torch.tools.time_opt_megaleaf

``--device cpu`` with ``--d-model``, ``--layers`` and ``--vocab`` runs it
at a small size on the host clock. Prints the JAX tool's line, one line
an arm, each with the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from ..utils import resolve_device
from .bench import card_or_device, emit, free_memory
from .time_opt import optimizer_stage, time_stages

LR = 5e-5           # the chain's optax.scale(-5e-5)


def chain(named_params, lr: float = LR):
    """(the JAX tool's chain as ``GradientTransform`` stages over
    ``named_params``, its state, its learning rates): the names must be in
    no clip set and no group but the base one."""
    from ..train.optimizer import GradientTransform, GroupLRs, leaf_meta
    named = list(named_params)
    for name, _ in named:
        meta = leaf_meta(name, use_gan=False)
        if meta.group or meta.vuln_clip or meta.fusion:
            raise ValueError(f"{name!r} is in a group or a clip set")
    opt = GradientTransform(named, use_gan=False)
    return opt, opt.init(), GroupLRs.init(lr)


def arm(opt, state, lrs, device: torch.device) -> Dict[str, object]:
    row = time_stages(optimizer_stage(opt, state, lrs, opt.params), device)
    row.update(leaves=len(opt.params),
               elements=sum(p.numel() for p in opt.params),
               optimizer=type(opt).__name__)
    return row


def run(args) -> Dict[str, object]:
    from ..models.sct_transformer import SmartContractTransformer
    from ..train.optimizer import FusedOptimizer, GroupLRs
    from ._common import model_config
    device = resolve_device(args.device)
    card = card_or_device(device)
    model = SmartContractTransformer(
        model_config(args.seq, args.d_model, args.layers, vocab=args.vocab),
        seed=0).to(device)
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    rows: Dict[str, Dict[str, object]] = {}

    print(f"mega-leaf of {n:,} f32 elements [{card}]", flush=True)
    mega = torch.full((n,), 1e-3, dtype=torch.float32, device=device)
    rows["mega"] = arm(*chain([("mega", mega)]), device)
    del mega
    free_memory()
    rows["tree"] = arm(*chain(
        (f"leaf{i}", p) for i, p in enumerate(params)), device)
    free_memory()
    fused = FusedOptimizer(model.named_parameters(), use_gan=True)
    rows["fused"] = arm(fused, fused.init(), GroupLRs.init(LR),
                        device)
    for name, r in rows.items():
        launches = "" if r["launches"] is None else (
            f", {r['launches']} launches a stage")
        print(f"{name}: {r['optimizer']} over {r['leaves']} leaves, "
              f"{r['ms']:.3f} ms{launches} [{card}]", flush=True)
    print(f"mega-leaf optimizer stage: {rows['mega']['ms']:.1f} ms (vs "
          f"{rows['tree']['ms']:.1f} ms on the {rows['tree']['leaves']:,}"
          f"-leaf tree) [{card}]", flush=True)
    return {"card": card, "device": str(device), "elements": n,
            "timing": "CUDA events" if device.type == "cuda"
            else "host clock", "arms": rows}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--vocab", type=int, default=50265)
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
