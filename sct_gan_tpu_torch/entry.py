"""The port's driver entry points: the root ``__graft_entry__.py``'s.

``entry()`` gives a forward step of the full-size SCT-GAN model (d=768,
8 heads of 96, 6+6 layers, the GAN head, L=1024, vocab 50265 padded to
50304, bf16 compute over f32 parameters) with its example arguments.

``dryrun_multichip(n)`` runs one full GAN train step of
``SmartContractTrainer(mesh=...)`` (forward, every loss, gradients, the
clip, Adam, the group LRs) on a dp × mp mesh of n ranks at a tiny size,
then the sequence-parallel encode of the same batch over all n ranks.
The JAX file provisions a virtual CPU mesh when it sees fewer devices than
n; the port is one process per rank, so it starts n ranks here:

  * on the card, with n cards or more: NCCL, one rank a card;
  * on the card, with fewer cards than ranks: gloo, the ranks sharing the
    cards; the step still runs on the card, through its kernels;
  * ``device="cpu"``: n gloo ranks on the CPU (the plain versions).

Without a card, either function raises unless ``device="cpu"`` is passed.

    python -m sct_gan_tpu_torch.entry [--n 8] [--device cpu]

runs ``dryrun_multichip(n)``. Nothing here imports JAX, the JAX package or
the root ``__graft_entry__.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ModelConfig, TrainConfig
from .utils import resolve_device

PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT = "result{}.json"
TIMEOUT_S = 600.0       # the whole dry-run world's limit


def _make_batch(batch_size: int, seq: int, vocab: int, ntypes: int = 8):
    """The JAX file's example batch (``__graft_entry__.py:23-37``), bit for
    bit: numpy arrays from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return {
        "input_ids": rng.integers(0, vocab, (batch_size, seq)).astype(np.int32),
        "attention_mask": np.ones((batch_size, seq), np.int32),
        "ast_input_ids": rng.integers(0, vocab, (batch_size, seq)).astype(np.int32),
        "ast_attention_mask": np.ones((batch_size, seq), np.int32),
        "token_to_line": np.minimum(
            np.arange(seq, dtype=np.int32)[None] // 4,
            seq - 1).repeat(batch_size, axis=0),
        "vulnerable_lines": rng.integers(
            0, 2, (batch_size, ntypes, seq)).astype(np.int32),
        "contract_vulnerabilities": rng.integers(
            0, 2, (batch_size, ntypes)).astype(np.int32),
    }


def entry(cfg: Optional[ModelConfig] = None, device="cuda"
          ) -> Tuple[Callable, Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]]:
    """``(fn, (params, batch))``: the forward step of
    ``__graft_entry__.entry`` and its arguments.

    ``cfg=None`` is the full-size ``ModelConfig(use_gan=True)``; a smaller
    ``cfg`` is the tests' hook. ``params`` are the model's parameters by
    name (random, from seed 0) and ``batch`` is ``_make_batch(2,
    max_length, vocab_size)`` as int64 tensors, both on ``device``.
    ``fn(params, batch)`` runs the model in eval mode (deterministic)
    through ``torch.func.functional_call``, without autograd, with the JAX
    file's arguments (``target_ids=input_ids``, ``token_to_line``), and
    returns ``(contract_vulnerability_logits, line_vulnerability_logits,
    logits, discriminator_logits)``. Any name-to-tensor dict of the
    model's parameters can stand for ``params``, such as
    ``convert_flax_params`` of a flax tree."""
    dev = resolve_device(device)
    from .models.sct_transformer import SmartContractTransformer
    cfg = cfg or ModelConfig(use_gan=True)
    model = SmartContractTransformer(cfg, seed=0).to(dev).eval()
    batch = {k: torch.from_numpy(v.astype(np.int64)).to(dev)
             for k, v in _make_batch(2, cfg.max_length,
                                     cfg.vocab_size).items()}
    params = {k: p.detach() for k, p in model.named_parameters()}

    def fn(params, batch):
        with torch.no_grad():
            out = torch.func.functional_call(
                model, params,
                (batch["input_ids"], batch["attention_mask"],
                 batch["ast_input_ids"], batch["ast_attention_mask"]),
                {"target_ids": batch["input_ids"],
                 "token_to_line": batch["token_to_line"]})
        return (out["contract_vulnerability_logits"],
                out["line_vulnerability_logits"], out["logits"],
                out["discriminator_logits"])

    return fn, (params, batch)


def tiny_config(device="cpu") -> ModelConfig:
    """The JAX file's dry-run model (``__graft_entry__.py:136-141``). Its
    f32 compute holds on the CPU; on the card it computes in bf16, the
    dtype the flash kernel takes (an f32 operand there raises)."""
    on_card = torch.device(device).type == "cuda"
    return ModelConfig(d_model=64, nhead=4, num_encoder_layers=2,
                       num_decoder_layers=2, dim_feedforward=128, dropout=0.1,
                       max_length=128, max_lines=128, vocab_size=256,
                       use_gan=True, use_flash_attention=False,
                       compute_dtype="bfloat16" if on_card else "float32")


def dryrun_trainer(cfg: ModelConfig, dp: int, mesh=None, device="cpu"):
    """The dry run's trainer and host batch (``__graft_entry__.py:
    142-156``): ``max(2 dp, 4)`` synthetic records, a loader of ``max(dp,
    2)`` rows, the model from seed 0, ``TrainConfig(learning_rate=1e-4,
    use_gan=True, use_augmentation=True, warmup_epochs=1)``, and the
    loader's first batch padded to a multiple of dp. As in the JAX file,
    the batch is not augmented: augmentation sets the loss mix only."""
    from .data.dataset import (ArrayDataLoader,
                               SmartContractVulnerabilityDataset)
    from .data.synthetic import generate_corpus
    from .data.tokenizer import SolidityTokenizer
    from .models.sct_transformer import SmartContractTransformer
    from .train.trainer import SmartContractTrainer
    tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
    records = generate_corpus(n=max(2 * dp, 4), seed=0)
    ds = SmartContractVulnerabilityDataset(records=records, tokenizer=tok,
                                           max_length=cfg.max_length)
    loader = ArrayDataLoader(ds, batch_size=max(dp, 2))
    trainer = SmartContractTrainer(
        SmartContractTransformer(cfg, seed=0), loader, loader, tok,
        config=TrainConfig(learning_rate=1e-4, use_gan=True,
                           use_augmentation=True, warmup_epochs=1),
        device=device, mesh=mesh, verbose=False)
    return trainer, trainer._pad_to_dp(next(iter(loader)))


def dryrun_multichip(n_devices: int, device="cuda",
                     cfg: Optional[ModelConfig] = None) -> Dict[str, object]:
    """One full GAN train step on a dp × mp mesh of ``n_devices`` ranks,
    then the sp = n sequence-parallel encode of its batch
    (``__graft_entry__.dryrun_multichip``); each leg asserts a finite
    result and rank 0 prints the JAX file's line. ``cfg=None`` is
    ``tiny_config``. Returns rank 0's ``{"dp", "mp", "loss", "sp",
    "memory_shape"}`` (the sp memory's global shape) and ``launches``,
    each rank's kernel launches in each leg (``step`` and ``sp_encode``;
    0 on the CPU). Raises if a rank fails, or after ``TIMEOUT_S``."""
    from .parallel.launch import run_world
    n = n_devices
    if resolve_device(device).type == "cpu":
        backend, devices = "gloo", ["cpu"] * n
    elif n <= torch.cuda.device_count():
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n)]
    else:           # ranks share the cards
        cards = torch.cuda.device_count()
        backend, devices = "gloo", [f"cuda:{r % cards}" for r in range(n)]
    cfg = cfg or tiny_config(devices[0])
    print(f"dryrun_multichip({n_devices}): {n_devices} {backend} ranks on "
          f"{', '.join(devices)}", flush=True)
    work = tempfile.mkdtemp(prefix="dryrun_")
    try:
        with open(os.path.join(work, "setup.json"), "w") as f:
            json.dump({"backend": backend, "devices": devices,
                       "config": dataclasses.asdict(cfg)}, f)
        path = os.pathsep.join(p for p in (
            PACKAGE_PARENT, os.environ.get("PYTHONPATH")) if p)
        outs = run_world(
            ["-m", "sct_gan_tpu_torch.entry", "--dryrun-rank", work],
            n_devices, os.path.join(work, "logs"), timeout_s=TIMEOUT_S,
            env={"OMP_NUM_THREADS": "2", "PYTHONPATH": path})
        for line in outs[0].splitlines():
            if line.startswith("dryrun_multichip("):
                print(line, flush=True)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(work, RESULT.format(r))) as f:
                ranks.append(json.load(f))
        return dict(ranks[0], launches=[r["launches"] for r in ranks])
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _dryrun_rank(work: str) -> int:
    """One rank of ``dryrun_multichip``'s world (``__graft_entry__.
    _dryrun_impl``): joins the world through ``work``'s rendezvous file,
    runs the two legs, and writes its result into ``work``."""
    import torch.distributed as dist
    from .parallel.launch import init_rank
    with open(os.path.join(work, "setup.json")) as f:
        setup = json.load(f)
    devices = setup["devices"]
    rank = init_rank(os.path.join(work, "rendezvous"), setup["backend"])
    if devices[rank].startswith("cuda"):
        torch.cuda.set_device(devices[rank])
    try:
        res = _dryrun(ModelConfig(**setup["config"]), devices)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, RESULT.format(rank)), "w") as f:
        json.dump(res, f)
    return 0


def _dryrun(cfg: ModelConfig, devices: Sequence[str]) -> Dict[str, object]:
    """The step and the sp encode on this rank of a world of
    ``len(devices)`` ranks."""
    from .models.sct_transformer import SmartContractTransformer
    from .parallel import make_mesh, make_sp_mesh, shard_batch, sp_encode
    from .tools.bench import kernel_launches
    n = len(devices)
    # model-parallel pairs when n is even and at least 4 (:132-133)
    mp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // mp
    mesh = make_mesh(dp=dp, mp=mp, devices=devices)
    rank0 = mesh.axis("dp").rank == 0 and mesh.axis("mp").rank == 0
    trainer, batch = dryrun_trainer(cfg, dp, mesh=mesh)
    device_batch = shard_batch(batch, mesh)
    before = kernel_launches()
    state, metrics, _ = trainer.train_step(
        trainer.state, device_batch, trainer._scalars(1.0),
        trainer._group_lrs(), trainer.generator)
    total = float(metrics["total_loss"])
    step = kernel_launches()
    if not np.isfinite(total):
        raise AssertionError(f"multichip step produced {total}")
    if rank0:
        print(f"dryrun_multichip({n}): mesh dp={dp} mp={mp}, "
              f"loss={total:.4f} OK", flush=True)

    # the sequence-parallel leg on the stepped weights, whole on every rank
    whole = trainer._whole(state.params)
    model = SmartContractTransformer(cfg, seed=None)
    model.load_state_dict({**model.state_dict(), **whole})
    model.to(mesh.device)
    sp_mesh = make_sp_mesh(sp=n, dp=1, devices=devices)
    with torch.no_grad():
        mem = sp_encode(model, batch["input_ids"], batch["attention_mask"],
                        batch["ast_input_ids"], batch["ast_attention_mask"],
                        sp_mesh)
    after = kernel_launches()
    if not bool(torch.isfinite(mem.float()).all()):
        raise AssertionError("sp_encode produced non-finite memory")
    shape = (mem.shape[0], mem.shape[1] * n, mem.shape[2])
    if rank0:
        print(f"dryrun_multichip({n}): sp={n} sequence-parallel encode "
              f"{shape} OK", flush=True)
    return {"dp": dp, "mp": mp, "loss": total, "sp": n,
            "memory_shape": list(shape),
            "launches": {"step": {k: step[k] - before[k] for k in step},
                         "sp_encode": {k: after[k] - step[k] for k in step}}}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8,
                    help="ranks of the dry run (the JAX file's 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--dryrun-rank", metavar="WORK_DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun_rank:
        return _dryrun_rank(args.dryrun_rank)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
