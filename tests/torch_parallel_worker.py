"""The ranks of the port's gloo test worlds (``test_torch_parallel_*.py``).

    python tests/torch_parallel_worker.py <case> <work dir>

runs one rank of ``case`` (``RANK`` and ``WORLD_SIZE`` in the environment,
as ``parallel.launch.run_world`` sets them) on the CPU. The test that
starts the world writes the model configuration (``cfg.json``), its
weights (``weights.pt``) and the inputs (``inputs.pt``) into the work dir;
each rank writes what it computed to ``out<rank>.pt``, and the test holds
that against the single-card port and the JAX package. This module imports
torch and the port only, never JAX or the tests' conftest.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sct_gan_tpu_torch import (SmartContractAnalyzer,  # noqa: E402
                               SmartContractTrainer, SmartContractTransformer)
from sct_gan_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from sct_gan_tpu_torch.data import create_dataloaders  # noqa: E402
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer  # noqa: E402
from sct_gan_tpu_torch.losses.syntax import SyntaxLossTables  # noqa: E402
from sct_gan_tpu_torch.ops.fused_ce import \
    fused_linear_cross_entropy  # noqa: E402
from sct_gan_tpu_torch.parallel import (make_mesh, make_sp_mesh,  # noqa: E402
                                        shard_batch, shard_params, sp_detect,
                                        sp_encode)
from sct_gan_tpu_torch.parallel.collectives import (  # noqa: E402
    all_gather, all_reduce_, copy_to, gather_rows, gather_seq, reduce_from)
from sct_gan_tpu_torch.parallel.launch import init_rank, run_world  # noqa
from sct_gan_tpu_torch.parallel.mesh import param_shard_dims  # noqa: E402
from sct_gan_tpu_torch.parallel.sequence import _whole_memory  # noqa: E402
from sct_gan_tpu_torch.train.optimizer import (  # noqa: E402
    FusedOptimizer, GradientTransform, GroupLRs)
from sct_gan_tpu_torch.train.train_step import (  # noqa: E402
    DynamicScalars, TrainState, compute_losses, make_train_step)

SCALARS = (5.0, 3.0, 0.25, 2.0, 0.2)
LR = 1e-3


# -- the test side ------------------------------------------------------------

def launch(case: str, world: int, work: str, *, cfg: ModelConfig,
           weights=None, inputs=None, timeout_s: float = 300.0):
    """Write the case's files into ``work``, run its world (every
    collective times out after 120 s, the world after ``timeout_s``), and
    return each rank's output dict."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    torch.save(weights or {}, os.path.join(work, "weights.pt"))
    torch.save(inputs or {}, os.path.join(work, "inputs.pt"))
    # a few threads a rank: the ranks share the host's cores
    run_world([os.path.abspath(__file__), case, work], world,
              os.path.join(work, "logs"), timeout_s=timeout_s,
              env={"OMP_NUM_THREADS": "2"})
    return [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def model_from(cfg: ModelConfig, weights) -> SmartContractTransformer:
    model = SmartContractTransformer(cfg, seed=None)
    model.load_state_dict(weights)
    return model


def train_step_run(model, batch, *, fused: bool = True, mesh=None,
                   generator_seed: int = 0, fused_lm_ce: bool = True):
    """One dropout-on train step of ``model`` (parallelized or not) on
    ``batch``: (metrics as floats, the updated parameters by name, Adam's
    moments ``{"mu": {name: t}, "nu": {name: t}}``). ``fused`` picks the
    optimizer, ``fused_lm_ce`` the LM cross-entropy."""
    opt_cls = FusedOptimizer if fused else GradientTransform
    kw = {}
    if mesh is not None:
        dims = param_shard_dims(model.config, mesh)
        kw = dict(mp=mesh.axis("mp"),
                  sharded=[n for n, d in dims.items() if d is not None])
    opt = opt_cls(model.named_parameters(), use_gan=True, **kw)
    tables = SyntaxLossTables.from_tokenizer(
        SolidityTokenizer(vocab_size=model.config.vocab_size))
    step = make_train_step(model, opt, tables, use_gan=True,
                           use_augmentation=False, fused_lm_ce=fused_lm_ce)
    state = TrainState(dict(model.named_parameters()), opt.init(), 0)
    state, metrics, _ = step(state, batch, DynamicScalars.make(*SCALARS),
                             GroupLRs.init(LR),
                             torch.Generator().manual_seed(generator_seed))
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.detach().clone() for n, p in model.named_parameters()},
            moments(state.opt_state))


def moments(opt_state):
    """Copies of Adam's moments, ``{"mu": {name: t}, "nu": {name: t}}``."""
    return {k: {n: t.detach().clone() for n, t in opt_state[k].items()}
            for k in ("mu", "nu")}


def deterministic_losses(model, batch, fused_lm_ce: bool = True):
    """compute_losses with dropout off, and the gradient (summed over dp
    under a mesh): (metrics as floats, gradients by name)."""
    tables = SyntaxLossTables.from_tokenizer(
        SolidityTokenizer(vocab_size=model.config.vocab_size))
    total, (m, *_) = compute_losses(
        model, batch, DynamicScalars.make(*SCALARS), None, use_gan=True,
        use_augmentation=False, tables=tables, deterministic=True,
        fused_lm_ce=fused_lm_ce)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in
                                        model.named_parameters()],
                                allow_unused=True)
    grads = {n: (torch.zeros_like(p) if g is None else g) for n, g, p in
             zip(names, grads, model.parameters())}
    if model.mesh is not None:
        for g in grads.values():
            all_reduce_(g, model.mesh.axis("dp"))
    return {k: float(v.detach()) for k, v in m.items()}, grads


# -- the rank side ------------------------------------------------------------

def _whole(tensors, cfg, mesh):
    """Copies of parameter-shaped tensors, the mp shards gathered."""
    dims = param_shard_dims(cfg, mesh)
    mp = mesh.axis("mp")
    out = {}
    for n, t in tensors.items():
        t, d = t.detach(), dims[n]
        out[n] = (t.clone() if d is None else
                  all_gather(t.transpose(0, d), mp).transpose(0, d))
    return out


def case_mesh(rank, world, cfg, weights, inputs):
    cpu = ["cpu"] * world
    out = {}
    mesh = make_mesh(dp=2, devices=cpu)
    out["shape"] = mesh.shape
    out["dp_rank"] = mesh.axis("dp").rank
    for bad in ((4, 1), (1, 1)):
        try:
            make_mesh(dp=bad[0], mp=bad[1], devices=cpu)
        except ValueError as e:
            out[f"error_{bad[0]}x{bad[1]}"] = str(e)
    batch = {"a": np.arange(8).reshape(4, 2), "f": np.ones((4, 3), np.float32),
             "source_code": ["x"] * 4}
    sb = shard_batch(batch, mesh)
    out["batch_keys"] = sorted(sb)
    out["rows"] = sb["a"]
    out["rows_dtype"] = str(sb["a"].dtype)

    dp = mesh.axis("dp")
    w = torch.arange(12, dtype=torch.float32).view(6, 2)
    x = (torch.arange(6, dtype=torch.float32).view(3, 2) * (rank + 1)
         ).requires_grad_()
    g = gather_seq(x, dp)
    out["gather_seq"] = g.detach()
    (gx,) = torch.autograd.grad((g * w).sum(), x)
    out["gather_seq_grad"] = gx
    (gx,) = torch.autograd.grad((gather_rows(x, dp) * w).sum(), x)
    out["gather_rows_grad"] = gx
    (gx,) = torch.autograd.grad((copy_to(x, dp) * (rank + 1)).sum(), x)
    out["copy_to_grad"] = gx
    y = reduce_from(x, dp)
    out["reduce_from"] = y.detach()
    (gx,) = torch.autograd.grad((y * w[:3]).sum(), x)
    out["reduce_from_grad"] = gx

    mp_mesh = make_mesh(dp=1, mp=2, devices=cpu)
    local = shard_params(weights, mp_mesh, cfg)
    out["local_shapes"] = {n: tuple(t.shape) for n, t in local.items()}
    out["whole_again"] = all(torch.equal(t, weights[n]) for n, t in
                             _whole(local, cfg, mp_mesh).items())
    return out


def case_sp(rank, world, cfg, weights, inputs):
    cpu = ["cpu"] * world
    out = {}
    model = model_from(cfg, weights)
    ids = [inputs[k] for k in ("input_ids", "attention_mask",
                               "ast_input_ids", "ast_attention_mask")]
    mesh = make_sp_mesh(sp=world, devices=cpu)
    with torch.no_grad():
        mem = sp_encode(model, *ids, mesh)
        out["local_shape"] = tuple(mem.shape)
        out["encode"] = _whole_memory(mem, mesh, "sp")
    mem = sp_encode(model, *ids, mesh)
    loss = (mem.float() ** 2).sum() / (mem.numel() * world)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    out["grads"] = {n: all_reduce_(torch.zeros_like(p) if g is None else g,
                                   mesh.axis("sp"))
                    for n, g, p in zip(names, grads, model.parameters())}
    if world == 4:
        mesh22 = make_sp_mesh(sp=2, dp=2, devices=cpu)
        with torch.no_grad():
            out["encode_2x2"] = _whole_memory(sp_encode(model, *ids, mesh22),
                                              mesh22, "sp")
            long_ids = [inputs[k] for k in ("long_ids", "long_mask",
                                            "long_ids", "long_mask")]
            n = long_ids[0].shape[1]
            out["encode_long"] = _whole_memory(sp_encode(
                model, *long_ids, mesh, max_length=n), mesh, "sp")
        c, l = sp_detect(model, inputs, mesh)
        out["detect"] = (c, l)
        attn = model.encoder.layer_0.self_attn
        h = torch.zeros(2, 8, cfg.d_model)
        try:
            with model.sequence_parallel(mesh.axis("sp")):
                attn(h, h, h, causal=True)
            out["causal"] = "ran"
        except NotImplementedError as e:
            out["causal"] = str(e)
    return out


def case_dp(rank, world, cfg, weights, inputs):
    cpu = ["cpu"] * world
    out = {}
    mesh = make_mesh(dp=world, devices=cpu)
    batch = inputs["batch"]
    drop_cfg = dataclasses.replace(cfg, dropout=0.1)
    model = model_from(drop_cfg, weights).parallelize_(mesh)
    out["step"] = train_step_run(model, shard_batch(batch, mesh), mesh=mesh)
    model = model_from(drop_cfg, weights).parallelize_(mesh)
    out["step_ce_unfused"] = train_step_run(
        model, shard_batch(batch, mesh), mesh=mesh, fused_lm_ce=False)
    model = model_from(cfg, weights).parallelize_(mesh)
    out["losses"] = deterministic_losses(model, shard_batch(batch, mesh))
    out["losses_ce_unfused"] = deterministic_losses(
        model, shard_batch(batch, mesh), fused_lm_ce=False)

    tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
    tr, va = create_dataloaders(inputs["corpus"], tok, batch_size=3,
                                max_length=cfg.max_length)
    trainer = SmartContractTrainer(
        model_from(drop_cfg, weights), tr, va, tok,
        config=TrainConfig(learning_rate=LR, use_gan=True, warmup_epochs=1),
        mesh=mesh, seed=7, verbose=False)
    out["history"] = trainer.train(1, checkpoint_dir=inputs["ckpt"])
    out["trained"] = {n: p.detach().clone()
                      for n, p in trainer.model.named_parameters()}
    out["trained_moments"] = moments(trainer.state.opt_state)

    an = SmartContractAnalyzer(model_config=cfg, tokenizer=tok,
                               params=weights, batch_size=2, verbose=False,
                               mesh=mesh)
    out["analysis"] = an.analyze_multiple_contracts(inputs["codes"],
                                                    threshold=0.5)
    return out


def case_mp(rank, world, cfg, weights, inputs):
    cpu = ["cpu"] * world
    out = {}
    mesh = make_mesh(dp=world // 2, mp=2, devices=cpu)
    batch = shard_batch(inputs["batch"], mesh)
    drop_cfg = dataclasses.replace(cfg, dropout=0.1)
    for fused in (True, False):
        model = model_from(drop_cfg, weights).parallelize_(mesh)
        metrics, params, mom = train_step_run(model, batch, fused=fused,
                                              mesh=mesh)
        out["step" if fused else "step_unfused"] = (
            metrics, _whole(params, cfg, mesh),
            {k: _whole(v, cfg, mesh) for k, v in mom.items()})
    # the fused optimizer over the unfused LM cross-entropy
    model = model_from(drop_cfg, weights).parallelize_(mesh)
    metrics, params, mom = train_step_run(model, batch, mesh=mesh,
                                          fused_lm_ce=False)
    out["step_ce_unfused"] = (metrics, _whole(params, cfg, mesh),
                              {k: _whole(v, cfg, mesh) for k, v in
                               mom.items()})
    out["q_proj_shape"] = tuple(
        model.encoder.layer_0.self_attn.q_proj.weight.shape)
    out["embedding_shape"] = tuple(model.embedding.weight.shape)
    model = model_from(cfg, weights).parallelize_(mesh)
    for key, fused_ce in (("losses", True), ("losses_ce_unfused", False)):
        metrics, grads = deterministic_losses(model, batch, fused_ce)
        out[key] = (metrics, _whole(grads, cfg, mesh))

    # the vocab-parallel CE against the plain one, on every rank
    g = torch.Generator().manual_seed(3)
    hidden = torch.randn(2, 16, 8, generator=g)
    w = torch.randn(64, 8, generator=g) * 0.3
    bias = torch.randn(64, generator=g) * 0.1
    t = torch.randint(0, 60, (2, 16), generator=g)
    rows = torch.tensor([1.0, 0.0])
    mp = mesh.axis("mp")
    n = 64 // mp.size
    leaves = [a.clone().requires_grad_() for a in (hidden, w[mp.rank * n:
                                                             (mp.rank + 1) * n],
                                                   bias)]
    got = fused_linear_cross_entropy(*leaves, t, rows, 60, mp)
    grads = torch.autograd.grad(2.0 * got, leaves)
    plain = [a.clone().requires_grad_() for a in (hidden, w, bias)]
    want = fused_linear_cross_entropy(*plain, t, rows, 60)
    want_g = torch.autograd.grad(2.0 * want, plain)
    if "corpus" in inputs:      # checkpoints across layouts
        tok = SolidityTokenizer(vocab_size=cfg.vocab_size)
        tr, va = create_dataloaders(inputs["corpus"], tok, batch_size=3,
                                    max_length=cfg.max_length)
        trainer = SmartContractTrainer(
            model_from(drop_cfg, weights), tr, va, tok,
            config=TrainConfig(learning_rate=LR, use_gan=True,
                               warmup_epochs=1),
            mesh=mesh, seed=7, verbose=False)
        trainer.restore(inputs["one_rank_ckpt"])
        out["restored"] = _whole(dict(trainer.model.named_parameters()), cfg,
                                 mesh)
        trainer.train(1, checkpoint_dir=inputs["ckpt"])
        out["trained"] = _whole(dict(trainer.model.named_parameters()), cfg,
                                mesh)
    out["ce"] = (float(got), float(want),
                 [(a - b).abs().max().item() for a, b in zip(
                     grads, (want_g[0], want_g[1][mp.rank * n:
                                                  (mp.rank + 1) * n],
                             want_g[2]))])
    return out


CASES = {"mesh": case_mesh, "sp": case_sp, "dp": case_dp, "mp": case_mp}


def main() -> int:
    case, work = sys.argv[1], sys.argv[2]
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    rank = init_rank(os.path.join(work, "rendezvous"), "gloo", 120.0)
    world = dist.get_world_size()
    with open(os.path.join(work, "cfg.json")) as f:
        cfg = ModelConfig(**json.load(f))
    weights = torch.load(os.path.join(work, "weights.pt"))
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = CASES[case](rank, world, cfg, weights, inputs)
    torch.save(out, os.path.join(work, f"out{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
