"""The port's step tools (``sct_gan_tpu_torch/tools``: ``profile_step``,
``time_opt_ab``, ``time_lmce_ab``, ``time_opt_megaleaf``, ``ablate_step``,
``time_dispatch``, ``ab_aug_labels``, ``ab_contract_dilution``) and the
one reading of ``torch.profiler`` (``utils.profiling.trace_device``) on the
CPU, at a tiny size, inputs from a numpy seed:

  * every tool's ``main``, through ``chip_smoke.phase_step_tools`` at
    ``chip_smoke.STEP_TOOLS_CPU``, prints the JAX tool's line prefixes and
    a JSON line whose numbers are finite and positive (launch counts are
    0 on the CPU, and checked so);
  * ``ablate_step``'s loss, gradients and one AdamW update under each of
    the six ablations against the loss and chain the JAX tool builds
    (``tools/ablate_step.py:84-148``: ``models.sct_transformer``,
    ``losses.focal``, ``losses.syntax``, ``optax``) on weights carried
    across by ``convert.py``, f32, dropout off on both sides (the two
    frameworks draw different masks): the loss to 1e-4 relative, the
    gradients to 1e-4, every updated parameter to 1e-5 absolute; under
    ``no_embed_grad`` the embedding tables get no gradient and are
    decayed bit for bit as ``adamw`` decays a zero-gradient leaf;
  * ``time_opt_megaleaf``'s chain (``GradientTransform`` stages) on a
    small leaf against the JAX tool's optax chain, three stages, 1e-6
    relative;
  * ``time_dispatch``'s graph-parity comparison: bit-for-bit parameters
    pass, an update off by more than ``PARITY_RTOL`` raises;
  * ``trace_device`` (C7's repair): a trace whose port-kernel records fall
    short of the launch counters, or whose primers were all lost, is
    profiled again, and past ``TRACES`` runs it raises.

On the card (``cuda``-marked, in ``test_torch_step_tools_cuda.py``, which
imports no JAX): the graph's parity and ``trace_device`` against the
launch counters.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from sct_gan_tpu.config import ModelConfig as JaxModelConfig
from sct_gan_tpu.data.tokenizer import SolidityTokenizer as JaxTokenizer
from sct_gan_tpu.losses.focal import (contract_level_focal_loss,
                                      spatial_aware_focal_loss)
from sct_gan_tpu.losses.syntax import (SyntaxLossTables, cross_entropy_loss,
                                       solidity_syntax_loss)
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu_torch import convert_flax_params
from sct_gan_tpu_torch.config import ModelConfig
from sct_gan_tpu_torch.tools import ablate_step, time_dispatch
from sct_gan_tpu_torch.tools.time_opt import optimizer_stage
from sct_gan_tpu_torch.tools.time_opt_megaleaf import chain
from sct_gan_tpu_torch.utils import profiling
from test_torch_model import flax_params


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread while this file runs (the tools make
    many tiny ops; see ``test_torch_bench.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- every tool's main, through the smoke's phase -----------------------------

JAX_LINES = {
    "profile_step": ("== ", "-- CPU  (sum "),
    "time_opt_ab": ("[fused_tree] ", "[optax_chain] ",
                    "fused tree optimizer saves "),
    "time_lmce_ab": ("[fused_lm_ce] ", "[materialized] ",
                     "delta: fused_lm_ce saves "),
    "time_opt_megaleaf": ("mega-leaf optimizer stage: ",),
    "ablate_step": (*(f"{name:16s} " for name in ablate_step.ABLATIONS),
                    "deltas vs full:"),
    "time_dispatch": ("trivial dispatch: ", "matmul dispatch:  ",
                      "train step, 2 separate dispatches: "),
    "ab_aug_labels": ("arm A: ", "arm B: ", "  [quirk] epoch 0: ",
                      "  [correct] contract PR-AUC ", "RESULT quirk "),
    "ab_contract_dilution": ("arm A: ", "arm B: ", "  [short] epoch 0: ",
                             "  [long] contract PR-AUC ", "RESULT short "),
}


@pytest.fixture(scope="module")
def phase_output():
    """``phase_step_tools`` on the CPU at the tiny sizes, its stdout split
    at each JSON line (one a tool, in ``STEP_TOOLS_CPU``'s order)."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        counts = chip_smoke.phase_step_tools(
            "cpu", chip_smoke.STEP_TOOLS_CPU, device="cpu")
    runs, lines = [], []
    for line in out.getvalue().splitlines():
        if line.startswith("{"):
            runs.append((lines, json.loads(line)))
            lines = []
        elif not line.startswith("phase step tools"):
            lines.append(line)
    return counts, dict(zip((n for n, _ in chip_smoke.STEP_TOOLS_CPU),
                            runs))


def test_phase_rehearses_on_the_cpu(phase_output):
    counts, runs = phase_output
    assert counts == dict.fromkeys(chip_smoke.KERNELS, 0)
    assert list(runs) == list(JAX_LINES)


@pytest.mark.parametrize("name", list(JAX_LINES))
def test_main_prints_the_jax_tools_lines(phase_output, name):
    lines, res = phase_output[1][name]
    for prefix in JAX_LINES[name]:
        assert any(line.startswith(prefix) for line in lines), prefix
    assert chip_smoke._numbers(res) and not chip_smoke.bad_numbers(res)


def test_step_tool_launch_check_refuses_a_count_off_the_config():
    """``step_tool_launch_errors`` on card-like ``ablate_step`` rows at the
    JAX tools' config (F = 23 K1 calls a step): the config's counts pass,
    one pair call less does not, nor a K6 count in ``no_dropout``."""
    k = dict.fromkeys(chip_smoke.KERNELS, 0)
    f = 23

    def row(fwd, bwd, drop, steps=2):
        return {"steps": steps, "launches": {
            **k, "flash_attention_fwd": fwd * steps,
            "flash_attention_bwd": bwd * steps, "dropout": drop * steps}}
    res = {"ablations": {
        "full": row(f, f, 138), "no_heads": row(f - 2, f - 3, 120),
        "no_dropout": row(f, f, 0)}}

    def total():
        return {key: sum(r["launches"][key] for r in res["ablations"]
                         .values()) for key in k}
    assert chip_smoke.step_tool_launch_errors(
        "ablate_step", res, total(), True) == []
    res["ablations"]["no_heads"]["launches"]["flash_attention_bwd"] -= 1
    assert chip_smoke.step_tool_launch_errors(
        "ablate_step", res, total(), True)
    res["ablations"]["no_heads"] = row(f - 2, f - 3, 120)
    res["ablations"]["no_dropout"] = row(f, f, 6)
    assert chip_smoke.step_tool_launch_errors(
        "ablate_step", res, total(), True)


# -- ablate_step against the JAX tool's step ----------------------------------

JCFG = JaxModelConfig(d_model=32, nhead=4, num_encoder_layers=1,
                      num_decoder_layers=1, dim_feedforward=64, dropout=0.0,
                      max_length=32, max_lines=32, vocab_size=256,
                      use_gan=True, compute_dtype="float32",
                      use_flash_attention=False)
CFG = ModelConfig(d_model=32, nhead=4, num_encoder_layers=1,
                  num_decoder_layers=1, dim_feedforward=64, dropout=0.0,
                  max_length=32, max_lines=32, vocab_size=256, use_gan=True,
                  compute_dtype="float32")
LR = 1e-5


# the JAX tool's loss branches as weights of its terms (gen, CE alone,
# contract, line, discriminator) and whether the tables stop their
# gradient: one compile serves the six ablations. Its ``no_heads`` passes
# ``token_to_line=None`` (no line head); here the line head runs with
# weight 0, which leaves the loss and every gradient as they are. With
# dropout off, ``no_dropout`` is ``full``.
MIX = {"full": (0.5, 0, 0.75, 0.2, 0.05, 0),
       "no_embed_grad": (0.5, 0, 0.75, 0.2, 0.05, 1),
       "ce_only_loss": (0, 1, 0, 0, 0, 0),
       "no_line_loss": (0.5, 0, 0.75, 0, 0.05, 0),
       "no_heads": (0, 1, 0, 0, 0, 0),
       "no_dropout": (0.5, 0, 0.75, 0.2, 0.05, 0)}


@jax.jit
def jax_step(params, batch, mix):
    """(loss, gradients, new params): one step of the JAX tool's
    ``make_step`` (``tools/ablate_step.py:84-148``) from ``params``, its
    loss terms weighted by ``mix``, dropout off."""
    model = JaxModel(JCFG)
    tables = SyntaxLossTables.from_tokenizer(
        JaxTokenizer(vocab_size=JCFG.vocab_size))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(LR, b1=0.9, b2=0.98, eps=1e-9,
                                 weight_decay=0.1))
    w_gen, w_ce, w_contract, w_line, w_disc, stop = mix

    def loss_fn(p):
        p = dict(p)
        for k in ("embedding", "ast_embedding"):
            p[k] = jax.tree_util.tree_map(
                lambda x: stop * jax.lax.stop_gradient(x) + (1 - stop) * x,
                p[k])
        outputs = model.apply(
            {"params": p}, batch["input_ids"], batch["attention_mask"],
            batch["ast_input_ids"], batch["ast_attention_mask"],
            target_ids=batch["input_ids"],
            token_to_line=batch["token_to_line"], deterministic=True)
        ce = cross_entropy_loss(outputs["logits"], outputs["target_ids"])
        gen_loss, _, _ = solidity_syntax_loss(
            outputs["logits"], outputs["target_ids"], tables)
        contract_loss = contract_level_focal_loss(
            outputs["contract_vulnerability_logits"],
            batch["contract_vulnerabilities"].astype(jnp.float32),
            alpha=0.05, gamma=4.0)
        line_labels = batch["vulnerable_lines"].transpose(
            0, 2, 1).astype(jnp.float32)
        line_loss = spatial_aware_focal_loss(
            outputs["line_vulnerability_logits"], line_labels,
            batch["token_to_line"], alpha=0.1, gamma=1.5, spatial_weight=0.1)
        disc = outputs["discriminator_logits"]
        disc_loss = optax.sigmoid_binary_cross_entropy(
            disc, jnp.ones_like(disc)).mean()
        return (w_gen * gen_loss + w_ce * ce + w_contract * contract_loss
                + w_line * line_loss + w_disc * disc_loss)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return loss, grads, optax.apply_updates(params, updates)


@pytest.fixture(scope="module")
def weights():
    params = flax_params(JCFG, seed=3)
    batch = ablate_step.make_batch(2, JCFG.max_length, JCFG.vocab_size)
    return params, batch


@pytest.mark.parametrize("name", list(ablate_step.ABLATIONS))
def test_ablation_matches_the_jax_tools_step(weights, name):
    """Dropout off on both sides (the port's ``no_dropout``, JAX's
    ``deterministic=True``): the two frameworks draw different masks, and
    the line heads' sites keep a fixed rate of 0.1 whatever the config's.
    The loss (1e-4), every gradient (1e-4 relative, and 1e-4 of the
    largest gradient entry absolute: a key projection's bias has an
    analytic gradient of 0 and a float one of rounding noise; zero in JAX
    where the port has none), and the update of
    ``ablate_step.AdamW`` from JAX's gradients (its None where the port's
    is None) against optax's, 1e-5 absolute: Adam's first step is about
    lr x sign(g), so the whole step's parameters would differ by 2 lr
    where a near-zero gradient's sign differs between the frameworks."""
    params, batch = weights
    want_loss, want_g, want_p = jax_step(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(MIX[name], jnp.float32))
    step = ablate_step.AblatedStep(
        CFG, batch, "cpu", state_dict=convert_flax_params(params, CFG),
        lr=LR, **dict(ablate_step.ABLATIONS[name], no_dropout=True))
    old = {n: p.detach().clone() for n, p in zip(step.names, step.params)}
    loss, grads = step.loss_and_grads()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    want_g = convert_flax_params(want_g, CFG)
    top = max(float(g.abs().max()) for g in want_g.values())
    for n, g in zip(step.names, grads):
        w = want_g[n].numpy()
        if g is None:
            assert not w.any(), n
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * top, err_msg=n)
    step.opt.update([None if g is None else want_g[n]
                     for n, g in zip(step.names, grads)])
    want_p = convert_flax_params(want_p, CFG)
    for n, p in zip(step.names, step.params):
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                   rtol=0, atol=1e-5, err_msg=n)
    if name == "no_embed_grad":     # decayed, as adamw decays a zero grad
        for n in ("embedding.weight", "ast_embedding.weight"):
            p = dict(zip(step.names, step.params))[n]
            assert not torch.equal(p, old[n])
            assert torch.equal(p, want_p[n]), n


# -- the mega-leaf chain against optax ----------------------------------------

def test_megaleaf_chain_matches_optax():
    """``time_opt_megaleaf.chain`` over one leaf, three stages of
    ``time_opt.optimizer_stage`` (gradients ``p * 1e-3 + seed * 1e-9``),
    against the JAX tool's ``step``: clip 1.0, Adam, + 0.1 p, x -5e-5,
    kept on a finite norm <= 1000."""
    leaf = np.random.default_rng(0).normal(0, 1e-3, 1000).astype(np.float32)
    mega = torch.from_numpy(leaf.copy())
    opt, state, lrs = chain([("mega", mega)])
    stage = optimizer_stage(opt, state, lrs, opt.params)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.scale_by_adam(b1=0.9, b2=0.98, eps=1e-9),
                     optax.add_decayed_weights(0.1), optax.scale(-5e-5))
    params = {"mega": jnp.asarray(leaf)}
    opt_state = tx.init(params)
    for seed in (0.0, 1.0, 2.0):
        stage(seed)
        grads = jax.tree_util.tree_map(lambda p: p * 1e-3 + seed * 1e-9,
                                       params)
        gnorm = optax.global_norm(grads)
        updates, new_state = tx.update(grads, opt_state, params)
        ok = bool(jnp.isfinite(gnorm) & (gnorm <= 1000.0))
        if ok:
            params = optax.apply_updates(params, updates)
            opt_state = new_state
    np.testing.assert_allclose(mega.numpy(), np.asarray(params["mega"]),
                               rtol=1e-6, atol=0)
    assert int(state["count"]) == 3


def test_megaleaf_chain_refuses_a_clip_set_name():
    with pytest.raises(ValueError, match="clip set"):
        chain([("line_vulnerability_head.weight", torch.zeros(2))])


# -- time_dispatch's parity comparison ----------------------------------------

def test_graph_parity_comparison():
    """Bit-for-bit parameters pass; an update off by more than
    ``PARITY_RTOL`` norm-wise raises; within it, it passes and says it was
    not bitwise."""
    rng = np.random.default_rng(0)
    state = [torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))]
    eager = [state[0] + 1e-3]
    losses = [torch.tensor(2.0), torch.tensor(1.5)]
    cmp = time_dispatch.compare
    got = cmp([eager[0].clone()], eager, state, losses, torch.stack(losses),
              2)
    assert got["bitwise"] and got["update_rel_err"] == 0.0
    near = [eager[0] + 1e-3 * time_dispatch.PARITY_RTOL / 10]
    got = cmp(near, eager, state, losses, torch.stack(losses), 2)
    assert not got["bitwise"] and got["update_rel_err"] < 0.2 * 1e-2
    with pytest.raises(AssertionError, match="graph parity"):
        cmp([state[0] + 2e-3], eager, state, losses, torch.stack(losses), 2)


# -- C7: the repaired profiler reading ----------------------------------------

def _record(name, us):
    return type("Record", (), {
        "name": lambda self: name,
        "device_type": lambda self: torch.autograd.DeviceType.CUDA,
        "start_ns": lambda self: 0, "end_ns": lambda self: us * 1e3})()


@pytest.mark.parametrize("kept", [[1], [0, 1], [0] * profiling.TRACES])
def test_trace_device_profiles_a_short_trace_again_then_raises(monkeypatch,
                                                               kept):
    """A run that launches two K1 calls (the counter moves by 2) under a
    profiler that keeps, in turn, both K1 records (1) or one of them (0):
    a trace with fewer K1 records than launches is profiled again, the
    run made again, and after ``TRACES`` short traces it raises; a whole
    trace's rows leave the primers out."""
    from sct_gan_tpu_torch.ops.flash_attention import flash_attention
    it, ran = iter(kept), []
    k1 = "void flash_fwd_hopper_kernel<FwdShape<96> >(CUtensorMap)"

    class Trace:
        def __enter__(self):
            whole = next(it)
            events = [_record(profiling.PRIMER_NAME, 1.0)] * 3 + [
                _record(k1, 5.0)] * (1 + whole) + [_record("mul", 2.0)]
            results = type("Results", (), {"events": lambda self: events})
            self.profiler = type("Profiler", (), {
                "kineto_results": results()})()
            return self

        def __exit__(self, *exc):
            return False

    def run():
        ran.append(1)
        flash_attention.launches += 2

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Trace())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(flash_attention, "launches", 0)
    if kept[-1]:
        trace = profiling.trace_device(run)
        assert trace.runs == len(kept)
        assert trace.rows == [(k1, 2, 10.0), ("mul", 1, 2.0)]
    else:
        with pytest.raises(RuntimeError, match="lost records"):
            profiling.trace_device(run)
    assert len(ran) == len(kept)


def test_trace_device_needs_a_surviving_primer(monkeypatch):
    """A trace that lost every primer lost records of the run too, though
    no port kernel ran to show it: profiled again."""
    it = iter([[], [_record(profiling.PRIMER_NAME, 1.0)]])

    class Trace:
        def __enter__(self):
            events = [*next(it), _record("mul", 2.0)]
            results = type("Results", (), {"events": lambda self: events})
            self.profiler = type("Profiler", (), {
                "kineto_results": results()})()
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Trace())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    trace = profiling.trace_device(lambda: None)
    assert trace.runs == 2 and trace.rows == [("mul", 1, 2.0)]
