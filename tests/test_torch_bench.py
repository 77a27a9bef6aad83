"""The port's bench and step-attribution tools (``sct_gan_tpu_torch/tools``:
``bench``, ``quick_bench``, ``bench_decode``, ``peak_matmul``, ``time_fwd``,
``time_decode``, ``time_fwd_modules``) on the CPU at a tiny width (d=32,
1+1 layers, L=64, B=2), against the JAX repo's root ``bench.py``:

  * ``make_batch`` equals the JAX bench's bit for bit;
  * one step of the naive leg (f32, dense attention) equals one step of the
    JAX trainer built as ``bench.build_trainer("float32", False, ...)``
    builds it, from the same weights, dropout off on both sides (the two
    frameworks draw different masks): ``total_loss`` within 1e-4 relative
    (the bar of ``test_torch_train.py``'s whole step), ``grad_norm`` within
    1e-3 (a norm over every gradient, summed in another order);
  * the naive leg's dense route gives the plain flash route's step on the
    CPU in f32 within 1e-5 (the swap changes the implementation, not the
    math), and the rebinding is undone after the leg, also when it raises;
  * ``time_decode`` runs every round to L - 1 steps and its rates are
    B (L - 1) over a round's seconds;
  * the slope of two run lengths (``bench.slope_ms``, behind
    ``time_decode`` and ``time_fwd_modules.call_ms``) takes further pairs
    of runs while the long run is not the longer, never gives a time
    <= 0, and past its bound raises;
  * ``bench.device_ms`` profiles the run again after a trace with no
    device time, up to ``TRACES`` runs, and says how many it made;
  * each tool's ``main`` prints the keys of its JAX counterpart's output.
"""
import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from sct_gan_tpu.config import ModelConfig as JaxModelConfig
from sct_gan_tpu.config import TrainConfig as JaxTrainConfig
from sct_gan_tpu.data.tokenizer import SolidityTokenizer as JaxTokenizer
from sct_gan_tpu.models import layers as jax_layers
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu.parallel.mesh import make_mesh, shard_batch
from sct_gan_tpu.train.trainer import SmartContractTrainer as JaxTrainer
from sct_gan_tpu_torch import convert_flax_params
from sct_gan_tpu_torch.models import layers
from sct_gan_tpu_torch.models.layers import Dropout, MultiheadAttention
from sct_gan_tpu_torch.ops import attention, flash_attention
from sct_gan_tpu_torch.tools import (bench, bench_decode, peak_matmul,
                                     quick_bench, time_decode, time_fwd,
                                     time_fwd_modules)
from sct_gan_tpu_torch.tools._common import model_config, tokenizer_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, LAYERS, SEQ, B = 32, 1, 64, 2
SIZE = dict(device="cpu", d_model=D, layers=LAYERS)
TINY = ["--device", "cpu", "--d-model", str(D), "--layers", str(LAYERS),
        "--seq", str(SEQ)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread while this file runs: the tools make
    many tiny ops, and with every test worker's pool on the shared cores
    each op waits for its threads (``bench``'s ``main`` took 558 s in a
    six-worker run of the suite on 8 threads a process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_bench():
    """The JAX repo's root ``bench.py`` (numpy only at module level)."""
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("b, s, vocab", [(2, 64, 50265), (8, 1024, 50265),
                                         (3, 100, 512)])
def test_make_batch_equals_the_jax_bench(b, s, vocab):
    want = _jax_bench().make_batch(b, s, vocab)
    got = bench.make_batch(b, s, vocab)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _no_dropout(trainer):
    """Every dropout site of the port's model off: the Dropout modules
    (the line heads' and the discriminator's fixed 0.1 included) and the
    attention-weight dropout."""
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
        elif isinstance(m, MultiheadAttention):
            m.dropout = 0.0
    return trainer


def _port_step(trainer, batch):
    _, metrics, _ = trainer.train_step(
        trainer.state, trainer.to_device(batch), trainer._scalars(1.0),
        trainer._group_lrs(), trainer.generator)
    return {k: float(v) for k, v in metrics.items()}


def test_naive_step_matches_the_jax_naive_trainer(monkeypatch):
    """The JAX trainer as ``bench.build_trainer("float32", False, B, L)``
    builds it (a 1 x 1 mesh, learning rate 1e-5, one warm-up epoch, no
    loaders), at the tiny width, against the port's naive leg on its
    weights."""
    cfg = model_config(SEQ, D, LAYERS, "float32")
    jcfg = JaxModelConfig(**{**dataclasses.asdict(cfg), "dropout": 0.0,
                             "use_flash_attention": False})
    # the line heads' and the discriminator's fixed 0.1 (JAX side)
    monkeypatch.setattr(jax_layers, "fast_dropout",
                        lambda x, rate, rng, deterministic=False: x)

    class _Empty:
        def __iter__(self):
            return iter(())

    jt = JaxTrainer(JaxModel(jcfg), _Empty(), _Empty(),
                    JaxTokenizer(vocab_size=jcfg.vocab_size),
                    config=JaxTrainConfig(learning_rate=1e-5, use_gan=True,
                                          warmup_epochs=1),
                    mesh=make_mesh(dp=1, mp=1, devices=jax.devices()[:1]),
                    verbose=False)
    params = jax.device_get(jt.state.params)
    batch = bench.make_batch(B, SEQ, cfg.vocab_size)
    _, want, _ = jt.train_step(jt.state, shard_batch(batch, jt.mesh),
                               jt._scalars(1.0), jt._group_lrs(),
                               jax.random.PRNGKey(0))

    naive = _no_dropout(bench.build_trainer("float32", True, B, SEQ, **SIZE))
    naive.model.load_state_dict(convert_flax_params(params, cfg))
    got = _port_step(naive, batch)
    np.testing.assert_allclose(got["total_loss"], float(want["total_loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], float(want["grad_norm"]),
                               rtol=1e-3)
    assert got["skipped"] == 0.0 == float(want["skipped"])


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the calls of the flash route (``ops.flash_attention``'s entry,
    which ``dot_product_attention`` imports at each call)."""
    box = [0]
    real = flash_attention.flash_attention

    def counted(*a, **k):
        box[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(flash_attention, "flash_attention", counted)
    return box


def test_dense_route_equals_the_plain_flash_route(flash_calls):
    """The same f32 trainer (seed 0, dropout on) stepped once through the
    package's attention and once through the naive leg's dense route: the
    metrics agree within 1e-5, and the naive leg never reaches the flash
    route."""
    batch = bench.make_batch(B, SEQ, 50265)
    flash = bench.build_trainer("float32", False, B, SEQ, **SIZE)
    calls = flash_calls[0]
    want = _port_step(flash, batch)
    assert flash_calls[0] > calls
    calls = flash_calls[0]
    naive = bench.build_trainer("float32", True, B, SEQ, **SIZE)
    got = _port_step(naive, batch)
    assert flash_calls[0] == calls
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for n, p in naive.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   flash.state.params[n].detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def test_the_rebinding_is_undone():
    """``dense_attention`` holds the plain dense attention only inside it,
    and the naive trainer only while it is built and steps: afterwards the
    layers call the package's attention again, also after a raise."""
    package = layers.dot_product_attention
    assert package is attention.dot_product_attention
    with bench.dense_attention():
        assert layers.dot_product_attention is attention.mha_reference
    assert layers.dot_product_attention is package
    with pytest.raises(RuntimeError, match="inside"):
        with bench.dense_attention():
            raise RuntimeError("inside")
    assert layers.dot_product_attention is package

    naive = bench.build_trainer("float32", True, B, SEQ, **SIZE)
    assert layers.dot_product_attention is package
    broken = bench.make_batch(B, SEQ, 50265)
    del broken["token_to_line"]
    with pytest.raises(KeyError, match="token_to_line"):
        _port_step(naive, broken)
    assert layers.dot_product_attention is package


def test_time_decode_runs_full_length_rounds(monkeypatch):
    """Every round decodes L - 1 steps (``min_length=10**9``: no row stops
    early) into (B, L) tokens starting at BOS; the rates are B (L - 1) and
    B over a round's seconds."""
    from sct_gan_tpu_torch.infer import generate as gen_mod
    from sct_gan_tpu_torch.models.sct_transformer import \
        SmartContractTransformer
    seen = []
    real = gen_mod.make_generate_fn

    def spy(*a, **k):
        assert k["min_length"] == 10 ** 9
        fn = real(*a, **k)

        def generate(*args):
            tokens, steps = fn(*args)
            seen.append((tuple(tokens.shape), steps,
                         bool((tokens[:, 0] == gen_mod.BOS_ID).all())))
            return tokens, steps
        return generate
    monkeypatch.setattr(gen_mod, "make_generate_fn", spy)
    seq = 32
    cfg = model_config(seq, D, LAYERS)
    model = SmartContractTransformer(cfg, seed=0)
    res = bench.time_decode(model, tokenizer_for(cfg), 3, n_large=2)
    # a warm-up run of each length, then at least HOST_REPS pairs of runs
    # of 1 and 2 rounds
    rounds = res["rounds"]
    assert rounds >= 3 * (1 + bench.HOST_REPS) and rounds % 3 == 0
    assert seen == [((3, seq), seq - 1, True)] * rounds
    assert res["steps"] == rounds * (seq - 1)
    assert res["decode_tokens_per_sec"] == pytest.approx(
        3 * (seq - 1) / res["seconds_per_batch"])
    assert res["decode_contracts_per_sec"] == pytest.approx(
        3 / res["seconds_per_batch"])
    assert model.training       # handed back in its mode


# What each JAX tool prints: the JSON keys of bench.py:204-211,
# tools/quick_bench.py:40-50 and tools/bench_decode.py:79-86; the text
# lines of the others (the port prints them too, then one JSON line whose
# keys carry the same numbers).
JAX_OUTPUT = {
    "bench": ({"metric", "value", "unit", "vs_baseline",
               "decode_contracts_per_sec", "decode_tokens_per_sec",
               "decode_batch"}, ()),
    "quick_bench": ({"step_ms", "tok_per_sec", "decode_contracts_per_sec",
                     "decode_tokens_per_sec", "decode_batch"}, ()),
    "bench_decode": ({"metric", "contracts_per_sec", "decode_tokens_per_sec",
                      "batch", "seq", "seconds_per_batch"}, ()),
    "peak_matmul": ({"matmul", "hbm"}, ("matmul 64^3 x16:",
                                        "elementwise x8 over 2 MB:")),
    "time_fwd": ({"step_ms", "fwd_ms", "bwd_opt_ms"},
                 ("full step:", "eval (fwd-only) step:",
                  "=> bwd+optimizer+train-extras:")),
    "time_decode": ({"decode_step_ms", "seconds_per_batch",
                     "contracts_per_sec", "decode_tokens_per_sec",
                     "loop_step_ms"},
                    ("decode_step alone:", "full generation:")),
    "time_fwd_modules": ({"fwd", "fwd+bwd"},
                         tuple(f"{m} {s:14s}:" for m in ("fwd", "fwd+bwd")
                               for s in time_fwd_modules.STAGES)
                         + ("fwd sum:", "fwd+bwd sum:")),
}
TOOLS = {
    "bench": (bench, [*TINY, "--batch", "2", "--decode-batch", "2"]),
    "quick_bench": (quick_bench, [*TINY, "--batch", "2", "--decode-batch",
                                  "2"]),
    "bench_decode": (bench_decode, ["2", *TINY]),
    "peak_matmul": (peak_matmul, ["--device", "cpu", "--sizes", "64",
                                  "--copy-mb", "2"]),
    "time_fwd": (time_fwd, [*TINY, "--batch", "2", "--steps", "2"]),
    "time_decode": (time_decode, [*TINY, "--batch", "2", "--rounds", "2"]),
    "time_fwd_modules": (time_fwd_modules, [*TINY, "--batch", "2",
                                            "--grad", "--calls", "1", "2"]),
}


def _numbers(x) -> list:
    """Every number in a nest of lists and dicts (strings and bools
    left out)."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, list):
        return [v for item in x for v in _numbers(item)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x,
                                                                  bool) else []


@pytest.mark.parametrize("name", list(TOOLS))
def test_main_prints_the_jax_tools_output(name, capsys):
    tool, argv = TOOLS[name]
    assert tool.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    keys, texts = JAX_OUTPUT[name]
    assert keys <= set(res), keys - set(res)
    for text in texts:
        assert any(line.startswith(text) for line in lines[:-1]), text
    nums = _numbers([res[k] for k in keys])
    assert nums and all(np.isfinite(v) and v > 0 for v in nums), res
    if name == "bench":
        assert res["metric"] == "train_tokens_per_sec_per_chip"
        assert res["device"] == "cpu" and res["tf32"] is False
        assert res["launches"]["step"]["steps"] == 22
        assert res["launches"]["naive_step"]["steps"] == 10
    if name == "peak_matmul":
        assert res["matmul"][0]["n"] == 64 and res["hbm"]["gb_per_s"] > 0
    if name == "time_fwd_modules":
        assert set(res["fwd"]) == {*time_fwd_modules.STAGES, "sum"}


def _clock(times):
    """A stand-in for ``timed_ms`` that runs nothing and returns the next
    of ``times`` as the host clock's ms (no CUDA events: the CPU)."""
    it = iter(times)
    calls = []

    def timed(run, device):
        calls.append(device)
        return None, next(it)
    return timed, calls


def test_time_decode_raises_where_a_long_run_is_not_longer(monkeypatch):
    """Every run shorter than the one before: the long run never takes
    longer than the short one, so ``time_decode`` takes its further pairs
    of runs, then raises (the JAX bench clamps the slope and reports
    about B·1e9 contracts/s)."""
    from sct_gan_tpu_torch.models.sct_transformer import \
        SmartContractTransformer
    timed, calls = _clock(1000.0 - i for i in range(1000))
    monkeypatch.setattr(bench, "timed_ms", timed)
    cfg = model_config(SEQ, D, LAYERS)
    model = SmartContractTransformer(cfg, seed=0)
    with pytest.raises(RuntimeError, match="host is too loaded"):
        bench.time_decode(model, tokenizer_for(cfg), B)
    assert len(calls) == 2 + 2 * (bench.HOST_REPS + bench.MORE_PAIRS)


@pytest.mark.parametrize("case", ["recovers", "raises"])
def test_call_ms_is_positive_or_raises(monkeypatch, case):
    """``call_ms`` on the host clock at ``--calls 1 2``: a run of two calls
    timed under one call's run (9 against 10 ms) HOST_REPS times, then a
    quiet pair (5, 9.5): the stage time is 9 - 5 ms, from the fastest of
    each length. A host that never lets the long run be the longer makes
    it raise after its bound; it never returns a time <= 0."""
    pairs = [(10.0, 9.0)] * bench.HOST_REPS
    if case == "recovers":
        pairs.append((5.0, 9.5))
    else:
        pairs += [(10.0, 9.0)] * bench.MORE_PAIRS
    timed, calls = _clock([20.0, 30.0, *(t for p in pairs for t in p)])
    monkeypatch.setattr(time_fwd_modules, "timed_ms", timed)
    fn = lambda c: c + 1.0   # noqa: E731
    cpu = torch.device("cpu")
    if case == "recovers":
        assert time_fwd_modules.call_ms(fn, cpu, 1, 2) == 4.0
    else:
        with pytest.raises(RuntimeError, match="host is too loaded"):
            time_fwd_modules.call_ms(fn, cpu, 1, 2)
    assert len(calls) == 2 + 2 * len(pairs)


@pytest.mark.parametrize("trace_us", [[7.0], [0.0, 0.0, 5.0], [0.0] * 3])
def test_device_ms_profiles_again_after_an_empty_trace(monkeypatch,
                                                       trace_us):
    """``device_ms`` on a card whose profiler gives the traces' device µs
    in turn: a trace with device time is the result, over the runs made;
    an empty one (records lost) is profiled again, up to ``TRACES`` runs,
    then it raises. Every trace runs the run once."""
    from torch.autograd import DeviceType
    it, ran = iter(trace_us), []

    class Trace:
        def __enter__(self):
            self.us = next(it)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [type("Event", (), {"device_type": DeviceType.CUDA,
                                       "self_device_time_total": self.us})]

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Trace())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    run = lambda: ran.append(1)   # noqa: E731
    cuda = torch.device("cuda")
    assert len(trace_us) <= bench.TRACES
    if trace_us[-1] > 0:
        ms, runs = bench.device_ms(run, 4, cuda)
        assert (ms, runs) == (trace_us[-1] / 4 / 1e3, len(trace_us))
    else:
        with pytest.raises(RuntimeError, match="no device time"):
            bench.device_ms(run, 4, cuda)
    assert len(ran) == len(trace_us)
