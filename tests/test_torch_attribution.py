"""The port's last six attribution tools (``sct_gan_tpu_torch/tools``:
``time_lmce``, ``time_lmce_parts``, ``time_flash_real``, ``time_layer``,
``time_decode_parts``, ``time_host_prep``) on the CPU at a tiny width,
inputs from a numpy seed, against the JAX package:

  * ``time_lmce``'s variants (value, dx, dW) and its forward chain, over
    a head padded past the vocab as the model's is, against
    ``jax.scipy.special.logsumexp`` and the JAX fused CE over the unpadded
    head, f32, rtol 1e-5 (atol 1e-7 on the gradients, whose entries reach
    ~1e-9; the pad rows' gradient exactly 0);
  * each ``time_lmce_parts`` piece, unpadded, against the JAX tool's jnp
    expression, in f32 (the JAX ``dlogits`` casts to bf16; here to the
    inputs' f32), 1e-5;
  * ``time_flash_real``'s forward and ``fb`` chains, 3 steps, dropout 0,
    against the JAX ``flash_attention`` in interpret mode, 2e-5 in f32;
  * a 2-layer ``time_layer`` stack, its flax weights carried across by
    ``convert.py``, dropout 0: its output and every parameter's gradient
    against the JAX ``TransformerEncoderStack`` (``pad_heads=False``,
    dense attention), plain, with the tanh GELU (both sides rebound) and
    under the dense attention, 1e-4 (``test_torch_model.py``'s bar);
  * ``time_decode_parts``' layers-only loop (4 steps) and ``embed-only``
    against the JAX decoder step and ``embed_target_token`` from the same
    weights, 1e-4;
  * ``time_host_prep``'s batches an epoch, with and without the bank,
    equal the JAX trainer's over its loader on the same corpus;
  * each tool's ``main`` prints the JAX tool's line prefixes and a JSON
    line whose numbers are finite and positive (errors and launch counts
    may be 0; the launches are 0 on the CPU);
  * ``chip_smoke.phase_attribution`` rehearsed on the CPU, and its launch
    check refusing a count off the config.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from sct_gan_tpu.config import ModelConfig as JaxModelConfig
from sct_gan_tpu.config import TrainConfig as JaxTrainConfig
from sct_gan_tpu.data.dataset import \
    create_dataloaders as jax_create_dataloaders
from sct_gan_tpu.data.native_tokenizer import \
    NativeSolidityTokenizer as JaxNativeTokenizer
from sct_gan_tpu.infer.generate import _init_caches
from sct_gan_tpu.models import layers as jax_layers
from sct_gan_tpu.models.layers import \
    TransformerEncoderStack as JaxEncoderStack
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu.ops.fused_ce import \
    fused_linear_cross_entropy as jax_fused_ce
from sct_gan_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from sct_gan_tpu.parallel.mesh import make_mesh
from sct_gan_tpu.train.trainer import SmartContractTrainer as JaxTrainer
from sct_gan_tpu_torch import SmartContractTransformer, convert_flax_params
from sct_gan_tpu_torch.convert import convert_flax_module_params
from sct_gan_tpu_torch.data.dataset import create_dataloaders
from sct_gan_tpu_torch.data.native_tokenizer import NativeSolidityTokenizer
from sct_gan_tpu_torch.data.synthetic import write_corpus_csv
from sct_gan_tpu_torch.models import layers
from sct_gan_tpu_torch.tools import (bench, time_decode_parts,
                                     time_flash_real, time_host_prep,
                                     time_layer, time_lmce, time_lmce_parts)
from test_torch_model import flax_params

F32 = dict(rtol=1e-5, atol=1e-7)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread while this file runs: the tools make
    many tiny ops, and with every test worker's pool on the shared cores
    each op waits for its threads (the phase rehearsal took 189 s on 8
    threads beside five busy processes, 14 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# -- time_lmce ----------------------------------------------------------------

def _jax_dense(x, kernel, b, t):
    """``time_lmce.py:52-61``."""
    logits = x @ kernel + b.astype(x.dtype)
    lse = jax.scipy.special.logsumexp(logits.astype(jnp.float32), axis=-1)
    picked = jnp.take_along_axis(logits, t[..., None],
                                 axis=-1)[..., 0].astype(jnp.float32)
    return (lse - picked).mean()


LMCE_JAX = {"dense": _jax_dense, "chunked": _jax_dense,
            "fused": lambda x, k, b, t: jax_fused_ce(x, k, b, t)}


V = 70                  # padded to 80 (a multiple of 16)


@pytest.fixture(scope="module")
def lmce_inputs():
    return time_lmce.make_inputs(2, 10, 16, V, dtype=torch.float32,
                                 pad_multiple=16)


@pytest.mark.parametrize("name", list(LMCE_JAX))
def test_lmce_variant_matches_jax(name, lmce_inputs):
    """Value, dx and dW of the variant (``chunked``: 3 chunks, a part-full
    last one) against the JAX dense log-sum-exp (``fused``: the JAX fused
    CE); the forward chain of 3 calls against the JAX tool's chain."""
    x, w, b, t = lmce_inputs
    assert w.shape == (80, 16) and not w[V:].any()
    fn = time_lmce.variants(True, 3, V)[name]
    jx, jk, jb, jt = (jnp.asarray(_np(x)), jnp.asarray(_np(w[:V]).T),
                      jnp.asarray(_np(b[:V])), jnp.asarray(t.numpy()))
    jfn = LMCE_JAX[name]
    want, (gx, gk) = jax.value_and_grad(jfn, argnums=(0, 1))(jx, jk, jb, jt)
    got, dx, dw, _ = time_lmce.grads(fn, x, w, b, t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(_np(dx), np.asarray(gx), **F32)
    np.testing.assert_allclose(_np(dw[:V]), np.asarray(gk).T, **F32)
    assert not dw[V:].any()
    num = time_lmce.numerics(fn, x, w, b, t, V)
    np.testing.assert_allclose(num["value"], num["ref"], rtol=1e-5)

    acc, xx = jnp.float32(0), jx
    for _ in range(3):
        acc = acc + jfn(xx, jk, jb, jt)
        xx = xx * (1.0 + acc * 1e-20)
    np.testing.assert_allclose(
        float(time_lmce.forward_chain(fn, x, w, b, t, 3)), float(acc),
        rtol=1e-5)


# -- time_lmce_parts ----------------------------------------------------------

def _jax_pieces(j):
    """The JAX tool's pieces (``time_lmce_parts.py:41-58``), cast to the
    inputs' dtype where the tool casts to bf16."""
    w, b, t, lse = j["W"], j["b"], j["t"], j["lse"]
    v = w.shape[1]
    return {
        "logits": lambda h, dl: h @ w + b,
        "dlogits": lambda h, dl: (jnp.exp((h @ w + b).astype(jnp.float32)
                                          - lse[..., None])
                                  - (t[..., None] == jnp.arange(v)
                                     ).astype(jnp.float32)).astype(h.dtype),
        "dhidden": lambda h, dl: jnp.matmul(
            dl, w.T, preferred_element_type=jnp.float32),
        "dkernel": lambda h, dl: jnp.einsum(
            "bsd,bsv->dv", h, dl, preferred_element_type=jnp.float32),
        "dkernel_flat": lambda h, dl: jax.lax.dot_general(
            h.reshape(-1, h.shape[-1]), dl.reshape(-1, v),
            (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32),
    }


@pytest.mark.parametrize("piece", time_lmce_parts.PIECES)
def test_lmce_part_matches_jax(piece):
    inp = time_lmce_parts.make_inputs(2, 9, 16, 70, dtype=torch.float32,
                                      pad_multiple=1)
    j = {k: jnp.asarray(v.numpy()) for k, v in inp.items()}
    want = _jax_pieces(j)[piece](j["h"], j["dl"])
    got = time_lmce_parts.pieces(inp)[piece](inp["h"], inp["dl"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -- time_flash_real ----------------------------------------------------------

def _jax_chain(kind, x, mask, steps):
    """The JAX tool's ``fwd`` / ``fwdbwd`` bodies (``time_flash_real.py:
    67-85``) at dropout 0."""
    for _ in range(steps):
        if kind == "fwd":
            x = jax_flash_attention(x, x, x, key_padding_mask=mask) * 0.999
            continue

        def loss(xx):
            o = jax_flash_attention(xx, xx, xx, key_padding_mask=mask)
            return jnp.sum(o.astype(jnp.float32) * 1e-3), o
        (_, o), g = jax.value_and_grad(loss, has_aux=True)(x)
        x = (o + g).astype(x.dtype) * 0.5
    return x


@pytest.mark.parametrize("kind", ["fwd", "fb"])
def test_flash_real_chain_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1, 2, 128, 32)) * 0.5).astype(np.float32)
    mask = np.ones((1, 128), bool)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_chain(kind, jnp.asarray(x), jnp.asarray(mask), 3)
    got = time_flash_real.CHAINS[kind](torch.from_numpy(x),
                                       torch.from_numpy(mask), 0.0, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_shipped_tiles_name_the_sources_shapes():
    tiles = time_flash_real.shipped_tiles(96)
    assert tiles.startswith("K1 128 queries x 64 keys; dKV 64 keys")
    assert "pair: the wgmma instance 192" in time_flash_real.shipped_tiles(192)


# -- time_layer ---------------------------------------------------------------

LAYER = dict(num_layers=2, d_model=32, heads=4, ffn=64)


def _stack_params(seed=0):
    """The JAX stack's parameter tree, numpy-seeded as ``flax_params``."""
    jm = JaxEncoderStack(LAYER["num_layers"], LAYER["d_model"],
                         LAYER["heads"], LAYER["ffn"], 0.0,
                         dtype=jnp.float32, use_flash=False, pad_heads=False)
    x = jnp.zeros((1, 8, LAYER["d_model"]))
    shapes = jax.eval_shape(lambda k: jm.init(k, x)["params"],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if len(s.shape) == 2:
            return rng.normal(0, s.shape[0] ** -0.5, s.shape).astype(
                np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.1, s.shape)).astype(np.float32)
    return jm, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("variant", ["drop0.0+flash", "drop0.0+dense",
                                     "drop0+flash+tanh"])
def test_layer_stack_matches_jax(variant, monkeypatch):
    jm, params = _stack_params()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, LAYER["d_model"])).astype(np.float32)
    mask = np.ones((2, 16), bool)
    mask[1, 11:] = False
    if variant.endswith("tanh"):
        monkeypatch.setattr(jax_layers, "gelu",
                            lambda a: jax.nn.gelu(a, approximate=True))

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x),
                       key_padding_mask=jnp.asarray(mask))
        return out.astype(jnp.float32).mean(), out
    (_, want), gwant = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)

    stack = time_layer.encoder_stack(**LAYER, dropout=0.0,
                                     dtype=torch.float32)
    stack.load_state_dict(convert_flax_module_params(params, stack))
    context = {"drop0.0+dense": bench.dense_attention,
               "drop0+flash+tanh": time_layer.tanh_gelu}.get(variant)
    package_gelu = layers.gelu
    if context is None:
        _, grads = time_layer.grad_step(stack, torch.from_numpy(x),
                                        torch.from_numpy(mask))
        got = stack(torch.from_numpy(x), torch.from_numpy(mask))
    else:
        with context():
            _, grads = time_layer.grad_step(stack, torch.from_numpy(x),
                                            torch.from_numpy(mask))
            got = stack(torch.from_numpy(x), torch.from_numpy(mask))
    assert layers.gelu is package_gelu          # the rebinding is undone
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)
    names = [n for n, _ in stack.named_parameters()]
    flat = dict(convert_flax_module_params(gwant, stack))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(_np(g), flat[name].numpy(), err_msg=name,
                                   **MODEL_TOL)


def test_matmul_floor_holds_the_layers_products():
    floor = time_layer.floor_stack(2, 32, 64, torch.float32)
    shapes = sorted(tuple(p.shape) for n, p in floor.named_parameters()
                    if n.endswith("weight"))
    assert shapes == sorted([(32, 32)] * 8 + [(64, 32), (32, 64)] * 2)
    loss, grads = time_layer.grad_step(floor, torch.ones(2, 8, 32))
    assert torch.isfinite(loss) and len(grads) == 24


# -- time_decode_parts --------------------------------------------------------

DECODE = dict(d_model=32, nhead=4, num_encoder_layers=1,
              num_decoder_layers=2, dim_feedforward=64, max_length=32,
              max_lines=32, vocab_size=300, compute_dtype="float32",
              dropout=0.0)


@pytest.fixture(scope="module")
def decode_pair():
    from sct_gan_tpu_torch.config import ModelConfig
    cfg = ModelConfig(**DECODE)
    jcfg = JaxModelConfig(**{**dataclasses.asdict(cfg),
                             "use_flash_attention": False})
    params = flax_params(jcfg)
    tm = SmartContractTransformer(cfg, seed=None)
    tm.load_state_dict(convert_flax_params(params, cfg))
    return JaxModel(jcfg), params, tm.eval()


def test_decode_layers_loop_matches_jax(decode_pair):
    jm, params, tm = decode_pair
    b, n = 2, 4
    x0, caches, cross, src = time_decode_parts.layers_state(tm, b)
    x0 = x0 + torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(x0.shape)).astype(np.float32))
    with torch.inference_mode():
        got = time_decode_parts.layers_loop(tm, x0, caches, cross, src, n)

    ids = jnp.zeros((b, DECODE["max_length"]), jnp.int32)
    mask = jnp.ones_like(ids)
    jcross = jax.jit(lambda p: jm.apply(
        {"params": p}, jm.apply({"params": p}, ids, mask, ids, mask,
                                method=jm.encode),
        method=jm.precompute_cross_kv))(params)
    jcaches = _init_caches(jm.config, b, dtype=jnp.float32)
    step = jax.jit(lambda x, c, pos: jm.apply(
        {"params": params}, x, c, jcross, pos,
        memory_key_padding_mask=mask.astype(bool),
        method=lambda m, *a, **k: m.decoder.step(*a, **k)))
    x = jnp.asarray(x0.numpy())
    for pos in range(n):
        x, jcaches = step(x, jcaches, jnp.int32(pos))
    np.testing.assert_allclose(_np(got), np.asarray(x), **MODEL_TOL)


def test_decode_embed_loop_matches_jax(decode_pair):
    jm, params, tm = decode_pair
    ids = np.random.default_rng(3).integers(0, 300, (4, 2, 1))
    with torch.inference_mode():
        got = time_decode_parts.embed_loop(
            tm, 4, lambda pos: torch.from_numpy(ids[pos]))
    want = sum(jm.apply({"params": params}, jnp.asarray(ids[pos]),
                        jnp.int32(pos), method=jm.embed_target_token
                        ).astype(jnp.float32).sum() for pos in range(4))
    np.testing.assert_allclose(float(got), float(want), **MODEL_TOL)


# -- time_host_prep -----------------------------------------------------------

def test_host_prep_batches_match_the_jax_trainer(tmp_path, monkeypatch):
    """Batches an epoch over two epochs, each bank. The JAX trainer's
    eager ``model.init`` (15 s here) is replaced by numpy-seeded
    parameters of its shapes: the host path reads none of them."""
    csv = os.path.join(tmp_path, "corpus.csv")
    write_corpus_csv(csv, n=20, seed=0)
    seq, bs = 128, 3
    train, val = create_dataloaders(csv, NativeSolidityTokenizer(), bs, seq)
    jtok = JaxNativeTokenizer()
    jtrain, jval = jax_create_dataloaders(csv, tokenizer=jtok, batch_size=bs,
                                          max_length=seq)
    mcfg = JaxModelConfig(d_model=32, nhead=2, num_encoder_layers=1,
                          num_decoder_layers=1, dim_feedforward=64,
                          max_length=seq, max_lines=seq, use_gan=True,
                          use_flash_attention=False,
                          compute_dtype="float32")
    mesh = make_mesh(dp=1, mp=1, devices=jax.devices()[:1])
    params = flax_params(mcfg)
    monkeypatch.setattr(JaxModel, "init",
                        lambda self, *a, **k: {"params": params})
    for bank in time_host_prep.BANKS:
        trainer = time_host_prep.prep_trainer(
            train, val, NativeSolidityTokenizer(), seq, bank, "cpu")
        got = [e["batches"] for e in time_host_prep.time_epochs(
            trainer, train, 2)]
        jt = JaxTrainer(JaxModel(mcfg), jtrain, jval, jtok,
                        config=JaxTrainConfig(use_gan=True,
                                              use_augmentation=True,
                                              aug_bank_size=bank),
                        mesh=mesh, verbose=False)
        want = [sum(1 for batch in jtrain if jt._pad_to_dp(
            jt._create_augmented_batch(batch)) is not None)
            for _ in range(2)]
        assert got == want == [len(jtrain)] * 2, (bank, got, want)


# -- main() and the chip_smoke phase -----------------------------------------

TINY = chip_smoke.ATTRIBUTION_CPU
JAX_LINES = {
    "time_lmce": ("dense    val=", "  dense    fwd ", "  dense    fwd+bwd",
                  "chunked  val=", "fused    val=", "  fused    fwd+bwd"),
    "time_lmce_parts": tuple(f"{p:13s} " for p in time_lmce_parts.PIECES),
    "time_flash_real": ("fwd nodrop ", "fwd drop.3 ", "fb  nodrop ",
                        "fb  drop.3 "),
    "time_layer": ("drop0.3+flash ", "drop0.0+flash ", "drop0.0+dense ",
                   "drop0+flash+tanh ", "matmul floor "),
    "time_decode_parts": ("layers-only x1:", "layers-only x3:",
                          "layers-only x6:", "lm+sample-only:",
                          "embed-only:", "per-decoder-layer:"),
    "time_host_prep": ("native tokenizer:", "dataset build:",
                       "aug_bank_size=6: epoch 0:",
                       "aug_bank_size=0: epoch 0:"),
}
MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    time_lmce, time_lmce_parts, time_flash_real, time_layer,
    time_decode_parts, time_host_prep)}


def _leaves(x, key=""):
    """(key, value) of every number in a nest of lists and dicts."""
    if isinstance(x, dict):
        return [kv for k, v in x.items() for kv in _leaves(v, k)]
    if isinstance(x, list):
        return [kv for v in x for kv in _leaves(v, key)]
    return [(key, x)] if isinstance(x, (int, float)) and not isinstance(
        x, bool) else []


@pytest.mark.parametrize("name", list(JAX_LINES))
def test_main_prints_the_jax_tools_lines(name, capsys):
    assert MODULES[name].main(["--device", "cpu", *dict(TINY)[name]]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    for prefix in JAX_LINES[name]:
        assert any(line.startswith(prefix) for line in lines[:-1]), prefix
    assert chip_smoke._numbers(res) and not chip_smoke.bad_numbers(res), res
    assert all(v == 0 for k, v in _leaves(res)
               if k in chip_smoke.KERNELS)       # launch counts on the CPU


def test_phase_attribution_rehearses_on_the_cpu():
    """All six tools through the phase at the tiny sizes; the launch
    check is held on the CPU too, where every count is 0."""
    counts = chip_smoke.phase_attribution("cpu", TINY, device="cpu")
    assert counts == dict.fromkeys(chip_smoke.KERNELS, 0)


def test_launch_check_refuses_a_count_off_the_config():
    """``attribution_launch_errors`` on card-like results: the config's
    counts pass, one launch more or less in a row does not."""
    k = dict.fromkeys(chip_smoke.KERNELS, 0)
    flash = {"rows": {
        "fwd nodrop": {"calls": 8, "launches": {**k,
                                                "flash_attention_fwd": 8}},
        "fb nodrop": {"calls": 8, "launches": {
            **k, "flash_attention_fwd": 8, "flash_attention_bwd": 8}}}}
    total = {**k, "flash_attention_fwd": 16, "flash_attention_bwd": 8}
    assert chip_smoke.attribution_launch_errors(
        "time_flash_real", flash, total, True) == []
    flash["rows"]["fb nodrop"]["launches"]["flash_attention_bwd"] = 7
    assert chip_smoke.attribution_launch_errors(
        "time_flash_real", flash, total, True)
    layer = {"layers": 2, "variants": {
        "drop0.3+flash": {"steps": 4, "launches": {
            **k, "flash_attention_fwd": 8, "flash_attention_bwd": 8,
            "dropout": 48}},
        "matmul floor": {"steps": 4, "launches": dict(k)}}}
    total = {**k, "flash_attention_fwd": 8, "flash_attention_bwd": 8,
             "dropout": 48}
    assert chip_smoke.attribution_launch_errors(
        "time_layer", layer, total, True) == []
    layer["variants"]["matmul floor"]["launches"]["dropout"] = 1
    assert chip_smoke.attribution_launch_errors(
        "time_layer", layer, {**total, "dropout": 49}, True)
    assert chip_smoke.attribution_launch_errors(
        "time_lmce", {}, {**k, "decode_attention": 1}, True)
