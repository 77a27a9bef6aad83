"""The port's sequence-parallel encode against the JAX package's.

The cases of ``tests/test_sequence_parallel.py`` (D=64, L=256, B=2, a
ragged row), with the JAX side on the CPU and the port's ranks in gloo worlds of two and four CPU processes
(``torch_parallel_worker.py``), the same weights on both (``flax_params``):

  * ``sp_encode`` at sp = 2 and 4 and on a dp × sp = 2 × 2 mesh against
    JAX's encode: 1e-5 relative (f32; the sums of one attention row run in
    another order). JAX's ``sp_encode`` is that encode, held to it at 2e-5
    by ``tests/test_sequence_parallel.py``; it is not run again here, since
    its ``shard_map`` compiles for about 45 s on the virtual mesh;
  * its gradients against JAX's gradient of the unsharded encode: 1e-4
    relative, with an absolute floor at 1e-4 of the largest gradient (the
    leaves whose true gradient is ~0 are cancellation noise on both sides,
    as the JAX test says);
  * 4× beyond ``max_length`` (L=1024 on an L=256 model) against the port's
    own single-rank encode at the same length: 1e-5;
  * ``sp_detect`` against JAX's heads on the unsharded memory: 1e-5
    relative, 3e-5 absolute (the JAX test's);
  * causal attention under sequence parallelism raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.config import ModelConfig as JaxConfig
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu_torch import SmartContractTransformer, convert_flax_params
from sct_gan_tpu_torch.config import ModelConfig
from sct_gan_tpu_torch.parallel import make_sp_mesh, sp_encode
from test_torch_model import flax_params
from torch_parallel_worker import launch

D, L, B = 64, 256, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _fields():
    return dict(d_model=D, nhead=4, num_encoder_layers=2,
                num_decoder_layers=1, dim_feedforward=128, dropout=0.0,
                max_length=L, max_lines=L, vocab_size=512, use_gan=False,
                compute_dtype="float32")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, cfg = JaxConfig(**_fields()), ModelConfig(**_fields())
    params = flax_params(jcfg, seed=0)
    weights = convert_flax_params(params, cfg)
    rng = np.random.default_rng(0)
    am = np.ones((B, L), np.int32)
    am[1, L - 37:] = 0          # ragged row: the mask survives the gather
    batch = {
        "input_ids": rng.integers(0, 512, (B, L)).astype(np.int32),
        "attention_mask": am,
        "ast_input_ids": rng.integers(0, 512, (B, L)).astype(np.int32),
        "ast_attention_mask": np.ones((B, L), np.int32),
        "token_to_line": np.tile(np.minimum(
            np.arange(L, dtype=np.int32) // 4, L - 1), (B, 1)),
    }
    long_mask = np.ones((B, 4 * L), np.int32)
    long_mask[0, 3 * L + 5:] = 0
    inputs = {k: torch.from_numpy(v.astype(np.int64))
              for k, v in batch.items()}
    inputs["long_ids"] = torch.from_numpy(
        rng.integers(0, 512, (B, 4 * L)).astype(np.int64))
    inputs["long_mask"] = torch.from_numpy(long_mask.astype(np.int64))
    outs = {w: launch("sp", w, str(tmp_path_factory.mktemp(f"sp{w}")),
                      cfg=cfg, weights=weights, inputs=inputs)
            for w in (2, 4)}
    return dict(jcfg=jcfg, cfg=cfg, params=params, weights=weights,
                batch=batch, inputs=inputs, outs=outs)


def _jax_encode(s, params):
    jm = JaxModel(s["jcfg"])
    b = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    return jm, jax.jit(lambda p: jm.apply(
        {"params": p}, b["input_ids"], b["attention_mask"],
        b["ast_input_ids"], b["ast_attention_mask"], deterministic=True,
        method=jm.encode))(params)


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_encode_matches_jax(setup, sp):
    _, want = _jax_encode(setup, setup["params"])
    for out in setup["outs"][sp]:
        assert out["local_shape"] == (B, L // sp, D)
        np.testing.assert_allclose(out["encode"].numpy(), np.asarray(want),
                                   **TOL)


def test_sp_encode_dp_by_sp(setup):
    """2 × 2 (dp × sp): batch and sequence sharded at once."""
    _, want = _jax_encode(setup, setup["params"])
    for out in setup["outs"][4]:
        np.testing.assert_allclose(out["encode_2x2"].numpy(),
                                   np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def jax_grads(setup):
    jm = JaxModel(setup["jcfg"])
    b = {k: jnp.asarray(v) for k, v in setup["batch"].items()}

    def loss(p):
        mem = jm.apply({"params": p}, b["input_ids"], b["attention_mask"],
                       b["ast_input_ids"], b["ast_attention_mask"],
                       deterministic=True, method=jm.encode)
        return (mem.astype(jnp.float32) ** 2).mean()
    g = jax.jit(jax.grad(loss))(setup["params"])
    return convert_flax_params(jax.device_get(g), setup["cfg"])


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_encode_grads_match_jax(setup, jax_grads, sp):
    """The K/V/mask gathers' reduce-scatters give the unsharded gradient,
    every parameter of the encode path included."""
    scale = max(float(g.abs().max()) for g in jax_grads.values())
    checked = 0
    for out in setup["outs"][sp]:
        for name, want in jax_grads.items():
            np.testing.assert_allclose(
                out["grads"][name].numpy(), want.numpy(), rtol=1e-4,
                atol=1e-4 * scale, err_msg=name)
            checked += want.abs().max() > 0
    assert checked > 0


def test_sp_encode_beyond_max_length(setup):
    """L=1024 through an L=256 model at sp=4: the positional table is
    extended, the parameters are the same, and the result is the port's
    single-rank encode at that length."""
    s = setup
    model = SmartContractTransformer(s["cfg"], seed=None)
    model.load_state_dict(s["weights"])
    ids, mask = s["inputs"]["long_ids"], s["inputs"]["long_mask"]
    with torch.no_grad():
        want = sp_encode(model, ids, mask, ids, mask,
                         make_sp_mesh(devices=["cpu"]), max_length=4 * L)
    assert want.shape == (B, 4 * L, D)
    assert model._pe.shape[0] == L
    for out in s["outs"][4]:
        got = out["encode_long"]
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_sp_detect_matches_jax(setup):
    """The heads on the gathered memory give JAX's heads on the unsharded
    memory, on every rank."""
    s = setup
    jm, mem = _jax_encode(s, s["params"])
    c_ref, _ = jax.jit(lambda p, m: jm.apply(
        {"params": p}, m, method=jm.contract_head))(s["params"], mem)
    l_ref = jax.jit(lambda p, m: jm.apply(
        {"params": p}, m, jnp.asarray(s["batch"]["token_to_line"]),
        method=jm.line_head))(s["params"], mem)
    for out in s["outs"][4]:
        c, l = out["detect"]
        assert c.shape == (B, 8)
        np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), **TOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(l_ref), rtol=2e-5,
                                   atol=3e-5)


def test_sp_causal_attention_raises(setup):
    for out in setup["outs"][4]:
        assert "not sequence-sharded" in out["causal"]


def test_single_rank_sp_encode_is_encode(setup):
    """The 1 × 1 mesh runs no collective: ``model.encode`` itself."""
    s = setup
    model = SmartContractTransformer(s["cfg"], seed=None)
    model.load_state_dict(s["weights"])
    model.eval()
    t = [s["inputs"][k] for k in ("input_ids", "attention_mask",
                                  "ast_input_ids", "ast_attention_mask")]
    with torch.no_grad():
        got = sp_encode(model, *t, make_sp_mesh(devices=["cpu"]))
        want = model.encode(*t)
    assert torch.equal(got, want)
