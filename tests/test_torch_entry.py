"""The port's driver entry points (``sct_gan_tpu_torch/entry.py``) against
the root ``__graft_entry__.py``, on the CPU at a small size:

  * ``_make_batch`` equals the root file's bit for bit;
  * ``entry(CFG, device="cpu")``'s ``fn`` on ``convert_flax_params`` of a
    flax tree gives the JAX model's four outputs, called with the root
    ``entry``'s arguments (``target_ids=input_ids``, ``token_to_line``,
    deterministic), within ``test_torch_model.TOL`` (1e-4);
  * ``dryrun_multichip(4, device="cpu")`` (gloo, dp=2, mp=2, sp=4) prints
    the JAX file's two lines and gives the world of one's loss within
    2e-4 relative (the bar of ``test_torch_parallel_dp.py``), and the sp
    memory's global shape;
  * without ``device="cpu"`` both entry points raise on a host without a
    card, and the module imports no JAX, no JAX package and no root file.
"""
import contextlib
import dataclasses
import importlib.util
import io
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu_torch import SmartContractTransformer, convert_flax_params
from sct_gan_tpu_torch.entry import _make_batch, dryrun_multichip, entry

from test_torch_model import CFG, TOL, flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the dry run at CFG's size with dropout on, so that the dp ranks' masks
# (keyed by the global row) are part of the comparison
DRYRUN_CFG = dataclasses.replace(CFG, dropout=0.1)
LOSS_RTOL = 2e-4
OUTPUTS = ("contract_vulnerability_logits", "line_vulnerability_logits",
           "logits", "discriminator_logits")


def _root_entry():
    """The root ``__graft_entry__.py`` (numpy only at module level)."""
    spec = importlib.util.spec_from_file_location(
        "root_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("b, s, vocab", [(2, 1024, 50265), (2, 64, 512),
                                         (3, 100, 256)])
def test_make_batch_equals_the_root_file(b, s, vocab):
    want = _root_entry()._make_batch(b, s, vocab)
    got = _make_batch(b, s, vocab)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def forward():
    """The port's ``fn`` and the JAX model's apply, both on the root
    file's batch at CFG, from the same flax tree."""
    params = flax_params(CFG)
    fn, (own, batch) = entry(CFG, device="cpu")
    got = fn(convert_flax_params(params, CFG), batch)
    jb = {k: jnp.asarray(v) for k, v in _make_batch(
        2, CFG.max_length, CFG.vocab_size).items()}
    out = jax.jit(lambda p: JaxModel(CFG).apply(
        {"params": p}, jb["input_ids"], jb["attention_mask"],
        jb["ast_input_ids"], jb["ast_attention_mask"],
        target_ids=jb["input_ids"], token_to_line=jb["token_to_line"],
        deterministic=True))(params)
    return got, [np.asarray(out[k]) for k in OUTPUTS], own, batch


@pytest.mark.parametrize("i", range(len(OUTPUTS)), ids=OUTPUTS)
def test_entry_fn_matches_the_jax_forward(forward, i):
    got, want, _, _ = forward
    assert tuple(got[i].shape) == want[i].shape
    np.testing.assert_allclose(got[i].numpy(), want[i], **TOL)


def test_entry_gives_its_own_params_and_the_batch(forward):
    _, _, params, batch = forward
    model = SmartContractTransformer(CFG, seed=0)
    assert list(params) == [n for n, _ in model.named_parameters()]
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in params.values())
    assert set(batch) == set(_make_batch(1, 4, 8))
    assert all(t.dtype == torch.int64 and t.shape[0] == 2
               for t in batch.values())


@pytest.fixture(scope="module")
def dryruns():
    """``dryrun_multichip`` at 4 and at 1 gloo rank on the CPU: (result,
    printed lines) each."""
    runs = {}
    for n in (4, 1):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = dryrun_multichip(n, device="cpu", cfg=DRYRUN_CFG)
        runs[n] = (res, out.getvalue().splitlines())
    return runs


def test_dryrun_on_four_ranks_gives_the_world_of_ones_loss(dryruns):
    (four, _), (one, _) = dryruns[4], dryruns[1]
    assert (four["dp"], four["mp"], four["sp"]) == (2, 2, 4)
    assert (one["dp"], one["mp"], one["sp"]) == (1, 1, 1)
    assert np.isfinite(four["loss"])
    assert abs(four["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])


def test_dryrun_prints_the_jax_files_lines(dryruns):
    for n, (res, lines) in dryruns.items():
        assert lines[0] == (f"dryrun_multichip({n}): {n} gloo ranks on "
                            + ", ".join(["cpu"] * n))
        assert lines[1] == (f"dryrun_multichip({n}): mesh dp={res['dp']} "
                            f"mp={res['mp']}, loss={res['loss']:.4f} OK")
        assert lines[2] == (f"dryrun_multichip({n}): sp={n} "
                            f"sequence-parallel encode (2, "
                            f"{DRYRUN_CFG.max_length}, "
                            f"{DRYRUN_CFG.d_model}) OK")


def test_dryrun_memory_has_the_global_shape(dryruns):
    for res, _ in dryruns.values():
        assert res["memory_shape"] == [2, DRYRUN_CFG.max_length,
                                       DRYRUN_CFG.d_model]
        assert len(res["launches"]) == res["dp"] * res["mp"]
        assert all(v == 0 for rank in res["launches"]
                   for leg in rank.values() for v in leg.values())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


def test_entry_module_imports_no_jax_and_no_root_file():
    code = textwrap.dedent("""
        import sys
        import sct_gan_tpu_torch.entry
        banned = ("jax", "sct_gan_tpu", "__graft_entry__")
        print([m for m in sys.modules
               if m.split(".")[0] in banned])
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]"
