"""The port's public import surface against the JAX package's, on the CPU.

Every name that a JAX package ``__init__`` exports (``__all__``, and the
top level's lazy ``_LAZY`` names with ``VULNERABILITY_TYPES`` and
``__version__``) resolves from the port's counterpart module, except the
names the port leaves out by design (``BY_DESIGN``). The JAX exports are
read from the ``__init__`` sources, so listing them imports nothing. In a
fresh process, ``import sct_gan_tpu_torch`` and its lazy names pull in no
JAX, scikit-learn or matplotlib. Each top-level function of the root
``__graft_entry__.py`` has its counterpart in ``sct_gan_tpu_torch.entry``.
The sampling helpers are held against JAX's on the same numpy logits, and
``AsyncSaver.busy`` against a save held in flight.
"""
import ast
import importlib
import pathlib
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.ops.sampling import sample_categorical as jax_sample
from sct_gan_tpu.ops.sampling import top_k_filter as jax_top_k_filter
from sct_gan_tpu.ops.sampling import \
    top_k_top_p_filter as jax_top_k_top_p_filter
from sct_gan_tpu_torch.ops.sampling import (sample_categorical, top_k_filter,
                                            top_k_top_p_filter)
from sct_gan_tpu_torch.train import checkpoint

ROOT = pathlib.Path(__file__).resolve().parents[1]

# JAX names the port leaves out, each with its reason: XLA's compilation
# cache and optax's gradient transform and its group tree have no PyTorch
# meaning (the port has ``GradientTransform``); ``FastDropout`` is the
# flax dropout that the port's ``Dropout``, backed by K6, replaces.
BY_DESIGN = {
    ("sct_gan_tpu.utils", "enable_compilation_cache"),
    ("sct_gan_tpu.train", "build_gradient_transform"),
    ("sct_gan_tpu.train", "group_index_tree"),
    ("sct_gan_tpu.models.layers", "FastDropout"),
}


def _jax_exports():
    """(JAX module, name) of every ``__all__`` and ``_LAZY`` entry of the
    JAX package's ``__init__`` files, read from their source."""
    out = [("sct_gan_tpu", "VULNERABILITY_TYPES"),
           ("sct_gan_tpu", "__version__")]
    for init in sorted((ROOT / "sct_gan_tpu").rglob("__init__.py")):
        module = ".".join(init.parent.relative_to(ROOT).parts)
        for node in ast.parse(init.read_text()).body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            target = getattr(node.targets[0], "id", None)
            if target == "__all__":
                out += [(module, e.value) for e in node.value.elts]
            elif target == "_LAZY":
                out += [(module, k.value) for k in node.value.keys]
    return out


JAX_EXPORTS = _jax_exports()


def _port_module(jax_module: str):
    return importlib.import_module(
        jax_module.replace("sct_gan_tpu", "sct_gan_tpu_torch", 1))


@pytest.mark.parametrize(
    "jax_module,name",
    [e for e in JAX_EXPORTS if e not in BY_DESIGN],
    ids=[f"{m}.{n}" for m, n in JAX_EXPORTS if (m, n) not in BY_DESIGN])
def test_port_exports_the_jax_name(jax_module, name):
    module = _port_module(jax_module)
    assert getattr(module, name) is not None
    assert name in dir(module)


def test_port_leaves_out_exactly_the_by_design_names():
    """The names the port lacks are the by-design list, no more, no
    fewer."""
    candidates = set(JAX_EXPORTS) | BY_DESIGN
    missing = {(m, n) for m, n in candidates
               if not hasattr(_port_module(m), n)}
    assert missing == BY_DESIGN


# root ``__graft_entry__.py`` functions whose counterpart has another name
ENTRY_RENAMED = {"_dryrun_impl": "_dryrun_rank"}


def test_root_entry_points_have_their_port():
    """Every top-level function of the root ``__graft_entry__.py`` (read
    with ``ast``, nothing of it imported) has its counterpart in
    ``sct_gan_tpu_torch.entry``, so an entry point added there later
    cannot go unported unnoticed."""
    from sct_gan_tpu_torch import entry
    tree = ast.parse((ROOT / "__graft_entry__.py").read_text())
    names = [node.name for node in tree.body
             if isinstance(node, ast.FunctionDef)]
    assert {"_make_batch", "entry", "dryrun_multichip",
            "_dryrun_impl"} <= set(names)
    missing = [n for n in names if not callable(
        getattr(entry, ENTRY_RENAMED.get(n, n), None))]
    assert missing == []


def test_lazy_top_level_imports_no_jax_sklearn_or_matplotlib():
    """In a fresh process: ``import sct_gan_tpu_torch`` and every lazy name
    of its top level load, and jax, scikit-learn and matplotlib stay
    unimported."""
    code = textwrap.dedent("""
        import sys
        import sct_gan_tpu_torch as p
        banned = ("jax", "sklearn", "matplotlib", "sct_gan_tpu")
        def loaded():
            return [m for m in banned if m in sys.modules]
        assert loaded() == [], loaded()
        from sct_gan_tpu_torch import (ModelConfig, TrainConfig,
                                       VULNERABILITY_TYPES,
                                       create_dataloaders, get_tokenizer)
        for name in p._LAZY:
            assert getattr(p, name) is not None and name in dir(p), name
        assert p.__version__ == "0.1.0" and len(VULNERABILITY_TYPES) == 8
        assert ModelConfig().d_model == 768
        assert loaded() == [], loaded()
        print("OK")
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.strip() == "OK", run.stderr


def _logits(seed=0, b=4, v=50):
    logits = np.random.default_rng(seed).normal(size=(b, v)) * 2.0
    logits[0, :3] = logits[0].max() + 1.0      # a tie at the top
    return logits.astype(np.float32)


@pytest.mark.parametrize("k", [0, 1, 3, 10, 50, 60])
def test_top_k_filter_matches_jax(k):
    logits = _logits()
    got = top_k_filter(torch.from_numpy(logits), k).numpy()
    want = np.asarray(jax_top_k_filter(jnp.asarray(logits), k))
    np.testing.assert_array_equal(got, want)


SAMPLE_CASES = {
    "plain": (1.0, 0, 1.0),
    "top_k5_t0.7": (0.7, 5, 1.0),
    "top_p0.8_t1.3": (1.3, 0, 0.8),
    "top_k10_top_p0.9_t0.8": (0.8, 10, 0.9),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_categorical_draws_from_the_jax_support(case):
    """The filtered logits equal JAX's; under a seeded generator every
    draw lies in JAX's support, and 20000 draws a row come within 0.02 of
    its probabilities (their standard error is at most 0.0036)."""
    temperature, top_k, top_p = SAMPLE_CASES[case]
    logits = _logits(1)
    filtered = np.array(jax_top_k_top_p_filter(
        jnp.asarray(logits / temperature), top_k, top_p))
    got_f = top_k_top_p_filter(torch.from_numpy(logits / temperature),
                               top_k, top_p).numpy()
    np.testing.assert_allclose(got_f, filtered, rtol=1e-6, atol=1e-6)
    support = filtered > -1e29
    n = 20000
    g = torch.Generator().manual_seed(0)
    draws = sample_categorical(
        torch.from_numpy(np.repeat(logits, n, axis=0)).view(4, n, -1),
        temperature, top_k, top_p, generator=g).numpy()
    assert draws.shape == (4, n)
    assert all(support[r, draws[r]].all() for r in range(4))
    jax_draws = np.asarray(jax_sample(
        jax.random.PRNGKey(0), jnp.asarray(logits), temperature, top_k,
        top_p))
    assert all(support[r, jax_draws[r]] for r in range(4))
    probs = torch.softmax(torch.from_numpy(filtered), -1).numpy()
    for r in range(4):
        freq = np.bincount(draws[r], minlength=logits.shape[1]) / n
        np.testing.assert_allclose(freq, probs[r], atol=0.02)


def test_async_saver_is_busy_while_a_save_is_in_flight(monkeypatch,
                                                        tmp_path):
    started, release = threading.Event(), threading.Event()
    written = []

    def slow_save(ckpt_dir, name, state, meta):
        started.set()
        assert release.wait(30)
        written.append(name)

    monkeypatch.setattr(checkpoint, "save_checkpoint", slow_save)
    saver = checkpoint.AsyncSaver()
    assert not saver.busy()
    saver.submit(str(tmp_path), "latest_checkpoint", {"w": torch.zeros(2)},
                 {"epoch": 1})
    assert saver.busy()                 # queued or already being written
    assert started.wait(30)
    assert saver.busy()                 # being written
    release.set()
    saver.wait()
    assert not saver.busy() and written == ["latest_checkpoint"]
