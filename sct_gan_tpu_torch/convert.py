"""Carry JAX (flax) parameters over to the port.

The inverse of ``torch_state_to_flax`` in ``tests/test_reference_parity.py``.
The port's modules carry the flax names, so the mapping is by rule:

  * Dense ``kernel`` (in, out)  → ``weight`` (out, in), transposed;
  * LayerNorm ``scale``         → ``weight``;
  * Embed ``embedding``         → ``weight`` (all padded-vocab rows kept);
  * ``bias`` and top-level leaves keep their names.

q, k and v stay separate projections. The result is checked against the
port's own parameter list: a key left over on either side, or a shape that
differs, raises.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .models.sct_transformer import SmartContractTransformer


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_tree_from_npz(path: str) -> Dict[str, Any]:
    """Nested flax tree from an ``.npz`` of the flattened tree, whose keys
    are the leaf paths joined by ``/``."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *mods, leaf = key.split("/")
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = data[key]
    return tree


def convert_flax_params(tree: Mapping,
                        config: ModelConfig) -> Dict[str, torch.Tensor]:
    """flax parameter tree (numpy or jax leaves) → the port's state dict
    (f32 CPU tensors) for ``SmartContractTransformer(config)``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        *mods, name = path
        arr = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            name, arr = "weight", arr.T
        elif name in ("scale", "embedding"):
            name = "weight"
        elif name != "bias" and mods:
            raise ValueError(f"unknown flax leaf {'/'.join(path)}")
        sd[".".join([*mods, name])] = torch.tensor(arr)

    with torch.device("meta"):
        want = SmartContractTransformer(config, seed=None).state_dict()
    extra, missing = sorted(sd.keys() - want.keys()), sorted(
        want.keys() - sd.keys())
    if extra or missing:
        raise ValueError(f"flax tree does not match the port: left over "
                         f"from flax {extra}, missing for the port {missing}")
    bad = [k for k in want if tuple(want[k].shape) != tuple(sd[k].shape)]
    if bad:
        raise ValueError("shape mismatch: " + ", ".join(
            f"{k} flax {tuple(sd[k].shape)} port {tuple(want[k].shape)}"
            for k in bad))
    return sd


def convert_flax_opt_state(opt_state: Mapping, config: ModelConfig
                           ) -> Dict[str, Any]:
    """The JAX ``FusedOptimizer`` state (``count``, ``mu``, ``nu``) → the
    port's ``FusedOptimizer`` state: the moments are parameter-shaped trees,
    mapped leaf by leaf with the rules of ``convert_flax_params``."""
    return {"count": torch.tensor(np.asarray(opt_state["count"]),
                                  dtype=torch.int32),
            "mu": convert_flax_params(opt_state["mu"], config),
            "nu": convert_flax_params(opt_state["nu"], config)}
