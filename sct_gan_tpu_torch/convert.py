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

``flax_params_from_torch`` and ``flax_opt_state_from_torch`` go the other
way, so that the port's checkpoints (``train/checkpoint.py``) hold flax
trees, which ``flax_tree_from_npz`` and ``convert_flax_params`` read back.

The configuration names the model: a ``ModelConfig`` is the
``SmartContractTransformer``, a ``TASCConfig`` the
``SmartContractVulnerabilityGAN`` and a ``CodeBERTConfig`` the frozen
CodeBERT embedder (``FlaxCodeBERT``). ``convert_tasc_opt_states`` and
``tasc_opt_states_from_torch`` carry the TASC trainer's per-submodule Adam
states (``count``, ``mu``, ``nu``, the moments over that submodule only).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from .config import CodeBERTConfig, ModelConfig, TASCConfig
from .models.layers import Dense, Embed, LayerNorm
from .models.sct_transformer import SmartContractTransformer

AnyConfig = Union[ModelConfig, TASCConfig, CodeBERTConfig]


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


def _meta_model(config: AnyConfig) -> nn.Module:
    """The port's model of ``config``, on the meta device (shapes only).
    The configuration's class name picks the model, so the JAX package's
    configurations, which have the same fields, are taken too."""
    kind = type(config).__name__
    with torch.device("meta"):
        if kind == "ModelConfig":
            return SmartContractTransformer(config, seed=None)
        if kind == "TASCConfig":
            from .variants.tasc import SmartContractVulnerabilityGAN
            return SmartContractVulnerabilityGAN(config, seed=None)
        if kind == "CodeBERTConfig":
            from .variants.codebert import FlaxCodeBERT
            return FlaxCodeBERT.from_config(config, seed=None)
    raise TypeError(f"no port model for a {kind}")


def _port_state(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax tree's leaves under the port's names (the rules above)."""
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
    return sd


def convert_flax_params(tree: Mapping,
                        config: AnyConfig) -> Dict[str, torch.Tensor]:
    """flax parameter tree (numpy or jax leaves) → the port's state dict
    (f32 CPU tensors) for the model of ``config``."""
    return _checked(_port_state(tree), _meta_model(config).state_dict())


def convert_flax_module_params(tree: Mapping, module: nn.Module
                               ) -> Dict[str, torch.Tensor]:
    """The flax tree of one of the port's building blocks (a layer stack,
    say) → ``module``'s state dict, checked against its own."""
    return _checked(_port_state(tree), module.state_dict())


def _checked(sd: Dict[str, torch.Tensor],
             want: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``sd`` if it has exactly ``want``'s names and shapes, else raise."""
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


def _flax_leaves(config: AnyConfig
                 ) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """Port parameter name → (flax leaf path, transposed?), by the type of
    the module that holds the parameter (the rules above, inverted)."""
    model = _meta_model(config)
    leaves = {}
    for mod_name, mod in model.named_modules():
        mods = tuple(mod_name.split(".")) if mod_name else ()
        for name, _ in mod.named_parameters(recurse=False):
            leaf, transpose = name, False
            if isinstance(mod, Dense) and name == "weight":
                leaf, transpose = "kernel", True
            elif isinstance(mod, Embed):
                leaf = "embedding"
            elif isinstance(mod, LayerNorm) and name == "weight":
                leaf = "scale"
            leaves[".".join((*mods, name))] = ((*mods, leaf), transpose)
    return leaves


def flax_params_from_torch(named: Mapping[str, Any],
                           config: AnyConfig, prefix: str = ""
                           ) -> Dict[str, Any]:
    """The port's parameters by name (tensors or arrays) → the nested flax
    tree of ``config``'s JAX model. Leaves are views of the inputs (a Dense
    weight transposed), not copies; every name of the port must be there.
    With ``prefix`` (a submodule's name and a dot) only that submodule's
    parameters are expected and converted."""
    leaves = {k: v for k, v in _flax_leaves(config).items()
              if k.startswith(prefix)}
    extra, missing = (sorted(named.keys() - leaves.keys()),
                      sorted(leaves.keys() - named.keys()))
    if extra or missing:
        raise ValueError(f"parameters do not match the port: unknown "
                         f"{extra}, missing {missing}")
    tree: Dict[str, Any] = {}
    for name, x in named.items():
        path, transpose = leaves[name]
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = x.T if transpose else x
    return tree


def flax_opt_state_from_torch(opt_state: Mapping[str, Any],
                              config: ModelConfig) -> Dict[str, Any]:
    """The port's optimizer state (``count``, ``mu``, ``nu`` by parameter
    name) → the JAX ``FusedOptimizer`` layout, which
    ``convert_flax_opt_state`` reads."""
    return {"count": opt_state["count"],
            "mu": flax_params_from_torch(opt_state["mu"], config),
            "nu": flax_params_from_torch(opt_state["nu"], config)}


def convert_tasc_opt_states(opt_states: Mapping[str, Mapping],
                            config: TASCConfig) -> Dict[str, Dict[str, Any]]:
    """The TASC trainer's Adam states in flax layout, ``{submodule:
    {"count", "mu", "nu"}}`` with ``mu`` and ``nu`` that submodule's flax
    subtree, → ``{submodule: {"count": int tensor, "mu": {name: tensor},
    "nu": {name: tensor}}}`` under the port's full parameter names
    (``generator.dense_0.weight``, ...). Each moment tree must cover its
    submodule exactly."""
    want = _meta_model(config).state_dict()
    out = {}
    for key, st in opt_states.items():
        sub = {n: t for n, t in want.items() if n.startswith(key + ".")}
        out[key] = {"count": torch.tensor(np.asarray(st["count"]),
                                          dtype=torch.int32)}
        for m in ("mu", "nu"):
            out[key][m] = _checked(_port_state({key: st[m]}), sub)
    return out


def tasc_opt_states_from_torch(opt_states: Mapping[str, Mapping],
                               config: TASCConfig) -> Dict[str, Any]:
    """The inverse of ``convert_tasc_opt_states``: ``{submodule: {"count",
    "mu", "nu"}}`` by port names → the flax layout, each moment the
    submodule's subtree (views, not copies)."""
    return {key: {"count": st["count"],
                  **{m: flax_params_from_torch(st[m], config,
                                               prefix=key + ".")[key]
                     for m in ("mu", "nu")}}
            for key, st in opt_states.items()}
