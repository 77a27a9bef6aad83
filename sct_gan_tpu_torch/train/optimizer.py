"""Optimizer of the port: ``sct_gan_tpu/train/optimizer.py`` in PyTorch.

AdamW with the reference's four learning-rate groups and three-tier
gradient clipping (SCT-GAN/train.py:512-540, 1277-1291):

  * parameter groups by name — contract heads (lr×2), line heads (lr×3),
    discriminator (lr×0.5), base (lr×1); the rules are substrings of the
    flax leaf path, and the port's parameter names follow the flax tree, so
    they apply to a port name read with ``.`` as ``/``;
  * Adam β = (0.9, 0.98), ε = 1e-9, decoupled weight decay 0.1 on every
    parameter (LayerNorm and biases included, as the JAX formula does;
    ``torch.optim.AdamW`` with param groups would differ);
  * clipping: the feature_fusion gradients clamped to ±1 (the reference's
    grad hooks), the global L2 norm to 1.0, then the discriminator set to
    0.3 and the vulnerability-head set to 2.0 times it;
  * the NaN-loss / exploding-gradient skip.

``FusedOptimizer`` is the JAX package's single-pass optimizer: every clip
factor is a scalar composed analytically, and the skip gate is folded into
the coefficients, so a skipped step leaves parameters and moments bit for
bit as they were. All of it stays on the device: no value is read back to
the host during a step. The port updates the parameters and the moments in
place (where JAX returns new trees), which saves a copy of each.

Under mp (``mp`` and ``sharded``, the names of the parameters this rank
holds a shard of) each clip set's norm is taken over the whole parameters:
the squared norms of the sharded leaves are summed over mp, the replicated
leaves, whole and alike on every rank, counted once. Adam and the weight
decay are elementwise and run on the shards as they are.

``GradientTransform`` is the unfused chain the JAX package builds with
optax (``build_gradient_transform`` then ``apply_group_lrs``, and the train
step's skip keep-where), stage by stage over the whole gradient set: the
trainer's ``fused_optimizer=False``. Both take and keep the same state
layout, so a checkpoint of either resumes under the other.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Tuple

import torch

from ..parallel.collectives import SINGLE, Axis, all_reduce_

GROUPS = ("base", "contract", "line", "disc")

# name-substring rules, first match wins (reference order: disc → contract →
# line → base; SCT-GAN/train.py:518-527)
_DISC_KEYS = ("disc_",)
_CONTRACT_KEYS = ("contract_vulnerability_head", "contract_feature_aggregation",
                  "contract_vuln_attention")
_LINE_KEYS = ("line_vulnerability_head", "line_feature_extractor",
              "line_vuln_attention", "vuln_type_attention")
# the separate 2.0·max_norm clip set (train.py:1287-1291)
_VULN_CLIP_KEYS = ("vulnerability_head", "line_feature_extractor",
                   "line_vuln_attention", "vuln_type_attention")


def flax_path(name: str) -> str:
    """A port parameter name read as the flax leaf path the rules match."""
    return name.replace(".", "/")


def group_of(path: str, use_gan: bool) -> str:
    if use_gan and any(k in path for k in _DISC_KEYS):
        return "disc"
    if any(k in path for k in _CONTRACT_KEYS):
        return "contract"
    if any(k in path for k in _LINE_KEYS):
        return "line"
    return "base"


class LeafMeta(NamedTuple):
    """Static annotations of one parameter."""

    group: int          # index into GROUPS
    vuln_clip: bool     # in the 2.0·max_norm clip set
    disc_clip: bool     # in the 0.3·max_norm clip set
    fusion: bool        # under the feature_fusion ±1 grad clamp


def leaf_meta(name: str, use_gan: bool) -> LeafMeta:
    path = flax_path(name)
    return LeafMeta(GROUPS.index(group_of(path, use_gan)),
                    any(k in path for k in _VULN_CLIP_KEYS),
                    use_gan and any(k in path for k in _DISC_KEYS),
                    "feature_fusion" in path)


class GroupLRs(NamedTuple):
    """The four group learning rates (host floats)."""

    base: float
    contract: float
    line: float
    disc: float

    @classmethod
    def init(cls, learning_rate: float, contract_mult: float = 2.0,
             line_mult: float = 3.0, disc_mult: float = 0.5) -> "GroupLRs":
        lr = float(learning_rate)
        return cls(lr, lr * contract_mult, lr * line_mult, lr * disc_mult)

    def as_vector(self, device=None) -> torch.Tensor:
        return torch.tensor(list(self), dtype=torch.float32, device=device)


class ReduceLROnPlateau:
    """Host-side plateau scheduler with the reference's settings
    (SCT-GAN/train.py:543-550): mode=min, factor=0.3, patience=5,
    min_lr=1e-6. Scales all four group LRs together, like torch does."""

    def __init__(self, factor: float = 0.3, patience: int = 5,
                 min_lr: float = 1e-6):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float, lrs: Dict[str, float]
             ) -> Tuple[Dict[str, float], bool]:
        """Returns (possibly reduced lrs, reduced?)."""
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
            return lrs, False
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            new = {k: max(v * self.factor, self.min_lr)
                   for k, v in lrs.items()}
            return new, True
        return lrs, False

    def state_dict(self) -> Dict:
        return {"best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: Dict) -> None:
        self.best = d.get("best", float("inf"))
        self.num_bad = d.get("num_bad", 0)


def _whole_sq(sq: torch.Tensor, sharded: torch.Tensor, mp: Axis
              ) -> torch.Tensor:
    """Per-leaf squared norms of the whole parameters: the sharded leaves'
    (0/1 ``sharded``) summed over ``mp``, the others as they are."""
    return torch.where(sharded > 0, all_reduce_(sq.clone(), mp), sq)


class FusedOptimizer:
    """Clip, Adam, weight decay, group LRs and the skip gate in one pass
    over the parameters (``FusedOptimizer`` of the JAX package).

    ``named_params``: the (name, parameter) pairs to optimise, in a fixed
    order. The state is ``{"count": int32 scalar, "mu": {name: f32},
    "nu": {name: f32}}`` on the parameters' device; ``convert_flax_opt_state``
    carries the JAX optimizer's state over to it.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], *,
                 use_gan: bool, max_grad_norm: float = 1.0,
                 adam_b1: float = 0.9, adam_b2: float = 0.98,
                 adam_eps: float = 1e-9, weight_decay: float = 0.1,
                 mp: Axis = SINGLE, sharded: Iterable[str] = ()):
        self.names: List[str] = []
        self.params: List[torch.Tensor] = []
        for name, p in named_params:
            self.names.append(name)
            self.params.append(p)
        self.meta = [leaf_meta(n, use_gan) for n in self.names]
        device = self.params[0].device
        self.mp = mp
        sharded = set(sharded)
        self._sharded = torch.tensor([n in sharded for n in self.names],
                                     dtype=torch.float32, device=device)
        # 0/1 masks of the two clip sets, over the leaves
        self._vuln = torch.tensor([m.vuln_clip for m in self.meta],
                                  dtype=torch.float32, device=device)
        self._disc = torch.tensor([m.disc_clip for m in self.meta],
                                  dtype=torch.float32, device=device)
        self.max_norm = float(max_grad_norm)
        self.b1, self.b2, self.eps = (float(adam_b1), float(adam_b2),
                                      float(adam_eps))
        self.wd = float(weight_decay)

    def init(self) -> Dict:
        device = self.params[0].device
        zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for n, p in zip(self.names, self.params)}
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], opt_state: Dict,
               lrs: GroupLRs, total_loss: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply one step in place to the parameters and ``opt_state``.

        ``grads`` is aligned with the parameters. Returns (grad_norm, ok),
        both device scalars: ``ok`` is the NaN/explosion gate, taken on the
        norm after the fusion ±1 clamp, as the reference's grad hooks run
        before clip_grad_norm_ sees the gradients."""
        g_all = [g.float() for g in grads]
        # fusion grad-hook clamp (model.py:284-286): a handful of leaves
        g_all = [g.clamp(-1.0, 1.0) if m.fusion else g
                 for g, m in zip(g_all, self.meta)]

        # one reduce per leaf feeds every norm: global, vuln set, disc set
        sq = _whole_sq(torch.stack([torch.dot(g.reshape(-1), g.reshape(-1))
                                    for g in g_all]), self._sharded, self.mp)
        device = sq.device
        total_sq = sq.sum()
        vuln_sq = (sq * self._vuln).sum()
        disc_sq = (sq * self._disc).sum()

        mx = self.max_norm
        one = torch.ones((), device=device)
        norm = torch.sqrt(total_sq)
        s_g = torch.where(norm < mx, one, mx / norm)
        # subset norms on post-global-clip values = s_g * pre-clip norms
        vn = s_g * torch.sqrt(vuln_sq)
        s_v = torch.where(vn < 2.0 * mx, one, 2.0 * mx / vn)
        dn = s_g * torch.sqrt(disc_sq)
        s_d = torch.where(dn < 0.3 * mx, one, 0.3 * mx / dn)

        # the skip gate folded into the scalar coefficients
        ok = torch.isfinite(total_loss) & (norm <= 1000.0)
        okf = ok.float()
        count = opt_state["count"] + ok.int()
        b1_eff = 1.0 - okf * (1.0 - self.b1)    # ok: b1, skip: 1
        c1_eff = okf * (1.0 - self.b1)          # ok: 1-b1, skip: 0
        b2_eff = 1.0 - okf * (1.0 - self.b2)
        c2_eff = okf * (1.0 - self.b2)
        # a skipped step leaves count unchanged; t >= 1 keeps the discarded
        # bias correction finite
        t = torch.clamp_min(count.float(), 1.0)
        bc1 = 1.0 - torch.pow(self.b1, t)
        bc2 = 1.0 - torch.pow(self.b2, t)
        lr_eff = okf * lrs.as_vector(device)    # ok: lr, skip: 0 → p' = p
        scales = {(v, d): s_g * (s_v if v else 1.0) * (s_d if d else 1.0)
                  for v in (False, True) for d in (False, True)}

        for name, p, g, m in zip(self.names, self.params, g_all, self.meta):
            mu, nu = opt_state["mu"][name], opt_state["nu"][name]
            # 0·NaN = NaN, so a skipped step zeroes the clipped grad itself
            gc = torch.where(ok, g * scales[(m.vuln_clip, m.disc_clip)], 0.0)
            mu.mul_(b1_eff).add_(gc * c1_eff)
            nu.mul_(b2_eff).add_(gc * gc * c2_eff)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            pf = p.float()
            p.copy_(pf - lr_eff[m.group] * (u + self.wd * pf))
        opt_state["count"] = count
        return norm, ok


class GradientTransform:
    """The optax chain of the JAX package in plain PyTorch, one stage at a
    time (``build_gradient_transform`` + ``apply_group_lrs``):

      fusion ±1 clamp → clip by global norm (max_grad_norm) → [GAN: the
      discriminator set clipped to 0.3·max] → the vulnerability set clipped
      to 2·max → Adam (β, ε; bias-corrected) → + weight_decay·p →
      × −lr[group] → p + u;

    then the skip: a non-finite loss or a gradient norm above 1000 (taken
    after the clamp) keeps parameters, moments and count as they were.
    Each clip recomputes its set's norm on the clipped values, as optax
    does. Same constructor, state and ``update`` as ``FusedOptimizer``;
    parameters and state are updated in place."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], *,
                 use_gan: bool, max_grad_norm: float = 1.0,
                 adam_b1: float = 0.9, adam_b2: float = 0.98,
                 adam_eps: float = 1e-9, weight_decay: float = 0.1,
                 mp: Axis = SINGLE, sharded: Iterable[str] = ()):
        named = list(named_params)
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.meta = [leaf_meta(n, use_gan) for n in self.names]
        self.mp = mp
        sharded = set(sharded)
        self._sharded = torch.tensor([n in sharded for n in self.names],
                                     dtype=torch.float32,
                                     device=self.params[0].device)
        self.use_gan = use_gan
        self.max_norm = float(max_grad_norm)
        self.b1, self.b2, self.eps = (float(adam_b1), float(adam_b2),
                                      float(adam_eps))
        self.wd = float(weight_decay)

    def init(self) -> Dict:
        device = self.params[0].device
        zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for n, p in zip(self.names, self.params)}
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros(), "nu": zeros()}

    def _clip(self, gs: List[torch.Tensor], chosen: List[bool],
              max_norm: float) -> torch.Tensor:
        """optax.clip_by_global_norm over the chosen gradients, in place;
        returns their norm before the clip."""
        sq = _whole_sq(torch.stack([torch.sum(g * g) for g in gs]),
                       self._sharded, self.mp)
        norm = torch.sqrt((sq * torch.tensor(
            chosen, dtype=sq.dtype, device=sq.device)).sum())
        for i, c in enumerate(chosen):
            if c:
                gs[i] = torch.where(norm < max_norm, gs[i],
                                    gs[i] / norm * max_norm)
        return norm

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], opt_state: Dict,
               lrs: GroupLRs, total_loss: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply one step in place; returns (grad_norm, ok) as device
        scalars, as ``FusedOptimizer.update`` does."""
        gs = [g.float().clamp(-1.0, 1.0) if m.fusion else g.float()
              for g, m in zip(grads, self.meta)]
        every = [True] * len(gs)
        norm = self._clip(gs, every, self.max_norm)
        if self.use_gan:
            self._clip(gs, [m.disc_clip for m in self.meta],
                       0.3 * self.max_norm)
        self._clip(gs, [m.vuln_clip for m in self.meta], 2.0 * self.max_norm)

        ok = torch.isfinite(total_loss) & (norm <= 1000.0)
        count = opt_state["count"] + 1
        t = count.float()
        bc1 = 1.0 - torch.pow(self.b1, t)
        bc2 = 1.0 - torch.pow(self.b2, t)
        lr = lrs.as_vector(gs[0].device)
        for name, p, g, m in zip(self.names, self.params, gs, self.meta):
            mu, nu = opt_state["mu"][name], opt_state["nu"][name]
            mu2 = (1.0 - self.b1) * g + self.b1 * mu
            nu2 = (1.0 - self.b2) * (g * g) + self.b2 * nu
            u = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + self.eps)
            pf = p.float()
            u = (u + self.wd * pf) * -lr[m.group]
            p.copy_(torch.where(ok, pf + u, pf))
            mu.copy_(torch.where(ok, mu2, mu))
            nu.copy_(torch.where(ok, nu2, nu))
        opt_state["count"] = torch.where(ok, count, opt_state["count"])
        return norm, ok
