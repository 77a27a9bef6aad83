"""Building blocks of the port, one for one with ``sct_gan_tpu/models/layers.py``.

Module and parameter names follow the flax tree (``q_proj``, ``layer_0``,
``dense_1``, ``norm_0``, ...), so ``convert.py`` maps a JAX checkpoint by
rule. Numerics follow flax's mixed precision: parameters are f32; a Dense
layer casts its input, kernel and bias to the compute dtype; LayerNorm takes
f32 statistics and returns the compute dtype.

Attention goes through ``ops.attention.dot_product_attention`` (flash
kernel on CUDA, plain version on the CPU); the KV-cached single-token path
(``init_cache`` / ``precompute_cross_kv`` / ``step``) goes through
``ops.decode_attention``. The caches are updated in place.

Dropout (``Dropout`` sites and the attention-weight dropout of every
``MultiheadAttention``) is active in training mode. Each site draws its
32-bit seed on the host from its ``SeedSource``, the model's one, which
holds the generator handed to the model's forward, as the JAX package
draws ``jax.random.randint(rng, (), 0, 2**31 - 1)`` per site; a step
therefore makes no device sync for seeds. The mask itself is the hash
stream of ``ops/dropout.py``. Flax's per-site key derivation is not
reproduced, so the masks of a training forward differ from the JAX
package's.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.decode_attention import decode_attention
from ..ops.dropout import SEED_HIGH, dropout

Init = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def xavier_init(gain: float = 1.0) -> Init:
    """flax ``xavier_uniform`` (``variance_scaling(gain², fan_avg)``)."""
    return lambda w, g: nn.init.xavier_uniform_(w, gain=gain, generator=g)


def normal_init(std: float) -> Init:
    return lambda w, g: nn.init.normal_(w, 0.0, std, generator=g)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU: the tanh form in half precision, exact (erf) in f32."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def sinusoidal_position_encoding(max_len: int, d_model: int) -> torch.Tensor:
    """Classic sin/cos table (max_len, d_model), f32."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


line_position_encoding = sinusoidal_position_encoding


class SeedSource:
    """Where the dropout sites of one model draw their seeds: the
    generator handed to the model's forward, for as long as it runs."""

    def __init__(self):
        self.generator: Optional[torch.Generator] = None

    @contextlib.contextmanager
    def using(self, generator: Optional[torch.Generator]) -> Iterator[None]:
        previous, self.generator = self.generator, generator
        try:
            yield
        finally:
            self.generator = previous

    def draw(self) -> int:
        """One site's dropout seed in [0, 2**31 - 1), drawn on the host."""
        if self.generator is None:
            raise RuntimeError(
                "training-mode dropout needs a generator: pass generator="
                "torch.Generator().manual_seed(...) to the model's forward, "
                "or call .eval()")
        return int(torch.randint(0, SEED_HIGH, (), generator=self.generator))


class Dropout(nn.Module):
    """Dropout site (flax ``FastDropout``): the identity in eval mode or at
    rate 0; in training mode the hash dropout of ``ops/dropout.py`` with a
    seed from ``seeds`` (the model replaces it with its own source)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.seeds = SeedSource()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        return dropout(x, self.rate, self.seeds.draw())


class Dense(nn.Module):
    """flax ``nn.Dense``: weight (out, in) = the transposed flax kernel.
    Input, weight and bias are cast to the compute dtype (a no-op once the
    weights are held in it, see ``SmartContractTransformer.
    cast_dense_weights_``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, kernel_init: Init = xavier_init(),
                 bias_init: float = 0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.bias_init = bias_init

    def init_params(self, generator: torch.Generator) -> None:
        self.kernel_init(self.weight, generator)
        nn.init.constant_(self.bias, self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class Embed(nn.Module):
    """flax ``nn.Embed``: an f32 table, normal(0.02) init, f32 output."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=compute)``: f32 statistics
    and f32 scale/bias, output in the compute dtype."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))
        self.dtype = dtype

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), 1e-5)
        return y.to(self.dtype)


class MultiheadAttention(nn.Module):
    """PyTorch-semantics MHA over separate q/k/v/out projections, heads at
    the real width dh = d / H (the JAX lane padding is a TPU layout knob;
    the parameter tree is unpadded)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float,
                 dtype: torch.dtype, kernel_init: Init = xavier_init()):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.sm_scale = 1.0 / self.head_dim ** 0.5
        self.dropout = float(dropout)           # attention-weight dropout
        self.seeds = SeedSource()               # the model's, once built
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(d_model, d_model, dtype, kernel_init))
        self._qkv = None                        # fused (3d, d) weight, bias

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape                       # (B, S, d) -> (B, H, S, dh)
        return x.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge_out(self, x: torch.Tensor) -> torch.Tensor:
        b, _, s, _ = x.shape                    # (B, H, S, dh) -> out_proj
        return self.out_proj(x.transpose(1, 2).reshape(b, s, -1))

    def forward(self, query, key, value, *,
                key_padding_mask: Optional[torch.Tensor] = None,
                causal: bool = False, return_weights: bool = False):
        rate = self.dropout if self.training else 0.0
        out = dot_product_attention(
            self._split(self.q_proj(query)), self._split(self.k_proj(key)),
            self._split(self.v_proj(value)), key_padding_mask=key_padding_mask,
            causal=causal, dropout_rate=rate,
            seed=self.seeds.draw() if rate > 0.0 else 0,
            return_weights=return_weights, sm_scale=self.sm_scale)
        if return_weights:
            out, weights = out
            return self._merge_out(out), weights
        return self._merge_out(out)

    # -- decode-time primitives ---------------------------------------------
    def project_kv(self, key, value) -> Tuple[torch.Tensor, torch.Tensor]:
        """Split-head K/V against a fixed memory, computed once."""
        return self._split(self.k_proj(key)), self._split(self.v_proj(value))

    def attend_kv(self, query, k, v,
                  key_padding_mask: Optional[torch.Tensor] = None):
        """Attention of a one-token query against precomputed K/V."""
        q = self._split(self.q_proj(query))
        out = decode_attention(q, k, v, key_padding_mask,
                               sm_scale=self.sm_scale)
        return self._merge_out(out)

    def fuse_qkv_(self) -> None:
        """Concatenate the q/k/v projections, in the compute dtype, into the
        one (3d, d) projection that ``step`` runs. Done once per decode (by
        ``TransformerDecoderStack.init_cache``), not once per token."""
        dt = self.q_proj.dtype
        projs = (self.q_proj, self.k_proj, self.v_proj)
        self._qkv = (torch.cat([p.weight for p in projs]).to(dt),
                     torch.cat([p.bias for p in projs]).to(dt))

    def step(self, query, k_cache, v_cache, pos: int):
        """One-token causal self-attention; writes this token's K/V into the
        caches at ``pos`` (in place) and attends to positions 0..pos, passed
        to the kernel as a view of the cache cut to that length."""
        b = query.shape[0]
        h, dh = self.num_heads, self.head_dim
        w, bias = self._qkv
        qkv = F.linear(query.to(w.dtype), w, bias).view(b, 1, 3, h, dh)
        q, k_new, v_new = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        k_cache[:, :, pos] = k_new[:, :, 0]
        v_cache[:, :, pos] = v_new[:, :, 0]
        out = decode_attention(q, k_cache[:, :, :pos + 1],
                               v_cache[:, :, :pos + 1], None,
                               sm_scale=self.sm_scale)
        return self._merge_out(out)


class FeedForward(nn.Module):
    """linear1 → GELU → dropout → linear2."""

    def __init__(self, d_model: int, dim_feedforward: int, dropout: float,
                 dtype: torch.dtype):
        super().__init__()
        self.linear1 = Dense(d_model, dim_feedforward, dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.linear2(self.drop(gelu(self.linear1(x))))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm: x += attn(LN(x)); x += ffn(LN(x))."""

    def __init__(self, d_model, num_heads, dim_feedforward, dropout, dtype):
        super().__init__()
        self.norm1 = LayerNorm(d_model, dtype)
        self.self_attn = MultiheadAttention(d_model, num_heads, dropout, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.ffn = FeedForward(d_model, dim_feedforward, dropout, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, key_padding_mask=None):
        h = self.norm1(x)
        h = self.self_attn(h, h, h, key_padding_mask=key_padding_mask)
        x = x + self.drop(h)
        return x + self.drop(self.ffn(self.norm2(x)))


class TransformerDecoderLayer(nn.Module):
    """Pre-norm: causal self-attn, cross-attn to memory, FFN. ``step`` runs
    the same layer for one token against KV caches."""

    def __init__(self, d_model, num_heads, dim_feedforward, dropout, dtype):
        super().__init__()
        self.norm1 = LayerNorm(d_model, dtype)
        self.self_attn = MultiheadAttention(d_model, num_heads, dropout, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.cross_attn = MultiheadAttention(d_model, num_heads, dropout,
                                             dtype)
        self.norm3 = LayerNorm(d_model, dtype)
        self.ffn = FeedForward(d_model, dim_feedforward, dropout, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, memory, memory_key_padding_mask=None):
        h = self.norm1(x)
        x = x + self.drop(self.self_attn(h, h, h, causal=True))
        h = self.norm2(x)
        x = x + self.drop(self.cross_attn(
            h, memory, memory, key_padding_mask=memory_key_padding_mask))
        return x + self.drop(self.ffn(self.norm3(x)))

    def step(self, x, k_cache, v_cache, cross_k, cross_v, pos: int,
             memory_key_padding_mask=None):
        x = x + self.self_attn.step(self.norm1(x), k_cache, v_cache, pos)
        x = x + self.cross_attn.attend_kv(self.norm2(x), cross_k, cross_v,
                                          memory_key_padding_mask)
        return x + self.ffn(self.norm3(x))

    def cross_kv(self, memory):
        return self.cross_attn.project_kv(memory, memory)


class TransformerEncoderStack(nn.Module):
    def __init__(self, num_layers, d_model, num_heads, dim_feedforward,
                 dropout, dtype):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, num_heads, dim_feedforward, dropout, dtype))

    def forward(self, x, key_padding_mask=None):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, key_padding_mask)
        return x


class TransformerDecoderStack(nn.Module):
    def __init__(self, num_layers, d_model, num_heads, dim_feedforward,
                 dropout, dtype):
        super().__init__()
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(
                d_model, num_heads, dim_feedforward, dropout, dtype))

    @property
    def layers(self) -> List[TransformerDecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, x, memory, memory_key_padding_mask=None):
        for layer in self.layers:
            x = layer(x, memory, memory_key_padding_mask)
        return x

    # -- KV-cached decode ---------------------------------------------------
    def init_cache(self, batch_size: int, max_length: int,
                   dtype: torch.dtype, device) -> List:
        """Self-attention KV caches: one (k, v) pair per layer, each
        (B, H, max_length, dh), zeros. Also fuses each layer's q/k/v
        projection for ``step`` from the weights as they are now."""
        for layer in self.layers:
            layer.self_attn.fuse_qkv_()
        shape = (batch_size, self.num_heads, max_length, self.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in range(self.num_layers)]

    def precompute_cross_kv(self, memory) -> List:
        return [layer.cross_kv(memory) for layer in self.layers]

    def step(self, x, caches, cross_kvs, pos: int,
             memory_key_padding_mask=None):
        for layer, (kc, vc), (ck, cv) in zip(self.layers, caches, cross_kvs):
            x = layer.step(x, kc, vc, ck, cv, pos, memory_key_padding_mask)
        return x


class MLP(nn.Module):
    """[Dense (+LayerNorm) + GELU + dropout]* Dense. ``features`` lists the
    hidden and output widths; the last layer has no activation unless
    ``activate_final``."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: torch.dtype, dropout: float = 0.0,
                 use_layernorm: bool = True, activate_final: bool = False,
                 kernel_init: Init = xavier_init(),
                 final_kernel_init: Optional[Init] = None,
                 final_bias_init: float = 0.0):
        super().__init__()
        self.n = len(features)
        self.use_layernorm = use_layernorm
        self.activate_final = activate_final
        self.drop = Dropout(dropout)
        width_in = in_features
        for i, width in enumerate(features):
            last = i == self.n - 1
            kinit = (final_kernel_init if last and final_kernel_init
                     else kernel_init)
            self.add_module(f"dense_{i}", Dense(
                width_in, width, dtype, kinit,
                final_bias_init if last else 0.0))
            if use_layernorm and (not last or activate_final):
                self.add_module(f"norm_{i}", LayerNorm(width, dtype))
            width_in = width

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1 or self.activate_final:
                if self.use_layernorm:
                    x = getattr(self, f"norm_{i}")(x)
                x = self.drop(gelu(x))
        return x


class ResidualLineFeatureExtractor(nn.Module):
    """Two Dense+LayerNorm blocks (GELU after the first, dropout 0.1),
    normal(0.1) kernels; output = h + 0.1 · x."""

    def __init__(self, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.linear1 = Dense(d_model, d_model, dtype, normal_init(0.1))
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear2 = Dense(d_model, d_model, dtype, normal_init(0.1))
        self.norm2 = LayerNorm(d_model, dtype)
        self.drop = Dropout(0.1)

    def forward(self, x):
        h = self.drop(gelu(self.norm1(self.linear1(x))))
        h = self.drop(self.norm2(self.linear2(h)))
        return h + 0.1 * x
