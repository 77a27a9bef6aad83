"""Legacy TASC GAN variants (binary and multiclass) of the port.

One for one with ``sct_gan_tpu/variants/tasc.py`` (same submodule names,
same numerics; see that file for the reference behaviours it keeps):

  * ``TASCEncoder``: 6 post-norm ReLU layers and a final LayerNorm;
  * ``Generator`` (MLP + Tanh) and ``Discriminator`` (MLP, LeakyReLU(0.2),
    Sigmoid);
  * ``CodeDecoder``: 6 post-norm ReLU decoder layers, an embedding whose
    row 0 starts at zero, a 2-layer projection to the 50000-token decoder
    vocab, and the KV-cached ``decode_step``. Positions index the sequence
    axis (the JAX package's deliberate deviation from the reference's
    batch-indexed PE);
  * ``VulnerabilityClassifier`` (multiclass): sigmoid type heads, the four
    per-pattern sub-detectors (attributes ``pattern_{k}_hidden`` /
    ``pattern_{k}_out``) and the location attention, whose one-key
    attention returns its weights and so takes the dense path;
  * ``SmartContractVulnerabilityGAN``: the composition; CodeBERT
    embeddings are its inputs.

Precision follows flax: parameters are f32, each Dense runs in the compute
dtype, and every LayerNorm returns f32 (a flax LayerNorm without a dtype
promotes to its f32 parameters), so the residual stream is f32.

Dropout: torch modules start in training mode, where every dropout site
(and the attention-weight dropout) draws its seed from the generator
handed to ``forward`` / ``encode``; call ``.eval()`` to run
deterministically. On the card attention runs K1 (and the backward pair
under autograd) and the decode step K5; dropout sites run K6.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import TASCConfig
from ..models.layers import (Dense, Dropout, Embed, LayerNorm,
                             MultiheadAttention, SeedSource,
                             sinusoidal_position_encoding)

PATTERN_HEADS = {
    "timestamp_dependence": 3,   # TDInvocation, TDAssign, TDContaminate
    "reentrancy": 4,             # callValue, balanceDeduction, zeroParam, Modifier
    "integer_overflow": 3,       # arithmeticOp, safeLibrary, conditionDecl
    "dangerous_delegatecall": 2, # delegateInvocation, ownerInvocation
}

# CodeDecoder's hard-coded Solidity seed ids (model_code_loc.py:167-176)
SPECIAL_TOKENS = {"pragma": 0, "solidity": 1, "contract": 2, "function": 3,
                  "returns": 4, "public": 5, "private": 6, "view": 7}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_F32 = torch.float32


class PostNormEncoderLayer(nn.Module):
    """torch-default encoder layer: x = LN(x + attn(x)); x = LN(x + ffn(x)),
    ReLU FFN."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float, dtype: torch.dtype):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, num_heads, dropout,
                                            dtype)
        self.norm1 = LayerNorm(d_model, _F32)
        self.linear1 = Dense(d_model, dim_feedforward, dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype)
        self.norm2 = LayerNorm(d_model, _F32)
        self.drop = Dropout(dropout)

    def forward(self, x, key_padding_mask=None):
        h = self.self_attn(x, x, x, key_padding_mask=key_padding_mask)
        x = self.norm1(x + self.drop(h))
        h = self.drop(F.relu(self.linear1(x)))
        return self.norm2(x + self.drop(self.linear2(h)))


class PostNormDecoderLayer(nn.Module):
    """torch-default decoder layer (post-norm, ReLU) with a cached
    ``step``."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float, dtype: torch.dtype):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, num_heads, dropout,
                                            dtype)
        self.cross_attn = MultiheadAttention(d_model, num_heads, dropout,
                                             dtype)
        self.norm1 = LayerNorm(d_model, _F32)
        self.norm2 = LayerNorm(d_model, _F32)
        self.norm3 = LayerNorm(d_model, _F32)
        self.linear1 = Dense(d_model, dim_feedforward, dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype)
        self.drop = Dropout(dropout)

    def _ffn(self, x):
        return self.linear2(self.drop(F.relu(self.linear1(x))))

    def forward(self, x, memory, memory_key_padding_mask=None):
        h = self.self_attn(x, x, x, causal=True)
        x = self.norm1(x + self.drop(h))
        h = self.cross_attn(x, memory, memory,
                            key_padding_mask=memory_key_padding_mask)
        x = self.norm2(x + self.drop(h))
        return self.norm3(x + self.drop(self._ffn(x)))

    def step(self, x, k_cache, v_cache, cross_k, cross_v, pos: int):
        """One token at ``pos``: writes its K/V into the caches in place
        (``MultiheadAttention.step``, which needs ``fuse_qkv_`` first)."""
        x = self.norm1(x + self.self_attn.step(x, k_cache, v_cache, pos))
        x = self.norm2(x + self.cross_attn.attend_kv(x, cross_k, cross_v))
        return self.norm3(x + self._ffn(x))

    def cross_kv(self, memory):
        return self.cross_attn.project_kv(memory, memory)


class TASCEncoder(nn.Module):
    """``SmartContractTransformer`` of the TASC variants
    (model_code_loc.py:9-46): post-norm layers + final LayerNorm."""

    def __init__(self, d_model: int = 768, nhead: int = 8,
                 num_layers: int = 6, dim_feedforward: int = 2048,
                 dropout: float = 0.1, dtype: torch.dtype = _F32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", PostNormEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, dtype))
        self.layer_norm = LayerNorm(d_model, _F32)

    def forward(self, x, key_padding_mask=None):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, key_padding_mask)
        return self.layer_norm(x)


class _MLP(nn.Module):
    """Two Dense + LayerNorm + activation + dropout blocks (widths f and
    f/2), then ``dense_out``: the shared body of Generator and
    Discriminator."""

    def __init__(self, d_model: int, dim_feedforward: int, out: int,
                 dropout: float, dtype: torch.dtype,
                 act: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__()
        widths = (d_model, dim_feedforward, dim_feedforward // 2)
        for i in range(2):
            self.add_module(f"dense_{i}", Dense(widths[i], widths[i + 1],
                                                dtype))
            self.add_module(f"norm_{i}", LayerNorm(widths[i + 1], _F32))
        self.dense_out = Dense(widths[2], out, dtype)
        self.drop = Dropout(dropout)
        self.act = act

    def forward(self, x):
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        for i in range(2):
            x = getattr(self, f"norm_{i}")(getattr(self, f"dense_{i}")(x))
            x = self.drop(self.act(x))
        return self.dense_out(x)


class Generator(_MLP):
    """MLP generator with Tanh output (model_code_loc.py:48-83); the output
    is in the compute dtype."""

    def __init__(self, d_model: int = 768, dim_feedforward: int = 2048,
                 dropout: float = 0.1, dtype: torch.dtype = _F32):
        super().__init__(d_model, dim_feedforward, d_model, dropout, dtype,
                         F.relu)

    def forward(self, x):
        return torch.tanh(super().forward(x))


class Discriminator(_MLP):
    """MLP discriminator, LeakyReLU(0.2) + Sigmoid, f32 scores
    (model_code_loc.py:85-125)."""

    def __init__(self, d_model: int = 768, dim_feedforward: int = 2048,
                 dropout: float = 0.1, dtype: torch.dtype = _F32):
        super().__init__(d_model, dim_feedforward, 1, dropout, dtype,
                         lambda x: F.leaky_relu(x, 0.2))

    def forward(self, x):
        return torch.sigmoid(super().forward(x)).float()


class _PaddedEmbed(Embed):
    """normal(0.02) with row 0 zeroed at init (padding_idx=0,
    model_code_loc.py:150-151); row 0 trains like any other."""

    def init_params(self, generator: torch.Generator) -> None:
        super().init_params(generator)
        with torch.no_grad():
            self.weight[0] = 0.0


class CodeDecoder(nn.Module):
    """Post-norm decoder + 2-layer vocab projection
    (model_code_loc.py:127-243)."""

    def __init__(self, d_model: int = 768, nhead: int = 8,
                 num_layers: int = 6, dim_feedforward: int = 2048,
                 dropout: float = 0.1, vocab_size: int = 50000,
                 max_length: int = 512, dtype: torch.dtype = _F32):
        super().__init__()
        self.num_layers = num_layers
        self.num_heads = nhead
        self.head_dim = d_model // nhead
        self.max_length = max_length
        self.dtype = dtype
        self.embedding = _PaddedEmbed(vocab_size, d_model)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", PostNormDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, dtype))
        self.layer_norm = LayerNorm(d_model, _F32)
        self.proj1 = Dense(d_model, 2 * d_model, dtype)
        self.proj2 = Dense(2 * d_model, vocab_size, dtype)
        self.drop = Dropout(dropout)
        self.register_buffer(
            "_pe", sinusoidal_position_encoding(max(max_length, 2048),
                                                d_model),
            persistent=False)

    @property
    def layers(self) -> List[PostNormDecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def _project(self, x):
        h = self.drop(F.relu(self.proj1(x)))
        return self.proj2(h).float()

    def forward(self, x, memory, target_sequence):
        """Teacher-forced decode of ``target_sequence`` against ``memory``
        → (B, S, vocab) f32 logits.

        ``x`` (the synthetic embedding) is accepted for signature parity
        but, as in the reference (model_code_loc.py:184-242), does not
        influence the decode: only the memory does."""
        del x
        t = self.embedding(target_sequence)
        t = self.drop(t + self._pe[:t.shape[1]])
        for layer in self.layers:
            t = layer(t, memory)
        return self._project(self.layer_norm(t))

    # -- KV-cached sampled generation (replaces the reference's host loop) --
    def init_cache(self, batch_size: int, max_length: Optional[int] = None,
                   device=None) -> List:
        """Self-attention KV caches, one (k, v) pair per layer, each
        (B, H, max_length, dh) f32 zeros, as the JAX caches: each step
        writes its K/V into them as f32 and attends over them with the
        f32-cache decode kernel on the card. Also fuses each layer's q/k/v
        projection for ``step`` from the weights as they are now."""
        for layer in self.layers:
            layer.self_attn.fuse_qkv_()
        shape = (batch_size, self.num_heads, max_length or self.max_length,
                 self.head_dim)
        device = device or self.embedding.weight.device
        return [(torch.zeros(shape, dtype=_F32, device=device),
                 torch.zeros(shape, dtype=_F32, device=device))
                for _ in range(self.num_layers)]

    def decode_step(self, token_ids, pos: int, caches, cross_kvs):
        """(B, 1) ids at ``pos`` → (B, vocab) f32 logits; writes this
        position's K/V into ``caches`` in place."""
        t = self.embedding(token_ids) + self._pe[pos:pos + 1]
        for layer, (kc, vc), (ck, cv) in zip(self.layers, caches, cross_kvs):
            t = layer.step(t, kc, vc, ck, cv, pos)
        return self._project(self.layer_norm(t))[:, 0, :]

    def cross_kvs(self, memory) -> List:
        return [layer.cross_kv(memory) for layer in self.layers]


class VulnerabilityClassifier(nn.Module):
    """Multiclass type heads + per-pattern sub-detectors + location
    attention (model_code_loc.py:261-383)."""

    def __init__(self, d_model: int = 768, num_vulnerability_types: int = 4,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 dtype: torch.dtype = _F32):
        super().__init__()
        d, f = d_model, dim_feedforward
        self.cls_dense_0 = Dense(d, f, dtype)
        self.cls_norm_0 = LayerNorm(f, _F32)
        self.cls_dense_1 = Dense(f, f // 2, dtype)
        self.cls_norm_1 = LayerNorm(f // 2, _F32)
        self.cls_out = Dense(f // 2, num_vulnerability_types, dtype)
        for k, n in PATTERN_HEADS.items():
            self.add_module(f"pattern_{k}_hidden", Dense(d, f // 2, dtype))
            self.add_module(f"pattern_{k}_out", Dense(f // 2, n, dtype))
        self.location_attention = MultiheadAttention(d, 8, dropout, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x) -> Dict[str, Any]:
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        h = self.drop(F.relu(self.cls_norm_0(self.cls_dense_0(x))))
        h = self.drop(F.relu(self.cls_norm_1(self.cls_dense_1(h))))
        vulnerability_scores = torch.sigmoid(self.cls_out(h)).float()
        pattern_scores = {
            k: torch.sigmoid(getattr(self, f"pattern_{k}_out")(F.relu(
                getattr(self, f"pattern_{k}_hidden")(x)))).float()
            for k in PATTERN_HEADS}
        q = x[:, None, :]
        attn_out, attn_weights = self.location_attention(
            q, q, q, return_weights=True)
        return {
            "vulnerability_scores": vulnerability_scores,
            "pattern_scores": pattern_scores,
            "attention_weights": attn_weights,
            "location_embeddings": attn_out[:, 0, :],
        }


def get_vulnerability_explanation(pattern_scores: Dict[str, Any],
                                  index: int = 0) -> List[str]:
    """Rule-based explanations (model_code_loc.py:360-383). Scores may be
    tensors or arrays, (B, n) (row ``index`` is read) or (n,)."""
    def row(v):
        a = np.asarray(v.detach().float().cpu() if torch.is_tensor(v) else v)
        return a[index] if a.ndim > 1 else a

    ts = {k: row(v) for k, v in pattern_scores.items()}
    explanations = []
    td = ts["timestamp_dependence"]
    if td[0] > 0.5 and (td[1] > 0.5 or td[2] > 0.5):
        explanations.append("Timestamp Dependence: Block timestamp is used "
                            "in critical operations")
    re_ = ts["reentrancy"]
    if re_[0] > 0.5 and re_[1] > 0.5 and re_[2] > 0.5 and re_[3] < 0.5:
        explanations.append("Reentrancy: Unsafe call.value usage without "
                            "proper balance deduction")
    io = ts["integer_overflow"]
    if io[0] > 0.5 and io[1] < 0.5 and io[2] < 0.5:
        explanations.append("Integer Overflow: Arithmetic operations without "
                            "safety checks")
    dd = ts["dangerous_delegatecall"]
    if dd[0] > 0.5 and dd[1] < 0.5:
        explanations.append("Dangerous Delegatecall: Unauthorized "
                            "delegatecall usage")
    return explanations


class SmartContractVulnerabilityGAN(nn.Module):
    """Composition wrapper (model_code_loc.py:385-553). CodeBERT embeddings
    are inputs (the frozen embedder lives outside the trainable module).

    Parameters are f32 and initialised from ``seed`` (xavier-uniform
    kernels, zero biases, normal(0.02) decoder embedding with row 0 zero);
    ``seed=None`` leaves them uninitialised for a state dict. In training
    mode every dropout site draws its seed from the ``generator`` handed to
    ``forward`` / ``encode`` / ``detect_vulnerabilities``."""

    def __init__(self, config: TASCConfig, seed: Optional[int] = 0):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = _DTYPES[cfg.compute_dtype]
        self.transformer = TASCEncoder(cfg.d_model, cfg.nhead, cfg.num_layers,
                                       cfg.dim_feedforward, cfg.dropout, dt)
        self.generator = Generator(cfg.d_model, cfg.dim_feedforward,
                                   cfg.dropout, dt)
        self.discriminator = Discriminator(cfg.d_model, cfg.dim_feedforward,
                                           cfg.dropout, dt)
        self.decoder = CodeDecoder(cfg.d_model, cfg.nhead, cfg.num_layers,
                                   cfg.dim_feedforward, cfg.dropout,
                                   cfg.decoder_vocab_size, cfg.max_gen_length,
                                   dt)
        if cfg.multiclass:
            self.vulnerability_classifier = VulnerabilityClassifier(
                cfg.d_model, cfg.num_vulnerability_types, cfg.dim_feedforward,
                cfg.dropout, dt)
        self.seeds = SeedSource()
        for m in self.modules():
            if isinstance(m, (Dropout, MultiheadAttention)):
                m.seeds = self.seeds
        if seed is not None:
            self.init_params(torch.Generator().manual_seed(seed))

    def init_params(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "init_params"):
                m.init_params(generator)

    def encode(self, combined_embeddings,
               generator: Optional[torch.Generator] = None):
        """(transformed (B, S, d) f32, its unmasked mean over S)."""
        with self.seeds.using(generator):
            transformed = self.transformer(combined_embeddings)
        return transformed, transformed.mean(dim=1)

    def forward(self, contract_embeddings, path_embeddings,
                target_sequence=None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        with self.seeds.using(generator):
            return self._forward(contract_embeddings, path_embeddings,
                                 target_sequence)

    def _forward(self, contract_embeddings, path_embeddings, target_sequence):
        combined = contract_embeddings + path_embeddings
        transformed, mean_embeddings = self.encode(combined,
                                                   self.seeds.generator)
        synthetic = self.generator(mean_embeddings)
        real_scores = self.discriminator(mean_embeddings)
        fake_scores = self.discriminator(synthetic)
        if target_sequence is None:
            b = contract_embeddings.shape[0]
            target_sequence = torch.full(
                (b, 2), SPECIAL_TOKENS["pragma"], dtype=torch.long,
                device=contract_embeddings.device)
            target_sequence[:, 1] = SPECIAL_TOKENS["solidity"]
        decoded_code = self.decoder(synthetic, transformed, target_sequence)
        out = {
            "embeddings": transformed,
            "synthetic": synthetic,
            "real_scores": real_scores,
            "fake_scores": fake_scores,
            "decoded_code": decoded_code,
        }
        if self.config.multiclass:
            vout = self.vulnerability_classifier(mean_embeddings)
            out["vulnerability_scores"] = vout["vulnerability_scores"]
            out["pattern_scores"] = vout["pattern_scores"]
            out["vulnerability_locations"] = vout["attention_weights"]
            out["location_embeddings"] = vout["location_embeddings"]
        return out

    def detect_vulnerabilities(self, contract_embeddings,
                               generator: Optional[torch.Generator] = None
                               ) -> Dict[str, Any]:
        """Classifier-only path (model_code_loc.py:487-516); multiclass
        only."""
        if not self.config.multiclass:
            raise ValueError("detect_vulnerabilities needs the multiclass "
                             "variant (TASCConfig(multiclass=True))")
        with self.seeds.using(generator):
            _, mean_embeddings = self.encode(contract_embeddings, generator)
            vout = self.vulnerability_classifier(mean_embeddings)
        return {
            "vulnerability_scores": vout["vulnerability_scores"],
            "vulnerability_locations": vout["attention_weights"],
            "location_embeddings": vout["location_embeddings"],
            "pattern_scores": vout["pattern_scores"],
        }


def make_tasc_generate_fn(model: SmartContractVulnerabilityGAN,
                          max_length: Optional[int] = None) -> Callable:
    """KV-cached sampled generation from the pragma seed
    (model_code_loc.py:189-218): ``fn(memory, generator) -> tokens``, (B,
    max_length) int64. Each step samples the full-vocab categorical with
    ``generator`` (on the memory's device); the loop stops when every row
    has emitted token 0, one host sync a step. ``fn.last_steps`` holds the
    ``decode_step`` calls of the last run."""
    max_len = int(max_length or model.config.max_gen_length)
    decoder = model.decoder

    @torch.inference_mode()
    def generate(memory: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, dev = memory.shape[0], memory.device
        cross = decoder.cross_kvs(memory)
        caches = decoder.init_cache(b, max_len, dev)
        tokens = torch.full((b, max_len), 0, dtype=torch.long, device=dev)
        tokens[:, 0] = SPECIAL_TOKENS["pragma"]
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        steps = 0
        for pos in range(max_len - 1):
            logits = decoder.decode_step(tokens[:, pos:pos + 1], pos, caches,
                                         cross)
            nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=generator)[:, 0]
            tokens[:, pos + 1] = nxt
            finished |= nxt == 0
            steps += 1
            if bool(finished.all()):
                break
        generate.last_steps = steps
        return tokens

    generate.last_steps = 0
    return generate
