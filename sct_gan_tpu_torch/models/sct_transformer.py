"""SmartContractTransformer — the SCT-GAN model in PyTorch.

One for one with ``sct_gan_tpu/models/sct_transformer.py`` (same submodule
names, same numerics; see that file for the architecture and the
reference behaviours it keeps): ``encode``, ``contract_head``,
``line_head``, ``discriminator_forward``, the teacher-forced decoder, the
KV-cached ``decode_step``, beam search's ``encode_concat``, and the full
training/eval ``forward``.

``parallelize_(mesh)`` puts the model on a ("dp", "mp") mesh of
``parallel/``: each parameter becomes this rank's shard by the mp rules, the
layers run Megatron-style, and the line head's batch-wide statistics are
reduced over dp. ``sequence_parallel`` is the context that
``parallel.sequence.sp_encode`` runs ``encode`` in.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.segment_mean import line_segment_mean
from ..parallel.collectives import (SINGLE, Axis, all_reduce_, copy_to,
                                    gather_rows)
from .layers import (
    MLP,
    Dense,
    Dropout,
    Embed,
    LayerNorm,
    MultiheadAttention,
    ResidualLineFeatureExtractor,
    FeedForward,
    TransformerDecoderStack,
    SeedSource,
    Shards,
    TransformerEncoderStack,
    line_position_encoding,
    normal_init,
    sinusoidal_position_encoding,
    xavier_init,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _record(stats: Optional[dict], name: str, x: torch.Tensor) -> None:
    """Per-stage statistics for ``debug_forward``: (population) std as the
    JAX model's ``_debug_sow`` takes it; nothing when ``stats`` is None."""
    if stats is not None:
        x32 = x.float()
        stats[name] = {"mean": x32.mean(), "std": x32.std(correction=0),
                       "min": x32.min(), "max": x32.max()}


class _VulnTypeProcessor(nn.Module):
    """One per-type sub-head: d/2 → d/4 → 1 without LayerNorm."""

    def __init__(self, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.mlp = MLP(d_model // 2, [d_model // 4, 1], dtype, dropout=0.1,
                       use_layernorm=False)

    def forward(self, x):
        return self.mlp(x)


class SmartContractTransformer(nn.Module):
    """Dual-input encoder-decoder with vulnerability heads and GAN head.

    Parameters are f32 and initialised from ``seed`` (xavier-uniform,
    normal(0.02) / normal(0.1), the line head's final bias -0.2, zeros), as
    the JAX initialisers do — equal in distribution, not bit for bit.
    ``seed=None`` leaves them uninitialised (for loading a state dict).
    Like every torch module it starts in training mode, where every dropout
    site is active and draws its seed from the ``generator`` handed to
    ``forward``; call ``.eval()`` to serve.
    """

    def __init__(self, config: ModelConfig, seed: Optional[int] = 0):
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        dt = self.dtype = _DTYPES[cfg.compute_dtype]
        vp = cfg.padded_vocab_size
        nv = cfg.num_vulnerability_types

        self.embedding = Embed(vp, d)
        self.embedding_norm = LayerNorm(d, dt)
        self.ast_embedding = Embed(vp, d)
        self.ast_embedding_norm = LayerNorm(d, dt)
        self.embedding_dropout = Dropout(cfg.dropout)
        self.ast_embedding_dropout = Dropout(cfg.dropout)

        self.encoder = TransformerEncoderStack(
            cfg.num_encoder_layers, d, cfg.nhead, cfg.dim_feedforward,
            cfg.dropout, dt)
        self.decoder = TransformerDecoderStack(
            cfg.num_decoder_layers, d, cfg.nhead, cfg.dim_feedforward,
            cfg.dropout, dt)

        self.ast_attention = MultiheadAttention(d, cfg.nhead, cfg.dropout, dt)
        self.cross_attention = MultiheadAttention(d, cfg.nhead, cfg.dropout,
                                                  dt)
        self.feature_fusion = MLP(2 * d, [d, d // 2, d], dt,
                                  dropout=cfg.dropout)

        self.contract_vuln_attention = MultiheadAttention(
            d, cfg.nhead, cfg.dropout, dt)
        self.contract_feature_aggregation = MLP(
            2 * d, [2 * d, d], dt, dropout=cfg.dropout, activate_final=True)
        self.contract_vulnerability_head = MLP(
            d, [d, d // 2, nv], dt, dropout=cfg.dropout,
            kernel_init=normal_init(0.02), final_kernel_init=normal_init(0.02))

        self.line_feature_extractor = ResidualLineFeatureExtractor(d, dt)
        self.line_vuln_attention = MultiheadAttention(
            d, cfg.nhead, cfg.dropout * 0.2, dt, kernel_init=xavier_init(0.8))
        self.vuln_type_attention = MultiheadAttention(
            d, cfg.nhead, cfg.dropout * 0.2, dt, kernel_init=xavier_init(0.8))
        self.line_vulnerability_head_1 = MLP(
            2 * d, [d, d // 2, nv], dt, dropout=0.1, use_layernorm=False,
            final_kernel_init=normal_init(0.1), final_bias_init=-0.2)
        self.line_specific_processor = MLP(
            d, [d, d // 2], dt, dropout=0.1, use_layernorm=False,
            activate_final=True)
        for i in range(nv):
            self.add_module(f"vuln_type_processor_{i}",
                            _VulnTypeProcessor(d, dt))
        self.empty_line_embedding = nn.Parameter(torch.empty(d))

        self.output_norm = LayerNorm(d, dt)
        self.output_dropout = Dropout(cfg.dropout)
        self.output_layer = Dense(d, vp, dt, normal_init(0.02))

        if cfg.use_gan:
            self.disc_path_attention = MultiheadAttention(
                d, cfg.nhead, cfg.dropout, dt)
            self.disc_grammar_projection = Dense(d, d, dt)
            self.disc_feature_extractor = MLP(
                d, [2 * d, d], dt, dropout=cfg.dropout, activate_final=True)
            self.disc_synthetic_head = MLP(d, [d // 2, 1], dt,
                                           dropout=cfg.dropout)

        # every dropout site draws its seed from the generator handed to
        # forward, through this one source, and keys its mask by where the
        # rank's rows sit (one Shards)
        self.seeds = SeedSource()
        self.shards = Shards()
        for m in self.modules():
            if isinstance(m, (Dropout, MultiheadAttention)):
                m.seeds, m.shards = self.seeds, self.shards
        self.mesh = None        # set by parallelize_
        # the vocab axis of a column-parallel LM head (parallelize_)
        self.lm_axis: Axis = SINGLE

        self.register_buffer(
            "_pe", sinusoidal_position_encoding(cfg.max_length, d),
            persistent=False)
        self.register_buffer(
            "_line_pe", line_position_encoding(cfg.max_lines, d),
            persistent=False)
        if seed is not None:
            self.init_params(torch.Generator().manual_seed(seed))

    def init_params(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "init_params"):
                m.init_params(generator)
        nn.init.zeros_(self.empty_line_embedding)

    def cast_dense_weights_(self) -> "SmartContractTransformer":
        """Hold every Dense weight in the compute dtype. flax casts the f32
        parameter at each use, so this is the same arithmetic without the
        per-call cast. LayerNorm and embedding tables stay f32. For serving
        only: training keeps the f32 parameters."""
        for m in self.modules():
            if isinstance(m, Dense):
                m.to(self.dtype)
        return self

    def parallelize_(self, mesh) -> "SmartContractTransformer":
        """Run on ``mesh`` (``parallel.make_mesh``), in place: every
        parameter becomes this rank's shard by the mp rules
        (``parallel.mesh.param_shard_dims``) on the mesh's device, the
        sharded layers run model-parallel, and the line head reduces its
        batch-wide statistics over dp. Call it on whole weights; the same
        mesh again is a no-op, another raises."""
        if self.mesh is not None:
            if self.mesh is mesh:
                return self
            raise RuntimeError("the model is already sharded over another "
                               "mesh; build it anew from whole weights")
        from ..parallel.mesh import param_shard, param_shard_dims
        dims = param_shard_dims(self.config, mesh)
        mp = mesh.axis("mp")
        self.to(mesh.device)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if dims[name] is not None:
                    p.data = param_shard(p.data, dims[name], mp).contiguous()
        for name, m in self.named_modules():
            pre = name + "." if name else ""
            if isinstance(m, MultiheadAttention) and dims[
                    pre + "q_proj.weight"] is not None:
                m.shard_heads_(mp)
            elif isinstance(m, FeedForward) and dims[
                    pre + "linear1.weight"] is not None:
                m.shard_hidden_(mp, self.config.dim_feedforward)
            elif isinstance(m, Embed) and dims[pre + "weight"] is not None:
                m.axis = mp
        if dims["output_layer.weight"] is not None:
            self.lm_axis = mp
        self.shards.dp = mesh.axis("dp")
        self.mesh = mesh
        return self

    @contextlib.contextmanager
    def sequence_parallel(self, sp: Axis,
                          pe: Optional[torch.Tensor] = None
                          ) -> Iterator[None]:
        """Run ``encode`` on this rank's shard of the sequence: attention
        gathers K, V and the key mask over ``sp``, and the positional table
        (``pe``, when the sequence outgrows the model's) is read at the
        shard's offset."""
        old = self.shards.sp, self.shards.pe
        self.shards.sp, self.shards.pe = sp, pe
        try:
            yield
        finally:
            self.shards.sp, self.shards.pe = old

    @property
    def vuln_type_processors(self) -> List[_VulnTypeProcessor]:
        return [getattr(self, f"vuln_type_processor_{i}")
                for i in range(self.config.num_vulnerability_types)]

    # -- embedding pipelines -------------------------------------------------
    def _embed(self, ids, embed, norm, drop):
        """f32 embedding × √d → dropout → LayerNorm (compute dtype) → + PE in
        f32 → compute dtype. A sequence shard's rows sit at global positions
        [rank·s, (rank+1)·s)."""
        x = drop(embed(ids) * math.sqrt(self.config.d_model))
        pe = self._pe if self.shards.pe is None else self.shards.pe
        s = x.shape[1]
        offset = self.shards.sp.rank * s
        x = norm(x).float() + pe[offset:offset + s]
        return x.to(self.dtype)

    def embed_target(self, target_ids):
        return self._embed(target_ids, self.embedding, self.embedding_norm,
                           self.embedding_dropout)

    def embed_target_token(self, token_ids, pos: int):
        """Embed the (B, 1) decode-step tokens at position ``pos`` (the
        generation pipeline has no dropout)."""
        x = self.embedding(token_ids) * math.sqrt(self.config.d_model)
        x = self.embedding_norm(x).float() + self._pe[pos:pos + 1]
        return x.to(self.dtype)

    # -- encoder side ----------------------------------------------------------
    def encode(self, input_ids, attention_mask=None, ast_input_ids=None,
               ast_attention_mask=None):
        """Contract encoding with AST attention and fusion → (B, S, d)."""
        b, s = input_ids.shape
        src_mask = (attention_mask.bool() if attention_mask is not None
                    else torch.ones(b, s, dtype=torch.bool,
                                    device=input_ids.device))
        memory = self.encoder(
            self._embed(input_ids, self.embedding, self.embedding_norm,
                        self.embedding_dropout),
            key_padding_mask=src_mask)
        if ast_input_ids is not None and ast_attention_mask is not None:
            ast_mask = ast_attention_mask.bool()
            ast_emb = self._embed(ast_input_ids, self.ast_embedding,
                                  self.ast_embedding_norm,
                                  self.ast_embedding_dropout)
            memory = memory + 0.1 * self.ast_attention(
                memory, ast_emb, ast_emb, key_padding_mask=ast_mask)
            cross_out = self.cross_attention(memory, ast_emb, ast_emb,
                                             key_padding_mask=ast_mask)
            fused = self.feature_fusion(
                torch.cat([memory, 0.1 * cross_out], dim=-1))
            memory = memory + 0.1 * fused
        return memory

    def encode_concat(self, input_ids, attention_mask, ast_input_ids,
                      ast_attention_mask):
        """Beam search's encode: the contract's and the AST's first
        ``max_length // 2`` tokens, each embedded plainly (embed × √d + PE,
        no norm, no dropout), concatenated and run through the encoder once.
        Returns (memory, src_mask): (B, S, d) and (B, S) bool, where the
        mask has a hole wherever the contract half is padded."""
        half = self.config.max_length // 2
        scale = math.sqrt(self.config.d_model)
        pe = self._pe[:half]
        src = torch.cat(
            [self.embedding(input_ids[:, :half]) * scale + pe,
             self.ast_embedding(ast_input_ids[:, :half]) * scale + pe],
            dim=1).to(self.dtype)
        src_mask = torch.cat([attention_mask[:, :half],
                              ast_attention_mask[:, :half]], dim=1).bool()
        return self.encoder(src, key_padding_mask=src_mask), src_mask

    # -- heads -----------------------------------------------------------------
    def contract_head(self, memory):
        """Contract logits (B, types) f32 and pooling weights (B, 1, S).

        Reference quirks kept: the pooling attention has NO key mask and the
        global average is an unmasked mean. The pooling stays dense because
        it returns its weights."""
        attn_out, attn_weights = self.contract_vuln_attention(
            memory.mean(dim=1, keepdim=True), memory, memory,
            return_weights=True)
        rep = torch.cat([memory.mean(dim=1), attn_out[:, 0]], dim=-1)
        feats = self.contract_feature_aggregation(rep)
        return self.contract_vulnerability_head(feats).float(), attn_weights

    def line_head(self, memory, token_to_line,
                  stats: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
        """Line logits (B, max_lines, types) f32.

        ``stats``, a dict, receives the mean, std, min and max (f32 device
        scalars) of three stages under the names the JAX model sows them:
        ``line_means``, ``line_extracted``, ``line_logits``. Without it
        nothing is recorded (the production path)."""
        cfg = self.config
        num_lines = cfg.max_lines
        means, counts = line_segment_mean(memory, token_to_line, num_lines)
        _record(stats, "line_means", means)
        slot_ids = torch.arange(num_lines, device=memory.device)
        dp = self.shards.dp
        if cfg.per_sample_line_counts:
            row_max = token_to_line.amax(dim=-1, keepdim=True) + 1
            valid = slot_ids[None, :] < row_max                 # (B, L)
        else:
            # the line count is global across the batch (reference parity),
            # the global batch under dp
            top = all_reduce_(token_to_line.max(), dp,
                              torch.distributed.ReduceOp.MAX)
            valid = slot_ids[None, :] < top + 1                 # (1, L)

        line_pe = self._line_pe[None].to(means.dtype)
        feats = torch.where((counts > 0)[..., None], means,
                            self.empty_line_embedding) + line_pe
        original = feats

        extracted = self.line_feature_extractor(feats)
        # collapse fallback: std < 1e-6 over the valid slots → 0.1 × original
        mask_f = valid[..., None].float()
        # (sums over the global batch under dp; the statistics only pick a
        # branch, so no gradient flows through them)
        ext32 = extracted.float().detach()
        count = mask_f.sum()
        if cfg.per_sample_line_counts:
            count = all_reduce_(count, dp)
        denom = torch.clamp(count * extracted.shape[-1], min=1.0)
        mean_v = all_reduce_((ext32 * mask_f).sum(), dp) / denom
        var_v = all_reduce_((((ext32 - mean_v) ** 2) * mask_f).sum(),
                            dp) / denom
        feats = torch.where(torch.sqrt(var_v) < 1e-6, original * 0.1,
                            extracted)
        _record(stats, "line_extracted", feats)

        valid_b = valid.expand(feats.shape[0], num_lines)
        attn1 = self.line_vuln_attention(feats, feats, feats,
                                         key_padding_mask=valid_b)
        feats = feats + 0.05 * attn1
        attn2 = self.vuln_type_attention(feats, feats, feats,
                                         key_padding_mask=valid_b)
        feats = feats + 0.05 * attn2

        main_out = self.line_vulnerability_head_1(
            torch.cat([feats, attn1], dim=-1))
        line_specific = self.line_specific_processor(original)
        type_specific = torch.cat(
            [proc(line_specific) for proc in self.vuln_type_processors],
            dim=-1)
        logits = main_out + 0.1 * type_specific
        # zero logits beyond the true line count
        logits = torch.where(valid[..., None], logits, 0.0)
        _record(stats, "line_logits", logits)
        return logits.float()

    def discriminator_forward(self, features):
        if not self.config.use_gan:
            return None
        x = features + self.disc_path_attention(features, features, features)
        x = self.disc_grammar_projection(x).mean(dim=1)
        x = self.disc_feature_extractor(x)
        return self.disc_synthetic_head(x).float()

    # -- KV-cached autoregressive decode ------------------------------------
    def init_decode_cache(self, batch_size: int, device=None):
        """Per-layer self-attention KV caches sized to max_length."""
        device = device or self.empty_line_embedding.device
        return self.decoder.init_cache(batch_size, self.config.max_length,
                                       self.dtype, device)

    def precompute_cross_kv(self, memory):
        """Cross-attention K/V per decoder layer, computed once per encode."""
        return self.decoder.precompute_cross_kv(memory)

    def decode_step(self, token_ids, pos: int, caches, cross_kvs, src_mask):
        """One decode step: (B, 1) ids at ``pos`` → (B, vocab) f32 logits.
        Writes this position's K/V into ``caches`` in place."""
        x = self.embed_target_token(token_ids, pos)
        x = self.decoder.step(x, caches, cross_kvs, pos,
                              memory_key_padding_mask=src_mask)
        logits = self._lm_logits(self.output_norm(x))
        return logits[:, 0, :self.config.vocab_size].float()

    def decode_hidden(self, target_ids, memory, src_mask):
        """Teacher-forced decode up to output_norm/dropout."""
        out = self.decoder(self.embed_target(target_ids), memory,
                           memory_key_padding_mask=src_mask)
        return self.output_dropout(self.output_norm(out))

    def decode_teacher_forced(self, target_ids, memory, src_mask):
        """Teacher-forced decode → (B, S, vocab) logits, compute dtype."""
        out = self.decode_hidden(target_ids, memory, src_mask)
        return self._lm_logits(out)[..., :self.config.vocab_size]

    def _lm_logits(self, hidden):
        """The LM head's logits over the padded vocab. Column-parallel under
        mp: each rank's columns (its rows of the weight, its slice of the
        whole bias), gathered over mp. The hidden state and the bias enter
        through ``copy_to``, so their gradients are summed over mp, and the
        gather hands each rank back its own columns' gradient, as the fused
        cross-entropy does (``ops/fused_ce.py``)."""
        head, mp = self.output_layer, self.lm_axis
        if mp.size == 1:
            return head(hidden)
        n, dt = head.weight.shape[0], head.dtype
        bias = copy_to(head.bias, mp)[mp.rank * n:(mp.rank + 1) * n]
        local = F.linear(copy_to(hidden, mp).to(dt), head.weight.to(dt),
                         bias.to(dt))
        return gather_rows(local.movedim(-1, 0), mp).movedim(0, -1)

    # -- full forward ------------------------------------------------------------
    def forward(self, input_ids, attention_mask=None, ast_input_ids=None,
                ast_attention_mask=None, target_ids=None, token_to_line=None,
                return_lm_hidden: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """The reference's output dict, with shifted LM logits/targets.

        ``return_lm_hidden=True`` (the train step's fused LM-CE path)
        returns the shifted hidden states before the LM head under
        "lm_hidden" instead of "logits". In training mode every dropout
        site draws its seed from ``generator`` (a CPU ``torch.Generator``).
        """
        # the global row of this rank's first row keys its dropout masks
        self.shards.batch_origin = self.shards.dp.rank * input_ids.shape[0]
        with self.seeds.using(generator):
            return self._forward(input_ids, attention_mask, ast_input_ids,
                                 ast_attention_mask, target_ids,
                                 token_to_line, return_lm_hidden)

    def _forward(self, input_ids, attention_mask, ast_input_ids,
                 ast_attention_mask, target_ids, token_to_line,
                 return_lm_hidden):
        b, s = input_ids.shape
        src_mask = (attention_mask.bool() if attention_mask is not None
                    else torch.ones(b, s, dtype=torch.bool,
                                    device=input_ids.device))
        memory = self.encode(input_ids, attention_mask, ast_input_ids,
                             ast_attention_mask)
        contract_logits, contract_attn_weights = self.contract_head(memory)
        out: Dict[str, Any] = {
            "contract_vulnerability_logits": contract_logits,
            "line_vulnerability_logits": (
                self.line_head(memory, token_to_line)
                if token_to_line is not None else None),
            "contract_attn_weights": contract_attn_weights,
            "encoder_output": memory.mean(dim=1).float(),
            "memory": memory,
        }
        if target_ids is not None:
            if return_lm_hidden:
                hidden = self.decode_hidden(target_ids, memory, src_mask)
                out["lm_hidden"] = hidden[:, :-1, :]
            else:
                logits = self.decode_teacher_forced(target_ids, memory,
                                                    src_mask)
                out["logits"] = logits[:, :-1, :]
            out["target_ids"] = target_ids[:, 1:]
        out["discriminator_logits"] = self.discriminator_forward(memory)
        return out
