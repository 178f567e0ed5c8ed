"""Model configuration schema covering the 10 assigned architectures.

One frozen dataclass tree describes any model of the registry: dense /
MoE / MLA / SSM (Mamba2-SSD) / hybrid / encoder-decoder, with optional
stub modality frontends (audio frames, vision patches) and a numerics
policy (the paper's LNS modes plug in here).  The same data as the JAX
package's, so that a config and its parameter tree carry across 1:1;
``nn/model.py`` builds every family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64          # routed experts
    top_k: int = 6
    n_shared: int = 2            # always-on shared experts
    d_expert: int = 1408         # per-expert FFN hidden
    first_dense_layers: int = 1  # leading layers keep a dense FFN
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2              # d_inner = expand * d_model
    head_dim: int = 64
    chunk: int = 256             # SSD chunk length
    n_groups: int = 1            # B/C projection groups


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Mamba2 backbone with a parameter-shared attention block every
    ``attn_every`` SSM layers (Zamba2-style)."""
    attn_every: int = 6


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 12
    n_dec_layers: int = 12


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    # attention
    attn_kind: str = "gqa"       # gqa | mla | none
    qk_norm: bool = False
    causal: bool = True
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0
    block_style: str = "serial"  # serial | parallel (command-r)
    # norms / misc
    norm_kind: str = "rmsnorm"   # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"
    mlp_kind: str = "glu"        # glu | mlp
    tie_embeddings: bool = False
    # family extensions
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[str] = None   # audio_stub | vision_stub
    frontend_frac: float = 0.25      # fraction of sequence from the frontend
    # execution
    numerics: str = "bf16"           # NumericsSpec alias, spec string, or
                                     # per-layer NumericsPlan string, e.g.
                                     # "lns16-train-emulate,backend=pallas"
                                     # or "bf16;layers.mlp=fmt:lns12,
                                     # delta:lut20,quantize:params" (kept
                                     # as a string so the config stays
                                     # trivially serializable; parse via
                                     # .numerics_plan / .numerics_spec)
    param_dtype: str = "float32"     # master weights
    q_chunk: int = 512               # query-chunked attention block
    attn_bands: int = 8              # banded-causal KV extents (see
                                     # attention.py: exact at band granularity)
    attn_remat: bool = False         # inner SDPA remat (redundant under
                                     # remat="block"; measured ±0)
    ce_chunk: int = 512              # chunked-CE sequence block
    remat: str = "block"             # none | block
    vocab_pad_to: int = 256          # embedding tables padded for TP
    sequence_parallel: bool = True   # SP residual stream between blocks
    branch_sp: bool = False          # constrain attn/mlp branch outputs to
                                     # SP pre-residual (AR→RS hypothesis)
    # analysis knobs (the JAX package's dry-run)
    layer_override: Optional[int] = None
    scan_layers: bool = True     # the JAX package's scan switch; the
                                 # port always loops over the layers

    @property
    def layers(self) -> int:
        return self.layer_override or self.n_layers

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows, padded so TP sharding divides evenly."""
        p = self.vocab_pad_to
        return -(-self.vocab_size // p) * p

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM/hybrid only)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs can decode (encdec has a decoder)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def numerics_plan(self):
        """The parsed :class:`~repro_torch.core.plan.NumericsPlan` of
        ``numerics`` (cached by the parser; raises with the valid-values
        list on an unknown alias/key/pattern-override)."""
        from ..core.plan import NumericsPlan
        return NumericsPlan.parse(self.numerics)

    @property
    def numerics_spec(self):
        """The *default* :class:`~repro_torch.core.spec.NumericsSpec` of the
        numerics plan (what layers no plan rule overrides run under)."""
        return self.numerics_plan.default

    # ---- parameter counting (for 6·N·D roofline model flops) -------------
    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.n_heads, self.n_kv_heads, self.d_head
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params():
            if self.attn_kind == "mla":
                m = self.mla
                q = d * h * (m.nope_head_dim + m.rope_head_dim)
                kv_down = d * (m.kv_lora_rank + m.rope_head_dim)
                kv_up = m.kv_lora_rank * h * (m.nope_head_dim + m.v_head_dim)
                o = h * m.v_head_dim * d
                return q + kv_down + kv_up + o
            return d * h * hd + 2 * d * kv * hd + h * hd * d

        def mlp_params(hidden):
            mult = 3 if self.mlp_kind == "glu" else 2
            return mult * d * hidden

        def ssm_params():
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            in_p = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
            conv = (d_in + 2 * s.n_groups * s.d_state) * s.d_conv
            return in_p + conv + 2 * nh + d_in * d

        if self.family in ("dense", "vlm"):
            per_layer = attn_params() + mlp_params(ff)
            total = emb + self.n_layers * per_layer
        elif self.family == "moe":
            m = self.moe
            moe_ffn = (m.n_experts + m.n_shared) * mlp_params(m.d_expert)
            dense_l = m.first_dense_layers
            total = emb + self.n_layers * attn_params() \
                + dense_l * mlp_params(ff) \
                + (self.n_layers - dense_l) * moe_ffn
        elif self.family == "ssm":
            total = emb + self.n_layers * ssm_params()
        elif self.family == "hybrid":
            n_attn = 1  # parameter-shared attention block
            total = emb + self.n_layers * ssm_params() \
                + n_attn * (attn_params() + mlp_params(ff))
        elif self.family in ("encdec", "audio"):
            e = self.encdec
            enc = e.n_enc_layers * (attn_params() + mlp_params(ff))
            dec = e.n_dec_layers * (2 * attn_params() + mlp_params(ff))
            total = emb + enc + dec
        else:
            raise ValueError(self.family)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        full_moe = (m.n_experts + m.n_shared) * 3 * self.d_model * m.d_expert
        act_moe = (m.top_k + m.n_shared) * 3 * self.d_model * m.d_expert
        return int(self.param_count()
                   - (self.n_layers - m.first_dense_layers)
                   * (full_moe - act_moe))


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the assignment."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch
        return self.global_batch * self.seq_len


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
