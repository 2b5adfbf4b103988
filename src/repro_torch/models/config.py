"""Model configuration for all supported architecture families.

A copy of ``repro.models.config`` (the port imports nothing of ``repro``);
``tests/test_torch_package.py`` holds the two equal field by field for
every architecture, full and ``reduced``.  Configs for the assigned
architectures live in ``repro_torch.configs``; this module only holds the
schema plus helpers (reduced smoke variants, parameter counting).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2): shared attention block applied every N ssm layers
    hybrid_attn_every: int = 0

    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0         # 0 = full causal attention
    long_context_window: int = 0    # SWA window used only for long_500k decode
    attn_logit_softcap: float = 0.0

    # --- block details ---
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    mlp: str = "swiglu"             # swiglu | geglu | gelu | glu
    tie_embeddings: bool = False

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0        # stub frontend frames (e.g. 1500 mel frames)

    # --- VLM (paligemma) ---
    num_prefix_tokens: int = 0      # stub image tokens (prefix-LM, bidirectional)

    max_seq_len: int = 8192
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.family in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"), self.family
        if self.family == "moe":
            assert self.num_experts > 0 and self.experts_per_token > 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
        if self.family == "hybrid":
            assert self.hybrid_attn_every > 0
        if self.family == "audio":
            assert self.is_encoder_decoder and self.num_encoder_layers > 0

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def block_kind(self) -> str:
        """Transformer block kind the family instantiates — the dispatch
        key ``models.model`` builds stacks from and the jax-free layers
        (cost model, ``repro.analysis``) use to decide which runtimes /
        kernels apply (manual tp shards dense blocks only)."""
        return {"dense": "dense", "vlm": "dense", "moe": "moe",
                "ssm": "ssm"}.get(self.family, "dense")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_dinner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_dinner // self.ssm_headdim

    @property
    def supports_decode(self) -> bool:
        return True  # every assigned arch has a decoder

    @property
    def supports_long_context(self) -> bool:
        """Whether long_500k decode is in-scope (see DESIGN.md §4)."""
        if self.family == "audio":
            return False  # enc-dec, out of positional spec
        if self.family in ("ssm", "hybrid"):
            return True   # O(1) recurrent state
        return self.effective_long_window > 0

    @property
    def effective_long_window(self) -> int:
        """Sliding window used for long_500k decode for attention layers."""
        if self.sliding_window > 0:
            return self.sliding_window
        return self.long_context_window

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (must match jax init exactly; tested)."""
        d, hd = self.d_model, self.head_dim
        n = 0
        # embeddings (+ untied lm head)
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        # final norm
        n += d if self.norm == "rmsnorm" else 2 * d

        def attn_params(n_heads, n_kv):
            p = d * n_heads * hd + 2 * d * n_kv * hd + n_heads * hd * d
            if self.qkv_bias:
                p += n_heads * hd + 2 * n_kv * hd
            if self.qk_norm:
                p += 2 * hd
            return p

        def mlp_params(ff):
            if self.mlp in ("swiglu", "geglu", "glu"):
                return 3 * d * ff
            return 2 * d * ff

        def norm_params():
            return d if self.norm == "rmsnorm" else 2 * d

        def moe_params():
            p = d * self.num_experts                      # router
            p += self.num_experts * mlp_params(self.d_ff)
            return p

        def ssm_params():
            dinner, ng, st, nh = (self.ssm_dinner, self.ssm_ngroups,
                                  self.ssm_state, self.ssm_nheads)
            conv_dim = dinner + 2 * ng * st
            p = d * (2 * dinner + 2 * ng * st + nh)       # in_proj (z,x,B,C,dt)
            p += conv_dim * self.ssm_conv_width + conv_dim  # conv1d w + b
            p += nh + nh + nh                              # A_log, D, dt_bias
            p += dinner                                    # gated rmsnorm
            p += dinner * d                                # out_proj
            return p

        if self.family in ("dense", "vlm"):
            per = attn_params(self.num_heads, self.num_kv_heads) + \
                mlp_params(self.d_ff) + 2 * norm_params()
            n += self.num_layers * per
        elif self.family == "moe":
            per = attn_params(self.num_heads, self.num_kv_heads) + \
                moe_params() + 2 * norm_params()
            n += self.num_layers * per
        elif self.family == "ssm":
            per = ssm_params() + norm_params()
            n += self.num_layers * per
        elif self.family == "hybrid":
            per = ssm_params() + norm_params()
            n += self.num_layers * per
            # one shared attention block (attn + mlp + 2 norms)
            n += attn_params(self.num_heads, self.num_kv_heads) + \
                mlp_params(self.d_ff) + 2 * norm_params()
        elif self.family == "audio":
            dec = attn_params(self.num_heads, self.num_kv_heads) * 2 + \
                mlp_params(self.d_ff) + 3 * norm_params()
            enc = attn_params(self.num_heads, self.num_kv_heads) + \
                mlp_params(self.d_ff) + 2 * norm_params()
            n += self.num_layers * dec + self.num_encoder_layers * enc
            n += self.encoder_seq_len * d                 # learned enc positions
            n += d if self.norm == "rmsnorm" else 2 * d   # encoder final norm
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        per_expert = (3 if self.mlp in ("swiglu", "geglu", "glu") else 2) * d * self.d_ff
        inactive = self.num_layers * (self.num_experts - self.experts_per_token) * per_expert
        return self.param_count() - inactive


def reduced(cfg: ModelConfig, *, num_layers: int = 2, d_model: int = 256,
            max_experts: int = 4) -> ModelConfig:
    """Reduced smoke-test variant of the same family (per assignment:
    ≤2 layers, d_model ≤ 512, ≤4 experts)."""
    head_dim = 64
    num_heads = max(2, d_model // 128)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=max(64, d_model * 2),
        vocab_size=512,
        max_seq_len=512,
        encoder_seq_len=min(cfg.encoder_seq_len, 32) if cfg.encoder_seq_len else 0,
        num_prefix_tokens=min(cfg.num_prefix_tokens, 8) if cfg.num_prefix_tokens else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else 64,
        ssm_chunk=32 if cfg.ssm_state else 256,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        hybrid_attn_every=1 if cfg.family == "hybrid" else 0,
        sliding_window=min(cfg.sliding_window, 128) if cfg.sliding_window else 0,
        long_context_window=min(cfg.long_context_window, 128) if cfg.long_context_window else 0,
    )
    if cfg.is_moe:
        changes.update(
            num_experts=min(cfg.num_experts, max_experts),
            experts_per_token=min(cfg.experts_per_token, 2),
        )
    return dataclasses.replace(cfg, **changes)
