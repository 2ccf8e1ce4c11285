"""Model, shape, mesh, LMS, DDL and training configuration: the frozen
dataclasses the serve and train paths read. A copy of the JAX package's
`config/base.py` (its validation helpers and smoke shapes left out), kept
here so the port never imports the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int            # query heads (0 for attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int                 # MLP hidden (per-expert hidden for MoE)
    vocab_size: int

    # dense-transformer knobs
    qkv_bias: bool = False
    use_bias: bool = False            # bias on all linear layers (starcoder2)
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm | layernorm_nonparam
    norm_eps: float = 1e-6
    mlp_act: str = "swiglu"           # swiglu | gelu | geglu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # hybrid (RecurrentGemma)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn")
    window: int = 0                       # local-attention window
    lru_width: int = 0

    # multimodal stubs
    frontend: Optional[str] = None        # "vision" | "audio"
    mrope_sections: Tuple[int, ...] = ()  # M-RoPE split of head_dim/2 freqs
    encoder_layers: int = 0               # >0 => encoder-decoder (whisper)
    encoder_seq: int = 1500               # audio frames after conv frontend

    dtype: str = "bfloat16"

    def __post_init__(self):
        assert self.family in FAMILIES, self.family

    # ---- derived properties -------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if a 500k-token KV history is bounded (SSM state / local window)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.window > 0:
            return True
        return False

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the decoder stack."""
        if self.family == "ssm":
            return ("ssd",) * self.num_layers
        if self.family == "hybrid" and self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return ("attn",) * self.num_layers

    # ---- parameter counting (used by planner + roofline MODEL_FLOPS) -------
    def param_count(self) -> int:
        return sum(n for _, n in self.param_breakdown())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        total = 0
        for name, n in self.param_breakdown():
            if name == "moe_experts":
                total += n * self.experts_per_token // max(self.num_experts, 1)
            else:
                total += n
        return total

    def param_breakdown(self):
        """[(component, param_count)] for the full model."""
        out = []
        d = self.d_model
        out.append(("embed", self.vocab_size * d))
        if not self.tie_embeddings:
            out.append(("lm_head", self.vocab_size * d))
        kinds = self.layer_kinds()
        n_attn = sum(1 for k in kinds if k in ("attn", "local_attn"))
        n_ssd = sum(1 for k in kinds if k == "ssd")
        n_rglru = sum(1 for k in kinds if k == "rglru")

        if n_attn:
            q = d * self.num_heads * self.head_dim + (self.num_heads * self.head_dim if self.qkv_bias or self.use_bias else 0)
            kv = 2 * (d * self.num_kv_heads * self.head_dim + (self.num_kv_heads * self.head_dim if self.qkv_bias or self.use_bias else 0))
            o = self.num_heads * self.head_dim * d + (d if self.use_bias else 0)
            out.append(("attn", n_attn * (q + kv + o)))
        if n_ssd:
            di, ns, ng, nh = self.d_inner, self.ssm_state, self.ssm_ngroups, self.ssm_nheads
            in_proj = d * (2 * di + 2 * ng * ns + nh)
            conv = self.ssm_conv * (di + 2 * ng * ns)
            extra = nh * 3  # A_log, D, dt_bias
            norm = di
            out_proj = di * d
            out.append(("ssd", n_ssd * (in_proj + conv + extra + norm + out_proj)))
        if n_rglru:
            w = self.lru_width or d
            proj = 2 * d * w + w * d          # x-branch, gate-branch, out
            conv = 4 * w                       # temporal conv width 4
            lru = 3 * w                        # Lambda, input gate, rec gate (diag approx)
            gates = 2 * w * w                  # RG-LRU input/recurrent gate mats (block-diag full here)
            out.append(("rglru", n_rglru * (proj + conv + lru + gates)))

        # MLP / MoE per decoder layer
        n_mlp_layers = self.num_layers if self.family != "ssm" else 0
        if self.num_experts:
            per_expert = 3 * d * self.d_ff  # gated
            out.append(("moe_experts", n_mlp_layers * self.num_experts * per_expert))
            out.append(("router", n_mlp_layers * d * self.num_experts))
        elif n_mlp_layers:
            if self.mlp_act in ("swiglu", "geglu"):
                per = 3 * d * self.d_ff + (2 * self.d_ff + d if self.use_bias else 0)
            else:
                per = 2 * d * self.d_ff + (self.d_ff + d if self.use_bias else 0)
            out.append(("mlp", n_mlp_layers * per))

        # norms
        if self.norm_type != "layernorm_nonparam":
            scale = 2 if self.norm_type == "layernorm" else 1
            out.append(("norms", scale * (2 * self.num_layers + 1) * d))

        # encoder stack (whisper): same attn+mlp shape, full attention
        if self.is_encdec:
            enc_attn = self.encoder_layers * (4 * d * self.num_heads * self.head_dim)
            enc_mlp = self.encoder_layers * 2 * d * self.d_ff
            cross = self.num_layers * 4 * d * self.num_heads * self.head_dim
            out.append(("encoder", enc_attn + enc_mlp + cross))
        return out


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


# ---------------------------------------------------------------------------
# LMS / DDL / mesh / train configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LMSConfig:
    enabled: bool = True
    hbm_budget: int = 0               # 0 => hardware HBM size
    offload_params: str = "auto"      # "auto" | "always" | "never"
    offload_optimizer: str = "auto"
    offload_activations: str = "auto"
    remat: bool = True                # allow remat as alternative to swap
    # planner safety margin for workspace / fragmentation
    workspace_frac: float = 0.10


@dataclass(frozen=True)
class DDLConfig:
    mode: str = "allreduce"           # "allreduce" (paper) | "zero1" (beyond) | "none"
    compress_dcn: bool = False        # int8 + error feedback on pod hop
    # gradient bucketing for overlap. None = auto
    bucket_mb: Optional[int] = None
    topology_aware: bool = True       # False => flat single all-reduce
    # per-layer reduction inside the backward pass vs a post-hoc tree pass;
    # None = auto
    overlap_grads: Optional[bool] = None


@dataclass(frozen=True)
class MeshSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshSpec((16, 16), ("data", "model"))


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshSpec = SINGLE_POD
    lms: LMSConfig = field(default_factory=LMSConfig)
    ddl: DDLConfig = field(default_factory=DDLConfig)
    # optimizer
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    # execution
    microbatches: int = 1             # grad accumulation
    remat_policy: str = "auto"        # "auto" (planner) | "none" | "full" | "offload"
    seed: int = 0
    # checkpointing; None: no checkpoints (the port's own setting: the
    # trainer then neither saves nor resumes)
    checkpoint_dir: Optional[str] = "/tmp/repro_ckpt"
    checkpoint_every: int = 100
    async_checkpoint: bool = True
    # observability: metrics cross to the host (the per-step float() sync)
    # only every log_every steps
    log_every: int = 1
