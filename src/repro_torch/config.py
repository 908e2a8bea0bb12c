"""Configuration of the port: copies of ``repro.config``'s
:class:`ModelConfig` (with ``reduced()``, ``param_count()`` and
``layer_kinds()``), :class:`TrainConfig` and :class:`ConvexConfig`, field
for field, and the arch registry (``register`` / ``get_arch``) that
``repro_torch.configs`` fills.

The port keeps its own copy, because it imports nothing of ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for one model in the zoo."""

    name: str
    family: str                      # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- attention flavour ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # None = full attention
    attn_logit_softcap: Optional[float] = None
    pad_heads_to: int = 0            # TP alignment: pad Q heads to this
                                     # count with MASKED (inert) heads
    # --- norms / mlp ---
    norm_type: str = "rmsnorm"       # "rmsnorm" | "layernorm"
    mlp_type: str = "swiglu"         # "swiglu" | "gelu"
    mlp_bias: bool = False
    # --- embeddings ---
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0             # 0 -> dense MLP
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0      # 0 -> no shared expert
    shared_expert_gate: bool = False
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0               # d_state; 0 -> no ssm
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64              # SSD chunk length
    # --- hybrid (RecurrentGemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec","rec","attn"); () -> all "attn" or all "ssm"
    local_window: int = 0            # local-attention window for hybrid blocks
    rglru_heads: int = 0
    # --- modality frontend stub ---
    frontend: Optional[str] = None   # None | "vision" | "audio"
    frontend_tokens: int = 0         # prompt-prefix embedding tokens supplied by the stub
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: num_heads must divide by num_kv_heads")

    # -- derived sizes ------------------------------------------------------
    @property
    def padded_heads(self) -> int:
        """Physical Q-head count: num_heads, or pad_heads_to when set.
        Padded heads are zero-masked in attention (exact semantics) and
        exist purely so the head axis divides the tensor-parallel axis."""
        return max(self.pad_heads_to, self.num_heads) \
            if self.pad_heads_to else self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is natively sub-quadratic in memory."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length num_layers."""
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return ("attn",) * self.num_layers

    def param_count(self) -> int:
        """Exact parameter count (embeddings included once if tied)."""
        d, h = self.d_model, self.head_dim
        n_attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.qkv_bias:
            n_attn += self.q_dim + 2 * self.kv_dim
        if self.qk_norm:
            n_attn += 2 * h
        if self.mlp_type == "swiglu":
            n_mlp_dense = 3 * d * self.d_ff
        else:
            n_mlp_dense = 2 * d * self.d_ff + (self.d_ff + d if self.mlp_bias else 0)
        if self.is_moe:
            per_exp = 3 * d * self.moe_d_ff
            n_mlp = self.num_experts * per_exp + d * self.num_experts
            if self.shared_expert_d_ff:
                n_mlp += 3 * d * self.shared_expert_d_ff + (d if self.shared_expert_gate else 0)
        else:
            n_mlp = n_mlp_dense
        # ssm block params (in_proj for x,z,B,C,dt; out_proj; conv; A,D,dt_bias, norm)
        d_inner = self.ssm_expand * d
        nheads = max(d_inner // max(self.ssm_head_dim, 1), 1)
        n_ssm = (d * (2 * d_inner + 2 * self.ssm_state + nheads)
                 + d_inner * d + 4 * (d_inner + 2 * self.ssm_state)
                 + 3 * nheads + d_inner)
        # rg-lru block: wx_in, wy_in, out (3*d*dr) + conv (5dr) + lambda (dr)
        # + block-diagonal gates wa, wi (2*dr^2/heads)
        w = self.rglru_heads or self.num_heads
        d_rec = d
        n_rec = (3 * d * d_rec + 6 * d_rec + 2 * d_rec * d_rec // w)
        n_local = n_attn
        per_kind = {"attn": n_attn + n_mlp, "ssm": n_ssm,
                    "rec": n_rec + n_mlp_dense, "local": n_local + n_mlp_dense}
        total = 0
        for k in self.layer_kinds():
            total += per_kind[k] + 2 * d  # two norms per block
        total += d  # final norm
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.frontend is not None:
            total += d * d  # projector stub
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dead = (self.num_experts - self.num_experts_per_tok) * 3 * d * self.moe_d_ff
        return self.param_count() - dead * self.num_layers // 1

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant of the same family (2 layers, tiny dims)."""
        kv = min(self.num_kv_heads, 2)
        heads = max(2, min(4, self.num_heads))
        heads = heads - heads % kv if heads % kv else heads
        pat = self.block_pattern[: max(len(self.block_pattern), 0)]
        return replace(
            self,
            name=self.name + "-reduced",
            num_layers=2 if not pat else max(2, len(pat)),
            d_model=128,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4) if self.is_moe else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2) if self.is_moe else 0,
            moe_d_ff=64 if self.is_moe else 0,
            shared_expert_d_ff=64 if self.shared_expert_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=8 if self.ssm_state else self.ssm_chunk,
            local_window=min(self.local_window, 16) if self.local_window else 0,
            rglru_heads=2 if self.rglru_heads else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend else 0,
        )


# ---------------------------------------------------------------------------
# Training configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 4096
    global_batch: int = 256
    microbatch: int = 0              # 0 -> no gradient accumulation
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    optimizer: str = "adam"          # "sgd" | "momentum" | "adam" | "adamw"
    # --- the paper's technique ---
    vr: str = "none"                 # "none" | "centralvr" | "svrg" | "saga"
    vr_table_size: int = 8           # M index-groups for centralvr/saga tables
    local_epoch: int = 1             # K local steps between (x, ḡ) communications
    async_mode: bool = False         # CentralVR-Async delta algebra
    # --- memory policy ---
    remat: str = "block"             # "none" | "block" | "full"
    dp_replicated: bool = False      # paper-faithful pure-DP (no FSDP) when True
    seed: int = 0


# ---------------------------------------------------------------------------
# Convex (paper §6) configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvexConfig:
    problem: str = "logistic"        # "logistic" | "ridge" | "huber" | ...
    n: int = 5000                    # samples (per worker in distributed runs)
    d: int = 20
    lam: float = 1e-4                # l2 regularizer (paper value)
    outlier_frac: float = 0.0        # label corruption rate (robust runs)
    huber_delta: float = 1.0         # Huber/pseudo-Huber transition scale
    learning_rate: float = 0.1
    epochs: int = 30
    seed: int = 0
    # distributed
    workers: int = 1
    method: str = "centralvr"        # core/ algorithm id
    tau: int = 0                     # communication period (0 -> one local epoch)
    async_mode: bool = False


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def _ensure_loaded() -> None:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers every arch)
