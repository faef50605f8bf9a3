"""Model, sampler and phase-aware-sampling (PAS) plan configs.

The port's own copy of ``repro/common/types.py``: the LM transformer half
(``AttnSpec``, ``MoESpec``, ``LMConfig``, the shape cells) and the
diffusion half.  Field names, defaults, derived counts and plan semantics
are identical.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# LM transformer configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Attention behaviour for one slot of the repeating layer pattern."""

    kind: str = "global"  # "global" | "local" (sliding window) | "none"
    window: int = 0  # sliding-window size when kind == "local"

    def __post_init__(self):
        if self.kind not in ("global", "local", "none"):
            raise ValueError(f"bad attention kind: {self.kind}")
        if self.kind == "local" and self.window <= 0:
            raise ValueError("local attention needs window > 0")


GLOBAL = AttnSpec("global")


def local(window: int) -> AttnSpec:
    return AttnSpec("local", window)


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # 'ep' shards experts over the model axis, 'tp' shards d_expert; read by
    # the mesh layouts only (off-mesh every expert is local)
    shard_mode: str = "auto"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str  # "dense" | "moe" | "audio" | "vlm" | "ssm" | "hybrid"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # layer pattern: `pattern` repeats until n_layers is covered; a partial
    # final repeat is allowed (e.g. gemma3's 26 = 4x(5L+1G) + 2L tail).
    pattern: Tuple[AttnSpec, ...] = (GLOBAL,)

    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    act: str = "silu"  # "silu" | "gelu"
    glu: bool = True  # SwiGLU/GeGLU vs plain MLP
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling
    logit_softcap: float = 0.0  # gemma2-style final-logit soft capping
    attn_softcap: float = 0.0  # gemma2-style attention-logit soft capping
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q/k
    post_norm: bool = False  # gemma2/3-style post-sublayer norms
    moe: Optional[MoESpec] = None
    # number of parallel output heads over the same vocab (musicgen codebooks)
    n_codebooks: int = 1
    # modality frontend stub: if set, inputs are precomputed embeddings of
    # this dimensionality instead of token ids.
    frontend_stub: Optional[str] = None  # None | "audio_frames" | "vision_patches"

    # ssm / hybrid extras
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    #: weights and activations of the model: a "bfloat16" model computes in
    #: bf16 (norm statistics, router and attention scores in float32)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be divisible by n_kv_heads")

    # -- derived -----------------------------------------------------------
    def layer_specs(self) -> Tuple[AttnSpec, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return tuple((self.pattern * reps)[: self.n_layers])

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "ssm":  # mLSTM block: qkv + gates + out
            inner = self.ssm_expand * d
            attn = d * inner * 3 + 2 * d * self.n_heads + inner * d
        if self.family == "hybrid":
            inner = self.ssm_expand * d
            attn += d * inner * 2 + inner * d + inner * self.ssm_state * 2
        if self.moe is not None:
            mlp = self.moe.num_experts * 3 * d * self.moe.d_expert
            mlp += d * self.moe.num_experts  # router
        elif f > 0:
            mlp = (3 if self.glu else 2) * d * f
        else:
            mlp = 0
        per_layer = attn + mlp + 2 * d  # + norms
        emb = v * d * (1 if self.tie_embeddings else 2) * self.n_codebooks
        return self.n_layers * per_layer + emb

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        mlp_all = self.n_layers * self.moe.num_experts * 3 * d * self.moe.d_expert
        mlp_act = self.n_layers * self.moe.top_k * 3 * d * self.moe.d_expert
        return full - mlp_all + mlp_act


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named mesh of ``prod(axis_sizes)`` devices with no device in it:
    the counterpart of ``jax.sharding.AbstractMesh``, read by the partition
    specs (``common/sharding.py``) and the dry run (``launch/dryrun.py``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} and names {self.axis_names} differ")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        out = 1
        for n in self.axis_sizes:
            out *= n
        return out

# ---------------------------------------------------------------------------
# Diffusion configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str
    in_channels: int = 4
    out_channels: int = 4
    base_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    n_res_blocks: int = 2
    attn_levels: Tuple[int, ...] = (0, 1, 2)  # levels with transformer blocks
    n_heads: int = 8
    tf_depth: int = 1  # transformer blocks per attention site
    ctx_dim: int = 768  # text-conditioning width
    ctx_len: int = 77
    time_dim: int = 1280
    groups: int = 32
    latent_size: int = 64  # spatial size of the latent
    #: storage type of the weights; activations are always float32, and
    #: "bfloat16" weights are held as float32 tensors of bf16-rounded values
    dtype: str = "float32"
    #: transformer blocks a level (the mid block takes the last level's);
    #: where set, each attention site is one stack of that depth (one group
    #: norm, proj_in, the blocks, proj_out, one residual), and ``tf_depth``
    #: is unused; None: ``tf_depth`` whole sites, each with its own residual
    tf_depths: Optional[Tuple[int, ...]] = None
    #: width of every head where set (heads = channels // head_dim at each
    #: level); None: ``n_heads`` heads at every level
    head_dim: Optional[int] = None
    #: SDXL's "text_time" conditioning: a pooled prompt vector and time ids
    #: (each through a ``time_id_dim`` sinusoid), through a two-layer MLP
    #: added to the time embedding; 0 = none
    pooled_dim: int = 0
    n_time_ids: int = 0
    time_id_dim: int = 0

    @property
    def n_levels(self) -> int:
        return len(self.channel_mult)

    @property
    def n_skip_blocks(self) -> int:
        """Number of paper-indexed down/up block pairs (Fig. 3: 12 for SD)."""
        return 1 + self.n_levels * self.n_res_blocks + (self.n_levels - 1)


# Helpers over a U-Net config's SDXL fields, as free functions so that a
# config that lacks those fields (the JAX package's ``UNetConfig``) reads as
# one that leaves them at their defaults.


def added_cond_dim(cfg) -> int:
    """Input width of the added-conditioning MLP (0: none)."""
    return getattr(cfg, "pooled_dim", 0) + getattr(cfg, "n_time_ids", 0) * getattr(
        cfg, "time_id_dim", 0)


def heads_at(cfg, channels: int) -> int:
    """Attention heads at a level of ``channels`` channels."""
    head_dim = getattr(cfg, "head_dim", None)
    return channels // head_dim if head_dim else cfg.n_heads


def site_depths(cfg, level: int | None) -> Tuple[int, ...]:
    """Depth of each attention site's stack at ``level`` (None: the mid
    block): ``tf_depth`` sites of 1 block, or one stack."""
    depths = getattr(cfg, "tf_depths", None)
    if depths is None:
        return (1,) * cfg.tf_depth
    return (depths[-1 if level is None else level],)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    timesteps_train: int = 1000
    timesteps_sample: int = 50
    scheduler: str = "pndm"  # "ddim" | "pndm"
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    guidance_scale: float = 7.5


@dataclasses.dataclass(frozen=True)
class PASPlan:
    """{T_sketch, T_complete, T_sparse, L_sketch, L_refine} of the paper."""

    t_sketch: int
    t_complete: int
    t_sparse: int
    l_sketch: int
    l_refine: int

    def validate(self, total_steps: int, n_blocks: int, d_star: int | None = None):
        if not (0 < self.t_complete <= self.t_sketch <= total_steps):
            raise ValueError("need 0 < T_complete <= T_sketch <= T")
        if self.t_sparse < 1:
            raise ValueError("T_sparse >= 1")
        if not (0 < self.l_refine <= self.l_sketch <= n_blocks):
            raise ValueError("need 0 < L_refine <= L_sketch <= n_blocks")
        if d_star is not None and self.t_sketch < d_star:
            raise ValueError(
                f"T_sketch={self.t_sketch} must be >= D*={d_star} (paper Sec. III-B)"
            )

    def schedule(self, total_steps: int) -> list[int]:
        """Per-timestep block budget l_t. -1 denotes a full U-Net run."""
        out = []
        for t in range(total_steps):
            if t < self.t_complete:
                out.append(-1)
            elif t < self.t_sketch:
                since = t - self.t_complete
                out.append(-1 if (since + 1) % self.t_sparse == 0 else self.l_sketch)
            else:
                out.append(self.l_refine)
        return out
