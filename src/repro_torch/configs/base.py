"""Architecture & shape configuration registry (PyTorch port).

A field-for-field copy of ``repro.configs.base``: ``dataclasses.asdict`` of
every config here equals the reference's. ``smoke()`` derives a reduced
same-family config for CPU tests.

``use_pallas`` is kept only so the field sets stay equal; it has no effect
in the port. There, each kernel wrapper dispatches on the device of its
tensor: a CUDA tensor launches the hand-written kernel, a CPU tensor takes
the plain PyTorch version, and no flag turns the plain version back on for
a CUDA tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (seq_len x global_batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A full model architecture description.

    The zoo covers six families: dense decoder LMs, MoE LMs, pure SSM
    (Mamba-2/SSD), hybrid attention+SSM (Hymba), encoder-decoder audio
    (Whisper backbone; conv frontend stubbed) and VLM (Llama-3.2-Vision text
    backbone with gated cross-attention; ViT stubbed).
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention flavour ---
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0  # stablelm: 0.25 partial rotary
    qk_norm: bool = False  # qwen3
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    window: Optional[int] = None  # sliding-window size for local layers
    layer_pattern: str = "global"  # global | alt_local_global | hymba
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | geglu | gelu
    post_norms: bool = False  # gemma2 sandwich norms
    embed_scale: bool = False  # gemma2 scales embeddings by sqrt(d_model)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0  # per-expert hidden (defaults to d_ff)
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    moe_group: int = 512  # dispatch group size (tokens)

    # --- SSM (mamba2 / hymba) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 256

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_frames: int = 1500

    # --- vlm ---
    n_img_tokens: int = 0
    cross_every: int = 0  # one cross-attn layer after every N self layers

    # --- hymba ---
    meta_tokens: int = 0

    # --- numerics / runtime ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    use_pallas: bool = False  # no effect in the port: kernels follow the tensor's device
    remat: str = "layer"  # none | layer | dots
    q_block: int = 512  # chunked-attention query block

    # --- perf knobs (EXPERIMENTS.md §Perf; False reproduces the paper-
    # faithful baseline numbers) ---
    flash_remat: bool = True  # recompute per-q-block attention in backward
    # constrain q/k/v sharding inside attention: True | False | "train"
    attn_shard_hint: object = True
    # block-sparse triangular causal schedule: only lower-triangle
    # (q-block, kv-block) pairs are computed — halves causal attention
    # FLOPs and score traffic (§Perf beyond-paper). Values: True | False |
    # "prefill". Default "prefill": in training the scan's saved per-pair
    # probabilities cost more memory than the flash-remat dense path
    # (measured It-9); extending to training needs a custom-vjp backward.
    causal_sparse: object = "prefill"
    moe_bf16_combine: bool = True  # bf16 dispatch/combine einsums

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.n_heads == 0:  # attention-free (pure SSM)
            return self.head_dim
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so the 'model' axis always divides it."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def moe_hidden(self) -> int:
        return self.moe_dff or self.d_ff

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def supports_shape(self, shape: ShapeConfig) -> bool:
        """long_500k requires sub-quadratic attention (SSM / hybrid /
        sliding-window); skipped for pure full-attention archs (DESIGN.md
        §Arch-applicability)."""
        if shape.name == "long_500k":
            return self.family in ("ssm", "hybrid") or self.layer_pattern == "alt_local_global"
        return True

    def n_params(self) -> int:
        """Analytical parameter count (embedding + blocks + head)."""
        d, dff, V = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        n_ff_mats = 3 if self.act in ("silu", "geglu") else 2
        ffn = n_ff_mats * d * dff
        per_layer = 0
        if self.family in ("dense", "audio", "vlm"):
            per_layer = attn + ffn
        elif self.family == "moe":
            moe = self.n_experts * n_ff_mats * d * self.moe_hidden + d * self.n_experts
            per_layer = attn + moe + (ffn if self.dense_residual else 0)
        elif self.family == "ssm":
            di, G, N, H = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            per_layer = d * (2 * di + 2 * G * N + H) + di * d
        elif self.family == "hybrid":
            di, G, N = self.d_inner, self.ssm_groups, self.ssm_state
            ssm = d * (2 * di + 2 * G * N + self.ssm_heads) + di * d
            per_layer = attn + ffn + ssm
        total = self.n_layers * per_layer + 2 * V * d
        if self.family == "audio":
            total += self.n_enc_layers * (attn + ffn)
            total += self.enc_frames * d  # learned encoder positions
            total += 32768 * d  # learned decoder positions (MAX_DEC_POS)
        if self.family == "vlm" and self.cross_every:
            n_cross = self.n_layers // self.cross_every
            total += n_cross * (attn + ffn)
        return total

    def active_params(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.n_params()
        n_ff_mats = 3
        dead = (self.n_experts - self.top_k) * n_ff_mats * self.d_model * self.moe_hidden
        return self.n_params() - self.n_layers * dead

    # ------------------------------------------------------------------
    def smoke(self) -> "ArchConfig":
        """A reduced same-family config that runs a CPU forward/train step."""
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            moe_dff=96 if self.n_experts else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16,
            window=16 if self.window else None,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_frames=24 if self.n_enc_layers else 1500,
            n_img_tokens=8 if self.n_img_tokens else 0,
            cross_every=2 if self.cross_every else 0,
            meta_tokens=8 if self.meta_tokens else 0,
            ssd_chunk=16,
            q_block=16,
            moe_group=32,
        )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    import os

    if os.environ.get("REPRO_PERF_BASELINE"):
        # paper-faithful baseline: every §Perf optimization disabled
        # (EXPERIMENTS.md compares this against the tuned defaults)
        cfg = dataclasses.replace(
            cfg,
            flash_remat=False,
            attn_shard_hint=False,
            moe_bf16_combine=False,
            causal_sparse=False,
        )
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        import repro_torch.configs.all  # noqa: F401  (populate registry)
    return _REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs.all  # noqa: F401

    return sorted(_REGISTRY)


def all_cells() -> list[Tuple[str, str]]:
    """All runnable (arch, shape) dry-run cells, honouring documented skips."""
    cells = []
    for a in list_archs():
        cfg = get_arch(a)
        for s in SHAPES.values():
            if cfg.supports_shape(s):
                cells.append((a, s.name))
    return cells
