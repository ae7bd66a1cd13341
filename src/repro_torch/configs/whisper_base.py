"""whisper-base — encoder-decoder audio backbone [arXiv:2212.04356].

6L (decoder) + 6L (encoder) d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
Conv frontend is a STUB: input_specs() provides precomputed frame embeddings
(B, enc_frames, d_model). LayerNorm + GELU, learned positions (encoded as
absolute-positional; no RoPE).
"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_BASE = register(
    ArchConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,
        n_enc_layers=6,
        enc_frames=1500,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        norm="layernorm",
        act="gelu",
        rope_pct=0.0,  # learned absolute positions instead of RoPE
        # tiny model: the triangular pair-scan's carry overhead exceeds the
        # causal savings (measured +70% on a 0.4s memory term) — keep dense.
        # 8 heads don't divide the 16-way model axis either, so shard
        # pinning degenerates to batch-only replication (collectives x12,
        # measured) — keep default propagation.
        causal_sparse=False,
        attn_shard_hint=False,
        flash_remat=False,  # measured net-negative at 6L/512d scale
    )
)
