"""arctic-480b — 128-expert top-2 MoE with parallel dense residual FFN
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
"""
from repro_torch.configs.base import ArchConfig, register

ARCTIC_480B = register(
    ArchConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        n_experts=128,
        top_k=2,
        moe_dff=4864,
        dense_residual=True,
        act="silu",
        # 56 q-heads / 8 kv-heads don't divide the 16-way model axis, so the
        # prefill shard hint degenerates to batch-only pinning and regressed
        # (+11% memory, measured); training keeps it (bf16-combine + hint
        # cut the collective term 57%). The triangular schedule also
        # measured net-negative here (attention is a small share next to the
        # MoE dispatch; the pair-scan carry costs more than it saves).
        attn_shard_hint="train",
        causal_sparse=False,
    )
)
