"""dbrx-132b — fine-grained 16-expert top-4 MoE [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.configs.base import ArchConfig, register

DBRX_132B = register(
    ArchConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        n_experts=16,
        top_k=4,
        moe_dff=10752,
        dense_residual=False,
        act="silu",
    )
)
