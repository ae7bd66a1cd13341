"""qwen3-0.6b — dense decoder with qk-norm and GQA [hf:Qwen/Qwen3-8B family].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, head_dim=128.
"""
from repro_torch.configs.base import ArchConfig, register

QWEN3_0_6B = register(
    ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        rope_theta=1_000_000.0,
        qk_norm=True,
        act="silu",
    )
)
