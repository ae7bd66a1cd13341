"""deepseek-67b — llama-arch dense decoder [arXiv:2401.02954].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ArchConfig, register

DEEPSEEK_67B = register(
    ArchConfig(
        name="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        rope_theta=10_000.0,
        act="silu",
    )
)
