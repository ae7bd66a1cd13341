"""stablelm-3b — dense decoder, MHA (kv=heads), partial rotary, LayerNorm
[hf:stabilityai/stablelm-2-1_6b family].

32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import ArchConfig, register

STABLELM_3B = register(
    ArchConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        rope_theta=10_000.0,
        rope_pct=0.25,
        norm="layernorm",
        act="silu",
    )
)
