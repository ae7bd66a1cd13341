"""mamba2-370m — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L d_model=1024, d_ff=0 (no FFN; Mamba-2 blocks only), vocab=50280,
ssm_state=128.
"""
from repro_torch.configs.base import ArchConfig, register

MAMBA2_370M = register(
    ArchConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_groups=1,
        conv_width=4,
        ssd_chunk=256,
    )
)
