"""hymba-1.5b — parallel attention + Mamba heads in every layer
[arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16,
128 learned meta tokens, sliding window 1024 everywhere except 3 global
layers (first / middle / last).
"""
from repro_torch.configs.base import ArchConfig, register

HYMBA_1_5B = register(
    ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_headdim=64,
        ssm_expand=1,  # SSM branch operates at d_model width
        window=1024,
        layer_pattern="hymba",
        meta_tokens=128,
        act="silu",
        # 128 meta tokens shift sequence lengths to S+128; pick blocking that
        # divides 4096+128, 32768+128 and 524288+128 (= 2^7 * odd).
        # §Perf It-8 tried ssd_chunk=64 (hypothesis: intra-chunk segsum
        # tensors dominate memory) — measured +-0.1% on every term ->
        # REFUTED; SSD tensors are not the prefill memory driver. Kept 128.
        ssd_chunk=128,
        q_block=128,
    )
)
