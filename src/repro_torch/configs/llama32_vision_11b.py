"""llama-3.2-vision-11b — text backbone with gated cross-attention image
layers [hf:meta-llama/Llama-3.2-11B-Vision].

40L total: 32 self-attn + 8 gated cross-attn layers (one after every 4 self
layers). d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256. The ViT
frontend is a STUB: input_specs() provides precomputed patch embeddings
(B, n_img_tokens, d_model).
"""
from repro_torch.configs.base import ArchConfig, register

LLAMA32_VISION_11B = register(
    ArchConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=32,  # self-attn layers; +8 cross layers via cross_every
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500_000.0,
        act="silu",
        n_img_tokens=1601,
        cross_every=4,
    )
)
