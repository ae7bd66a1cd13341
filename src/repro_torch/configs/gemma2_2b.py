"""gemma2-2b — local+global alternating attention, logit softcaps
[arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256,
window=4096 on local (even) layers, attn softcap 50, final softcap 30,
GeGLU, sandwich norms, scaled embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

GEMMA2_2B = register(
    ArchConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        rope_theta=10_000.0,
        attn_softcap=50.0,
        final_softcap=30.0,
        window=4096,
        layer_pattern="alt_local_global",
        act="geglu",
        post_norms=True,
        embed_scale=True,
        # §Perf iterations 2b/2c/7: q/k/v and k/v-only shard pinning REGRESSED
        # for prefill (8 q-heads don't divide the 16-way model axis); the
        # train-only variant measured +4.2% collective but -3.2% on the
        # overall bound -> keep GSPMD default propagation entirely. The
        # triangular schedule also measured net-negative at this small width.
        attn_shard_hint=False,
        causal_sparse=False,
        # flash-remat recompute also measured net-negative at this scale
        flash_remat=False,
    )
)
