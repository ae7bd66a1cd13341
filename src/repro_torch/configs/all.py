"""Import every architecture config so the registry is populated."""
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    dbrx_132b,
    deepseek_67b,
    gemma2_2b,
    hymba_1_5b,
    llama32_vision_11b,
    mamba2_370m,
    qwen3_0_6b,
    stablelm_3b,
    whisper_base,
)
