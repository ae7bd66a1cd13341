"""Public model API: build once from an ArchConfig, get functions on tensors
(``repro.models.registry``). Entry points run on ``"cuda"`` unless the
caller asks for ``device="cpu"``; asking for CUDA without a card raises."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing CUDA on a machine without it (the
    port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


class ModelApi(NamedTuple):
    cfg: ArchConfig
    device: torch.device
    init: Callable[[int], Any]  # (seed) -> params
    loss: Callable[[Any, Any], Any]  # (params, batch) -> (loss, metrics)
    prefill: Callable[[Any, Any], Any]  # (params, batch) -> (last logits, caches)
    decode: Callable[[Any, Any, Any, Any], Any]  # (params, caches, tok, pos)
    init_cache: Callable[[int, int], Any]  # (batch, max_len) -> caches


def build_model(cfg: ArchConfig, device="cuda") -> ModelApi:
    dev = resolve_device(device)

    def init(seed: int):
        return T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)

    def loss(params, batch):
        return T.train_loss(params, cfg, batch)

    def prefill(params, batch):
        hidden, _, caches = T.forward(params, cfg, batch, "prefill")
        # only the last position's logits are needed to start decoding
        return T.full_logits(params, cfg, hidden[:, -1:, :])[:, 0, :], caches

    def decode(params, caches, tokens, positions):
        return T.decode_step(params, cfg, caches, tokens, positions)

    def init_cache(batch, max_len):
        return T.init_cache(cfg, batch, max_len, dev)

    return ModelApi(cfg, dev, init, loss, prefill, decode, init_cache)


class BatchSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def batch_specs(cfg: ArchConfig, B: int, S: int) -> dict:
    """The train/prefill batch's inputs: tokens, and the stubbed modality
    front ends' outputs (whisper's frame embeddings, llama-vision's patch
    embeddings) in the compute type. Tokens are int64 here (torch indexes
    with them), int32 in the reference."""
    specs = {"tokens": BatchSpec((B, S), torch.int64)}
    cdt = T.torch_dtype(cfg.compute_dtype)
    if cfg.family == "audio":
        specs["frames"] = BatchSpec((B, cfg.enc_frames, cfg.d_model), cdt)
    if cfg.family == "vlm":
        specs["image_embeds"] = BatchSpec((B, cfg.n_img_tokens, cfg.d_model), cdt)
    return specs


def materialize_batch(cfg: ArchConfig, B: int, S: int, seed: int = 0, device="cuda") -> dict:
    """A random batch matching ``batch_specs``, drawn with numpy from
    ``seed``: tokens uniform over the vocabulary, frames and image embeds
    normal with std 0.1 (the reference's laws, not its numbers)."""
    dev = resolve_device(device)
    specs = batch_specs(cfg, B, S)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    out = {"tokens": torch.from_numpy(toks).to(dev)}
    for stream, name in ((1, "frames"), (2, "image_embeds")):
        if name in specs:
            shape, dtype = specs[name]
            a = np.random.default_rng([seed, stream]).standard_normal(shape, dtype=np.float32)
            out[name] = torch.from_numpy(a).to(dev).to(dtype) * 0.1
    return out
