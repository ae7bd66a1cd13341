"""Deterministic synthetic data pipeline (``repro.data.pipeline``).

Serves token batches (plus stubbed modality-frontend embeddings) with:
  * deterministic content as a pure function of (seed, step): restartable
    from any step without replaying history (fault-tolerant resume);
  * per-host sharding hooks (process_index/process_count) so the same code
    drives multi-host data loading.

It is numpy, as the reference's is, and draws the same values: the token
batches equal the reference's value for value, as int64 (int32 there).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0
    process_index: int = 0
    process_count: int = 1


class SyntheticLM:
    """Markov-ish synthetic token stream: deterministic per (seed, step).

    Tokens follow a skewed unigram distribution with local repetition
    structure so the loss actually decreases during training (unlike pure
    uniform noise)."""

    def __init__(self, cfg: ArchConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        if data.batch % data.process_count:
            raise ValueError(f"batch {data.batch} does not split over "
                             f"{data.process_count} processes")
        self.local_batch = data.batch // data.process_count

    def batch_at(self, step: int) -> dict:
        d = self.data
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, step, d.process_index])
        )
        B, S, V = self.local_batch, d.seq_len, self.cfg.vocab_size
        # skewed unigram (zipf-ish) base stream
        base = rng.zipf(1.5, size=(B, S)).astype(np.int64)
        tokens = (base % (V - 3)) + 3
        # inject copy structure: second half repeats first half shifted
        half = S // 2
        tokens[:, half:] = tokens[:, : S - half]
        tokens[:, 0] = 1  # BOS
        out = {"tokens": tokens}
        if self.cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (B, self.cfg.enc_frames, self.cfg.d_model), dtype=np.float32
            ).astype(np.float32) * 0.1
        if self.cfg.family == "vlm":
            out["image_embeds"] = rng.standard_normal(
                (B, self.cfg.n_img_tokens, self.cfg.d_model), dtype=np.float32
            ).astype(np.float32) * 0.1
        return out

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

