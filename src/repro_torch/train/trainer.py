"""Training loop with production concerns (``repro.train.trainer``):

  * checkpoint/restart: periodic atomic checkpoints, auto-resume from the
    latest one (a preempted run restarted continues bit for bit where the
    kernels and the embedding's backward are deterministic);
  * data-iterator state is implicit (deterministic ``batch_at(step)``), so
    resume needs only the step number;
  * preemption: SIGUSR1 (or ``preempt_after``) saves a checkpoint after the
    current step and returns;
  * straggler watchdog: logs steps slower than ``watchdog_factor`` x the
    running median.

It runs on one device, ``"cuda"`` unless the caller asks for the CPU;
``mesh=`` raises until the port executes sharding (ROADMAP A10 part 2).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
import statistics
import tempfile
import time
from typing import Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.registry import build_model
from repro_torch.train.step import TrainConfig, init_train_state, make_optimizer, make_train_step

log = logging.getLogger("repro_torch.train")


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=default_ckpt_dir)
    keep: int = 3
    async_save: bool = False
    watchdog_factor: float = 3.0
    log_every: int = 10


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        data_cfg: DataConfig,
        tc: TrainConfig,
        trainer_cfg: TrainerConfig,
        mesh=None,
        state_shardings=None,
        batch_shardings=None,
        device="cuda",
    ):
        if mesh is not None or state_shardings is not None or batch_shardings is not None:
            raise NotImplementedError(
                "Trainer(mesh=...) needs executed sharding (ROADMAP A10 part 2)"
            )
        self.cfg = cfg
        self.api = build_model(cfg, device)
        self.device = self.api.device
        self.tc = tc
        self.tcfg = trainer_cfg
        self.data = SyntheticLM(cfg, data_cfg)
        self.optimizer = make_optimizer(tc)
        self.ckpt = CheckpointManager(
            trainer_cfg.ckpt_dir, keep=trainer_cfg.keep, async_save=trainer_cfg.async_save
        )
        self.train_step = make_train_step(self.api, self.optimizer, tc)
        self._preempted = False
        self.step_times: list[float] = []
        self.metrics_history: list[dict] = []

    # ------------------------------------------------------------------
    def init_or_restore(self, seed: int = 0):
        state = init_train_state(self.api, self.optimizer, seed,
                                 compress_grads=self.tc.compress_grads)
        restored = self.ckpt.restore_latest(state)
        if restored is not None:
            step, state, extra = restored
            log.info("resumed from checkpoint step %d", step)
            return int(step), state
        return 0, state

    def request_preemption(self, *_args):
        self._preempted = True

    def batch_at(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch_at(step).items()}

    # ------------------------------------------------------------------
    def run(self, seed: int = 0, preempt_after: Optional[int] = None):
        """Returns (final_step, state, losses). ``preempt_after`` simulates a
        preemption notice after N steps (fault-tolerance drills)."""
        start, state = self.init_or_restore(seed)
        signal.signal(signal.SIGUSR1, self.request_preemption)
        losses = []
        for step in range(start, self.tcfg.total_steps):
            batch = self.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])  # waits for the step's work on the device
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            losses.append(loss)
            self.metrics_history.append({k: float(v) for k, v in metrics.items()})
            if (step + 1) % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step + 1, loss, dt)
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == self.tcfg.total_steps:
                self.ckpt.save(step + 1, state, extra={"loss": loss})
            if preempt_after is not None and step + 1 - start >= preempt_after:
                self._preempted = True
            if self._preempted:
                self.ckpt.save(step + 1, state, extra={"loss": loss, "preempted": True})
                self.ckpt.wait()
                log.warning("preempted at step %d; checkpoint saved", step + 1)
                return step + 1, state, losses
        self.ckpt.wait()
        return self.tcfg.total_steps, state, losses

    # ------------------------------------------------------------------
    def _watchdog(self, step: int, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            med = statistics.median(self.step_times[-50:])
            if dt > self.tcfg.watchdog_factor * med:
                log.warning(
                    "straggler: step %d took %.2fs (median %.2fs); on a real "
                    "cluster this triggers host health checks",
                    step,
                    dt,
                    med,
                )
