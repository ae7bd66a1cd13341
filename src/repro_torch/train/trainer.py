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

It runs on ``"cuda"`` unless the caller asks for the CPU. With ``mesh=`` (a
``DeviceMesh`` over the process group, ``launch.mesh.make_mesh``) every rank
runs the same loop: the state is placed by ``state_shardings`` (default:
``train.step.train_state_pspecs``), each rank draws the same batch and
keeps its ``batch_shardings`` shard (default: ``dist.sharding.batch_pspecs``),
and each step runs under ``use_mesh(mesh)`` on DTensors. Checkpoints hold
full arrays and restore onto whatever mesh the run has (an elastic restart).
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
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.registry import build_model
from repro_torch.dist.sharding import batch_pspecs, device_mesh, place, to_named, use_mesh
from repro_torch.train.step import (
    TrainConfig,
    init_train_state,
    make_optimizer,
    make_train_step,
    train_state_pspecs,
)

log = logging.getLogger("repro_torch.train")


def _host(v) -> float:
    """A metric as a Python float (a DTensor's whole value)."""
    if isinstance(v, DTensor):
        v = v.full_tensor()
    return float(v)


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
        if mesh is None and (state_shardings is not None or batch_shardings is not None):
            raise ValueError("state_shardings=/batch_shardings= place on a mesh; pass mesh=")
        self.cfg = cfg
        self.mesh = None if mesh is None else device_mesh(mesh)
        self.state_shardings = state_shardings
        self.batch_shardings = batch_shardings
        self.api = build_model(cfg, device)
        self.device = self.api.device
        self.tc = tc
        self.tcfg = trainer_cfg
        self.data = SyntheticLM(cfg, data_cfg)
        self.optimizer = make_optimizer(tc)
        self.ckpt = CheckpointManager(
            trainer_cfg.ckpt_dir, keep=trainer_cfg.keep, async_save=trainer_cfg.async_save
        )
        step_fn = make_train_step(self.api, self.optimizer, tc)
        self.train_step = step_fn if mesh is None else self._on_mesh(step_fn)
        self._preempted = False
        self.step_times: list[float] = []
        self.metrics_history: list[dict] = []

    # ------------------------------------------------------------------
    def _on_mesh(self, step_fn):
        def step(state, batch):
            with use_mesh(self.mesh):
                return step_fn(state, batch)

        return step

    def init_or_restore(self, seed: int = 0):
        state = init_train_state(self.api, self.optimizer, seed,
                                 compress_grads=self.tc.compress_grads)
        if self.mesh is not None:
            if self.state_shardings is None:
                self.state_shardings = to_named(train_state_pspecs(state, self.mesh), self.mesh)
            state = place(state, self.state_shardings, self.mesh)
        restored = self.ckpt.restore_latest(state)
        if restored is not None:
            step, state, extra = restored
            log.info("resumed from checkpoint step %d", step)
            return int(step), state
        return 0, state

    def request_preemption(self, *_args):
        self._preempted = True

    def batch_at(self, step: int) -> dict:
        """The step's batch on the device; on a mesh, this rank's shard of it
        (every rank draws the same batch)."""
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.data.batch_at(step).items()}
        if self.mesh is None:
            return batch
        if self.batch_shardings is None:
            self.batch_shardings = to_named(batch_pspecs(batch, self.mesh), self.mesh)
        return place(batch, self.batch_shardings, self.mesh)

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
            metrics = {k: _host(v) for k, v in metrics.items()}
            loss = metrics["loss"]  # waits for the step's work on the device
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            losses.append(loss)
            self.metrics_history.append(metrics)
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
