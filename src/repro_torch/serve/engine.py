"""Serving engines, in PyTorch (``repro.serve.engine``): batched prefill and
decode with a KV cache, a request queue and a sampler.

``ServeEngine`` admits up to ``max_batch`` requests, prefills them together
(left-padded to the longest prompt) and decodes them in lock step.
``ContinuousBatchingEngine`` keeps a fixed pool of decode slots, prefills
each admitted request alone into its slot's rows of the shared cache and
decodes all slots in lock step. Both share a ``_ModelRunner`` that owns the
parameters, the model functions and the sampling generator.

A ``serve.trace.TraceRecorder`` passed as ``recorder=`` records every step
as the decomposer's call sequence for its shapes, stamped with the step's
wall-clock after a device sync. ``ContinuousBatchingEngine`` admits by a
fixed slot count or, with ``admission="predicted"``, only while a
predictor prices the would-be decode tick within ``decode_slo_s``.

``ContinuousBatchingEngine(audit=True)`` runs the predictor-coverage lint
(``analysis.audit_predictor``) on its predictor before anything else is
built, and raises ``analysis.AuditError`` on an error-severity finding.

Engines run on ``"cuda"`` unless ``device="cpu"`` is passed. With ``mesh=``
(a ``DeviceMesh`` over the process group; every rank builds the same engine
and submits the same requests) the runner places the parameters
(``param_pspecs``) and caches (``cache_pspecs``) as DTensors, runs every
step under ``use_mesh(mesh)``, and samples from the whole logits; the
engine reports the mesh's degrees (``dist.sharding.mesh_degrees``) and
binds an attached recorder to them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (
    cache_pspecs,
    device_mesh,
    mesh_degrees,
    param_pspecs,
    place,
    use_mesh,
    write_target,
)
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int
    max_new: int = 16
    temperature: float = 0.0


@dataclasses.dataclass
class Result:
    rid: int
    tokens: list
    prefill_s: float
    decode_s: float
    #: scheduler steps the request was resident for (its admission prefill
    #: plus every decode tick it took a token in)
    ticks: int = 0
    #: admission-to-retire wall-clock of this process
    latency_s: float = 0.0


class _ModelRunner:
    """Shared prefill/decode/sample machinery for the serving engines.

    Keeps ``params`` as given (``param_dtype``) and, beside them, the copy
    the forward pass reads (``transformer.cast_for_compute``). ``tp``/``pp``
    are the mesh's "model"/"pipe" axis sizes (1 without a mesh): the
    degrees every consumer (trace recorder, predicted admission) prices
    this engine's steps at. With ``mesh=`` the parameters and caches are
    DTensors and every step runs under ``use_mesh(mesh)``."""

    def __init__(self, cfg: ArchConfig, *, params=None, seed: int = 0, device="cuda",
                 mesh=None):
        self.cfg = cfg
        self.mesh = None if mesh is None else device_mesh(mesh)
        self.tp, self.pp = mesh_degrees(mesh)
        self.api = build_model(cfg, device)
        self.device = self.api.device
        self.params = self.api.init(seed) if params is None else params
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value):
        value = value.to(self.device)
        if self.mesh is not None:
            value = T.Tree(place(value, param_pspecs(value, self.mesh), self.mesh))
        self._params = value
        self._compute = T.cast_for_compute(self._params, self.cfg)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _ctx(self):
        return use_mesh(self.mesh) if self.mesh is not None else contextlib.nullcontext()

    @torch.no_grad()
    def prefill(self, batch):
        with self._ctx():
            return self.api.prefill(self._compute, batch)

    @torch.no_grad()
    def decode(self, caches, tokens, positions):
        with self._ctx():
            return self.api.decode(self._compute, caches, tokens, positions)

    def shard_cache(self, caches):
        """Place a cache tree on the mesh (the tree itself without one)."""
        if self.mesh is None:
            return caches
        return place(caches, cache_pspecs(caches, self.mesh), self.mesh)

    @torch.no_grad()
    def grow_cache(self, caches, max_len: int):
        with self._ctx():
            return self.shard_cache(T.pad_cache(caches, self.cfg, max_len))

    def init_cache(self, batch: int, max_len: int):
        return self.shard_cache(self.api.init_cache(batch, max_len))

    @torch.no_grad()
    def sample(self, logits, temperatures, generator: torch.Generator) -> torch.Tensor:
        """Greedy/categorical per row: ``logits (B, V_padded) -> (B,)``.
        Rows with temperature 0 take the argmax; the others sample by the
        Gumbel-max rule with noise from ``generator``. Vocab-sharded
        logits (the ``head`` rule) are gathered whole first."""
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        logits = logits[:, : self.cfg.vocab_size].float()
        greedy = logits.argmax(dim=-1)
        if not any(t > 0 for t in temperatures):
            return greedy
        temps = torch.tensor(temperatures, dtype=torch.float32, device=logits.device)[:, None]
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        sampled = (logits / temps.clamp_min(1e-3) + gumbel).argmax(dim=-1)
        return torch.where(temps[:, 0] > 0, sampled, greedy)


class _EngineBase:
    def __init__(self, cfg: ArchConfig, *, params, seed, recorder, device, mesh):
        self.cfg = cfg
        self._runner = _ModelRunner(cfg, params=params, seed=seed, device=device, mesh=mesh)
        self.api = self._runner.api
        self.queue: deque[Request] = deque()
        # optional serve.trace.TraceRecorder: every executed step also emits
        # its decomposer call sequence (actual launched shapes), stamped with
        # its wall-clock after a device sync
        self.recorder = recorder
        if recorder is not None and mesh is not None:
            recorder.bind_mesh(self._runner.tp, self._runner.pp)

    @property
    def params(self):
        return self._runner.params

    @params.setter
    def params(self, value):
        self._runner.params = value

    @property
    def device(self) -> torch.device:
        return self._runner.device

    @property
    def mesh(self):
        return self._runner.mesh

    @property
    def tp(self) -> int:
        """Tensor-parallel degree the engine executes at (the mesh's
        "model" axis size; 1 single-process)."""
        return self._runner.tp

    @property
    def pp(self) -> int:
        return self._runner.pp

    def submit(self, req: Request):
        self.queue.append(req)

    def _measured(self, seconds_since):
        if self.recorder is not None:
            self._runner.sync()
            self.recorder.mark_measured(time.perf_counter() - seconds_since)


class ServeEngine(_EngineBase):
    def __init__(self, cfg: ArchConfig, params=None, seed: int = 0, max_batch: int = 8,
                 recorder=None, mesh=None, device="cuda"):
        super().__init__(cfg, params=params, seed=seed, recorder=recorder, device=device,
                         mesh=mesh)
        self.max_batch = max_batch

    def _pad_batch(self, prompts: list[np.ndarray]):
        B = len(prompts)
        L = max(len(p) for p in prompts)
        toks = np.zeros((B, L), np.int64)
        for i, p in enumerate(prompts):
            toks[i, L - len(p):] = p  # left-pad so last token aligns
        return torch.from_numpy(toks).to(self.device), L

    def _extra_inputs(self, B: int) -> dict:
        """The stubbed modality front ends' outputs for a batch of ``B``:
        whisper's frame embeddings, llama-vision's patch embeddings, normal
        with std 0.1 in the compute type, drawn from the engine's seeded
        generator (the reference's law, not its numbers)."""
        cfg, gen = self.cfg, self._runner.generator
        shapes = {"audio": ("frames", cfg.enc_frames), "vlm": ("image_embeds", cfg.n_img_tokens)}
        if cfg.family not in shapes:
            return {}
        name, n = shapes[cfg.family]
        noise = torch.randn((B, n, cfg.d_model), generator=gen, device=self.device)
        return {name: noise.to(T.torch_dtype(cfg.compute_dtype)) * 0.1}

    def step_batch(self) -> list[Result]:
        """Admit up to max_batch requests, serve them to completion."""
        if not self.queue:
            return []
        batch_reqs = [self.queue.popleft() for _ in range(min(self.max_batch, len(self.queue)))]
        B = len(batch_reqs)
        toks, L = self._pad_batch([r.prompt for r in batch_reqs])
        max_new = max(r.max_new for r in batch_reqs)
        temps = [r.temperature for r in batch_reqs]
        gen = self._runner.generator

        t0 = time.perf_counter()
        if self.recorder is not None:
            self.recorder.record_step(f"prefill[b{B}xL{L}]", self.cfg, B, L, L, phase="prefill")
        logits, caches = self._runner.prefill({"tokens": toks, **self._extra_inputs(B)})
        caches = self._runner.grow_cache(caches, L + max_new)
        self._runner.sync()
        prefill_s = time.perf_counter() - t0
        if self.recorder is not None:
            self.recorder.mark_measured(prefill_s)

        outputs: list[list[int]] = [[] for _ in range(B)]
        t0 = time.perf_counter()
        cur = self._runner.sample(logits, temps, gen)
        for i, tok in enumerate(cur.tolist()):
            outputs[i].append(tok)
        for step in range(max_new - 1):
            pos = torch.full((B,), L + step, dtype=torch.int64, device=self.device)
            if self.recorder is not None:
                still = sum(1 for i in range(B) if len(outputs[i]) < batch_reqs[i].max_new)
                self.recorder.record_step(
                    f"decode@{L + step}", self.cfg, B, 1, L + step + 1,
                    phase="decode", active=still,
                )
            t_step = time.perf_counter()
            logits, caches = self._runner.decode(caches, cur, pos)
            cur = self._runner.sample(logits, temps, gen)
            for i, tok in enumerate(cur.tolist()):
                if len(outputs[i]) < batch_reqs[i].max_new:
                    outputs[i].append(tok)
            self._measured(t_step)
        self._runner.sync()
        decode_s = time.perf_counter() - t0
        return [
            Result(r.rid, outputs[i], prefill_s, decode_s,
                   ticks=len(outputs[i]), latency_s=prefill_s + decode_s)
            for i, r in enumerate(batch_reqs)
        ]


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0  # next write position (absolute)
    emitted: Optional[list] = None
    cur: int = 0  # last sampled token
    t_admit: float = 0.0
    prefill_s: float = 0.0
    ticks: int = 0

    @property
    def free(self) -> bool:
        return self.req is None


def _copy_slot(full, one, i: int):
    """``full_leaf[:, i] = one_leaf[:, 0]`` for each pair of leaves of two
    cache trees of the same structure (a leaf's slot axis is 1: the
    continuous engine's families stack their leaves once, over layers). A
    DTensor leaf's slot is written by the ranks that hold it."""
    if isinstance(full, torch.Tensor):
        local, slots, (row,) = write_target(full, 1, one[:, 0])
        if slots.start <= i < slots.stop:
            local[:, i - slots.start] = row
    elif isinstance(full, dict):
        for k in full:
            _copy_slot(full[k], one[k], i)
    else:
        for f, o in zip(full, one):
            _copy_slot(f, o, i)


class ContinuousBatchingEngine(_EngineBase):
    """In-flight batching: a fixed pool of decode slots steps in lock step;
    finished requests free their slot and waiting requests are admitted at
    the next step boundary. Each admission prefills its prompt alone, at its
    own length, and copies its KV rows into its slot of the shared cache
    ``(n_layers, slots, max_len, Hkv, D)``; running slots are never
    interrupted. Every decode tick launches the full slot pool, and its
    attended KV span is ``max(active positions) + 1``.

    Admission policy (``admission=``):

      * ``"fixed"`` (default): admit whenever a slot is free;
      * ``"predicted"``: before each admission, ask ``predictor`` (any
        ``repro_torch.predict`` backend) for the decode-tick latency of the
        would-be batch at its worst-case future KV span, and admit only
        while that stays within ``decode_slo_s``. The latencies are
        **seconds predicted on the predictor's hardware** (a registry
        TPU), not this machine's wall-clock. A request that violates the
        SLO even alone in the pool is admitted anyway with a warning
        (counted in ``slo_forced_admits``). If the predictor cannot price a
        step (it raises ``RuntimeError``), the engine warns once and falls
        back to fixed admission (``admission_fallback_reason``). Decisions
        are logged in ``admission_log``, one dict per considered candidate.
        Ticks are priced at the engine's tensor-parallel degree ``self.tp``.

    ``audit=True`` runs ``analysis.audit_predictor`` on ``predictor`` first
    (a callable runs as ``audit(predictor, hw_name)``); an error-severity
    finding raises ``analysis.AuditError`` before any parameter is built.
    """

    def __init__(self, cfg: ArchConfig, *, slots: int = 4, max_len: int = 128,
                 params=None, seed: int = 0, recorder=None, admission: str = "fixed",
                 predictor=None, decode_slo_s: Optional[float] = None, mesh=None,
                 audit=None, tuned: Optional[dict] = None, device="cuda"):
        if cfg.family in ("ssm", "hybrid", "audio", "vlm"):
            raise ValueError("the continuous-batching engine supports KV-cache LMs")
        if admission not in ("fixed", "predicted"):
            raise ValueError(f"admission must be 'fixed' or 'predicted', got {admission!r}")
        if admission == "predicted" and (predictor is None or decode_slo_s is None):
            raise ValueError(
                "admission='predicted' needs predictor= (a repro_torch.predict "
                "backend for the target hardware) and decode_slo_s= (the "
                "per-tick decode latency SLO in predicted seconds)"
            )
        if audit and predictor is not None:
            # audit=True: pre-flight coverage lint. A predictor that cannot
            # price the decode workload (stale CommRegressor, untrained
            # family) fails construction, before any parameter is built or
            # moved to the device, instead of the first admission tick. A
            # callable substitutes a custom lint:
            # audit(predictor, hw_name) -> list[Diagnostic].
            from repro_torch.analysis import AuditError, audit_predictor

            found = (
                audit_predictor(predictor)
                if audit is True
                else audit(predictor, getattr(getattr(predictor, "hw", None), "name", ""))
            )
            errors = [d for d in found if d.severity == "error"]
            if errors:
                raise AuditError(errors)
        super().__init__(cfg, params=params, seed=seed, recorder=recorder, device=device,
                         mesh=mesh)
        self.max_len = max_len
        self.admission = admission
        self.predictor = predictor
        self.decode_slo_s = decode_slo_s
        #: autotuned kernel block table for the predictor's hardware
        #: (``repro_torch.tune.TunedConfigs.for_hw(hw)``); predicted admission
        #: prices decode ticks with these blocks merged in
        self.tuned = tuned
        #: one dict per admission decision: rid, projected kv, predicted_s,
        #: slo_s, admitted, forced (admitted despite violating, alone in pool)
        self.admission_log: list[dict] = []
        self.slo_forced_admits = 0
        self.admission_fallback_reason: Optional[str] = None
        self.slots = [_Slot() for _ in range(slots)]
        self.caches = self._runner.init_cache(slots, max_len)
        self.done: list[Result] = []
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    # ------------------------------------------------------------------
    # predicted admission

    def _projected_kv(self, req: Request) -> int:
        """Worst-case attended KV span of any future tick of the would-be
        batch: every active slot and the candidate projected to their
        final write positions."""
        cap = self.max_len - 1
        spans = [min(len(req.prompt) + req.max_new, cap)]
        for s in self.slots:
            if not s.free:
                spans.append(min(s.pos + max(s.req.max_new - len(s.emitted), 0), cap))
        return max(spans) + 1

    def _predicted_tick_s(self, kv: int) -> Optional[float]:
        """Predicted decode-tick latency (seconds on the predictor's
        hardware) for the full slot pool attending ``kv``, at the engine's
        tensor-parallel degree ``self.tp``; None when the predictor cannot
        price the step (the engine has then fallen back to fixed
        admission)."""
        from repro_torch.core.e2e import model_calls

        try:
            return self.predictor.predict(
                model_calls(self.cfg, len(self.slots), 1, kv, tp=self.tp, tuned=self.tuned)
            ).total_s
        except RuntimeError as e:  # unfitted estimator / comm regressor
            self.admission_fallback_reason = f"{type(e).__name__}: {e}"
            self.admission = "fixed"
            warnings.warn(
                f"predicted admission unavailable ({e}); falling back to "
                "fixed slot admission",
                stacklevel=4,
            )
            return None

    def _admit_ok(self, req: Request) -> bool:
        """One admission decision under the predicted policy (always True
        for fixed admission). Logged in ``admission_log``."""
        if self.admission != "predicted":
            return True
        kv = self._projected_kv(req)
        pred = self._predicted_tick_s(kv)
        if pred is None:
            return True  # fell back to fixed admission mid-run
        ok = pred <= self.decode_slo_s
        forced = False
        if not ok and all(s.free for s in self.slots):
            # the request violates the SLO even alone: admit anyway so the
            # queue cannot deadlock, but say so
            forced, ok = True, True
            self.slo_forced_admits += 1
            warnings.warn(
                f"request {req.rid} cannot meet decode_slo_s="
                f"{self.decode_slo_s:.4g}s even alone in the pool "
                f"(predicted {pred:.4g}s); admitting anyway",
                stacklevel=3,
            )
        self.admission_log.append(
            {
                "rid": req.rid,
                "kv": kv,
                "predicted_s": pred,
                "slo_s": self.decode_slo_s,
                "admitted": ok,
                "forced": forced,
            }
        )
        return ok

    # ------------------------------------------------------------------
    def _admit(self):
        for i, slot in enumerate(self.slots):
            if not slot.free or not self.queue:
                continue
            if not self._admit_ok(self.queue[0]):
                break  # FIFO: a deferred head is retried next tick
            req = self.queue.popleft()
            L = len(req.prompt)
            t0 = time.perf_counter()
            if self.recorder is not None:
                self.recorder.record_step(f"admit#{req.rid}[L{L}]", self.cfg, 1, L, L,
                                          phase="prefill")
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64), device=self.device)
            logits, cache1 = self._runner.prefill({"tokens": tokens[None, :]})
            cache1 = self._runner.grow_cache(cache1, self.max_len)
            # copy this request's cache rows into slot i of the shared cache
            _copy_slot(self.caches, cache1, i)
            tok = self._runner.sample(logits, [req.temperature], self._gen).item()
            self._runner.sync()
            now = time.perf_counter()
            slot.req, slot.pos, slot.emitted, slot.cur = req, L, [tok], tok
            slot.t_admit, slot.prefill_s, slot.ticks = t0, now - t0, 1
            if self.recorder is not None:
                self.recorder.mark_measured(slot.prefill_s)

    def step(self) -> bool:
        """One scheduler tick: admit, decode all active slots, retire."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            return False
        toks = torch.tensor([s.cur if not s.free else 0 for s in self.slots],
                            dtype=torch.int64, device=self.device)
        pos = torch.tensor([min(s.pos, self.max_len - 1) for s in self.slots],
                           dtype=torch.int64, device=self.device)
        if self.recorder is not None:
            kv = max(min(self.slots[i].pos, self.max_len - 1) for i in active) + 1
            self.recorder.record_step(
                f"tick[{len(active)}/{len(self.slots)}]", self.cfg, len(self.slots), 1, kv,
                phase="decode", active=len(active),
            )
        t_tick = time.perf_counter()
        logits, self.caches = self._runner.decode(self.caches, toks, pos)
        temps = [s.req.temperature if not s.free else 0.0 for s in self.slots]
        sampled = self._runner.sample(logits, temps, self._gen).tolist()
        for i in active:
            s = self.slots[i]
            s.emitted.append(sampled[i])
            s.pos += 1
            s.cur = sampled[i]
            s.ticks += 1
            if len(s.emitted) >= s.req.max_new or s.pos >= self.max_len - 1:
                now = time.perf_counter()
                self.done.append(
                    Result(s.req.rid, s.emitted, s.prefill_s,
                           max(now - s.t_admit - s.prefill_s, 0.0),
                           ticks=s.ticks, latency_s=now - s.t_admit)
                )
                self.slots[i] = _Slot()
        self._measured(t_tick)
        return True

    def run_to_completion(self) -> list[Result]:
        while self.queue or any(not s.free for s in self.slots):
            self.step()
        out, self.done = self.done, []
        return out
