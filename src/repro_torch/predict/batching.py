"""Batched-estimation plumbing: canonical workload keys, a memoized
featurize cache, and call grouping.

A fine-grained E2E assembly re-featurizes the same shapes constantly — a
decode sweep issues the *identical* GEMM/rmsnorm/silu workloads at every
cache length (only attention varies with kvlen), and ``model_calls``
repeats one layer ``n_layers`` times. Grouping by (kind, canonical X) and
memoizing ``featurize`` turns thousands of per-call analytical passes
into one pass per unique shape, and lets backends run one vectorized MLP
forward per kernel family instead of per-call batch-1 inference.

Multi-hardware sweeps add further sharing levels: ``featurize`` is
decompose -> schedule -> analyze, and only the *cycle-conversion* half of
``analyze`` (plus the feature vector) reads the full hardware spec.
Decompose reads at most (vmem_mb, num_chips) — the GEMM tile heuristic —
the static scheduler only (n_tasks, num_chips), and the per-pipe demand
summary is hw-independent given the schedule, so each stage is memoized
under exactly the hw fields it reads (:func:`decompose_sig`,
:func:`task_sig`). Across a sweep only pure float math (cycle conversion,
feature vector, MLP forward) fans out per device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.decomposer import SCHED_POLICY, decompose
from repro_torch.core.features import FeatureSet, analyze_summary, demand_summary
from repro_torch.core.hardware import TPUSpec
from repro_torch.core.scheduler import schedule
from repro_torch.predict.api import CallSeq, CommCall, KernelCall, flatten_calls


def canonical_x(X: dict) -> tuple:
    """Order-independent hashable key for a workload dict."""
    return tuple(sorted(X.items()))


def decompose_sig(kind: str, hw: TPUSpec) -> tuple:
    """The subset of ``hw`` that ``decompose`` reads for ``kind`` — only
    the GEMM tile heuristic looks at the spec at all."""
    if kind in ("gemm", "scaled_mm"):
        return (hw.vmem_mb, hw.num_chips)  # gemm_tile_heuristic
    return ()  # attention/rmsnorm/silu_mul/fused_moe ignore hw


def task_sig(kind: str, hw: TPUSpec) -> tuple:
    """The subset of ``hw`` that decompose+schedule actually read for
    ``kind`` — hardware with equal signatures provably produces identical
    (tasks, chip_of), so those stages (and the derived demand summary) are
    shared across a sweep.
    ``tests/test_sweep.py::test_task_sig_matches_direct_featurize`` pins
    this to the decomposer/scheduler implementation for every family and
    every registry entry."""
    if SCHED_POLICY.get(kind) == "workqueue":
        # earliest-finish-first weighs tasks by per-pipe throughput
        sched: tuple = (
            hw.num_chips,
            hw.mxu_flops_per_cycle,
            hw.vpu_ops_per_cycle,
            hw.xu_ops_per_cycle,
            hw.hbm_bytes_per_cycle,
        )
    else:
        sched = (hw.num_chips,)
    return decompose_sig(kind, hw) + sched


class FeatureCache:
    """Memoizes the analytical pipeline per (kind, canonical workload,
    hardware), in levels matching what each stage actually reads:

      * decompose level — ``TaskArray`` keyed by :func:`decompose_sig`
        (for most families: shared across *all* hardware);
      * schedule level — static-policy ``chip_of`` keyed by
        (n_tasks, num_chips), shared across kinds and shapes; workqueue
        schedules are throughput-dependent and keyed by :func:`task_sig`;
      * demand level — the hw-independent half of ``analyze``
        (``demand_summary``) keyed by :func:`task_sig`;
      * feature level — ``FeatureSet`` / feature vector keyed by hw.name
        (the only truly per-device stage: cycle conversion + vector).

    Bounded: on overflow the caches reset rather than evicting — repeated
    sweeps re-warm in one pass."""

    def __init__(self, maxsize: int = 100_000) -> None:
        self.maxsize = maxsize
        self._dec: dict = {}
        self._sched: dict = {}
        self._summ: dict = {}
        self._fs: dict = {}
        self._vec: dict = {}
        self.hits = 0
        self.misses = 0
        #: demand-summary level accounting: ``task_misses`` counts full
        #: decompose+schedule+summary builds, ``task_hits`` cross-hw reuse
        self.task_hits = 0
        self.task_misses = 0

    def _bound(self, d: dict) -> None:
        if len(d) >= self.maxsize:
            d.clear()

    def tasks(self, kind: str, X: dict, hw: TPUSpec) -> tuple:
        """(tasks, chip_of) for one workload, shared across hw with equal
        :func:`decompose_sig` / schedule inputs."""
        cx = canonical_x(X)
        dkey = (kind, decompose_sig(kind, hw), cx)
        t = self._dec.get(dkey)
        if t is None:
            t = decompose(kind, X, hw)
            self._bound(self._dec)
            self._dec[dkey] = t
        if SCHED_POLICY.get(kind) == "workqueue":
            skey = (kind, task_sig(kind, hw), cx)
        else:
            # static partition depends only on the grid size and chip count
            skey = ("static", len(t), hw.num_chips)
        chip_of = self._sched.get(skey)
        if chip_of is None:
            chip_of = schedule(SCHED_POLICY[kind], t, hw)
            self._bound(self._sched)
            self._sched[skey] = chip_of
        return t, chip_of

    def summary(self, kind: str, X: dict, hw: TPUSpec) -> tuple:
        """Hw-independent demand summary, shared across hw with equal
        :func:`task_sig`."""
        key = (kind, task_sig(kind, hw), canonical_x(X))
        summ = self._summ.get(key)
        if summ is None:
            self.task_misses += 1
            tasks, chip_of = self.tasks(kind, X, hw)
            summ = demand_summary(tasks, chip_of, hw.num_chips)
            self._bound(self._summ)
            self._summ[key] = summ
        else:
            self.task_hits += 1
        return summ

    def featureset(self, kind: str, X: dict, hw: TPUSpec) -> "FeatureSet":
        key = (kind, hw.name, canonical_x(X))
        fs = self._fs.get(key)
        if fs is None:
            self.misses += 1
            fs = analyze_summary(self.summary(kind, X, hw), hw)
            self._bound(self._fs)
            if len(self._vec) >= self.maxsize:
                self._vec.clear()
            self._fs[key] = fs
        else:
            self.hits += 1
        return fs

    def vector(self, kind: str, X: dict, hw: TPUSpec) -> np.ndarray:
        key = (kind, hw.name, canonical_x(X))
        v = self._vec.get(key)
        if v is None:
            v = self.featureset(kind, X, hw).vector(hw)
            self._vec[key] = v
        else:
            self.hits += 1
        return v


@dataclasses.dataclass
class FamilyGroup:
    """Unique workloads of one kernel family with accumulated weights."""

    kind: str
    workloads: list  # unique dicts, first-seen order
    weights: list  # parallel floats (sum of call counts x group reps)

    @property
    def weight_array(self) -> np.ndarray:
        return np.asarray(self.weights, dtype=np.float64)


def group_calls(calls: CallSeq) -> tuple[dict, dict]:
    """Flatten ``calls`` and group: kernel calls into per-family
    ``FamilyGroup``s deduplicated by canonical workload, comm calls into
    ``{(op, nbytes, n_units, skew): weight}``."""
    families: dict[str, FamilyGroup] = {}
    index: dict[tuple, int] = {}
    comms: dict[tuple, float] = {}
    for call, w in flatten_calls(calls):
        if w == 0:
            continue
        if isinstance(call, KernelCall):
            key = (call.kind, canonical_x(call.X))
            i = index.get(key)
            if i is None:
                grp = families.setdefault(call.kind, FamilyGroup(call.kind, [], []))
                index[key] = len(grp.workloads)
                grp.workloads.append(call.X)
                grp.weights.append(w)
            else:
                families[call.kind].weights[i] += w
        elif isinstance(call, CommCall):
            key = (call.op, call.nbytes, call.n_units, call.skew)
            comms[key] = comms.get(key, 0.0) + w
        else:
            raise TypeError(f"not a KernelCall/CommCall: {call!r}")
    return families, comms
