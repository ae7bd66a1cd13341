"""Scheduling Simulator — M(tasks, S) -> per-chip partition  (paper §IV-B).

Two paradigms, mapping the paper's HW-vs-SW scheduler split onto TPU:

* ``static``   — XLA SPMD-style contiguous partition of the tile grid across
                 the slice's chips (conventional kernels). Like the paper's
                 round-robin GigaThread model it captures wave quantization
                 (ceil/floor task-count imbalance) plus the *content*
                 imbalance of non-uniform tasks (causal attention).
* ``workqueue``— greedy earliest-finish-first assignment (persistent-kernel /
                 grouped-GEMM work queues, e.g. fused MoE), mirroring the
                 MinHeap tile scheduler the paper replicates for FA3 (§V-A).

Returns ``chip_of``: an int array assigning each task to a chip.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.decomposer import TaskArray
from repro_torch.core.hardware import TPUSpec


def task_weights(tasks: TaskArray, hw: TPUSpec) -> np.ndarray:
    """Dominant-pipe theoretical cycles — the scheduler's cost estimate."""
    return np.maximum.reduce(
        [
            tasks.mxu / hw.mxu_flops_per_cycle,
            tasks.vpu / hw.vpu_ops_per_cycle,
            tasks.xu / hw.xu_ops_per_cycle,
            tasks.hbm / hw.hbm_bytes_per_cycle,
        ]
    )


def schedule_static(tasks: TaskArray, hw: TPUSpec) -> np.ndarray:
    """Contiguous grid partition (how SPMD shards a Pallas grid)."""
    n, total = hw.num_chips, len(tasks)
    base, rem = divmod(total, n)
    counts = np.full(n, base)
    counts[:rem] += 1
    return np.repeat(np.arange(n), counts)


def schedule_workqueue(tasks: TaskArray, hw: TPUSpec) -> np.ndarray:
    """Greedy earliest-finish-first over the global work list (queue order =
    expert-major problem order, like a software tile scheduler)."""
    n = hw.num_chips
    w = task_weights(tasks, hw)
    heap = [(0.0, c) for c in range(n)]
    heapq.heapify(heap)
    chip_of = np.zeros(len(tasks), dtype=np.int64)
    for i in range(len(tasks)):
        load, c = heapq.heappop(heap)
        chip_of[i] = c
        heapq.heappush(heap, (load + w[i], c))
    return chip_of


def schedule(policy: str, tasks: TaskArray, hw: TPUSpec) -> np.ndarray:
    if policy == "workqueue":
        return schedule_workqueue(tasks, hw)
    return schedule_static(tasks, hw)
