"""Meshes and rank groups (``repro.launch.mesh``).

``make_mesh`` builds a named ``DeviceMesh`` over the current process group
(one rank a device); ``spawn`` starts such a group: ``n`` processes that
meet through a ``FileStore`` and each run one function; ``process_group``
makes the calling process one rank of a group (alone, by default). Defined as
functions, so importing this module touches no device or process group.

The production meshes (256 and 512 ranks) are lowered only by the dry run,
which needs a fake process group: ``make_production_mesh`` waits for it
(ROADMAP A12 part 2) and raises.
"""
from __future__ import annotations

import contextlib
import os
import queue
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def make_production_mesh(*, multi_pod: bool = False, pipeline: bool = False):
    """The reference's 16x16 / 2x16x16 / 4x8x8 / 2x4x8x8 meshes need 256 or
    512 ranks on a fake process group, which the port's dry run brings."""
    raise NotImplementedError(
        f"make_production_mesh({mesh_tag(multi_pod=multi_pod, pipeline=pipeline)}) needs the "
        "dry run's fake process group (ROADMAP A12 part 2), not ported yet"
    )


def mesh_tag(*, multi_pod: bool = False, pipeline: bool = False) -> str:
    """Short mesh label used in dry-run artifact names/metadata."""
    if pipeline:
        return "2x4x8x8pp" if multi_pod else "4x8x8pp"
    return "2x16x16" if multi_pod else "16x16"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    current process group, whose world size must be the shape's product.
    ``device_type`` defaults to ``"cuda"``; the CPU's gloo groups pass
    ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise ValueError(f"a {shape} mesh needs a process group of {n} ranks, have {have}")
    return init_device_mesh(device_type or "cuda", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def process_group(store_path: str, *, backend: str = "gloo", rank: int = 0, world_size: int = 1):
    """This process as rank ``rank`` of a group of ``world_size`` that meets
    through a ``FileStore`` at ``store_path``, for the block's duration (a
    one-rank group by default: what a ``(1, 1)`` mesh in this process
    needs)."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, n: int, store_path: str, backend: str, fn, args, out):
    try:
        if backend != "nccl":  # n ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        with process_group(store_path, backend=backend, rank=rank, world_size=n):
            result = fn(rank, *args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable[..., Any], n: int, args: tuple = (), *, store_path: str,
          backend: str = "gloo", timeout: float = 300.0) -> list:
    """Run ``fn(rank, *args)`` in ``n`` new processes that form one process
    group (``backend``: ``"gloo"`` on the CPU, ``"nccl"`` one rank a GPU),
    meeting through a ``FileStore`` at ``store_path`` (a file that does not
    exist yet). Returns each rank's result, in rank order (results are
    pickled: return numpy arrays or numbers, not DTensors).

    If a rank raises, the others are stopped and a ``RuntimeError`` carries
    its traceback; a group that has not finished after ``timeout`` seconds
    is stopped and raises ``TimeoutError``. ``fn`` must be importable by
    name (a module-level function)."""
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"{n} NCCL ranks need {n} GPUs, this machine has "
                         f"{torch.cuda.device_count()}")
    if os.path.exists(store_path):
        raise ValueError(f"the rendezvous file {store_path} exists already")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, n, store_path, backend, fn, args, out),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    results: dict = {}
    try:
        deadline = time.monotonic() + timeout
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)} did not "
                                   f"finish in {timeout:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and out.empty():
                    raise RuntimeError(f"rank process {dead[0].pid} exited with "
                                       f"{dead[0].exitcode} and reported nothing")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == n else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(n)]
