"""Fault-tolerant checkpointing (``repro.checkpoint.manager``), with the
reference's layout.

  * every leaf of the state tree is saved as numpy inside one
    ``arrays.npz`` a save (``leaf_00000``, ... in the reference's flatten
    order, ``optim.adamw.tree_flatten``), beside a ``manifest.json`` with
    the step, the leaf count, the leaves' paths and types, and ``extra``;
  * saves are atomic (write to ``<dir>/tmp.<step>.<pid>``, then
    ``os.replace`` to ``step_XXXXXXXXXX``), so a preemption mid-save never
    corrupts the latest checkpoint;
  * ``restore_latest`` finds the newest complete checkpoint; checkpoints
    hold full arrays, and ``restore`` puts them on the devices and in the
    types of the tree it is given;
  * retention: keep the last K checkpoints;
  * optional async save on a background thread: the arrays are copied to
    the host before the thread starts, so the caller may go on updating
    its tensors.

bf16 leaves, which numpy cannot hold, are stored as their 16-bit patterns
(``uint16``) and the manifest records their type. Python scalars (the
optimizer's step count) are stored as 0-d arrays and come back as such
scalars.

Sharded states: a DTensor leaf is saved whole (``full_tensor()``, a
collective every rank of the group joins), and in a process group of
several ranks rank 0 alone writes, with a barrier after the checkpoint is
published (after an async save, in the next ``save`` or ``wait``, which
every rank calls alike: each rank makes the same barriers). ``restore``
gives a DTensor back for a DTensor leaf of ``like``, placed as it is, or
places each leaf by ``shardings=`` (specs or placements,
``dist.sharding.to_named``) on the active mesh: checkpoints hold full
arrays, so a state saved on one mesh, or on none, restores onto
any other (an elastic restart across rank counts).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.optim.adamw import tree_flatten


def _key(i: int) -> str:
    return f"leaf_{i:05d}"


def _in_group() -> bool:
    """Whether this process is one rank of a group of several."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of the leaf that the caller's later updates do not touch
    (``.cpu()`` of a CUDA tensor is already one); a DTensor's whole value."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.cpu() if t.is_cuda else t.clone()
        return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return type(leaf).__name__


def _leaf_shardings(like, shardings) -> list:
    """The entry of ``shardings`` at each leaf of ``like``, in
    ``tree_flatten`` order (None where ``shardings`` is None or lacks the
    leaf's key)."""
    out: list = []

    def walk(node, sh):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], None if sh is None else sh.get(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, None if sh is None else sh[i])
        else:
            out.append(sh)

    walk(like, shardings)
    return out


def _paths(tree, prefix="") -> list[str]:
    """Each leaf's path, in ``tree_flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        return [p for n, v in zip(names, tree) for p in _paths(v, f"{prefix}/{n}")]
    return [prefix or "/"]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        leaves, _ = tree_flatten(state)
        arrays = [_to_numpy(l) for l in leaves]  # on the host before any thread starts
        meta = {"paths": _paths(state), "dtypes": [_dtype_name(l) for l in leaves]}
        if self.async_save:
            self.wait()  # the previous save is published, on every rank alike
        if _in_group() and dist.get_rank() != 0:  # rank 0 alone writes
            if not self.async_save:
                dist.barrier()  # rank 0 has published the checkpoint
            return
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_sync, args=(step, arrays, meta, extra), daemon=True
            )
            self._thread.start()
        else:
            self._save_sync(step, arrays, meta, extra)
            if _in_group():
                dist.barrier()

    def wait(self):
        """Wait for an async save; in a group of ranks, until rank 0's is
        published. Every rank calls it alike (``save`` does, and so must the
        caller once after its last save): it is one barrier of the group."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.async_save and _in_group():
            dist.barrier()

    def _save_sync(self, step: int, arrays: list, meta: dict, extra: Optional[dict]):
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **{_key(i): a for i, a in enumerate(arrays)})
        manifest = {
            "step": step,
            "n_leaves": len(arrays),
            **meta,
            "time": time.time(),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, "manifest.json")
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``like``: each tensor leaf on the
        device and in the type of ``like``'s, each scalar leaf as its type.
        A leaf is distributed by its entry of ``shardings`` (a spec or a
        placement list; ``shardings`` has ``like``'s structure) on the
        active mesh, else, where ``like``'s leaf is a DTensor, as it is."""
        from repro_torch.dist.sharding import PartitionSpec, active_mesh, placements

        mesh = active_mesh()
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, unflatten = tree_flatten(like)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(f"checkpoint holds {manifest['n_leaves']} leaves, "
                             f"the state {len(leaves)}")
        new_leaves = []
        shards = _leaf_shardings(like, shardings)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i, (ref, sh) in enumerate(zip(leaves, shards)):
                arr = data[_key(i)]
                if not isinstance(ref, torch.Tensor):
                    new_leaves.append(type(ref)(arr.item()))
                    continue
                if arr.shape != tuple(ref.shape):
                    raise ValueError(f"leaf {i}: {arr.shape} vs {tuple(ref.shape)}")
                t = torch.from_numpy(arr)
                if manifest["dtypes"][i] == "bfloat16":
                    t = t.view(torch.bfloat16)
                t = t.to(device=ref.device, dtype=ref.dtype)
                if sh is not None:
                    if mesh is None:
                        raise ValueError("restore(shardings=...) places leaves on the active "
                                         "mesh; call it under dist.sharding.use_mesh(mesh)")
                    sh = placements(sh, mesh) if isinstance(sh, PartitionSpec) else sh
                    t = distribute_tensor(t, mesh, list(sh), src_data_rank=None)
                elif isinstance(ref, DTensor):
                    t = distribute_tensor(t, ref.device_mesh, list(ref.placements),
                                          src_data_rank=None)
                new_leaves.append(t)
        return unflatten(new_leaves), manifest["extra"]

    def restore_latest(self, like: Any, shardings: Any = None):
        step = self.latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, like, shardings)
        return step, state, extra

    # ------------------------------------------------------------------
    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)
