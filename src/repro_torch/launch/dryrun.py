"""Multi-pod dry run (``repro.launch.dryrun``): prove the distribution config
is coherent without hardware, and count what each step does per device.

For every (architecture x input shape) cell and the production meshes
(single pod 16x16, multi-pod 2x16x16, optionally with a 4-way ``pipe``
axis) this runs the step (one train step, a prefill or a decode) against
shape-only inputs and counts its per-device work: dot FLOPs, vector ops,
transcendentals, HBM bytes and collective operand bytes by kind (all-gather
/ all-reduce / reduce-scatter / all-to-all / collective-permute), the
inputs to the roofline (``roofline.analysis``).

It is device-free by design, as the reference's is with its 512 forced host
devices: this process joins a fake process group of 256 or 512 ranks
(``launch.mesh.fake_process_group``), builds the production mesh on it and
runs the step on fake CPU tensors (``FakeTensorMode``), so no tensor's
bytes are allocated and no collective moves anything. The parameter shapes
come from ``init_params`` on the meta device; the parameters, optimizer
state, batch and cache are fake CPU tensors placed by the sharding rules as
DTensors of fake local shards; the step runs once under the op counter
(``roofline.op_cost``), which takes the place of XLA's compile and the
reference's HLO walk. Its outputs are placed as the reference's
``out_shardings`` place them. The kernels' entry points see CPU tensors, so
the step runs their plain versions, as the reference lowers its plain path
(``use_pallas`` is off by default).

Each cell's JSON has the reference's keys, so ``roofline.analysis``,
``roofline.report`` and ``analysis.check_dryrun_artifacts`` read it as they
read the reference's. Where there is no XLA the meaning shifts:
``xla_flops_raw``/``xla_bytes_raw`` are null; ``compile_s`` is the
lowering's wall seconds; ``hlo_lines`` counts the op ledger's lines;
``memory.argument_bytes``/``output_bytes`` are the per-device bytes of the
step's inputs and outputs, ``temp_bytes`` the peak of the bytes its ops
had allocated and not yet freed. The op ledger is written beside the JSONs
as ``hlo/<tag>.ops.zst`` (``.ops.gz`` where ``zstandard`` is not
installed, as on the card's machine). ``hbm_bytes`` is the eager program's traffic,
unfused, so the port's artifacts go to their own directory and are never
mixed with the reference's fused-HLO ones.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 8 --out results/dryrun_torch

With more than one cell to lower (``--all``, ``--both-meshes``) each cell
is lowered by this CLI in a process of its own, ``--jobs`` at once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import time
import traceback
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.analysis.conservation import count_ep_alltoall_bytes
from repro_torch.configs import SHAPES, all_cells, get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (
    batch_pspecs,
    cache_pspecs,
    param_pspecs,
    place,
    resolve_pspec,
    use_mesh,
)
from repro_torch.launch.mesh import fake_process_group, make_production_mesh, mesh_tag
from repro_torch.models import transformer as T
from repro_torch.models.registry import batch_specs, build_model
from repro_torch.roofline.op_cost import OpCounter
from repro_torch.train.step import TrainConfig, make_optimizer, make_train_step, train_state_pspecs

__all__ = [
    "Lowering",
    "analyze",
    "collective_bytes",
    "count_ep_alltoall_bytes",
    "lower_cell",
    "local_nbytes",
    "lower_step",
    "main",
    "read_ledger",
    "run_cell",
    "state_pspecs",
    "write_ledger",
]


# ----------------------------------------------------------------------
# HLO collective parsing (the reference's, for its HLO text)
# ----------------------------------------------------------------------

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Sum per-device operand bytes of every collective op in optimized HLO.

    Returns {op_kind: {'bytes': int, 'count': int}} plus a '_total'."""
    out = {k: {"bytes": 0, "count": 0} for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        s = line.strip()
        # ops look like: %name = bf16[128,32]{1,0} all-gather(...), replica_groups=...
        m = re.match(r"^%?[\w.-]+\s*=\s*(\([^)]*\)|[^=]*?)\s*([a-z0-9-]+)\(", s)
        if not m:
            continue
        op = m.group(2)
        kind = None
        for k in _COLLECTIVES:
            if op == k or op.startswith(k + "-"):  # e.g. all-reduce-start
                kind = k
                break
        if kind is None or op.endswith("-done"):
            continue
        out[kind]["bytes"] += _shape_bytes(m.group(1))
        out[kind]["count"] += 1
    out["_total_bytes"] = sum(v["bytes"] for k, v in out.items() if isinstance(v, dict))
    out["_total_count"] = sum(v["count"] for k, v in out.items() if isinstance(v, dict))
    return out


# ----------------------------------------------------------------------
# per-cell lowering
# ----------------------------------------------------------------------


def state_pspecs(state_shapes, mesh):
    """``train.step.train_state_pspecs``, under the name the reference's
    dry run gives it (kept for that module's API)."""
    return train_state_pspecs(state_shapes, mesh)


@dataclasses.dataclass
class Lowering:
    """One step run under the op counter: the counter (its op ledger and
    peak live bytes), the per-device bytes of the step's inputs and
    outputs, of the outputs that are not inputs updated in place (a decode
    step's cache is), and the wall seconds the run took."""

    counter: OpCounter
    argument_bytes: int
    output_bytes: int
    new_output_bytes: int
    seconds: float


def _leaves(tree) -> list:
    """Every tensor leaf of a tree of dicts, ``Tree``s, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (dict, T.Tree)):
        return [t for k in tree.keys() for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _nbytes(t) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def local_nbytes(tree) -> int:
    """Bytes this rank holds of every tensor leaf (a DTensor's local shard)
    of a tree of dicts, ``Tree``s, lists and tuples; other leaves hold
    none."""
    return sum(_nbytes(t) for t in _leaves(tree))


def _fake(tree):
    """A fake CPU tensor (under the active ``FakeTensorMode``) for every
    leaf of a meta tree, same shape and dtype, in plain dicts and lists."""
    return T.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def lower_step(cfg: ArchConfig, kind: str, B: int, S: int, *, mesh=None,
               compute_params: bool = False) -> Lowering:
    """Run one step of ``cfg`` on fake CPU tensors under the op counter.

    ``kind`` is ``"train"`` (one ``make_train_step`` step on a ``(B, S)``
    batch: the loss, ``autograd.grad`` and AdamW), ``"prefill"`` (a
    ``(B, S)`` batch) or ``"decode"`` (one token for each of ``B`` rows
    over a cache of ``S`` positions). With ``mesh`` (a ``DeviceMesh``, of
    a fake process group for the production meshes) every input is placed
    by its sharding rules and the outputs as the reference's
    ``out_shardings`` place them; without one, nothing is sharded.
    ``compute_params`` hands prefill and decode the parameters as the
    serving engines hold them (``transformer.cast_for_compute``) instead of
    as ``init`` makes them."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind {kind!r}: train, prefill or decode")
    api = build_model(cfg, "cpu")
    meta = T.init_params(cfg, torch.Generator(), torch.device("meta"))

    def placed(tree, specs_of):
        """``tree`` placed by ``specs_of(tree, mesh)`` (itself without a mesh)."""
        return tree if mesh is None else place(tree, specs_of(tree, mesh), mesh)

    def logits_spec(logits, mesh):
        return resolve_pspec((B, cfg.padded_vocab), ("batch", "tp"), mesh)

    counter = OpCounter()
    # DTensor works out some shard offsets on real index tensors (see
    # roofline.op_cost), which then index fake shards
    with contextlib.ExitStack() as stack:
        stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        if mesh is not None:
            stack.enter_context(use_mesh(mesh))
        params = _fake(meta)
        if kind == "train":
            tc = TrainConfig()
            optimizer = make_optimizer(tc)
            state = {"params": params, "opt": optimizer.init(params), "step": 0, "err": None}
            batch = {k: torch.empty(shape, dtype=dt) for k, (shape, dt) in
                     batch_specs(cfg, B, S).items()}
            step = make_train_step(api, optimizer, tc)
            args = (placed(state, state_pspecs), placed(batch, batch_pspecs))

            def run(state, batch):
                new_state, metrics = step(state, batch)
                return placed(new_state, state_pspecs), metrics
        else:
            if compute_params:
                params = T.tree_map(lambda t: t, T.cast_for_compute(T.Tree(params), cfg))
            if kind == "prefill":
                batch = {k: torch.empty(shape, dtype=dt) for k, (shape, dt) in
                         batch_specs(cfg, B, S).items()}
                args = (placed(params, param_pspecs), placed(batch, batch_pspecs))

                @torch.no_grad()
                def run(params, batch):
                    logits, caches = api.prefill(params, batch)
                    return placed(logits, logits_spec), placed(caches, cache_pspecs)
            else:
                # the new tokens and their positions shard by batch, as the
                # reference's in_shardings place them
                args = (placed(params, param_pspecs),
                        placed(T.init_cache(cfg, B, S, "cpu"), cache_pspecs),
                        *placed([torch.empty((B,), dtype=torch.int64),
                                 torch.empty((B,), dtype=torch.int64)], batch_pspecs))

                @torch.no_grad()
                def run(params, caches, tokens, positions):
                    logits, caches = api.decode(params, caches, tokens, positions)
                    return placed(logits, logits_spec), placed(caches, cache_pspecs)
        argument_bytes = local_nbytes(args)
        t0 = time.perf_counter()
        with counter:
            out = run(*args)
        seconds = time.perf_counter() - t0
        output_bytes = local_nbytes(out)
        inputs = {id(t) for t in _leaves(args)}
        new_output_bytes = sum(_nbytes(t) for t in _leaves(out) if id(t) not in inputs)
    return Lowering(counter, argument_bytes, output_bytes, new_output_bytes, seconds)


def lower_cell(arch: str, shape_name: str, multi_pod: bool, pipeline: bool = False):
    """Lower one cell on its production mesh, on a fake process group of
    the mesh's size. Returns ``(lowering, meta)``.

    ``pipeline=True`` lowers against the pipeline-parallel production
    mesh (4-way ``pipe`` axis, see ``launch.mesh``); parameter/batch
    sharding rules replicate over the ``pipe`` axis (only the ``"pipe"``
    role claims it), so the lowering stays coherent while the mesh leaves
    room for ``dist.pipeline.pipeline_forward`` stage placement."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    if not cfg.supports_shape(shape):
        raise ValueError(f"{arch} x {shape_name}: documented skip (DESIGN.md)")
    with fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, pipeline=pipeline)
        lowering = lower_step(cfg, shape.kind, shape.global_batch, shape.seq_len, mesh=mesh)
    meta = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_tag(multi_pod=multi_pod, pipeline=pipeline),
        "n_devices": mesh.size(),
        "compile_s": round(lowering.seconds, 1),
    }
    return lowering, meta


def analyze(lowering: Lowering, meta: dict) -> dict:
    walk = lowering.counter.summary()
    out: dict[str, Any] = dict(meta)
    # there is no XLA here: its own (loop-unaware) numbers do not exist
    out["xla_flops_raw"] = None
    out["xla_bytes_raw"] = None
    out["flops"] = walk.flops
    out["dot_flops"] = walk.dot_flops
    out["vector_ops"] = walk.vector_ops
    out["transcendentals"] = walk.transcendentals
    out["hbm_bytes"] = walk.hbm_bytes
    out["memory"] = {
        "argument_bytes": lowering.argument_bytes,
        "output_bytes": lowering.output_bytes,
        "temp_bytes": lowering.counter.peak_bytes,
        "generated_code_bytes": None,
    }
    out["collectives"] = {
        **walk.collectives,
        "_total_bytes": walk.collective_bytes,
    }
    out["unknown_ops"] = walk.unknown_ops
    out["hlo_lines"] = len(lowering.counter.ledger_lines())
    cfg = get_arch(meta["arch"])
    if cfg.n_experts:
        # the analytical EP all-to-all ledger next to the counted
        # collectives: per-layer dispatch/combine bytes of the dispatched
        # (G, E, C, d) tensor, from the model's own grouping/capacity code
        shape = SHAPES[meta["shape"]]
        qlen = 1 if shape.kind == "decode" else shape.seq_len
        out["ep_alltoall"] = count_ep_alltoall_bytes(
            cfg, shape.global_batch, qlen, train=shape.kind == "train"
        )
    return out


def write_ledger(path: str, lines) -> str:
    """Write an op ledger compressed, with ``zstandard`` where it is
    installed (``path`` as given, ``.ops.zst``), else with the standard
    library's gzip (``.ops.gz`` in its place). Returns the path written."""
    data = "\n".join(lines).encode()
    try:
        import zstandard
    except ImportError:
        import gzip

        path = path.removesuffix(".zst") + ".gz"
        data = gzip.compress(data)
    else:
        data = zstandard.compress(data)
    with open(path, "wb") as f:
        f.write(data)
    return path


def read_ledger(path: str) -> list[str]:
    """The lines of an op ledger written by :func:`write_ledger`."""
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".gz"):
        import gzip

        return gzip.decompress(data).decode().splitlines()
    import zstandard

    return zstandard.decompress(data).decode().splitlines()


def run_cell(
    arch: str, shape_name: str, multi_pod: bool, print_analysis=True, ops_path=None,
    pipeline: bool = False,
) -> dict:
    lowering, meta = lower_cell(arch, shape_name, multi_pod, pipeline)
    result = analyze(lowering, meta)
    if ops_path:
        write_ledger(ops_path, lowering.counter.ledger_lines())
    if print_analysis:
        print(json.dumps(result, indent=2, default=str))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="lower against the pipeline-parallel production "
                         "mesh (4-way pipe axis; see launch.mesh)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with more than one cell to lower: cells lowered at once, "
                         "each in its own process")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if (args.all or args.both_meshes) else [args.multi_pod]
    todo = []
    for arch, shape_name in cells:
        for mp in meshes:
            tag = f"{arch}__{shape_name}__{mesh_tag(multi_pod=mp, pipeline=args.pipeline)}"
            if os.path.exists(os.path.join(args.out, tag + ".json")):
                print(f"[skip cached] {tag}")
            else:
                todo.append((arch, shape_name, mp, tag))
    if len(todo) > 1:
        return _run_apart(todo, args)

    n_fail = 0
    for arch, shape_name, mp, tag in todo:
        path = os.path.join(args.out, tag + ".json")
        print(f"[dry-run] {tag}", flush=True)
        try:
            ops_dir = os.path.join(args.out, "hlo")
            os.makedirs(ops_dir, exist_ok=True)
            result = run_cell(
                arch, shape_name, mp, print_analysis=False,
                ops_path=os.path.join(ops_dir, tag + ".ops.zst"),
                pipeline=args.pipeline,
            )
            with open(path, "w") as f:
                json.dump(result, f, indent=2, default=str)
            print(
                f"  ok: flops={result['flops']:.3e} "
                f"coll={result['collectives']['_total_bytes']:.3e}B "
                f"compile={result['compile_s']}s",
                flush=True,
            )
        except Exception:  # noqa: BLE001  (one cell's failure is recorded; the rest run)
            n_fail += 1
            with open(path + ".fail", "w") as f:
                f.write(traceback.format_exc())
            print(f"  FAIL ({tag}) — see {path}.fail", flush=True)
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


def _run_apart(todo, args) -> int:
    """Each cell of ``todo`` lowered by this module's CLI in a process of its
    own, ``args.jobs`` at once: a cell's fake process group and whatever
    DTensor caches for its mesh end with its process. Prints each cell's
    output as it ends, with its wall seconds, and the whole run's."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    # the children import this package from where this process found it
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))

    def run(cell):
        arch, shape_name, mp, tag = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape_name, "--out", args.out]
        cmd += ["--multi-pod"] * mp + ["--pipeline"] * args.pipeline
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, env=env)
        return tag, p.returncode, p.stdout, time.perf_counter() - t0

    t0 = time.perf_counter()
    n_fail = 0
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        for tag, rc, text, seconds in pool.map(run, todo):
            n_fail += rc != 0
            print(text.rstrip() + f"\n  {tag}: exit {rc} in {seconds:.1f}s", flush=True)
    print(f"done; {n_fail} failures of {len(todo)} cells in {time.perf_counter() - t0:.1f}s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
