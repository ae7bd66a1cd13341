"""Conservation checks (SP1xx), ported from ``repro.analysis.conservation``:
the analytical call stream must account for *exactly* the work the
lowered computation performs.

Three statically provable layers, per registry arch x request shape:

* every decomposed :class:`~repro_torch.core.decomposer.TaskArray` must conserve
  its family's closed-form demand — GEMM tile MXU sums telescope to
  ``2*M*N*K``, fused-MoE routing counts sum to ``M*topk`` so MXU is
  ``2*M*topk*3*H*N``, causal attention tiling stays inside its provable
  over-count bounds, elementwise families stream exactly their operands;
* the LM-head group of ``core.e2e.model_calls`` must price every position
  (``B*qlen`` prefill tokens: a head priced at the last token only is
  the undercount bug class, pinned forever) and
  its all-gather payload must match the head GEMM's output;
* the MoE EP dispatch/combine ``CommCall("all_to_all")`` payloads must
  equal :func:`count_ep_alltoall_bytes` — the byte ledger derived from
  the executed model layer — bit-for-bit. The reference keeps that ledger
  in ``launch.dryrun``; the port keeps it here, and its ``launch.dryrun``
  re-exports it.

Every check takes an optional ``calls=`` stream so seeded-bug tests can
re-introduce a historical bug and prove the diagnostic fires.
"""
from __future__ import annotations

import glob
import json
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.configs.base import ArchConfig
from repro_torch.core.decomposer import COMPUTE_DTYPE_BYTES, decompose, ep_alltoall_bytes
from repro_torch.core.hardware import REGISTRY, TPUSpec
from repro_torch.predict.api import CommCall, KernelCall, flatten_calls

#: decomposition tile choices depend on the device, but the conservation
#: sums are tile-invariant — one representative device is enough
DEFAULT_HW_NAME = "tpu-v5e"

#: relative tolerance for "exact" float comparisons
_RTOL = 1e-9


def _rel_err(actual: float, expected: float) -> float:
    return abs(actual - expected) / max(abs(expected), 1.0)


def _attention_mxu_bounds(X: Dict[str, Any]) -> tuple:
    """(lower, upper) MXU bound of one attention call: the exact causal
    per-row sum, and the sum plus the tile-granularity over-count (each
    row of a ``bq``-row query tile may see at most ``bq - 1`` extra KV
    positions — the tile's ``kv_eff`` is evaluated at its last row)."""
    B, H, G = X["bs"], X["nkv"], X["group"]
    qlen, kvlen, hd = X["qlen"], X["kvlen"], X["hd"]
    causal = X.get("causal", 1)
    if causal:
        offset = kvlen - qlen
        rows_kv = np.clip(offset + np.arange(qlen) + 1, 0, kvlen)
    else:
        rows_kv = np.full(qlen, float(kvlen))
    exact = 4.0 * hd * G * float(rows_kv.sum()) * B * H
    bq = min(256, qlen) if qlen > 1 else 1
    slack = 4.0 * hd * G * qlen * (bq - 1) * B * H if causal else 0.0
    return exact, exact + slack


def count_ep_alltoall_bytes(cfg: ArchConfig, B: int, qlen: int, *, train: bool = False) -> dict:
    """The EP dispatch/combine all-to-all payload of one MoE layer, counted
    from the executed model implementation (the reference's
    ``launch.dryrun.count_ep_alltoall_bytes``).

    ``models.moe.dispatch_geometry`` is the code path ``moe_layer`` builds
    its dispatched tensor ``(G, E, C, d)`` from, the tensor the expert mesh
    axis re-shards; so this is the byte ledger of EP traffic, in the
    layer's compute dtype. ``core.decomposer.ep_alltoall_bytes`` must
    reproduce ``dispatch_bytes``/``combine_bytes`` exactly from its
    workload dict.

    Returns ``{"dispatch_bytes", "combine_bytes", "layer_bytes",
    "model_bytes", "G", "group", "capacity"}`` (``model_bytes`` = per-layer
    x n_layers, the whole step's EP traffic)."""
    from repro_torch.models.moe import dispatch_geometry

    if not cfg.n_experts:
        raise ValueError(f"{cfg.name} is not an MoE architecture")
    G, Sg, C = dispatch_geometry(cfg, B * qlen, train=train)
    hop = float(G * cfg.n_experts * C * cfg.d_model * COMPUTE_DTYPE_BYTES[cfg.compute_dtype])
    return {
        "dispatch_bytes": hop,
        "combine_bytes": hop,
        "layer_bytes": 2.0 * hop,
        "model_bytes": 2.0 * hop * cfg.n_layers,
        "G": G,
        "group": Sg,
        "capacity": C,
    }


def check_task_conservation(
    cfg: ArchConfig,
    *,
    B: int,
    lin: int,
    lout: int,
    tp: int,
    hw: Optional[TPUSpec] = None,
    calls: Optional[list] = None,
) -> List[Diagnostic]:
    """SP102: decompose every unique kernel call of the request stream and
    check the family's conservation law on the task sums."""
    from repro_torch.core.e2e import request_calls

    hw = hw if hw is not None else REGISTRY[DEFAULT_HW_NAME]
    if calls is None:
        calls = request_calls(cfg, B, lin, lout, tp=tp)
    diags: List[Diagnostic] = []
    seen: set = set()
    for call, _w in flatten_calls(calls):
        if not isinstance(call, KernelCall):
            continue
        key = (call.kind, tuple(sorted(call.X.items())))
        if key in seen:
            continue
        seen.add(key)
        t = decompose(call.kind, call.X, hw)
        mxu = float(t.mxu.sum())
        X = call.X

        def fail(expected: str, actual: float, want: float) -> None:
            diags.append(
                Diagnostic(
                    code="SP102",
                    severity="error",
                    check="conservation",
                    message=(
                        f"{call.kind} task demands break conservation: "
                        f"expected {expected}, got {actual:.6g} (want {want:.6g})"
                    ),
                    arch=cfg.name,
                    where=f"core/decomposer:{call.kind} X={X}",
                    data={"kind": call.kind, "X": X, "actual": actual, "expected": want},
                )
            )

        if call.kind in ("gemm", "scaled_mm"):
            want = 2.0 * X["M"] * X["N"] * X["K"]
            if _rel_err(mxu, want) > _RTOL:
                fail("sum(mxu) == 2*M*N*K", mxu, want)
        elif call.kind == "fused_moe":
            want = 2.0 * X["M"] * X["topk"] * 3.0 * X["H"] * X["N"]
            if _rel_err(mxu, want) > _RTOL:
                fail("sum(mxu) == 2*M*topk*3*H*N", mxu, want)
        elif call.kind == "attention":
            lo, hi = _attention_mxu_bounds(X)
            if not (lo * (1 - _RTOL) <= mxu <= hi * (1 + _RTOL)):
                fail(f"causal MXU within [{lo:.6g}, {hi:.6g}]", mxu, lo)
        elif call.kind in ("rmsnorm", "silu_mul"):
            if mxu != 0.0:
                fail("sum(mxu) == 0 for elementwise families", mxu, 0.0)
            streams = 2.0 if call.kind == "rmsnorm" else 3.0
            b = X.get("dtype_bytes", 2)
            want = streams * X["seq"] * X["dim"] * b
            hbm = float(t.hbm.sum())
            if _rel_err(hbm, want) > _RTOL:
                fail("sum(hbm) == streams*seq*dim*bytes", hbm, want)
    return diags


def check_head_accounting(
    cfg: ArchConfig,
    *,
    B: int,
    qlen: int,
    tp: int,
    calls: Optional[list] = None,
) -> List[Diagnostic]:
    """SP103/SP104: the LM-head group must price every position.

    Prefill runs the head GEMM over ``B*qlen`` tokens (a decode step over
    ``B``); its TP all-gather moves exactly the f32 logit shard
    ``tokens * padded_vocab/tp * 4`` bytes. This is the statically pinned
    form of the LM-head undercount bug class; the SP103 message keeps the
    reference's words."""
    from repro_torch.core.e2e import model_calls

    if calls is None:
        calls = model_calls(cfg, B, qlen, qlen, tp)
    diags: List[Diagnostic] = []
    head_seq = None
    for item in calls:
        if not isinstance(item, (KernelCall, CommCall)) and item[0] == "head":
            head_seq = list(item[2])
    if head_seq is None:
        return [
            Diagnostic(
                code="SP103",
                severity="error",
                check="conservation",
                message="model_calls emits no ('head', ...) group — the LM head is unpriced",
                arch=cfg.name,
                where="core/e2e:model_calls",
            )
        ]
    want_tokens = B * qlen if qlen > 1 else B
    want_n = cfg.padded_vocab // tp
    gemms = [c for c in head_seq if isinstance(c, KernelCall) and c.kind == "gemm"]
    gathers = [c for c in head_seq if isinstance(c, CommCall) and c.op == "all_gather"]
    if not gemms:
        diags.append(
            Diagnostic(
                code="SP103",
                severity="error",
                check="conservation",
                message="head group has no GEMM call",
                arch=cfg.name,
                where="core/e2e:model_calls head",
            )
        )
        return diags
    g = gemms[0]
    if g.X["M"] != want_tokens or g.X["N"] != want_n or g.X["K"] != cfg.d_model:
        diags.append(
            Diagnostic(
                code="SP103",
                severity="error",
                check="conservation",
                message=(
                    f"LM-head GEMM prices (M={g.X['M']}, N={g.X['N']}, K={g.X['K']}) "
                    f"but the model computes logits for (M={want_tokens}, "
                    f"N={want_n}, K={cfg.d_model}) at B={B}, qlen={qlen}, tp={tp} "
                    f"— token undercount (the PR 2 bug class)"
                ),
                arch=cfg.name,
                where="core/e2e:model_calls head",
                data={"actual": dict(g.X), "expected": {"M": want_tokens, "N": want_n, "K": cfg.d_model}},
            )
        )
    if tp > 1:
        want_bytes = want_tokens * want_n * 4.0
        if not gathers:
            diags.append(
                Diagnostic(
                    code="SP104",
                    severity="error",
                    check="conservation",
                    message=f"head group emits no all_gather at tp={tp} — logit shards never rejoin",
                    arch=cfg.name,
                    where="core/e2e:model_calls head",
                )
            )
        elif _rel_err(gathers[0].nbytes, want_bytes) > _RTOL:
            diags.append(
                Diagnostic(
                    code="SP104",
                    severity="error",
                    check="conservation",
                    message=(
                        f"head all_gather moves {gathers[0].nbytes:.6g} bytes but the "
                        f"f32 logit shard is {want_bytes:.6g} (tokens*padded_vocab/tp*4)"
                    ),
                    arch=cfg.name,
                    where="core/e2e:model_calls head",
                    data={"actual": gathers[0].nbytes, "expected": want_bytes},
                )
            )
    return diags


def check_ep_alltoall(
    cfg: ArchConfig,
    *,
    B: int,
    qlen: int,
    tp: int,
    calls: Optional[list] = None,
) -> List[Diagnostic]:
    """SP101: the workload generator's EP dispatch/combine all-to-all
    payloads must equal :func:`count_ep_alltoall_bytes` — the byte ledger
    counted through the executed model layer's own dispatch geometry —
    exactly. Non-MoE archs (or tp==1) audit vacuously."""
    from repro_torch.core.e2e import layer_calls

    if not cfg.n_experts or tp <= 1:
        return []
    if calls is None:
        calls = layer_calls(cfg, B, qlen, qlen, tp)
    ledger = count_ep_alltoall_bytes(cfg, B, qlen)
    a2a = [
        c for c, _w in flatten_calls(calls)
        if isinstance(c, CommCall) and c.op == "all_to_all"
    ]
    diags: List[Diagnostic] = []
    if len(a2a) != 2:
        diags.append(
            Diagnostic(
                code="SP101",
                severity="error",
                check="conservation",
                message=(
                    f"MoE layer at tp={tp} emits {len(a2a)} all_to_all call(s); "
                    f"EP dispatch+combine require exactly 2"
                ),
                arch=cfg.name,
                where="core/e2e:layer_calls moe",
            )
        )
    for label, call in zip(("dispatch", "combine"), a2a):
        want = ledger[f"{label}_bytes"]
        if call.nbytes != want:
            diags.append(
                Diagnostic(
                    code="SP101",
                    severity="error",
                    check="conservation",
                    message=(
                        f"EP {label} all_to_all prices {call.nbytes:.6g} bytes; the "
                        f"dry-run ledger counts {want:.6g} from the executed model "
                        f"layer (B={B}, qlen={qlen}, tp={tp}) — byte drift"
                    ),
                    arch=cfg.name,
                    where="core/e2e:layer_calls moe",
                    data={"actual": call.nbytes, "expected": want, "hop": label},
                )
            )
    return diags


def check_dryrun_artifacts(
    cfg: ArchConfig, *, root: str = os.path.join("results", "dryrun")
) -> List[Diagnostic]:
    """SP105/SP101: cross-check cached dry-run HLO cost ledgers (the
    reference's ``launch.dryrun.analyze`` writes them) against the
    analytical EP byte counts. When no artifacts are cached — the normal
    state, since full lowering is tier-2 — the check reports an *info* skip
    instead of lowering anything (the auditor never compiles). The ledgers
    are read as JSON data; the SP105 message keeps the reference's words,
    so the two auditors' reports are equal."""
    paths = sorted(glob.glob(os.path.join(root, f"*{cfg.name}*.json")))
    if not paths:
        return [
            Diagnostic(
                code="SP105",
                severity="info",
                check="conservation",
                message=(
                    f"no cached dry-run ledger under {root!r} — HLO cross-check "
                    f"skipped (run launch.dryrun to materialize one)"
                ),
                arch=cfg.name,
                where=root,
            )
        ]
    diags: List[Diagnostic] = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            ledger = json.load(f)
        ep = ledger.get("ep_alltoall")
        if not ep or not cfg.n_experts:
            continue
        T = int(ep.get("T", 0))
        if not T:
            continue
        want = ep_alltoall_bytes(
            {
                "T": T,
                "d": cfg.d_model,
                "E": cfg.n_experts,
                "topk": cfg.top_k,
                "capacity_factor": max(cfg.capacity_factor, 2.0),
                "moe_group": cfg.moe_group,
                "dtype_bytes": COMPUTE_DTYPE_BYTES[cfg.compute_dtype],
            }
        )
        got = float(ep.get("dispatch_bytes", math.nan))
        if got != want:
            diags.append(
                Diagnostic(
                    code="SP101",
                    severity="error",
                    check="conservation",
                    message=(
                        f"cached dry-run ledger {os.path.basename(path)} counts "
                        f"{got:.6g} EP dispatch bytes; the decomposer prices {want:.6g}"
                    ),
                    arch=cfg.name,
                    where=path,
                    data={"actual": got, "expected": want},
                )
            )
    return diags


def check_conservation(
    cfg: ArchConfig,
    *,
    B: int = 2,
    lin: int = 512,
    lout: int = 64,
    tp: int = 16,
    hw: Optional[TPUSpec] = None,
) -> List[Diagnostic]:
    """All conservation checks for one arch at one request shape: task
    sums over the full request stream, head accounting at prefill and
    decode, EP byte exactness at both phases, and the (artifact-gated)
    dry-run cross-check."""
    diags = check_task_conservation(cfg, B=B, lin=lin, lout=lout, tp=tp, hw=hw)
    for qlen in (lin, 1):
        diags += check_head_accounting(cfg, B=B, qlen=qlen, tp=tp)
        diags += check_ep_alltoall(cfg, B=B, qlen=qlen, tp=tp)
    diags += check_dryrun_artifacts(cfg)
    return diags
