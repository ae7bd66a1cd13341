"""End-to-end inference prediction (paper §V-D), ported from
``repro.core.e2e`` and held equal to it.

The Workload Generator lowers an ArchConfig + request shape + parallelism
into the kernel-invocation sequence a serving engine would issue, plus the
collective calls of TP/EP/PP. The default pricing is additive (sequential
kernel execution — the paper's stated assumption); ``comm_overlap=True``
re-prices collectives against the cross-pipeline exposed-compute window
(``Estimate.overlapped``). Latency estimation is delegated to a
``repro_torch.predict`` backend: ``request_estimate(cfg, ..., predictor=p)``
returns an ``Estimate`` with the total plus per-family/per-op breakdown and
the analytical ceiling; ``step_time``/``request_latency`` are the scalar
views, ``request_sweep`` prices the same request on many hardware at
once (``repro_torch.predict.sweep``), ``place_request`` ranks the fleet for
it under a placement objective (``repro_torch.serve.placement``) and
``simulate_fleet`` replays a request stream through it with queueing
(``repro_torch.serve.fleet``). The legacy ``kernel_time``/``comm_time``
two-lambda kwargs are kept as a deprecation shim (wrapped in
``CallableTimesPredictor``).

Every latency these functions return is a prediction for a registry TPU,
not a time measured on the machine that runs the port.

Modeling conventions (documented deviations):
  * one REGISTRY slice = one accelerator unit (the paper's "GPU"); TP/PP
    span units, the slice's chips are the intra-unit parallelism;
  * MoE EP over TP units: each unit runs ~M*topk/tp token-expert pairs on
    E/tp local experts; dispatch and combine are first-class
    ``CommCall("all_to_all", ...)``s whose payload is the dispatched
    (G, E, C, d) tensor — byte-exact against the executed model layer
    (``decomposer.ep_alltoall_bytes`` == the bytes ``models.moe`` builds);
  * PP bubbles are the exact tick counts of the pipeline schedules
    (GPipe, interleaved 1F1B, or zero-bubble ZB-H1), see ``pp_bubble``;
  * SSM (mamba2/hymba) lowers to the SSD chunked einsum structure expressed
    as gemm + elementwise calls, an approximation;
  * decode-phase cost integrates over growing KV via Simpson's rule on
    3 sampled cache lengths (same approximation for oracle and predictors).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core import hwsim
from repro_torch.core.decomposer import COMPUTE_DTYPE_BYTES, ep_alltoall_bytes
from repro_torch.core.hardware import TPUSpec

# call types + comm regressor live in the predict layer now; re-exported
# here, as the reference's e2e re-exports them
from repro_torch.predict.api import CommCall, Estimate, KernelCall  # noqa: F401
from repro_torch.predict.backends import CallableTimesPredictor, get_predictor
from repro_torch.predict.comm import CommRegressor  # noqa: F401
from repro_torch.predict.sweep import SweepPredictor, SweepResult, check_prebuilt_exclusive


def _gemm(M, N, K, count=1):
    return KernelCall("gemm", {"M": int(M), "N": int(max(N, 1)), "K": int(max(K, 1))}, count)


def layer_calls(cfg: ArchConfig, B: int, qlen: int, kvlen: int, tp: int) -> list:
    """One decoder layer's kernel + comm sequence."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    T = B * qlen
    calls: list = []

    def attn_block():
        out = [
            KernelCall("rmsnorm", {"seq": T, "dim": d}),
            _gemm(T, (Hq + 2 * Hkv) * hd // tp, d),
            KernelCall(
                "attention",
                {
                    "bs": B,
                    "nkv": max(Hkv // tp, 1),
                    "group": max(Hq // Hkv, 1),
                    "hd": hd,
                    "qlen": qlen,
                    "kvlen": kvlen,
                    "causal": 1,
                },
            ),
            _gemm(T, d, Hq * hd // tp),
        ]
        if tp > 1:
            out.append(CommCall("all_reduce", T * d * 2.0, tp))
        return out

    def ffn_block(dff):
        out = [
            KernelCall("rmsnorm", {"seq": T, "dim": d}),
            _gemm(T, dff // tp, d, count=2),  # gate + up
            KernelCall("silu_mul", {"seq": T, "dim": max(dff // tp, 1)}),
            _gemm(T, d, dff // tp),
        ]
        if tp > 1:
            out.append(CommCall("all_reduce", T * d * 2.0, tp))
        return out

    def ssm_block():
        di, N, Q = cfg.d_inner, cfg.ssm_state, cfg.ssd_chunk
        proj = 2 * di + 2 * cfg.ssm_groups * N + cfg.ssm_heads
        out = [
            KernelCall("rmsnorm", {"seq": T, "dim": d}),
            _gemm(T, proj // tp, d),  # in_proj
            # SSD chunked einsums (intra-chunk quadratic + state path)
            _gemm(T, min(Q, max(qlen, 1)), N),  # C B^T scores
            _gemm(T, cfg.ssm_headdim, min(Q, max(qlen, 1))),  # scores @ x
            _gemm(T, cfg.ssm_headdim * N // max(tp, 1), 2),  # state update/out
            KernelCall("silu_mul", {"seq": T, "dim": max(di // tp, 1)}),
            _gemm(T, d, di // tp),  # out_proj
        ]
        if tp > 1:
            out.append(CommCall("all_reduce", T * d * 2.0, tp))
        return out

    fam = cfg.family
    if fam in ("dense", "audio", "vlm"):
        calls += attn_block()
        calls += ffn_block(cfg.d_ff)
        if fam == "vlm" and cfg.cross_every:
            # amortized gated cross-attn layer every (cross_every+1) layers
            frac = 1.0 / cfg.cross_every
            calls.append(
                KernelCall(
                    "attention",
                    {
                        "bs": B,
                        "nkv": max(Hkv // tp, 1),
                        "group": max(Hq // Hkv, 1),
                        "hd": hd,
                        "qlen": qlen,
                        "kvlen": cfg.n_img_tokens,
                        "causal": 0,
                    },
                    count=0 if qlen == 0 else 1,
                )
            )
    elif fam == "moe":
        calls += attn_block()
        calls.append(KernelCall("rmsnorm", {"seq": T, "dim": d}))
        E_unit = max(cfg.n_experts // tp, 1)
        pairs = T * cfg.top_k
        M_unit = max(int(math.ceil(pairs / tp)), 1)
        calls.append(_gemm(T, cfg.n_experts, d))  # router
        # EP dispatch/combine: the expert dim shards over the tp units, so
        # routed tokens cross the mesh twice as all-to-alls. The payload is
        # the dispatched-activation tensor (G, E, C, d) — the exact bytes
        # launch.dryrun.count_ep_alltoall_bytes derives from the executed
        # model layer (serving capacity: max(capacity_factor, 2.0), the
        # inference branch of models.moe._capacity).
        if tp > 1:
            a2a = ep_alltoall_bytes(
                {
                    "T": T,
                    "d": d,
                    "E": cfg.n_experts,
                    "topk": cfg.top_k,
                    "capacity_factor": max(cfg.capacity_factor, 2.0),
                    "moe_group": cfg.moe_group,
                    "dtype_bytes": COMPUTE_DTYPE_BYTES[cfg.compute_dtype],
                }
            )
            # the routed payload inherits the fused-MoE workload's routing
            # skew (same dirichlet model), so the comm oracle prices the
            # hot-chip serialization instead of a balanced exchange
            calls.append(CommCall("all_to_all", a2a, tp, skew=0.3))  # dispatch
        calls.append(
            KernelCall(
                "fused_moe",
                {
                    "M": M_unit,
                    "E": E_unit,
                    "topk": 1,
                    "H": d,
                    "N": cfg.moe_hidden,
                    "skew": 0.3,
                    "seed": 7,
                },
            )
        )
        if tp > 1:
            calls.append(CommCall("all_to_all", a2a, tp, skew=0.3))  # combine
        if cfg.dense_residual:
            calls += ffn_block(cfg.d_ff)
    elif fam == "ssm":
        calls += ssm_block()
    elif fam == "hybrid":
        calls += attn_block()
        calls += ssm_block()
        calls += ffn_block(cfg.d_ff)
    return calls


def apply_tuned(calls: list, tuned: Optional[dict]) -> list:
    """Merge a tuned block table (``repro_torch.tune.TunedConfigs.for_hw(hw)``:
    kernel family -> block kwargs) into every matching kernel call's
    workload. Keys already present in a call's ``X`` win, so explicit
    per-call choices are never overridden; calls of untuned families pass
    through untouched."""
    if not tuned:
        return calls
    out: list = []
    for item in calls:
        if isinstance(item, KernelCall):
            blocks = tuned.get(item.kind)
            if blocks:
                item = KernelCall(
                    item.kind,
                    {**{k: int(v) for k, v in blocks.items()}, **item.X},
                    item.count,
                )
            out.append(item)
        elif isinstance(item, CommCall):
            out.append(item)
        else:  # (label, reps, sub-sequence) group
            label, reps, seq = item
            out.append((label, reps, apply_tuned(seq, tuned)))
    return out


def model_calls(
    cfg: ArchConfig, B: int, qlen: int, kvlen: int, tp: int,
    tuned: Optional[dict] = None,
) -> list:
    calls = []
    per_layer = layer_calls(cfg, B, qlen, kvlen, tp)
    calls.append(("layers", cfg.n_layers, per_layer))
    # LM head over every position: B*qlen tokens in prefill, B in decode
    head_tokens = B * qlen if qlen > 1 else B
    head = [
        KernelCall("rmsnorm", {"seq": B * qlen, "dim": cfg.d_model}),
        _gemm(head_tokens, cfg.padded_vocab // tp, cfg.d_model),
    ]
    if tp > 1:
        head.append(CommCall("all_gather", head_tokens * cfg.padded_vocab // tp * 4.0, tp))
    calls.append(("head", 1, head))
    # the audio encoder runs once per request, at prefill — decode steps
    # (qlen == 1) reuse its output, so they must not re-price it
    if cfg.family == "audio" and qlen > 1:
        enc = layer_calls(
            dataclasses.replace(cfg, family="dense"), B, cfg.enc_frames, cfg.enc_frames, tp
        )
        calls.append(("encoder", cfg.n_enc_layers, enc))
    return apply_tuned(calls, tuned)


def pp_boundary_hops(pp: int, schedule: str = "gpipe", interleave: int = 2) -> int:
    """Device hops an activation makes crossing stage boundaries: GPipe's
    contiguous placement crosses ``pp - 1``; the interleaved 1F1B placement
    routes every activation through all ``pp * interleave`` chunks, i.e.
    ``pp * interleave - 1`` ring hops. ZB-H1 keeps the 1F1B ring but the
    split backward (B then W ticks) re-crosses each chunk boundary with the
    input-grad wave, doubling boundary traffic to ``2*pp*interleave - 1``
    (the forward's ``pp*interleave - 1`` plus one B-phase hop per chunk).
    Single source of truth for ``request_calls`` and
    ``serve.trace.TraceRecorder``."""
    if pp <= 1:
        return 0
    if schedule == "zb-h1":
        return 2 * pp * interleave - 1
    return pp * interleave - 1 if schedule == "1f1b" else pp - 1


def request_calls(
    cfg: ArchConfig, B: int, lin: int, lout: int, *, tp: int = 1, pp: int = 1,
    pp_schedule: str = "gpipe", pp_interleave: int = 2,
    tuned: Optional[dict] = None,
) -> list:
    """The full request's call sequence: prefill + Simpson-weighted decode
    samples (3 cache lengths integrate the growing KV) + PP stage-boundary
    activations. One batched ``Predictor.predict`` over this sequence
    replaces 4 ``step_time`` passes.

    Stage-boundary traffic follows the schedule: GPipe crosses ``pp - 1``
    boundaries per token; the interleaved 1F1B placement
    (``pp_schedule="1f1b"``) routes every activation through
    ``pp * pp_interleave - 1`` chunk boundaries, all of them device hops
    on the pipeline ring (``dist.pipeline``)."""
    groups = [("prefill", 1.0, model_calls(cfg, B, lin, lin, tp, tuned))]
    for label, w, kvlen in (
        ("decode_start", lout / 6.0, lin),
        ("decode_mid", 4.0 * lout / 6.0, lin + lout // 2),
        ("decode_end", lout / 6.0, lin + lout),
    ):
        groups.append((label, w, model_calls(cfg, B, 1, kvlen, tp, tuned)))
    if pp > 1:
        # stage boundary activations, per token step and per prefill
        boundary = pp_boundary_hops(pp, pp_schedule, pp_interleave) * (
            B * cfg.d_model * 2.0
        )
        groups.append(
            ("pp_boundary", 1.0, [
                CommCall("p2p", boundary * lin, 2),
                CommCall("p2p", boundary, 2, count=lout),
            ])
        )
    return groups


# ----------------------------------------------------------------------
# E2E evaluation
# ----------------------------------------------------------------------


def pp_bubble(
    pp: int,
    n_micro: Optional[int] = None,
    schedule: str = "gpipe",
    interleave: int = 2,
) -> float:
    """Pipeline bubble surcharge factor: executed schedule length over
    ideal per-device work, from the exact tick counts of
    ``dist.pipeline.schedule_ticks``.

    ``n_micro`` defaults to ``2 * pp`` microbatches, the production
    convention this repo schedules requests at. For GPipe that default
    reduces to ``1 + (pp - 1) / (2 * pp)`` — numerically identical to the
    earlier heuristic surcharge, so existing estimates are unchanged;
    the interleaved 1F1B schedule (``schedule="1f1b"``) divides the
    fill/drain cost by ``interleave`` and is strictly cheaper whenever
    ``pp > 1``; the zero-bubble ``"zb-h1"`` splits the backward into B/W
    ticks that fill the warmup bubble, so its surcharge is <= 1F1B's at
    every (pp, n_micro, interleave) (strictly smaller off the
    ``n_micro % pp == 1`` tie region — the ordering theorem in
    ``dist.pipeline``). Returns 1.0 when not pipelined."""
    if pp <= 1:
        return 1.0
    from repro_torch.dist.pipeline import _PHASES, schedule_ticks

    M = 2 * pp if n_micro is None else int(n_micro)
    ticks = schedule_ticks(pp, M, schedule, interleave)
    work = M * (interleave * _PHASES[schedule] if schedule != "gpipe" else 1)
    return ticks / work


# the reference's older private name; the GPipe default is numerically identical
_pp_bubble = pp_bubble


def _resolve_predictor(predictor, kernel_time, comm_time):
    if predictor is not None:
        if kernel_time is not None or comm_time is not None:
            raise TypeError("pass either predictor= or kernel_time/comm_time, not both")
        return predictor
    if kernel_time is None or comm_time is None:
        raise TypeError(
            "no predictor given: pass predictor=get_predictor(...) "
            "(or the legacy kernel_time=/comm_time= callables)"
        )
    return CallableTimesPredictor(kernel_time, comm_time)


def step_estimate(
    cfg: ArchConfig, B: int, qlen: int, kvlen: int, *, tp: int,
    predictor=None, kernel_time: Optional[Callable] = None,
    comm_time: Optional[Callable] = None, tuned: Optional[dict] = None,
) -> Estimate:
    """One serving step (all layers + head) as a full ``Estimate``.
    ``tuned`` (a ``TunedConfigs.for_hw(hw)`` table) prices the step with
    autotuned kernel block configs instead of the defaults."""
    pred = _resolve_predictor(predictor, kernel_time, comm_time)
    return pred.predict(model_calls(cfg, B, qlen, kvlen, tp, tuned))


def step_time(
    cfg: ArchConfig, B: int, qlen: int, kvlen: int, *, tp: int,
    predictor=None, kernel_time: Optional[Callable] = None,
    comm_time: Optional[Callable] = None,
) -> float:
    return step_estimate(
        cfg, B, qlen, kvlen, tp=tp, predictor=predictor,
        kernel_time=kernel_time, comm_time=comm_time,
    ).total_s


def request_estimate(
    cfg: ArchConfig, B: int, lin: int, lout: int, *, tp: int = 1, pp: int = 1,
    pp_schedule: str = "gpipe", pp_microbatches: Optional[int] = None,
    pp_interleave: int = 2, comm_overlap: bool = False,
    predictor=None, kernel_time: Optional[Callable] = None,
    comm_time: Optional[Callable] = None, tuned: Optional[dict] = None,
) -> Estimate:
    """prefill + Simpson-integrated decode as one batched prediction, with
    the schedule's analytical PP bubble surcharge (``pp_bubble``) applied
    to the whole estimate. ``pp_schedule``/``pp_microbatches``/
    ``pp_interleave`` pick the pipeline schedule (GPipe default; the
    interleaved 1F1B of ``dist.pipeline`` shrinks the bubble at the same
    microbatch count, and the zero-bubble ``"zb-h1"`` shrinks it further).
    ``comm_overlap=True`` prices collectives against the exposed-compute
    window (``Estimate.overlapped``) instead of additively — applied
    before the bubble surcharge, which stretches the whole per-step
    timeline. ``tuned`` applies autotuned kernel block configs
    (``repro_torch.tune.TunedConfigs.for_hw(hw)``)."""
    pred = _resolve_predictor(predictor, kernel_time, comm_time)
    est = pred.predict(request_calls(cfg, B, lin, lout, tp=tp, pp=pp,
                                     pp_schedule=pp_schedule,
                                     pp_interleave=pp_interleave,
                                     tuned=tuned))
    if comm_overlap:
        est = est.overlapped()
    if pp > 1:
        est = est.scaled(
            pp_bubble(pp, pp_microbatches, pp_schedule, pp_interleave)
        )
    return est


def request_sweep(
    cfg: ArchConfig, B: int, lin: int, lout: int, *, tp: int = 1, pp: int = 1,
    pp_schedule: str = "gpipe", pp_microbatches: Optional[int] = None,
    pp_interleave: int = 2, comm_overlap: bool = False,
    hws=None, sweep: Optional[SweepPredictor] = None, backend: str = "synperf",
    **backend_kw,
) -> SweepResult:
    """``request_estimate`` across many devices: the same request call
    sequence priced on every hardware in ``hws`` (default: the full
    registry) with one grouping pass and a shared task/feature cache.
    ``comm_overlap=True`` overlap-prices every device's estimate.

    Pass a prebuilt ``sweep=SweepPredictor(...)`` to amortize backend
    construction and cache warmth across requests; otherwise ``backend`` +
    ``**backend_kw`` construct one per call (e.g. ``estimator=pw``)."""
    check_prebuilt_exclusive("sweep", sweep, hws, backend, backend_kw)
    sp = sweep if sweep is not None else SweepPredictor(hws, backend, **backend_kw)
    res = sp.predict(request_calls(cfg, B, lin, lout, tp=tp, pp=pp,
                                   pp_schedule=pp_schedule,
                                   pp_interleave=pp_interleave))
    if comm_overlap:
        res = res.overlapped()
    if pp > 1:
        res = res.scaled(
            pp_bubble(pp, pp_microbatches, pp_schedule, pp_interleave)
        )
    return res


def place_request(
    cfg: ArchConfig, B: int, lin: int, lout: int, *, tp: int = 1, pp: int = 1,
    pp_schedule: str = "gpipe", pp_microbatches: Optional[int] = None,
    pp_interleave: int = 2, comm_overlap: bool = False,
    objective="latency", hws=None, backend: str = "synperf", router=None,
    **backend_kw,
):
    """Route one synthetic request across the hardware fleet: assemble the
    same call sequence as ``request_estimate`` (prefill + Simpson decode +
    PP boundary traffic, bubble surcharge included; ``comm_overlap=True``
    overlap-prices each candidate) and rank every fleet entry under
    ``objective`` (see ``repro_torch.predict.objective``).

    Returns a ``repro_torch.serve.placement.Placement``. Pass a prebuilt
    ``router=FleetRouter(...)`` to amortize backend construction and cache
    warmth across requests (``hws``/``backend``/kwargs then stay unset);
    ``n_tokens`` for per-token objectives is the generated-token count
    ``B * lout``."""
    from repro_torch.serve.placement import FleetRouter

    check_prebuilt_exclusive("router", router, hws, backend, backend_kw)
    rt = router if router is not None else FleetRouter(hws, backend, **backend_kw)
    calls = request_calls(cfg, B, lin, lout, tp=tp, pp=pp,
                          pp_schedule=pp_schedule, pp_interleave=pp_interleave)
    return rt.route(calls, objective=objective, n_tokens=B * lout,
                    scale=pp_bubble(pp, pp_microbatches, pp_schedule,
                                    pp_interleave),
                    overlap=comm_overlap)


def simulate_fleet(
    cfg: ArchConfig, B: int, lin: int, lout: int, *,
    rate_rps: float, n_requests: int,
    tp: int = 1, pp: int = 1,
    pp_schedule: str = "gpipe", pp_microbatches: Optional[int] = None,
    pp_interleave: int = 2,
    objective="latency", replicas=1, seed: int = 0, autoscale=None,
    drift=None, monitor=None,
    hws=None, backend: str = "synperf", router=None,
    **backend_kw,
):
    """Replay a Poisson stream of synthetic requests through the fleet
    with queueing delay: the single-class convenience over
    ``serve.fleet.FleetSimulator`` (mirrors ``place_request``, which this
    extends from isolated pricing to queue-aware p50/p95/p99 latency and
    utilization). ``drift=``/``monitor=`` pass through to
    ``FleetSimulator.replay`` — inject measured-vs-predicted drift and let
    a ``serve.monitor.ResidualMonitor`` re-route the fleet mid-replay
    (the report's ``reroutes`` log records each trip). Returns a
    ``serve.fleet.FleetReport``."""
    from repro_torch.serve.fleet import FleetSimulator, WorkloadClass

    wc = WorkloadClass(
        "request", cfg, B=B, lin=lin, lout=lout, tp=tp, pp=pp,
        pp_schedule=pp_schedule, pp_microbatches=pp_microbatches,
        pp_interleave=pp_interleave,
    )
    sim = FleetSimulator(
        wc, router=router, hws=hws, backend=backend, objective=objective,
        replicas=replicas, autoscale=autoscale, **backend_kw,
    )
    return sim.replay(rate_rps=rate_rps, n_requests=n_requests, seed=seed,
                      drift=drift, monitor=monitor)


def request_latency(
    cfg: ArchConfig, B: int, lin: int, lout: int, *, tp: int = 1, pp: int = 1,
    pp_schedule: str = "gpipe", pp_microbatches: Optional[int] = None,
    pp_interleave: int = 2,
    predictor=None, kernel_time: Optional[Callable] = None,
    comm_time: Optional[Callable] = None,
) -> float:
    return request_estimate(
        cfg, B, lin, lout, tp=tp, pp=pp, pp_schedule=pp_schedule,
        pp_microbatches=pp_microbatches, pp_interleave=pp_interleave,
        predictor=predictor, kernel_time=kernel_time, comm_time=comm_time,
    ).total_s


# ----------------------------------------------------------------------
# deprecated two-lambda constructors (use repro_torch.predict.get_predictor)
# ----------------------------------------------------------------------


def oracle_times(hw: TPUSpec):
    """Deprecated: use ``get_predictor("oracle", hw)``. Returns the legacy
    (kernel_time, comm_time) pair backed by hwsim — the 'measured' system."""
    return (
        lambda kind, X: hwsim.simulate(kind, X, hw),
        lambda op, b, n: hwsim.simulate_comm(op, b, n, hw),
    )


def predictor_times(pw, hw: TPUSpec, comm: CommRegressor):
    """Deprecated: use ``get_predictor("synperf", hw, estimator=pw,
    comm=comm)``. Returns the legacy (kernel_time, comm_time) pair."""
    return get_predictor("synperf", hw, estimator=pw, comm=comm).as_times()
