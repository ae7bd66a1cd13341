"""Loop-aware cost analysis over optimized (post-SPMD) HLO text.

XLA's built-in ``compiled.cost_analysis()`` counts a ``while`` body ONCE,
which undercounts scanned layer stacks by ~n_layers (validated in
tests/test_hlo_cost.py). This walker parses the optimized HLO module,
extracts ``known_trip_count`` from each while's backend_config, and
aggregates, weighted by execution count:

  * dot FLOPs           = 2 * numel(out) * prod(contracting dims)
  * vector (VPU) ops    = elementwise op output elements
  * transcendental ops  = exp/tanh/log/rsqrt/... output elements
  * HBM bytes           = operand+output bytes of top-level instructions
                          (fusion boundaries = the memory schedule; fused
                          interiors stay on-chip)
  * collective bytes    = per-kind operand bytes of all-gather / all-reduce /
                          reduce-scatter / all-to-all / collective-permute

All numbers are PER DEVICE (the module is already SPMD-partitioned).

Ported from ``repro.roofline.hlo_cost`` as it is (pure ``re`` and ``json``)
and held equal to it: the port reads the reference's HLO artifacts with it
(``roofline.reanalyze``). Its fusion regrouping below models the
reference's target, the TPU backend, not this port's card; the port's own
programs are counted by ``roofline.op_cost``.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Optional

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e5m2fnuz": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "s4": 1, "u4": 1, "pred": 1,
}

_ELEMENTWISE = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "negate",
    "abs", "and", "or", "xor", "not", "select", "clamp", "compare", "floor",
    "ceil", "round-nearest-afz", "round-nearest-even", "sign", "convert",
    "remainder", "shift-left", "shift-right-logical", "shift-right-arithmetic",
    "is-finite", "atan2",
}
_TRANSCENDENTAL = {
    "exponential", "exponential-minus-one", "tanh", "log", "log-plus-one",
    "rsqrt", "sqrt", "cbrt", "power", "sine", "cosine", "tan", "logistic",
    "erf", "expm1", "log1p",
}
_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
# top-level ops considered free of HBM traffic
_FREE = {
    "tuple", "get-tuple-element", "parameter", "constant", "bitcast",
    "while", "call", "conditional", "partition-id", "replica-id",
    "after-all", "iota", "rng-bit-generator", "custom-call",
    "opt-barrier", "domain",
}

# split on commas outside [], () and {} — operand annotations can carry
# explicit layouts (f32[2,512,32]{2,1,0}) whose inner commas must not split
_TUPLE_SPLIT = re.compile(r",\s*(?![^\[\({]*[\]\)}])")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_COMP_HEADER = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->\s*.*\{\s*$")
_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^()]*\))|(?:[a-z0-9]+\[[\d,]*\](?:\{[^}]*\})?)|(?:[a-z0-9]+\[\]))\s*"
    r"([a-z0-9\-]+)\((.*?)\)(.*)$"
)


def _type_numel_bytes(t: str) -> tuple[int, int]:
    """(numel, bytes) of a type string (tuples summed)."""
    numel = 0
    nbytes = 0
    for m in _SHAPE_RE.finditer(t):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        numel += n
        nbytes += n * _DTYPE_BYTES[dt]
    return numel, nbytes


def _shape_dims(t: str) -> list[int]:
    m = _SHAPE_RE.search(t)
    if not m:
        return []
    return [int(d) for d in m.group(2).split(",") if d]


@dataclasses.dataclass
class Instr:
    name: str
    type: str
    op: str
    operands: list
    attrs: str


@dataclasses.dataclass
class Computation:
    name: str
    params: dict  # name -> type
    instrs: list


def parse_module(text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Optional[Computation] = None
    entry_name = None
    for raw in text.splitlines():
        line = raw.rstrip()
        if cur is None:
            m = _COMP_HEADER.match(line.strip())
            if m:
                params = {}
                for part in _TUPLE_SPLIT.split(m.group(3)):
                    part = part.strip()
                    if ":" in part:
                        pname, ptype = part.split(":", 1)
                        params[pname.strip().lstrip("%")] = ptype.strip()
                cur = Computation(m.group(2), params, [])
                if m.group(1):
                    entry_name = m.group(2)
                continue
        else:
            if line.strip() == "}":
                comps[cur.name] = cur
                cur = None
                continue
            m = _INSTR.match(line)
            if m:
                name, typ, op, ops_str, attrs = m.groups()
                operands = [o.strip() for o in _TUPLE_SPLIT.split(ops_str)] if ops_str.strip() else []
                cur.instrs.append(Instr(name, typ, op, operands, attrs))
    if entry_name:
        comps["__entry__"] = comps[entry_name]
    return comps


def _operand_type(opnd: str, comp: Computation, symtab: dict) -> Optional[str]:
    """Resolve an operand's type: inline annotation, local def or param."""
    opnd = opnd.strip()
    m = re.match(r"^((?:\([^=]*?\))|(?:[a-z0-9]+\[[\d,]*\](?:\{[^}]*\})?))\s+%?([\w.\-]+)$", opnd)
    if m:
        return m.group(1)
    name = opnd.lstrip("%")
    if name in symtab:
        return symtab[name]
    if name in comp.params:
        return comp.params[name]
    return None


_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_TOAPPLY_RE = re.compile(r"to_apply=%?([\w.\-]+)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")


def _trip_count(instr: Instr, comps) -> int:
    m = _TRIP_RE.search(instr.attrs)
    if m:
        return int(m.group(1))
    # fallback: look for compare against a constant in the condition
    cm = _COND_RE.search(instr.attrs)
    if cm and cm.group(1) in comps:
        for i in comps[cm.group(1)].instrs:
            if i.op == "constant":
                d = re.search(r"constant\((\d+)\)", i.attrs or "")
        # give up
    return 1


@dataclasses.dataclass
class CostSummary:
    dot_flops: float = 0.0
    vector_ops: float = 0.0
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0
    collectives: dict = dataclasses.field(
        default_factory=lambda: {k: {"bytes": 0.0, "count": 0.0} for k in _COLLECTIVES}
    )
    n_while: int = 0
    unknown_ops: dict = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        return self.dot_flops + self.vector_ops

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())

    def as_dict(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "vector_ops": self.vector_ops,
            "flops": self.flops,
            "transcendentals": self.transcendentals,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": self.collectives,
            "n_while": self.n_while,
            "unknown_ops": dict(sorted(self.unknown_ops.items(), key=lambda kv: -kv[1])[:10]),
        }


def analyze_hlo(text: str) -> CostSummary:
    comps = parse_module(text)
    summary = CostSummary()
    if "__entry__" not in comps:
        return summary
    _walk(comps["__entry__"], 1.0, comps, summary, top_level=True, seen=set())
    return summary


# ----------------------------------------------------------------------
# HBM traffic model with TPU-style fusion grouping
# ----------------------------------------------------------------------
#
# The CPU backend emits much finer fusions than the TPU backend would, so
# "every top-level instruction's operands+outputs hit HBM" wildly overcounts
# traffic for the TPU target. We re-fuse conservatively: any producer whose
# op is fusible and whose value has exactly one consumer is merged into that
# consumer's group (XLA's producer-consumer fusion rule of thumb). Traffic is
# then the deduplicated group-boundary I/O, with slice-like ops counting
# their *output* size (a dynamic-slice reads a tile, not the whole buffer)
# and dynamic-update-slice counting 2x the update (in-place cache writes).

_ALIAS = {"get-tuple-element", "bitcast", "tuple", "reshape"}
_SLICE_LIKE = {"slice", "dynamic-slice", "gather"}
_FUSIBLE = (
    _ALIAS
    | _SLICE_LIKE
    | _ELEMENTWISE
    | _TRANSCENDENTAL
    | {"fusion", "broadcast", "reduce", "pad", "iota", "reduce-window", "map",
       "reverse", "concatenate"}
)
_SINKS = _FUSIBLE | {"dot"}
_ZERO_TRAFFIC = {
    "parameter", "constant", "while", "call", "conditional", "after-all",
    "partition-id", "replica-id", "tuple", "get-tuple-element", "bitcast",
    "opt-barrier", "domain", "add-dependency",
}


def _operand_names(instr: Instr) -> list:
    out = []
    for o in instr.operands:
        m = re.search(r"%?([\w.\-]+)\s*$", o.strip())
        if m:
            out.append(m.group(1))
    return out


def _fusion_read_sizes(instr: Instr, comps) -> dict[int, int]:
    """Effective read bytes per operand index of a fusion: when a fusion
    parameter is consumed ONLY by slice-like ops inside the fused
    computation (a fused dynamic-slice over, e.g., stacked scan residuals),
    the hardware reads the slice, not the whole buffer."""
    out: dict[int, int] = {}
    if comps is None:
        return out
    cm = _CALLS_RE.search(instr.attrs)
    if not cm or cm.group(1) not in comps:
        return out
    fused = comps[cm.group(1)]
    pnames = list(fused.params.keys())
    for idx, pname in enumerate(pnames):
        uses = [i for i in fused.instrs if pname in [n for n in _operand_names(i)]]
        if uses and all(u.op in _SLICE_LIKE for u in uses):
            out[idx] = sum(_type_numel_bytes(u.type)[1] for u in uses)
    return out


def computation_traffic(
    comp: Computation, comps: dict | None = None, _debug: list | None = None
) -> float:
    """Per-execution HBM bytes of one top-level computation.

    _debug: optional list collecting (group_bytes, root_op, root_name,
    n_members) tuples for introspection."""
    defs: dict[str, Instr] = {i.name: i for i in comp.instrs}
    symtab = {i.name: i.type for i in comp.instrs}
    symtab.update(comp.params)

    consumers: dict[str, list] = {}
    for i in comp.instrs:
        for on in _operand_names(i):
            consumers.setdefault(on, []).append(i.name)

    # union-find
    parent: dict[str, str] = {i.name: i.name for i in comp.instrs}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    root_name = comp.instrs[-1].name if comp.instrs else None
    for i in comp.instrs:
        if i.op not in _FUSIBLE:
            continue
        cons = consumers.get(i.name, [])
        ext_used = i.name == root_name
        if len(cons) == 1 and not ext_used:
            c = defs.get(cons[0])
            if c is not None and c.op in _SINKS:
                union(i.name, c.name)

    def nbytes(name):
        t = symtab.get(name)
        return _type_numel_bytes(t)[1] if t else 0

    groups: dict[str, list] = {}
    for i in comp.instrs:
        groups.setdefault(find(i.name), []).append(i)

    total = 0.0
    for gid, members in groups.items():
        gtotal = 0.0
        names = {m.name for m in members}
        if all(m.op in _ZERO_TRAFFIC for m in members):
            continue
        if len(members) == 1 and members[0].op == "dynamic-update-slice":
            ops = _operand_names(members[0])
            upd = nbytes(ops[1]) if len(ops) > 1 else 0
            total += 2.0 * upd
            continue
        seen_in = set()
        for m in members:
            # pure views (gte/bitcast/reshape/tuple) never touch HBM — real
            # consumers count the view-sized read themselves via symtab
            if m.op in _ZERO_TRAFFIC or m.op in _ALIAS:
                continue
            fusion_reads = _fusion_read_sizes(m, comps) if m.op == "fusion" else {}
            for oi, on in enumerate(_operand_names(m)):
                if on in names or on in seen_in:
                    continue
                seen_in.add(on)
                t = symtab.get(on)
                if t is None or t.lstrip().startswith("("):
                    # tuple-typed values are aliases (loop-carried state);
                    # real reads happen element-wise via gte consumers
                    continue
                b = _type_numel_bytes(t)[1]
                if m.op in _SLICE_LIKE or m.op in _ALIAS:
                    b = min(b, _type_numel_bytes(m.type)[1] or b)
                if oi in fusion_reads:
                    b = min(b, fusion_reads[oi])
                gtotal += b
        for m in members:
            if m.op in _ZERO_TRAFFIC:
                continue
            used_outside = m.name == root_name or any(
                c not in names for c in consumers.get(m.name, [])
            )
            if used_outside:
                if m.op == "dynamic-update-slice":
                    ops = _operand_names(m)
                    gtotal += 2.0 * (nbytes(ops[1]) if len(ops) > 1 else 0)
                else:
                    gtotal += _type_numel_bytes(m.type)[1]
        total += gtotal
        if _debug is not None:
            _debug.append((gtotal, members[-1].op, members[-1].name, len(members)))
    return total


_TRAFFIC_CACHE_KEY = "__traffic__"


def _walk(comp: Computation, weight: float, comps, s: CostSummary, *, top_level: bool, seen):
    if top_level:
        cache = getattr(s, "_traffic_cache", None)
        if cache is None:
            cache = {}
            s._traffic_cache = cache
        if comp.name not in cache:
            cache[comp.name] = computation_traffic(comp, comps)
        s.hbm_bytes += weight * cache[comp.name]
    symtab = {i.name: i.type for i in comp.instrs}
    for instr in comp.instrs:
        op = instr.op
        out_numel, out_bytes = _type_numel_bytes(instr.type)

        # ---- control flow ------------------------------------------------
        if op == "while":
            trips = _trip_count(instr, comps)
            s.n_while += 1
            body = _BODY_RE.search(instr.attrs)
            if body and body.group(1) in comps:
                _walk(comps[body.group(1)], weight * trips, comps, s, top_level=top_level, seen=seen)
            continue
        if op in ("call", "async-start"):
            cm = _TOAPPLY_RE.search(instr.attrs) or _CALLS_RE.search(instr.attrs)
            if cm and cm.group(1) in comps:
                _walk(comps[cm.group(1)], weight, comps, s, top_level=top_level, seen=seen)
            continue
        if op == "conditional":
            for branch in re.findall(r"(?:true_computation|false_computation|branch_computations=\{[^}]*\}|computation)=%?([\w.\-]+)", instr.attrs):
                if branch in comps:
                    _walk(comps[branch], weight, comps, s, top_level=top_level, seen=seen)
            continue

        # ---- collectives --------------------------------------------------
        matched_coll = None
        for k in _COLLECTIVES:
            if op == k or op.startswith(k + "-start"):
                matched_coll = k
                break
        if matched_coll and not op.endswith("-done"):
            b = 0
            for o in instr.operands:
                t = _operand_type(o, comp, symtab)
                if t:
                    b += _type_numel_bytes(t)[1]
            s.collectives[matched_coll]["bytes"] += weight * b
            s.collectives[matched_coll]["count"] += weight
            continue

        # ---- fusion: recurse for compute (bytes handled by the traffic
        # model at the computation level) ------------------------------------
        if op == "fusion":
            cm = _CALLS_RE.search(instr.attrs)
            if cm and cm.group(1) in comps:
                _walk(comps[cm.group(1)], weight, comps, s, top_level=False, seen=seen)
            continue

        # ---- dot ----------------------------------------------------------
        if op == "dot":
            lhs_t = _operand_type(instr.operands[0], comp, symtab) if instr.operands else None
            k = 1
            cm = _CONTRACT_RE.search(instr.attrs)
            if cm and lhs_t:
                dims = _shape_dims(lhs_t)
                for ci in cm.group(1).split(","):
                    if ci and int(ci) < len(dims):
                        k *= dims[int(ci)]
            s.dot_flops += weight * 2.0 * out_numel * k
            continue

        # ---- elementwise / transcendental ---------------------------------
        if op in _TRANSCENDENTAL:
            s.transcendentals += weight * out_numel
            s.vector_ops += weight * out_numel
        elif op in _ELEMENTWISE:
            s.vector_ops += weight * out_numel
        elif op in ("reduce", "reduce-window"):
            in_numel = 0
            for o in instr.operands[: max(1, len(instr.operands) // 2)]:
                t = _operand_type(o, comp, symtab)
                if t:
                    in_numel += _type_numel_bytes(t)[0]
            s.vector_ops += weight * in_numel
        elif op in _FREE or op.endswith("-done"):
            pass
        elif op in ("dynamic-slice", "dynamic-update-slice", "slice", "copy",
                    "transpose", "reshape", "broadcast", "concatenate", "pad",
                    "gather", "scatter", "reverse", "sort", "dynamic-reshape",
                    "cholesky", "triangular-solve", "rng", "map", "select-and-scatter"):
            pass  # data movement: bytes handled by computation_traffic
        else:
            s.unknown_ops[op] = s.unknown_ops.get(op, 0) + 1


if __name__ == "__main__":
    import sys

    text = open(sys.argv[1]).read()
    print(json.dumps(analyze_hlo(text).as_dict(), indent=2))
