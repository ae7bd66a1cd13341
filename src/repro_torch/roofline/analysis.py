"""Three-term roofline analysis over the dry-run artifacts
(``repro.roofline.analysis``).

Per (arch x shape x mesh) cell, from the JSONs that ``launch.dryrun``
writes (per-device numbers from the op counter):

    compute term    = FLOPs_per_device / peak FLOP/s of one device
    memory term     = HBM_bytes_per_device / device-memory bytes/s
    collective term = collective_bytes_per_device / link bytes/s

(per-device numbers over one device's peaks is the same as the
global/(devices*peak) formulation). The peaks are a :class:`Peaks`; the
default is one H100 SXM's (:data:`H100_SXM`). ``PEAKS`` and
:func:`card_peaks` hold the published peaks of the cards the port runs on,
by the name ``torch.cuda.get_device_name`` gives.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

from repro_torch.configs import SHAPES, get_arch


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One device's roofs: dense bf16 FLOP/s, device-memory bytes/s, and
    the bytes/s of its interconnect in each direction (``link`` names it
    in reports)."""

    flops: float
    hbm_bw: float
    link_bw: float
    link: str = "NVLink"


# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s bf16 dense (no sparsity) and
# 3.35 TB/s of HBM3; NVLink 4 carries 900 GB/s a GPU, 450 GB/s each way
H100_SXM = Peaks(flops=989e12, hbm_bw=3.35e12, link_bw=450e9)

# published dense peaks by card name: device memory bytes/s; bf16
# tensor-core FLOP/s; f32 FLOP/s outside the tensor cores; int8 tensor-core
# ops/s; TF32 tensor-core FLOP/s
PEAKS = [
    ("H100 NVL", 3.9e12, 835e12, 60e12, 1670e12, 418e12),
    ("H100 PCIe", 2.0e12, 756e12, 51e12, 1513e12, 378e12),
    ("H100", 3.35e12, 989e12, 67e12, 1979e12, 495e12),  # SXM, "H100 80GB HBM3"
    ("H200", 4.8e12, 989e12, 67e12, 1979e12, 495e12),
]


def card_peaks(name: str) -> dict:
    """The published peaks of the card named ``name`` (the first entry of
    ``PEAKS`` its name contains): ``{"bytes", "bfloat16", "float32",
    "int8", "tf32"}``, per second."""
    for key, bw, bf16, f32, int8, tf32 in PEAKS:
        if key in name:
            return {"bytes": bw, "bfloat16": bf16, "float32": f32, "int8": int8, "tf32": tf32}
    raise RuntimeError(f"no published peaks known for {name!r}")


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_dev: float
    hlo_flops_dev: float
    hbm_bytes_dev: float
    coll_bytes_dev: float

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops_dev / max(self.hlo_flops_dev, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """compute_term / bound: what fraction of the step's lower-bound time
        is spent at the compute roof (1.0 = perfectly compute-bound)."""
        return self.compute_s / max(self.bound_s, 1e-30)

    def advice(self) -> str:
        if self.dominant == "memory":
            return (
                "memory-bound: cut device-memory traffic (fuse: keep attention "
                "scores & SSD intra-chunk tensors in shared memory and registers "
                "via the hand-written kernels; fewer materialized intermediates)"
            )
        if self.dominant == "collective":
            return (
                "collective-bound: reshard to reduce all-gather/reduce volume "
                "(fsdp gather granularity, TP axis choice) or overlap with "
                "compute"
            )
        if self.useful_ratio < 0.45:
            return (
                "compute-bound but low useful ratio: reduce recompute (remat "
                "policy) and masked-out causal work (block-sparse schedule)"
            )
        return "compute-bound: near the tensor-core roof; remaining headroom is remat policy"


def model_flops_per_device(arch: str, shape_name: str, n_devices: int) -> float:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    N = cfg.active_params()
    if shape.kind == "train":
        total = 6.0 * N * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * N * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * N * shape.global_batch
    return total / n_devices


def load_rows(dryrun_dir: str = "results/dryrun_torch",
              peaks: Peaks = H100_SXM) -> list[RooflineRow]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        n = d["n_devices"]
        rows.append(
            RooflineRow(
                arch=d["arch"],
                shape=d["shape"],
                mesh=d["mesh"],
                n_devices=n,
                compute_s=d["flops"] / peaks.flops,
                memory_s=d["hbm_bytes"] / peaks.hbm_bw,
                collective_s=d["collectives"]["_total_bytes"] / peaks.link_bw,
                model_flops_dev=model_flops_per_device(d["arch"], d["shape"], n),
                hlo_flops_dev=d["flops"],
                hbm_bytes_dev=d["hbm_bytes"],
                coll_bytes_dev=d["collectives"]["_total_bytes"],
            )
        )
    return rows


def markdown_table(rows: list[RooflineRow]) -> str:
    hdr = (
        "| arch | shape | mesh | compute (s) | memory (s) | collective (s) | "
        "dominant | MODEL/HLO flops | roofline frac | what would move it |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3e} | "
            f"{r.memory_s:.3e} | {r.collective_s:.3e} | **{r.dominant}** | "
            f"{r.useful_ratio:.2f} | {r.roofline_fraction:.2f} | {r.advice()} |"
        )
    return hdr + "\n".join(lines)


def pick_hillclimb_cells(rows: list[RooflineRow]) -> dict:
    """worst roofline fraction, most collective-bound, most representative of
    the paper's technique (the biggest fused-MoE training cell). Trivial
    cells (bound < 10 ms, launch-overhead territory) are excluded from the
    'worst fraction' pick."""
    single = [r for r in rows if r.mesh == "16x16"]
    heavy = [r for r in single if r.bound_s >= 0.01] or single
    worst = min(heavy, key=lambda r: r.roofline_fraction)
    coll = max(single, key=lambda r: r.collective_s / max(r.bound_s, 1e-30))
    moe = [r for r in single if get_arch(r.arch).n_experts and r.shape == "train_4k"]
    rep = max(moe, key=lambda r: r.hlo_flops_dev) if moe else single[0]
    return {"worst_fraction": worst, "most_collective": coll, "paper_representative": rep}
