#!/usr/bin/env python3
"""How far flash attention's plain version lands from float64 on this host's CPU.

    python3 tools/fa_f32_yardstick.py [--src DIR]

On the f32 case ``(1, 64, 64, 2, 2, 16, causal)`` of
``tests/test_torch_cuda.py::FA_CASES`` (the same seeded inputs), prints one
JSON line: the host's CPU model and flags that select a matmul path (AVX-512
bf16, AMX), torch's version, threads and float32 matmul settings, and the
largest absolute gap to the float64 function of

- the plain version (``ops.attention`` on CPU tensors) with the default
  threads, with one thread, and with oneDNN (mkldnn) turned off;
- its first product alone, the scores ``q k^T`` (``torch.einsum`` in f32);
- with a card, the kernel (``flash_attention_cuda``).

It runs no test and needs no card; run it in several fresh processes to see
whether the gap changes from one process to the next.
"""
import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    args = ap.parse_args()
    import numpy as np
    import torch

    sys.path.insert(0, args.src)
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, S, Skv, Hq, Hkv, D = 1, 64, 64, 2, 2, 16
    rng = np.random.default_rng(0)  # the test's draws, in its order
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))

    def exact(q, k, v):
        q, k, v = (t.double() for t in (q, k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / D ** 0.5
        mask = torch.ones(S, Skv, dtype=torch.bool).tril()
        p = torch.softmax(s.masked_fill(~mask, -1.0e30), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v), s

    want, scores = exact(q, k, v)

    def gap(t, ref=want):
        return float((t.double() - ref).abs().max())

    plain = lambda: fa_ops.attention(q, k, v, causal=True)
    flags = set()
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("flags"):
                flags = set(line.split(":", 1)[1].split())
                break
        model = next((ln.split(":", 1)[1].strip() for ln in open("/proc/cpuinfo")
                      if ln.startswith("model name")), "unknown")
    except OSError:
        model = "unknown"
    out = {
        "cpu": model,
        "cpu_flags": sorted(f for f in flags if f in ("avx512_bf16", "amx_bf16", "amx_tile",
                                                       "avx512f", "avx2")),
        "torch": torch.__version__,
        "threads": torch.get_num_threads(),
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "mkldnn_fp32_precision": getattr(getattr(torch.backends.mkldnn, "matmul", None),
                                         "fp32_precision", None),
        "plain_default": gap(plain()),
        "scores_einsum": gap(torch.einsum("bqhd,bkhd->bhqk", q, k) / D ** 0.5, scores),
    }
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out["plain_one_thread"] = gap(plain())
    torch.set_num_threads(threads)
    with torch.backends.mkldnn.flags(enabled=False):
        out["plain_without_mkldnn"] = gap(plain())
    if torch.cuda.is_available():
        from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

        dev = torch.device("cuda")
        got = flash_attention_cuda(q.to(dev), k.to(dev), v.to(dev), causal=True)
        out["kernel"] = gap(got.cpu())
        out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
