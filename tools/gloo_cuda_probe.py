"""Whether gloo takes CUDA tensors for the collectives of the mesh path:
two gloo ranks share card 0 and run, each in a group of its own,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``,
``all_to_all_single`` and a ``batch_isend_irecv`` ring (the pipeline's).
Each prints ``ok`` with its check, or the error that the ranks raised, or
that they did not finish in ``--timeout`` seconds (the ranks are then
killed).

  python3 tools/gloo_cuda_probe.py [--timeout 60]
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def _collective(rank, name):
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    if name == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        want = torch.cat([torch.arange(4.0), torch.arange(4.0) + 10])
    elif name == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        want = (2 * torch.arange(4.0) + 10)[2 * rank:2 * rank + 2]
    elif name == "all_reduce":
        out = x.clone()
        dist.all_reduce(out)
        want = 2 * torch.arange(4.0) + 10
    elif name == "all_to_all_single":
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, x)
        want = torch.tensor([0.0, 1.0, 10.0, 11.0]) + 2 * rank
    else:  # the pipeline's ring step
        out = torch.empty(4, device=dev)
        peer = 1 - rank
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                         dist.P2POp(dist.irecv, out, peer)]):
            w.wait()
        want = torch.arange(4.0) + 10 * peer
    torch.cuda.synchronize()
    return bool(torch.equal(out.cpu(), want))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.launch.mesh import spawn

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: this needs a CUDA card", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}", flush=True)
    for name in ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
                 "all_to_all_single", "batch_isend_irecv"):
        with tempfile.TemporaryDirectory() as tmp:
            try:
                got = spawn(_collective, 2, (name,), store_path=os.path.join(tmp, "store"),
                            backend="gloo", timeout=args.timeout)
                print(f"{name}: ok, values {'right' if all(got) else 'WRONG'} on both ranks",
                      flush=True)
            except (RuntimeError, TimeoutError) as e:  # the finding this probe reports
                lines = [ln for ln in str(e).splitlines() if ln.strip()]
                print(f"{name}: refused: {lines[0]} | {lines[-1][:300]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
