"""Training launcher (``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
      --steps 50 --batch 4 --seq 32 --ckpt-dir /tmp/ckpt [--device cpu]

Runs the full Trainer (data pipeline -> train step -> checkpoints ->
watchdog) on the card unless ``--device cpu``; a machine without CUDA
raises rather than falling back. ``--mesh RxC`` trains on a (data, model)
mesh of ``R*C`` ranks, spawned as gloo processes with ``--device cpu`` and
as NCCL processes one a GPU on the card; more ranks than GPUs is refused.
``--devices`` is kept for the reference's command line: the mesh sets the
rank count, and ``--devices``, when given, must equal it. ``--layers N``
cuts the depth at full width, for an arch whose train state does not fit
one card at full depth:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --layers 10 \
      --steps 5 --batch 1 --seq 4096

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
      --mesh 2x2 --devices 4 --device cpu"""
import argparse
import dataclasses
import logging
import os
import sys
import tempfile


def parse_args(argv=None):
    from repro_torch.train.trainer import default_ckpt_dir

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, at full width (0: the config's)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--async-save", action="store_true")
    ap.add_argument("--mesh", default="", help="e.g. '2x2' => (data,model) mesh")
    ap.add_argument("--devices", type=int, default=0,
                    help="the reference's flag, kept: must equal the --mesh's R*C")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def mesh_shape(args) -> tuple:
    """``--mesh RxC`` as ``(R, C)``; ``()`` without a mesh."""
    if not args.mesh:
        if args.devices:
            raise ValueError("--devices spawns the ranks of a --mesh; pass --mesh too")
        return ()
    r, c = (int(x) for x in args.mesh.split("x"))
    if args.devices and args.devices != r * c:
        raise ValueError(f"--mesh {args.mesh} has {r * c} ranks, --devices says {args.devices}")
    return (r, c)


def arch_config(args):
    """The arch's config these arguments train: ``--smoke``'s reduced one,
    and ``--layers``' depth."""
    from repro_torch.configs import get_arch

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    return dataclasses.replace(cfg, n_layers=args.layers) if args.layers else cfg


def build_trainer(args, mesh=None):
    """The Trainer that ``main`` runs for these arguments (on ``mesh``, a
    ``DeviceMesh`` this rank belongs to, when given)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = arch_config(args)
    data = DataConfig(batch=args.batch, seq_len=args.seq)
    tc = TrainConfig(
        lr=args.lr,
        total_steps=args.steps,
        warmup=max(args.steps // 10, 1),
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
    )
    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        async_save=args.async_save,
    )
    return Trainer(cfg, data, tc, tcfg, mesh=mesh, device=args.device)


def _rank(rank: int, args):
    """One rank of a ``--mesh`` run: its mesh, its Trainer, its result."""
    from repro_torch.launch.mesh import make_mesh

    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format=f"%(asctime)s rank{rank} %(name)s %(message)s")
    device = args.device if args.device == "cpu" else f"cuda:{rank}"
    args = argparse.Namespace(**{**vars(args), "device": device})
    mesh = make_mesh(mesh_shape(args), ("data", "model"), device_type=device.split(":")[0])
    step, _, losses = build_trainer(args, mesh).run()
    return step, losses


def run(args) -> tuple:
    """``(final step, losses)`` of the run these arguments ask for."""
    shape = mesh_shape(args)
    if not shape:
        step, _, losses = build_trainer(args).run()
        return step, losses
    from repro_torch.launch.mesh import spawn

    n = shape[0] * shape[1]
    backend = "gloo" if args.device == "cpu" else "nccl"
    with tempfile.TemporaryDirectory() as tmp:
        return spawn(_rank, n, (args,), store_path=os.path.join(tmp, "rendezvous"),
                     backend=backend, timeout=24 * 3600)[0]


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    step, losses = run(args)
    if losses:
        print(f"finished at step {step}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"finished at step {step}; no step left to run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
