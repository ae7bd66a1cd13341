"""Training launcher (``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
      --steps 50 --batch 4 --seq 32 --ckpt-dir /tmp/ckpt [--device cpu]

Runs the full Trainer (data pipeline -> train step -> checkpoints ->
watchdog) on one device: the card unless ``--device cpu``; a machine
without CUDA raises rather than falling back. ``--mesh``/``--devices``
raise until the port executes sharding (ROADMAP A10 part 2)."""
import argparse
import logging
import sys


def parse_args(argv=None):
    from repro_torch.train.trainer import default_ckpt_dir

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
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
    ap.add_argument("--devices", type=int, default=0, help="host device override")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def build_trainer(args):
    """The Trainer that ``main`` runs for these arguments."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.mesh or args.devices:
        raise NotImplementedError(
            "--mesh/--devices need executed sharding (ROADMAP A10 part 2)"
        )
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
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
    return Trainer(cfg, data, tc, tcfg, device=args.device)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    step, _, losses = build_trainer(args).run()
    if losses:
        print(f"finished at step {step}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"finished at step {step}; no step left to run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
