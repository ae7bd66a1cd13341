"""Serving launcher of the port: batched requests through the ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \
      --device cpu --requests 8 --max-new 8

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    engine = ServeEngine(cfg, max_batch=args.max_batch, device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        L = max(4, args.prompt_len + int(rng.integers(-4, 5)))
        prompt = rng.integers(1, cfg.vocab_size, size=L).astype(np.int32)
        engine.submit(Request(rid=i, prompt=prompt, max_new=args.max_new,
                              temperature=args.temperature))
    t0 = time.perf_counter()
    results = []
    while engine.queue:
        results += engine.step_batch()
    wall = time.perf_counter() - t0
    total_new = sum(len(r.tokens) for r in results)
    for r in results[:4]:
        print(f"req {r.rid}: {r.tokens[:8]}... prefill={r.prefill_s*1e3:.1f}ms "
              f"decode={r.decode_s*1e3:.1f}ms")
    print(f"served {len(results)} requests / {total_new} tokens in {wall:.2f}s "
          f"({total_new/wall:.1f} tok/s) on {engine.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
