"""Training launcher on the port: config-driven, fault-tolerant,
checkpointed (twin of `repro/launch/train.py`).

Usage (the smoke config on the host; without --smoke the full assigned
config, e.g. internlm2-1.8b's 1.9B parameters in bf16 with AdamW, on the
card):

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt \\
      --device cpu

Runs on the card (`--device cuda`, the default) and fails without one.
The trainer resumes from whatever `--ckpt-dir` already holds (its default
lies under the temp directory), so a fresh run needs a fresh directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from repro_torch.launch.serve import _device_arg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject one failure at this step (recovery demo)")
    _device_arg(ap)
    return ap


def train_lm(args: argparse.Namespace) -> tuple:
    """The launcher's run: (config, TrainerReport, wall seconds)."""
    from repro_torch.configs.registry import ARCHS, SMOKES
    from repro_torch.data.tokens import SyntheticTokenDataset
    from repro_torch.hw import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime.trainer import FaultTolerantTrainer
    from repro_torch.train.step import (default_optimizer_for,
                                        make_train_state_init,
                                        make_train_step)

    cfg = (SMOKES if args.smoke else ARCHS)[args.arch]
    dev = resolve_device(args.device)
    model = build_model(
        cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    opt = adamw() if args.smoke else default_optimizer_for(cfg)
    schedule = warmup_cosine(peak=args.lr, warmup_steps=args.steps // 10 + 1,
                             total_steps=args.steps)
    step = make_train_step(model, opt, schedule=schedule,
                           n_microbatches=args.microbatches)
    ds = SyntheticTokenDataset(vocab=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch, seed=args.seed)
    trainer = FaultTolerantTrainer(
        train_step=step,
        init_state=make_train_state_init(model, opt),
        dataset=ds, ckpt_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every, device=dev)

    t0 = time.time()
    report = trainer.run(n_steps=args.steps, seed=args.seed,
                         fail_at_step=args.fail_at)
    return cfg, report, time.time() - t0


def main(argv=None) -> int:
    args = parser().parse_args(sys.argv[1:] if argv is None else argv)
    cfg, report, dt = train_lm(args)
    tok_s = report.steps_run * args.batch * args.seq / dt
    print(f"[train] arch={cfg.name} steps={report.final_step} "
          f"restarts={report.restarts} wall={dt:.1f}s tok/s={tok_s:.0f}")
    print(f"[train] loss: first={report.losses[0]:.4f} "
          f"last={report.losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
