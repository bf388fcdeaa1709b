"""Time the port's LM steps from two checkouts in turns, on one card.

    python3 scripts/lm_steps_in_turns.py OTHER_DIR [--rounds 1]

OTHER_DIR is another checkout of the repo (for example the parent commit,
unpacked with `git archive` into an ignored directory); the turns run as
`paths_in_turns.py`'s (OTHER, THIS, THIS, OTHER a round). A turn draws
each model's weights from seed 0 at its registry config (bf16) and
times three host-bound steps: internlm2-1.8b's serve
step (batch 4 against a 128-position cache), its AdamW training step
(8 x 64 tokens, one microbatch) and qwen2-moe-a2.7b's serve step (4 x
128). Each step runs WARM times, then STEPS times, each timed by CUDA
events around the step (the median and the list are printed). It prints
the card's name and power limit first. Needs one CUDA card.
"""

from __future__ import annotations

import json

from paths_in_turns import in_turns, parse_args

STEPS_TIMED = [   # (arch, kind, batch, seq)
    ("internlm2-1.8b", "decode", 4, 128),
    ("internlm2-1.8b", "train", 8, 64),
    ("qwen2-moe-a2.7b", "decode", 4, 128),
]
WARM, STEPS = 3, 20


def _step(dev, arch, kind, b, s):
    """A callable running one step of `kind` on weights drawn from seed 0."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model as lm
    from repro_torch.serve.engine import make_serve_step
    from repro_torch.train import step as tstep
    cfg = ARCHS[arch]
    gen = torch.Generator(device=dev).manual_seed(0)
    model = lm.build_model(cfg, device=dev, generator=gen)
    if kind == "decode":
        caches = model.init_caches(batch=b, max_len=s)
        token = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        serve = make_serve_step(model)
        return lambda: serve(token, caches, s - 1, gen)
    opt = tstep.default_optimizer_for(cfg)
    state = tstep.make_train_state_init(model, opt)(gen)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                 .astype(np.int32)).to(dev)
             for k in ("tokens", "targets")}
    train = tstep.make_train_step(model, opt)
    return lambda: train(state, batch)


def turn() -> dict:
    """One turn, in the tree on sys.path: each step's times in ms."""
    import gc

    import torch
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    out = {}
    for arch, kind, b, s in STEPS_TIMED:
        run = _step(dev, arch, kind, b, s)
        for _ in range(WARM):
            run()
        torch.cuda.synchronize()
        times = []
        for _ in range(STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        out[f"{arch} {kind} {b}x{s}"] = {
            "median_ms": sorted(times)[len(times) // 2], "times": times}
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    args = parse_args(__doc__)
    if args.turn:
        print(json.dumps(turn()))
        return 0
    for r, name, res in in_turns(__file__, args.other, args.rounds):
        for tag, v in res.items():
            print(f"round {r} {name:5s} {tag:30s} median "
                  f"{v['median_ms']:.4f} ms (of "
                  f"{', '.join(f'{t:.3f}' for t in v['times'])})",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
