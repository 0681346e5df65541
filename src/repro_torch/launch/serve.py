"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the engine (reduced config, on the card unless ``--device cpu``) over a
synthetic request stream with shared prefixes and reports the paper-policy
cache metrics: request/token hit ratios and prefill compute saved. The
port's counterpart of the reference's ``repro/launch/serve.py``."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.cms_sketch import resolve_device
from repro_torch.models import LM
from repro_torch.serving import Engine, EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--policy", default="wtlfu-av")
    ap.add_argument("--cache-mb", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).scaled_down()
    model = LM(cfg, dtype=torch.float32, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    eng = Engine(model, params, EngineConfig(
        max_seq=96, cache_capacity_bytes=args.cache_mb << 20,
        cache_policy=args.policy, block_size=8))

    rng = np.random.default_rng(args.seed)
    templates = [
        [int(t) for t in rng.integers(0, cfg.vocab_size, int(n))]
        for n in rng.integers(16, 48, 6)
    ]
    pmf = np.arange(1, 7.0) ** -1.2
    pmf /= pmf.sum()
    prompts = []
    for i in range(args.requests):
        t = templates[int(rng.choice(6, p=pmf))]
        prompts.append(t + [int(x) for x in rng.integers(0, cfg.vocab_size, 4)])

    out = eng.serve(prompts, max_new_tokens=args.max_new_tokens)
    print(f"served {len(out)} requests with policy={args.policy} on {device}")
    for k, v in eng.stats().items():
        print(f"  {k}: {v}")
    return eng


if __name__ == "__main__":
    main()
