"""Serving example (port of ``examples/serve_decode.py``): batched greedy
decoding of a smoke-scale model with ``DecodeEngine``, optionally from a
training checkpoint, reporting tokens/s. Works for every decoder family,
including the SSM family (constant-state cache) and hybrid zamba2.

``--ckpt DIR`` restores the ``params`` part of the latest
``TrainState(params, AdamWState(step, m, v))`` checkpoint in DIR, whether
this package's ``launch/train.py`` or the JAX package's wrote it.

Run:  PYTHONPATH=src python -m repro_torch.serve_decode --arch mamba2_2_7b
      (add ``--device cpu`` where there is no card)
"""
import argparse
import time

import numpy as np

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import DecodeEngine, serve
from repro_torch.launch.train import TrainState
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW


def restore_params(ckpt_dir: str, step: int, model, device):
    """The params of a ``TrainState`` checkpoint, on ``device``."""
    params0 = model.abstract_params()
    like = TrainState(params0, AdamW().init(params0))
    return ckpt_lib.restore(ckpt_dir, step, like, device).params


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="stablelm_1_6b")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--ckpt", default="", help="training checkpoint dir (optional)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the model runs (default: the card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only — no decode path")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    if args.ckpt:
        step = ckpt_lib.latest_step(args.ckpt)
        if step is not None:
            print(f"restoring params from step {step}")
            params = restore_params(args.ckpt, step, model, dev)

    print(f"serving {cfg.name} (smoke config, family={cfg.family}) "
          f"with {args.slots} slots on {dev}")
    engine = DecodeEngine(model, params, args.slots, args.max_len, device=dev)

    rng = np.random.default_rng(0)
    requests = [(i, rng.integers(0, cfg.vocab, (args.prompt_len,)).astype(np.int32))
                for i in range(args.requests)]
    t0 = time.perf_counter()
    done, _ = serve(engine, requests, args.max_new)
    dt = time.perf_counter() - t0
    ntok = sum(len(o) for _, o in done)
    mode = "batched" if model.supports_prefill_cache() else "by-decode"
    print(f"served {len(done)} requests / {ntok} tokens in {dt:.2f}s "
          f"({ntok / dt:.1f} tok/s, {engine.prefill_calls} {mode} prefills)")
    for rid, out in sorted(done)[:3]:
        print(f"  req {rid:2d}: {out[:12]}{'...' if len(out) > 12 else ''}")
    return {"done": sorted(done), "params": params}


if __name__ == "__main__":
    main()
