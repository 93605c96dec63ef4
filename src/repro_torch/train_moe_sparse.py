"""End-to-end MoE training with runtime dispatch selection (port of
``examples/train_moe_sparse.py``): a ~100M-param MoE (deepseek-moe-16b cut
to 4 layers, d_model 512, 16 experts top-4 + 1 shared, vocab 8192, f32)
trained for a few hundred steps.

The dispatch implementation ('dense' one-hot einsum, 'sort' scatter, 'coo'
through ``repro_torch.core.ops.spmm``) is picked by timing one loss forward
of each on the first batch — the paper's profiling auto-tuner applied to
the token->expert dispatch operator — then the model trains with the
winner.

Run:  PYTHONPATH=src python -m repro_torch.train_moe_sparse --steps 200
      (add ``--device cpu`` where there is no card)
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.train import TrainState, make_train_step, trainable
from repro_torch.models import build_model
from repro_torch.models.moe import DISPATCH
from repro_torch.optim.adamw import AdamW


def mini_config():
    """The example's ~100M-param fine-grained MoE (deepseek-moe family)."""
    return dataclasses.replace(
        get_config("deepseek_moe_16b"),
        n_layers=4, d_model=512, n_heads=8, n_kv=8, d_ff=352, vocab=8192,
        n_experts=16, top_k=4, n_shared_experts=1, dtype="float32")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tune_dispatch(model, params, batch, dev) -> dict:
    """Seconds of one loss forward (mean of 3 after one warm-up call) in each
    dispatch format, fastest first."""
    times = {}
    for name in DISPATCH:
        m = dataclasses.replace(model, cfg=dataclasses.replace(model.cfg, moe_dispatch=name))
        with torch.no_grad():
            m.loss(params, batch, q_chunk=64, kv_chunk=64)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(3):
                m.loss(params, batch, q_chunk=64, kv_chunk=64)
            _sync(dev)
        times[name] = (time.perf_counter() - t0) / 3
    times = dict(sorted(times.items(), key=lambda kv: kv[1]))
    for k, v in times.items():
        print(f"  dispatch {k:6s}: {v * 1e3:8.2f} ms/step")
    return times


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the model trains (default: the card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = mini_config()
    model = build_model(cfg)
    params = trainable(model.init(0, device=dev))
    print(f"model: {cfg.name}-mini, {model.n_params() / 1e6:.1f}M params, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, on {dev}")

    src = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
    print("auto-tuning dispatch format (paper technique on MoE dispatch):")
    times = tune_dispatch(model, params, to_device(src.batch_at(0), dev), dev)
    best = next(iter(times))
    print(f"  -> selected '{best}'")
    model = build_model(dataclasses.replace(cfg, moe_dispatch=best))

    opt = AdamW(lr=args.lr, total_steps=args.steps, warmup_steps=max(1, args.steps // 20))
    step_fn = make_train_step(model, opt, dev, q_chunk=64, kv_chunk=64)
    state = TrainState(params, opt.init(params))

    t0, first, lv = time.perf_counter(), None, None
    for step in range(args.steps):
        state, loss = step_fn(state, src.batch_at(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            lv = float(loss)
            first = first if first is not None else lv
            tps = args.batch * args.seq * (step + 1) / (time.perf_counter() - t0)
            print(f"step {step:4d} loss {lv:.4f} ({tps:,.0f} tok/s)")
    learning = lv < first - 0.5
    print(f"loss: {first:.3f} -> {lv:.3f} "
          f"({'LEARNING' if learning else 'check hyperparams'})")
    return {"dispatch": best, "times": times, "first": first, "last": lv,
            "learning": learning, "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
