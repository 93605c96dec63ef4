"""Training driver (port of ``repro.launch.train``): train step, loop with
atomic checkpoints, auto-resume.

Usage (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_1_6b \\
      --smoke --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

Without ``--device`` it trains on the card, and raises where there is none.
A step is ``loss = model.loss(...)``, ``loss.backward()``,
``optimizer.update(...)`` (params updated in place). Checkpoints every
``--ckpt-every`` steps use the JAX package's layout, so either package
resumes the other's; ``--resume`` restores the latest valid step, and the
data pipeline is stateless-seekable, so step k always sees batch k.

``--mesh local`` trains on one device under a ``(1, 1)`` ``("data",
"model")`` mesh descriptor: each step runs under the activation policy
JAX's launcher sets, and the caller's policy is restored after it.
``--mesh production`` (or ``--multi-pod``) prints the dry-run's
per-device layout and argument bytes for the arch at the run's batch and
sequence (:mod:`repro_torch.launch.dryrun`), then raises ``ValueError``:
that mesh needs 256 (512) ranks, and one process of the port drives one
device.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.data.pipeline import make_source, to_device
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import dp_axes, make_mesh, tp_axis
from repro_torch.models import build_model, sharding_ctx
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def make_train_step(model, optimizer, device, *, q_chunk=512, kv_chunk=1024):
    """The train step: ``step_fn(state, batch) -> (state, loss)``. ``batch``
    is a dict of host arrays or tensors, put on ``device``; the params in
    ``state`` must require grad, and the loss reaches every one of them.
    Gradients are taken with ``backward`` into ``.grad``, handed to the
    optimizer and cleared."""
    dev = resolve_device(device)

    def step_fn(state: TrainState, batch):
        params = state.params
        loss = model.loss(params, to_device(batch, dev), q_chunk=q_chunk, kv_chunk=kv_chunk)
        loss.backward()
        params, opt = optimizer.update(tree_map(lambda p: p.grad, params), state.opt, params)
        for p in tree_leaves(params):
            p.grad = None
        return TrainState(params, opt), loss.detach()

    return step_fn


def trainable(params) -> dict:
    """``params`` as leaf tensors that require grad (in place)."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def production_layout(args, cfg) -> None:
    """``--mesh production``: print the dry-run's per-device layout and
    argument bytes of this run's train step on the production mesh, then
    raise ``ValueError`` naming the ranks that mesh needs."""
    cell = ShapeCell(f"train_b{args.batch}_s{args.seq}", args.seq, args.batch, "train")
    rec = dryrun.cell_record(args.arch, cell.name, args.multi_pod, cfg=cfg, cell=cell,
                             save=False)
    print(f"[layout] mesh {rec['mesh_shape']}; params and AdamW m, v share a spec")
    for path, spec in rec["layout"].items():
        if not path.startswith("opt_state/"):
            print(f"  {path}: {spec}")
    print("[bytes a device] " + ", ".join(f"{k} {v:,}" for k, v in rec["argument_bytes"].items()))
    raise ValueError(
        f"--mesh production{' --multi-pod' if args.multi_pod else ''} needs {rec['chips']} "
        f"ranks, one a device of the {rec['mesh_shape']} mesh; this process has 1 (the port "
        "drives one device a process). Use --mesh local.")


def train_loop(args) -> dict:
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.mesh == "production" or args.multi_pod:  # --multi-pod names the 2x16x16 mesh
        production_layout(args, cfg)
    dev = resolve_device(args.device)
    model = build_model(cfg)
    mesh = make_mesh((1, 1), ("data", "model"))  # one device
    dp = dp_axes(mesh)  # the activation policy of JAX's make_train_step
    policy = sharding_ctx.Policy(dp=dp if len(dp) > 1 else dp[0], tp=tp_axis(mesh))

    optimizer = AdamW(lr=args.lr, total_steps=args.steps,
                      warmup_steps=min(100, max(1, args.steps // 10)))
    step_fn = make_train_step(model, optimizer, dev, q_chunk=min(args.seq, 512),
                              kv_chunk=min(args.seq, 1024))

    # --- init or resume ------------------------------------------------------
    start_step = 0
    state = None
    if args.resume and args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            print(f"[resume] restoring step {latest} onto {dev}")
            params0 = model.abstract_params()
            state = ckpt_lib.restore(args.ckpt_dir, latest,
                                     TrainState(params0, optimizer.init(params0)), dev)
            state = TrainState(trainable(state.params), state.opt)
            start_step = latest
    if state is None:
        params = trainable(model.init(args.seed, device=dev))
        state = TrainState(params, optimizer.init(params))

    source = make_source(cfg, args.seq, args.batch, seed=args.seed, path=args.data or None)

    # --- loop ----------------------------------------------------------------
    losses = []
    t_start = time.perf_counter()
    for step in range(start_step, args.steps):
        with sharding_ctx.policy(policy.dp, policy.tp, policy.sp):  # restored after
            state, loss = step_fn(state, source.batch_at(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            lv = float(loss)
            losses.append((step, lv))
            tok_s = args.batch * args.seq * (step - start_step + 1) / (
                time.perf_counter() - t_start)
            print(f"step {step:5d} loss {lv:.4f} ({tok_s:,.0f} tok/s)")
        if args.ckpt_dir and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            path = ckpt_lib.save(args.ckpt_dir, step + 1, state)
            ckpt_lib.cleanup(args.ckpt_dir, keep=3)
            print(f"[ckpt] step {step + 1} -> {path}")
    return {"losses": losses, "final_loss": losses[-1][1] if losses else None,
            "state": state}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", default="", help="token file (memmap); synthetic if empty")
    p.add_argument("--mesh", default="local", choices=["local", "production"])
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the model trains (default: the card)")
    return p


def main(argv=None) -> dict:
    out = train_loop(parser().parse_args(argv))
    print("final loss:", out["final_loss"])
    return out


if __name__ == "__main__":
    main()
