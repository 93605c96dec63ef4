"""Production-mesh dry-run on the meta device (port of
``repro.launch.dryrun``, the part that needs no compiler).

For every (architecture x input-shape x mesh) cell, the arguments of the
cell's step are built as meta-device tensors (no storage) with their
partition specs, and the cell's record gives:

* the skip reason, ``n_params``, ``n_active_params``, ``tokens``, ``chips``;
* the step's policy, as JAX's: ``accum_steps`` and ``sp_axis`` (train), the
  arguments of JAX's ``sharding_ctx.set_policy`` call (recorded, not set),
  the param dtype (bf16 at >= 6e10
  params, train), the prefill/decode rules (``embed`` over 'data' above
  1e10 params) and the int8-cache decision (decode);
* per-device argument bytes: each leaf's bytes over the product of the
  mesh sizes of the axes its spec shards, by part (params, AdamW state and
  batch for train; params and batch for prefill; params, cache, tokens and
  pos for decode) and in total, and every leaf's partition spec
  (``layout``).

JAX's record also holds what only its compiler knows; these have no torch
counterpart here: ``memory_analysis``'s temp bytes, ``cost_analysis``'s
FLOPs and bytes, the collective bytes parsed from HLO text
(``parse_collective_bytes``), and the depth-0/depth-1 compiles of
``corrected_costs``.

Records land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm_1_6b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, ShapeCell, skip_reason, token_input_specs
from repro_torch.core.compat import PartitionSpec
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.models import build_model, sharding_ctx
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def accum_steps(cfg, cell) -> int:
    """Gradient-accumulation factor: 16 microbatches at >= 2.5e10 params, 8
    at >= 1.2e10, else 4; capped so each microbatch still fills the 16-way
    data-parallel axis."""
    n = cfg.n_params()
    want = 16 if n >= 2.5e10 else (8 if n >= 1.2e10 else 4)
    cap = max(1, cell.global_batch // 16)  # dp axis = 16
    a = min(want, cap)
    while a > 1 and cell.global_batch % a:
        a //= 2
    return max(1, a)


def sp_axis(cfg):
    """Sequence-parallel axis of train cells: only the >= 6e10-param models."""
    return "model" if cfg.n_params() >= 6e10 else None


def train_param_dtype(cfg) -> torch.dtype:
    """bf16 params (f32 AdamW moments) for the largest models."""
    return torch.bfloat16 if cfg.n_params() >= 6e10 else torch.float32


def serve_rules(cfg) -> dict:
    """Prefill/decode rules: models above 1e10 params shard ``embed`` over
    'data' too (bf16 params replicated over 'data' would not fit)."""
    return dict(shd.DECODE_RULES, embed="data" if cfg.n_params() > 1e10 else None)


def kv_quant(cfg, cell, n_chips: int) -> bool:
    """int8 decode cache when the bf16 one would take > 8 GiB a chip."""
    bf16_cache = (2 * 2 * cfg.n_layers * cell.global_batch * cell.seq_len
                  * cfg.n_kv * cfg.hd) if cfg.n_kv else 0
    return cfg.family in ("dense", "moe", "vlm") and bf16_cache / n_chips > 8 * 2 ** 30


def chips(mesh) -> int:
    """Devices the mesh spans."""
    return math.prod(int(n) for n in mesh.shape.values())


def step_args(model, cfg, cell: ShapeCell, mesh):
    """The abstract arguments of the cell's step (meta tensors), by part,
    and the parallel tree of their partition specs: JAX's ``build_step``
    arguments and ``in_shardings``."""
    if cell.kind == "train":
        pdtype = train_param_dtype(cfg)
        p_ps = shd.param_pspecs(model.specs(pdtype), mesh, shd.TRAIN_RULES)
        opt = AdamW().init(model.abstract_params())  # f32 m and v, int32 step
        batch = token_input_specs(cfg, cell, with_labels=True)
        args = {"params": model.abstract_params(pdtype),
                "opt_state": {"step": opt.step, "m": opt.m, "v": opt.v},
                "batch": batch}
        pspecs = {"params": p_ps,
                  "opt_state": {"step": PartitionSpec(), "m": p_ps, "v": p_ps},
                  "batch": shd.batch_pspec(mesh, batch)}
        return args, pspecs
    p_ps = shd.param_pspecs(model.specs(torch.bfloat16), mesh, serve_rules(cfg))
    params = model.abstract_params(torch.bfloat16)
    if cell.kind == "prefill":
        batch = token_input_specs(cfg, cell, with_labels=False)
        return ({"params": params, "batch": batch},
                {"params": p_ps, "batch": shd.batch_pspec(mesh, batch)})
    b = cell.global_batch
    cache = model.cache_specs(b, cell.seq_len, kv_quant=kv_quant(cfg, cell, chips(mesh)))
    tokens = torch.empty((b,), dtype=torch.int32, device="meta")
    args = {"params": params, "cache": cache, "tokens": tokens, "pos": torch.empty_like(tokens)}
    pspecs = {"params": p_ps, "cache": shd.cache_pspec(mesh, cache, cfg),
              "tokens": PartitionSpec(), "pos": PartitionSpec()}
    return args, pspecs


def shards(pspec, mesh) -> int:
    """How many ways a leaf is split: the product of its axes' sizes."""
    n = 1
    for entry in pspec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                n *= int(mesh.shape[ax])
    return n


def leaf_bytes(t: torch.Tensor, pspec, mesh) -> int:
    """Per-device bytes of one leaf under ``pspec``."""
    return math.prod(t.shape) * t.element_size() // shards(pspec, mesh)


def argument_bytes(args: dict, pspecs: dict, mesh) -> dict:
    """Per-device argument bytes by part, and their ``total``."""
    out = {}
    for part in args:
        leaves = tree_leaves(tree_map(lambda t, ps: leaf_bytes(t, ps, mesh),
                                      args[part], pspecs[part]))
        out[part] = sum(leaves)
    out["total"] = sum(out.values())
    return out


def layout(pspecs: dict) -> dict:
    """``{"params/blocks/attn/wq": [None, "data", ...], ...}``: the leaves'
    specs by path, as JSON lists."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], path + (k,))
        else:
            out["/".join(path)] = [list(e) if isinstance(e, tuple) else e for e in tree]
    walk(pspecs, ())
    return out


def cell_policy(cfg, cell, mesh) -> sharding_ctx.Policy:
    """The activation policy JAX's dry-run passes ``sharding_ctx.set_policy``
    for the cell. Returned, not set: nothing of the port reads it on the
    meta device, and the process's policy stays as it was."""
    dp = dp_axes(mesh)
    return sharding_ctx.Policy(dp=dp if len(dp) > 1 else dp[0], tp="model",
                               sp=sp_axis(cfg) if cell.kind == "train" else None)


def cell_record(arch: str, shape_name: str, multi_pod: bool, *, cfg=None, cell=None,
                save: bool = True, verbose: bool = True) -> dict:
    """The dry-run record of one cell. ``cfg``/``cell`` override the arch's
    config and the named shape cell (the launcher passes its own batch and
    sequence)."""
    cfg = cfg or get_config(arch)
    cell = cell or SHAPES[shape_name]
    mesh_name = "multipod" if multi_pod else "pod"
    cellname = f"{arch}__{shape_name}__{mesh_name}"
    reason = skip_reason(cfg, shape_name) if shape_name in SHAPES else None
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "n_params": None,
           "skip": reason}
    if reason:
        if verbose:
            print(f"[{cellname}] SKIP: {reason}")
        if save:
            _save(cellname, rec)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    model = build_model(cfg)
    rec["n_params"] = cfg.n_params()
    rec["n_active_params"] = cfg.n_active_params()
    rec["tokens"] = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    rec["chips"] = chips(mesh)
    rec["mesh_shape"] = mesh.shape
    pol = cell_policy(cfg, cell, mesh)
    rec["policy"] = {"dp": pol.dp, "tp": pol.tp, "sp": pol.sp}
    if cell.kind == "train":
        rec["accum_steps"] = accum_steps(cfg, cell)
        rec["param_dtype"] = str(train_param_dtype(cfg)).replace("torch.", "")
        rec["rules"] = dict(shd.TRAIN_RULES)
    else:
        rec["param_dtype"] = "bfloat16"
        rec["rules"] = serve_rules(cfg)
    if cell.kind == "decode":
        rec["kv_quant"] = kv_quant(cfg, cell, rec["chips"])
    args, pspecs = step_args(model, cfg, cell, mesh)
    rec["argument_bytes"] = argument_bytes(args, pspecs, mesh)
    rec["layout"] = layout(pspecs)
    if verbose:
        parts = ", ".join(f"{k} {v / 2**30:.3f}" for k, v in rec["argument_bytes"].items())
        extra = (f"accum {rec['accum_steps']}, " if "accum_steps" in rec else "") + (
            f"int8 cache {rec['kv_quant']}, " if "kv_quant" in rec else "")
        print(f"[{cellname}] {rec['n_params'] / 1e9:.2f} B params, {rec['chips']} chips, "
              f"{extra}sp {pol.sp} | per-device argument GiB: {parts}")
    if save:
        _save(cellname, rec)
    return rec


def _save(cellname, rec):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, cellname + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="")
    p.add_argument("--shape", default="", choices=[""] + list(SHAPES))
    p.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true")
    args = p.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    t0 = time.perf_counter()
    recs = [cell_record(a, s, mp) for a in archs for s in shapes for mp in meshes]
    skips = sum(1 for r in recs if r["skip"])
    print(f"\ndone. {len(recs)} cells, {skips} skipped, {time.perf_counter() - t0:.2f} s "
          f"(meta device; records in {os.path.normpath(RESULTS_DIR)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
