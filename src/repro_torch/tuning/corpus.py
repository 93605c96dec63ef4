"""Synthetic training corpus and trainer for the format-selection tree
(port of ``repro.tuning.corpus``).

The families span the pattern regimes of the paper's evaluation (stencil
and banded regular matrices, uniform random, power-law row lengths, block
structure). Labels come from ``profile_select`` on the device the matrices
live on: the winning format varies per device, so a trained tree belongs to
the card it was labelled on, and ``python -m repro_torch.tuning.corpus``
retrains it there.

    python -m repro_torch.tuning.corpus --samples 240 --holdout 0.25
    python -m repro_torch.tuning.corpus --samples 12 --iters 3 --out /tmp/tree.json

writes the tree (by default over the port's ``default_tree.json``) and
prints train/holdout agreement with the profiling oracle.

The matrices are drawn from one numpy stream, family by family, as the JAX
package draws them: from the same seed every family but ``random`` gives
the JAX package's matrices entry for entry, and ``random`` (whose seed is
one ``rng.integers`` draw, as in JAX) gives them too for the JAX package's
int-seeded ``random_coo``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hpcg
from repro_torch.core.formats import COO, Format, banded_coo, coo_from_arrays, random_coo
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tuning.engines import predicted_bytes, profile_select
from repro_torch.tuning.features import PatternFeatures
from repro_torch.tuning.tree import DEFAULT_TREE_PATH, DecisionTree, load_default_tree

FAMILIES = ("stencil27", "stencil7", "banded", "random", "powerlaw", "block")

DEFAULT_CANDIDATES = (Format.COO, Format.CSR, Format.DIA, Format.ELL, Format.SELL)


def make_matrix(family: str, rng: np.random.Generator, device: DeviceLike = None) -> COO:
    """One random matrix of ``family`` from ``rng``, built on the host and
    placed on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    if family == "stencil27":
        dims = rng.integers(6, 13, size=3)
        prob = hpcg.generate_problem(*map(int, dims))
        return hpcg.to_coo(prob, device=dev)
    if family == "stencil7":
        nx, ny, nz = map(int, rng.integers(6, 14, size=3))
        n = nx * ny * nz
        offs = sorted({-nx * ny, -nx, -1, 0, 1, nx, nx * ny})
        return banded_coo((n, n), offs, device=dev)
    if family == "banded":
        n = int(rng.integers(256, 4097))
        ndiag = int(rng.integers(3, 28))
        band = max(1, int(rng.integers(1, max(2, n // 8))))
        offs = rng.choice(np.arange(-band, band + 1), size=min(ndiag, 2 * band + 1),
                          replace=False)
        offs = np.unique(np.append(offs, 0))
        return banded_coo((n, n), [int(o) for o in offs], device=dev)
    if family == "random":
        n = int(rng.integers(128, 1025))
        density = float(10 ** rng.uniform(-3, -0.9))
        return random_coo(int(rng.integers(0, 2 ** 31 - 1)), (n, n), density=density,
                          device=dev)
    if family == "powerlaw":
        n = int(rng.integers(256, 2049))
        shape = float(rng.uniform(1.05, 2.0))
        scale = float(rng.uniform(1.0, 6.0))
        rows, cols = [], []
        for i in range(n):
            k = int(min(n, 1 + rng.pareto(shape) * scale))
            c = rng.choice(n, size=k, replace=False)
            rows.append(np.full(k, i, np.int64))
            cols.append(np.sort(c).astype(np.int64))
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        v = rng.standard_normal(len(r)).astype(np.float32)
        v = np.where(np.abs(v) < 1e-3, 1e-3, v)
        return coo_from_arrays(r, c, v, (n, n), device=dev)
    if family == "block":
        bs = int(rng.choice([8, 16, 32]))
        nb = int(rng.integers(8, 33))
        n = bs * nb
        occ = max(nb, int(rng.uniform(0.02, 0.15) * nb * nb))
        blk = rng.choice(nb * nb, size=min(occ, nb * nb), replace=False)
        br, bc = blk // nb, blk % nb
        ii, jj = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
        r = (br[:, None, None] * bs + ii[None]).ravel()
        c = (bc[:, None, None] * bs + jj[None]).ravel()
        v = rng.standard_normal(len(r)).astype(np.float32)
        v = np.where(np.abs(v) < 1e-3, 1e-3, v)
        order = np.lexsort((c, r))
        return coo_from_arrays(r[order], c[order], v[order], (n, n), device=dev)
    raise ValueError(f"unknown corpus family {family!r}")


def generate_corpus(n_samples: int, seed: int = 0,
                    families: Sequence[str] = FAMILIES,
                    device: DeviceLike = None) -> Tuple[List[COO], List[str]]:
    """``n_samples`` matrices cycling through ``families``."""
    rng = np.random.default_rng(seed)
    mats, fams = [], []
    for i in range(n_samples):
        fam = families[i % len(families)]
        mats.append(make_matrix(fam, rng, device=device))
        fams.append(fam)
    return mats, fams


def label_matrix(A: COO, candidates: Sequence[Format] = DEFAULT_CANDIDATES,
                 iters: int = 6, inner: int = 8, tie_tol: float = 1.5) -> Format:
    """The profiling oracle's label for one matrix, with deterministic ties.

    Every candidate is timed on the device of ``A`` (``profile_select``,
    ``inner``-amortized). When several measure within ``tie_tol``
    (relative) of the winner, the label is the analytic byte model's
    cheapest among them: labels that flip between near ties bound what a
    trained tree can agree with. ``tie_tol=1.5`` trades speed for
    footprint (a format up to 2.5x slower but smaller may win the label),
    as in the JAX package; shrink it on a quiet host.
    """
    x = torch.ones((A.shape[1],), dtype=A.dtype, device=A.device)
    rep = profile_select(A, x, candidates=candidates, iters=iters, inner=inner)
    best_t = rep.times[rep.best]
    near = [f for f, t in rep.times.items() if t <= best_t * (1 + tie_tol)]
    if len(near) <= 1:
        return rep.best
    stats = PatternFeatures.from_coo(A).to_stats()
    return min(near, key=lambda f: predicted_bytes(stats, f))


def label_corpus(mats: Sequence[COO], candidates: Sequence[Format] = DEFAULT_CANDIDATES,
                 iters: int = 6, inner: int = 8, tie_tol: float = 1.5) -> np.ndarray:
    """:func:`label_matrix` over a corpus -> ``Format`` int values."""
    return np.asarray([int(label_matrix(A, candidates, iters, inner, tie_tol))
                       for A in mats], np.int64)


def build_dataset(mats: Sequence[COO]) -> np.ndarray:
    """Feature matrix (n_samples, len(FEATURE_NAMES))."""
    return np.stack([PatternFeatures.from_coo(A).vector() for A in mats])


def train_tree(X: np.ndarray, y: np.ndarray, max_depth: int = 10,
               min_samples_leaf: int = 2) -> DecisionTree:
    return DecisionTree().fit(X, y, max_depth=max_depth, min_samples_leaf=min_samples_leaf)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", type=int, default=240)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--holdout", type=float, default=0.25)
    p.add_argument("--iters", type=int, default=8,
                   help="profiling repetitions per candidate (label quality)")
    p.add_argument("--max-depth", type=int, default=10)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the matrices are labelled (default: cuda, raises without a card)")
    p.add_argument("--out", default=DEFAULT_TREE_PATH)
    args = p.parse_args(argv)

    print(f"generating {args.samples} matrices over {FAMILIES} ...")
    mats, fams = generate_corpus(args.samples, seed=args.seed, device=args.device)
    print("labeling with profile_select (this profiles every candidate) ...")
    y = label_corpus(mats, iters=args.iters)
    X = build_dataset(mats)
    dist = {Format(k).name: int(v) for k, v in
            zip(*map(list, np.unique(y, return_counts=True)))}
    print(f"label distribution: {dist}")

    rng = np.random.default_rng(args.seed + 1)
    perm = rng.permutation(len(y))
    n_hold = int(len(y) * args.holdout)
    hold, train = perm[:n_hold], perm[n_hold:]
    tree = train_tree(X[train], y[train], max_depth=args.max_depth)
    acc_train = tree.score(X[train], y[train])
    acc_hold = tree.score(X[hold], y[hold]) if n_hold else float("nan")
    print(f"tree: {tree.n_nodes} nodes; train acc {acc_train:.3f}, "
          f"holdout acc {acc_hold:.3f}")
    for fam in FAMILIES:
        idx = np.asarray([i for i in hold if fams[i] == fam])
        if idx.size:
            print(f"  holdout[{fam:9s}]: {tree.score(X[idx], y[idx]):.3f} (n={idx.size})")
    tree.save(args.out)
    if args.out == DEFAULT_TREE_PATH:
        load_default_tree.cache_clear()  # retrained in place: drop the memo
    print(f"saved -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
