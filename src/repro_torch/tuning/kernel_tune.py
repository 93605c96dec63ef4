"""Kernel launch tuning: the knobs per (format, shape, device), measured
(port of ``repro.tuning.kernel_tune``).

Format selection answers "which format?"; this module answers the next
question down: "with which launch knobs?", and whether the CUDA kernel beats
the plain torch reference at all on this matrix and this card. Both are
facts of the run, so they are measured once and cached.

* A winner is a :class:`KernelRecord` (the JAX package's JSON schema 1) under
  a ``kernel:`` key of the shared :class:`~repro_torch.tuning.cache.SelectionCache`
  store. The key is (op, format, **shape bucket**, rhs-width bucket for the
  SpMM ops, backend tag, device name): the bucket rounds (m, n, average row
  nnz) to powers of two, so one tuned weight covers every same-sized one.
* :func:`tune_kernel` times a grid of knobs (:func:`default_grid`) through
  the kernel and the ``ref`` route with ``engines.time_fn`` (CUDA events),
  and stores the winner *with both times*: the ``auto`` route refuses a
  kernel that measured slower than the reference.
* :func:`best_config` is the lookup of the hot path
  (``repro_torch.core.ops.kernel_route``, ``kernels.ops.resolve_config``):
  host dict work on Python ints, no measuring, no device access.

``backend_tag()`` is ``"cuda-native"`` on the card and ``"cpu-plain"`` on
the CPU (where every wrapper runs its plain version). Records under any
other tag, the JAX package's ``cpu-interp`` and ``tpu-native`` among them,
are never replayed here: their keys differ.

CLI (on the card)::

    python -m repro_torch.tuning.kernel_tune           # warm the default cache
    python -m repro_torch.tuning.kernel_tune --smoke   # small grid + self-checks
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.formats import BSR, CSR, DIA, ELL, HYB, SELL, Format
from repro_torch.kernels import csr_spmm as _csr_mm
from repro_torch.kernels import ops as kops
from repro_torch.tuning import cache as _cache
from repro_torch.tuning.cache import SelectionCache, default_cache_path
from repro_torch.tuning.engines import time_fn

KERNEL_NS = "kernel"
KERNEL_SCHEMA = 1
CUDA_TAG = "cuda-native"
CPU_TAG = "cpu-plain"
OPS = ("spmv", "spmm", "spmm_t")


@dataclasses.dataclass(frozen=True)
class KernelRecord:
    """A measured winner for one (op, format, bucket, device). ``speedup``
    is kernel against reference: routing takes ``>= 1`` as "the kernel
    earned the hot path" and anything less as a measured veto."""

    fmt: str            # Format name
    op: str             # "spmv" | "spmm" | "spmm_t"
    cfg: dict           # launch knobs (block / vec / tt; SELL c, sigma)
    kernel_us: float    # best measured time of cfg, microseconds
    ref_us: float       # reference-route time on the same matrix

    @property
    def speedup(self) -> float:
        return self.ref_us / max(self.kernel_us, 1e-9)

    def to_json(self) -> str:
        return json.dumps({"v": KERNEL_SCHEMA, "fmt": self.fmt, "op": self.op,
                           "cfg": self.cfg, "kernel_us": self.kernel_us,
                           "ref_us": self.ref_us}, sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> Optional["KernelRecord"]:
        try:
            d = json.loads(raw)
            if d.get("v") != KERNEL_SCHEMA:
                return None
            return cls(str(d["fmt"]), str(d["op"]), dict(d["cfg"]),
                       float(d["kernel_us"]), float(d["ref_us"]))
        except (ValueError, KeyError, TypeError, AttributeError):
            return None


def _lg(v: float) -> int:
    return int(round(math.log2(max(1.0, float(v)))))


def shape_bucket(m: int, n: int, nnz: int) -> str:
    """Power-of-two bucket of (rows, cols, average row nnz)."""
    return f"m{_lg(m)}n{_lg(n)}r{_lg(max(1, nnz) / max(1, m))}"


def rhs_bucket(ncols: Optional[int]) -> str:
    """Power-of-two bucket of the rhs width; ``None`` is the b=1 bucket."""
    return f"b{_lg(ncols or 1)}"


def _on_card(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    if not isinstance(device, torch.device):
        device = torch.device(device)
    return device.type == "cuda"


def backend_tag(device=None) -> str:
    """``"cuda-native"`` for the card (``device=None``: this process's
    default device), ``"cpu-plain"`` for the CPU."""
    return CUDA_TAG if _on_card(device) else CPU_TAG


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index).replace("|", "/")


def device_kind(device=None) -> str:
    """``torch.cuda.get_device_name`` of the card (``"|"`` made ``"/"``, as
    the key separates fields by it), ``"cpu"`` for the CPU."""
    if not _on_card(device):
        return "cpu"
    index = None if device is None else torch.device(device).index
    return _card_name(torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=4096)
def _record(raw: str) -> Optional[KernelRecord]:
    """Parsed once per stored value: the hot path reads the same few."""
    return KernelRecord.from_json(raw)


@functools.lru_cache(maxsize=4096)
def kernel_key(fmt, m: int, n: int, nnz: int, op: str = "spmv",
               backend: Optional[str] = None, ncols: Optional[int] = None,
               device=None) -> str:
    """The ``kernel:`` key of a record: the JAX package's layout. The SpMM
    ops carry the rhs-width bucket (a winner tuned at b=1 never answers
    b=256); ``backend`` overrides the tag of ``device``. Memoized: every
    kernel call builds one."""
    width = f"|{rhs_bucket(ncols)}" if op in ("spmm", "spmm_t") else ""
    return (f"{KERNEL_NS}:v{KERNEL_SCHEMA}|{op}|{Format(fmt).name}|"
            f"{shape_bucket(m, n, nnz)}{width}|{backend or backend_tag(device)}|"
            f"{device_kind(device)}")


# The process-wide default store, re-read when $REPRO_TUNING_CACHE points
# elsewhere, when a store of this process flushed (a tune through another
# handle is seen by the next lookup), or when the file changed on disk (a
# tune by another process), which is checked at most every STAT_EVERY_S
# seconds: every kernel call looks its knobs up here, and on the H100 host of
# PERF.md a stat a call added 0.16-0.35 ms to a 0.06 ms layer call.
STAT_EVERY_S = 1.0
_DEFAULT_CACHE: Optional[SelectionCache] = None
_DEFAULT_STAMP = None
_SEEN_FLUSHES = -1
_STAT_AT = float("-inf")


def _cache_stamp(path: str):
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


def default_kernel_cache() -> SelectionCache:
    global _DEFAULT_CACHE, _DEFAULT_STAMP, _SEEN_FLUSHES, _STAT_AT
    path = default_cache_path()
    now = time.monotonic()
    if (_DEFAULT_CACHE is not None and _DEFAULT_CACHE.path == path
            and _SEEN_FLUSHES == _cache.FLUSHES and now - _STAT_AT < STAT_EVERY_S):
        return _DEFAULT_CACHE
    stamp = _cache_stamp(path)
    _SEEN_FLUSHES, _STAT_AT = _cache.FLUSHES, now
    if _DEFAULT_CACHE is None or _DEFAULT_CACHE.path != path or stamp != _DEFAULT_STAMP:
        _DEFAULT_CACHE = SelectionCache(path)
        _DEFAULT_STAMP = stamp
    return _DEFAULT_CACHE


def best_config(A, backend: Optional[str] = None, *, op: str = "spmv",
                ncols: Optional[int] = None,
                cache: Optional[SelectionCache] = None) -> Optional[KernelRecord]:
    """The cached winner for ``A``'s (format, shape bucket[, rhs-width
    bucket]) under ``backend`` (default: the tag of ``A``'s device). A pure
    lookup."""
    fmt = getattr(A, "format", None)
    if fmt is None:
        return None
    return best_config_for(fmt, A.shape[0], A.shape[1], max(1, int(A.nnz)), backend=backend,
                           op=op, ncols=ncols, cache=cache, device=A.device)


def best_config_for(fmt, m: int, n: int, nnz: int, backend: Optional[str] = None, *,
                    op: str = "spmv", ncols: Optional[int] = None,
                    cache: Optional[SelectionCache] = None,
                    device=None) -> Optional[KernelRecord]:
    cache = cache if cache is not None else default_kernel_cache()  # an empty cache is falsy
    raw = cache.get_raw(kernel_key(fmt, m, n, nnz, op=op, backend=backend, ncols=ncols,
                                   device=device))
    if raw is None:
        return None
    rec = _record(raw)
    if rec is None or rec.fmt != Format(fmt).name:
        return None
    return rec


def _bracket(v: int, widths: Sequence[int]) -> List[int]:
    return [w for w in widths if v // 2 <= w <= 2 * v]


def default_grid(A, smoke: bool = False, op: str = "spmv",
                 ncols: Optional[int] = None) -> List[dict]:
    """The knobs :func:`tune_kernel` searches for ``A`` and ``op`` at rhs
    width ``ncols``, :func:`~repro_torch.kernels.ops.default_config`'s
    choice first, so tuning can only match or beat the untuned path.

    ``vec`` brackets the default (half, same, double); ``tt`` takes every
    token tile up to the default (1, 2, 4, 8 at T >= 8); SELL adds a second
    container geometry (``c`` 64, or 32 where it is 64, ``sigma`` 8c),
    which the tuner rebuilds. ``smoke`` keeps two or three entries.
    """
    base = kops.default_config(A, op=op, ncols=ncols)
    if isinstance(A, HYB):
        sub = default_grid(A.ell, smoke=smoke, op=op, ncols=ncols)
        grid = [{"ell": g, "csr": dict(base["csr"], **({"tt": g["tt"]} if "tt" in g else {}))}
                for g in sub]
    elif isinstance(A, SELL):
        own = dict({"c": A.c, "sigma": A.sigma}, **base)
        alt_c = 32 if A.c == 64 else 64
        alt = dict({"c": alt_c, "sigma": 8 * alt_c}, **base)
        tts = [tt for tt in _csr_mm.TOKEN_TILES if tt <= base.get("tt", 0)]
        grid = [own] + [dict(own, tt=tt) for tt in tts] + [alt]
        if smoke:
            grid = [own, alt]
    else:
        vecs = _bracket(base["vec"], _csr_mm.VEC_WIDTHS) if "vec" in base else [None]
        tts = ([tt for tt in _csr_mm.TOKEN_TILES if tt <= base["tt"]] if "tt" in base
               else [None])
        if isinstance(A, DIA):
            grid = [base] + [{"block": b} for b in (128, 256, 512, 1024)]
        elif op == "spmm" and (ncols or 1) > 8:
            grid = [base]  # lanes lie along K: no knob is read
        else:
            grid = [base] + [{k: v for k, v in (("vec", vec), ("tt", tt)) if v is not None}
                             for vec in vecs for tt in tts]
        if smoke:
            grid = grid[:3]
    seen, out = set(), []
    for g in grid:  # dedup, keeping order (the default may recur)
        key = json.dumps(g, sort_keys=True)
        if key not in seen:
            seen.add(key)
            out.append(g)
    return out


def _cfg_operand(A, cfg: dict):
    """The container a cfg is timed on. For SELL, ``c``/``sigma`` are
    container geometry, not launch knobs: a cfg that changes them is timed
    on the same pattern sliced anew."""
    if isinstance(A, SELL) and cfg:
        c, sigma = int(cfg.get("c", A.c)), int(cfg.get("sigma", A.sigma))
        if (c, sigma) != (A.c, A.sigma):
            from repro_torch.core.convert import convert, sell_to_coo
            return convert(sell_to_coo(A), Format.SELL, c=c, sigma=sigma)
    return A


def _rhs(A, op: str, width: int) -> torch.Tensor:
    shape = {"spmv": (A.shape[1],), "spmm": (A.shape[1], width),
             "spmm_t": (width, A.shape[1])}[op]
    return torch.ones(shape, dtype=A.dtype, device=A.device)


def tune_kernel(A, x: Optional[torch.Tensor] = None, *, op: str = "spmv",
                cache: Optional[SelectionCache] = None,
                grid: Optional[Sequence[dict]] = None, iters: int = 5, inner: int = 4,
                B_cols: int = 8) -> KernelRecord:
    """Time every cfg of ``grid`` (default :func:`default_grid`) through
    ``A``'s kernel for ``op`` and the ``ref`` route on the same rhs ``x``
    (default: ones, ``B_cols`` wide for the SpMM ops), persist the fastest
    with both times, and return it. Setup-phase work, on the card: the
    kernel route needs CUDA tensors."""
    from repro_torch.core import ops as _ops

    if op not in OPS:
        raise ValueError(f"op {op!r} not in {OPS}")
    if type(A) not in kops.cuda_registry(op):
        raise ValueError(f"{type(A).__name__} has no {op} kernel to tune")
    cache = cache if cache is not None else default_kernel_cache()
    fn = {"spmv": _ops.spmv, "spmm": _ops.spmm, "spmm_t": _ops.spmm_t}[op]
    x = _rhs(A, op, B_cols) if x is None else x
    ncols = {"spmv": None, "spmm": x.shape[-1], "spmm_t": x.shape[0]}[op]
    ref_t = time_fn(lambda v: fn(A, v, backend="ref"), x, iters=iters, inner=inner)
    operands: Dict[tuple, object] = {}
    times: Dict[str, float] = {}
    cfgs: Dict[str, dict] = {}
    for cfg in grid if grid is not None else default_grid(A, op=op, ncols=ncols):
        geo = (cfg.get("c"), cfg.get("sigma"))
        if geo not in operands:  # one rebuild per SELL geometry
            operands[geo] = _cfg_operand(A, cfg)
        key = json.dumps(cfg, sort_keys=True)
        times[key] = time_fn(lambda v, a=operands[geo], c=cfg: fn(a, v, backend="cuda", cfg=c),
                             x, iters=iters, inner=inner)
        cfgs[key] = cfg
    best = min(times, key=times.get)
    rec = KernelRecord(fmt=Format(A.format).name, op=op, cfg=cfgs[best],
                       kernel_us=times[best] * 1e6, ref_us=ref_t * 1e6)
    cache.put_raw(kernel_key(A.format, A.shape[0], A.shape[1], max(1, int(A.nnz)), op=op,
                             ncols=ncols, device=A.device), rec.to_json())
    return rec


# ---------------------------------------------------------------------------
# CLI: cache warm-up and the smoke self-check (on the card)
# ---------------------------------------------------------------------------


def _suite(smoke: bool, device):
    """Matrices to warm the cache with: HPCG stencils (CSR, ELL, DIA), a
    uniform random pattern (CSR, ELL) and power-law rows (SELL), made with
    numpy from fixed seeds."""
    from repro_torch.core import hpcg
    from repro_torch.core.convert import convert
    from repro_torch.core.formats import coo_from_dense_np

    mats = []
    for s in ((8, 8, 8),) if smoke else ((8, 8, 8), (16, 16, 16)):
        coo = hpcg.to_coo(hpcg.generate_problem(*s), device=device)
        mats += [convert(coo, f) for f in (Format.CSR, Format.ELL, Format.DIA)]
    rng = np.random.default_rng(0)
    n = 512 if smoke else 2048
    a = np.where(rng.random((n, n)) < 0.02, rng.standard_normal((n, n)), 0).astype(np.float32)
    rnd = coo_from_dense_np(a, device=device)
    mats += [convert(rnd, f) for f in (Format.CSR, Format.ELL)]
    lens = np.minimum(n, (rng.pareto(1.2, n) * 4).astype(int) + 1)
    p = np.zeros((n, n), np.float32)
    for i, ln in enumerate(lens):
        p[i, rng.choice(n, ln, replace=False)] = rng.standard_normal(ln)
    mats.append(convert(coo_from_dense_np(p, device=device), Format.SELL))
    return mats


def run_smoke(cache_path: str, iters: int = 3, inner: int = 2) -> List[KernelRecord]:
    """Tune the smoke suite on the card into ``cache_path`` and check:

    1. every record round-trips through a fresh cache handle;
    2. ``kernel_route`` routes ``cuda`` with the record's cfg exactly where
       the record beat the reference, and ``spmv(backend="auto")`` then
       launches the kernel once and agrees with the reference;
    3. SELL records name the container geometry they were timed on;
    4. an ``spmm`` record tuned at b=1 is invisible at b=256.
    """
    from repro_torch.core import ops as _ops
    from repro_torch.device import resolve_device
    from repro_torch.tuning.cache import CACHE_PATH_ENV

    dev = resolve_device(None)
    prev = os.environ.get(CACHE_PATH_ENV)
    os.environ[CACHE_PATH_ENV] = cache_path  # the real auto route reads the default store
    try:
        cache = SelectionCache(cache_path)
        recs = []
        mats = _suite(True, dev)
        for A in mats:
            rec = tune_kernel(A, cache=cache, grid=default_grid(A, smoke=True),
                              iters=iters, inner=inner)
            recs.append(rec)
            fresh = best_config(A, cache=SelectionCache(cache_path))
            assert fresh is not None and fresh.cfg == rec.cfg, f"round trip failed: {rec}"
            route, cfg = _ops.kernel_route(A, cache=SelectionCache(cache_path))
            assert (route, cfg) == (("cuda", rec.cfg) if rec.speedup >= 1.0 else ("ref", None)), \
                (rec, route, cfg)
            x = torch.ones(A.shape[1], dtype=A.dtype, device=dev)
            before = sum(kops.launch_counts().values())
            y_auto = _ops.spmv(A, x, backend="auto")
            launched = sum(kops.launch_counts().values()) - before
            assert launched == (route == "cuda") * (2 if isinstance(A, HYB) else 1), \
                (rec, launched)
            torch.testing.assert_close(y_auto, _ops.spmv(A, x, backend="ref"),
                                       rtol=1e-4, atol=1e-4)
        sell = [r for r in recs if r.fmt == "SELL"]
        assert sell and all({"c", "sigma"} <= set(r.cfg) for r in sell), sell
        A = mats[0]
        rec = tune_kernel(A, _rhs(A, "spmm", 1), op="spmm", cache=cache,
                          grid=default_grid(A, smoke=True, op="spmm", ncols=1),
                          iters=iters, inner=inner)
        recs.append(rec)
        fresh = SelectionCache(cache_path)
        assert best_config(A, op="spmm", ncols=1, cache=fresh) is not None
        assert best_config(A, op="spmm", ncols=256, cache=fresh) is None, \
            "a b=1 spmm record answered a b=256 lookup"
        return recs
    finally:
        if prev is None:
            os.environ.pop(CACHE_PATH_ENV, None)
        else:
            os.environ[CACHE_PATH_ENV] = prev


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="small grid + cache and routing self-checks")
    p.add_argument("--cache", default=None, help="cache path (default: the process default)")
    args = p.parse_args(argv)
    if args.smoke:
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            recs = run_smoke(args.cache or f"{td}/kernels.json")
        for r in recs:
            print(f"smoke {r.fmt:4s} {r.op:6s} cfg={r.cfg} {r.kernel_us:9.1f}us vs ref "
                  f"{r.ref_us:9.1f}us (x{r.speedup:.2f})")
        print(f"kernel_tune smoke OK on {device_kind()}: {len(recs)} records, "
              f"cache round-trip + auto routing verified")
        return
    from repro_torch.device import resolve_device
    cache = SelectionCache(args.cache) if args.cache else default_kernel_cache()
    for A in _suite(False, resolve_device(None)):
        rec = tune_kernel(A, cache=cache)
        print(f"tuned {rec.fmt:4s} {tuple(A.shape)}: cfg={rec.cfg} {rec.kernel_us:9.1f}us vs "
              f"ref {rec.ref_us:9.1f}us (x{rec.speedup:.2f})")
    print(f"kernel cache: {cache.path}")


if __name__ == "__main__":
    main()
