"""The port's measured kernel route on the CPU, against the JAX package.

``repro_torch.tuning.cache`` and ``repro_torch.tuning.kernel_tune`` keep the
JAX package's keys, record schema and file format: bucket strings, record
JSON, pattern signatures, selection keys and decision values are compared
string for string, and a cache file written by either package is read by
the other. The routing rules (``kernel_route``, ``FormatPolicy("cached")``,
``resolve_config``) run against seeded caches; the card's tag and name are
monkeypatched where a rule holds only on the card, as the JAX package's
``test_auto_routing_interpret_tag_isolation`` flips its interpret mode. The
tuner runs with a stubbed timer (its kernel route needs the card).
"""
import json

import numpy as np
import pytest
import torch

import repro.tuning.cache as jcache
import repro.tuning.kernel_tune as jkt
from repro.core import Format as JFormat
from repro.tuning import FormatPolicy as JPolicy
from repro.tuning.features import PatternFeatures as JFeatures
import repro_torch.core.formats as tf
import repro_torch.core.ops as tops
from repro_torch import hpcg_solve
from repro_torch.core.dynamic import DynamicMatrix
from repro_torch.core.solvers import operator
from repro_torch.kernels import csr_spmm as kcm
from repro_torch.kernels import ops as kops
from repro_torch.models import WEIGHT_CANDIDATES, LinearSparse, prune_magnitude
from repro_torch.obs import metrics
from repro_torch.tuning import (CACHE_PATH_ENV, FormatPolicy, KernelRecord, PatternFeatures,
                                SelectionCache, cache as tcache, kernel_tune as kt)
from torch_parity import PATTERNS, coo_pair, tconv
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

H100 = "NVIDIA H100 80GB HBM3"
SHAPES = [(1000, 1000, 27000), (1024, 1024, 27648), (16384, 4096, 16777219),
          (4096, 16384, 16777217), (1, 1, 0), (300, 280, 3360)]
WIDTHS = (None, 1, 2, 3, 200, 256, 4096)


@pytest.fixture
def card_tag(monkeypatch):
    """This process as if on the card: tag ``cuda-native``, an H100's name
    (the memoized keys are dropped on the way in and out: a real device's
    tag and name never change)."""
    kt.kernel_key.cache_clear()
    monkeypatch.setattr(kt, "backend_tag", lambda device=None: kt.CUDA_TAG)
    monkeypatch.setattr(kt, "device_kind", lambda device=None: H100)
    yield
    kt.kernel_key.cache_clear()


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A fresh default store at a temporary path."""
    path = str(tmp_path / "sel.json")
    monkeypatch.setenv(CACHE_PATH_ENV, path)
    return path


def _csr(pattern="random"):
    return tconv.convert(coo_pair(PATTERNS[pattern]())[1], tf.Format.CSR)


def _seed(A, op, kernel_us, ref_us, cfg, ncols=None, path=None):
    rec = KernelRecord(tf.Format(A.format).name, op, cfg, kernel_us, ref_us)
    SelectionCache(path).put_raw(
        kt.kernel_key(A.format, A.shape[0], A.shape[1], A.nnz, op=op, ncols=ncols,
                      device=A.device), rec.to_json())
    return rec


# ---------------------------------------------------------------------------
# keys, records and values: string for string the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_buckets_and_kernel_keys_match_jax(shape):
    m, n, nnz = shape
    assert kt.shape_bucket(m, n, nnz) == jkt.shape_bucket(m, n, nnz)
    for w in WIDTHS:
        assert kt.rhs_bucket(w) == jkt.rhs_bucket(w)
        for op in kt.OPS:
            # the same tag on the CPU (JAX's device kind there is "cpu")
            assert kt.kernel_key(tf.Format.CSR, m, n, nnz, op=op, backend="cpu-interp",
                                 ncols=w, device="cpu") == \
                jkt.kernel_key(JFormat.CSR, m, n, nnz, op=op, backend="cpu-interp", ncols=w)


def test_kernel_record_json_matches_jax():
    args = ("SELL", "spmm_t", {"c": 32, "sigma": 256, "tt": 4}, 2145.3, 82961.1)
    rec = KernelRecord(*args)
    assert rec.to_json() == jkt.KernelRecord(*args).to_json()
    assert KernelRecord.from_json(jkt.KernelRecord(*args).to_json()) == rec
    assert jkt.KernelRecord.from_json(rec.to_json()) == jkt.KernelRecord(*args)
    assert rec.speedup == pytest.approx(82961.1 / 2145.3)
    for bad in ("{not json", json.dumps({"v": 999}), "[]"):
        assert KernelRecord.from_json(bad) is None


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_signature_selection_key_and_decisions_match_jax(pattern):
    Aj, At = coo_pair(PATTERNS[pattern]())
    fj, ft = JFeatures.from_coo(Aj), PatternFeatures.from_coo(At)
    assert tcache.pattern_signature(ft) == jcache.pattern_signature(fj)
    jc = [JFormat[f.name] for f in WEIGHT_CANDIDATES]
    for ctx in ("", "spmm_t-b0", "spmm-b8"):
        assert SelectionCache.key(ft, WEIGHT_CANDIDATES, "cpu", "cpu", op_ctx=ctx) == \
            jcache.SelectionCache.key(fj, jc, "cpu", "cpu", op_ctx=ctx)
    for fmt, backend, cfg, tag in (("ELL", "cuda", {"vec": 32, "tt": 8}, kt.CUDA_TAG),
                                   ("DIA", "pallas", {"tm": 512}, "cpu-interp"),
                                   ("CSR", None, None, None)):
        value = tcache.encode_decision(tf.Format[fmt], backend, cfg, tag)
        assert value == jcache.encode_decision(JFormat[fmt], backend, cfg, tag)
        assert tcache.decode_decision(value) == (tf.Format[fmt], backend, cfg, tag)
    assert tcache.decode_decision("DIA") == (tf.Format.DIA, None, None, None)
    assert tcache.decode_decision("v2|NOPE|||") == (None, None, None, None)
    assert tcache.default_cache_path() == jcache.default_cache_path()


def test_cache_files_cross_between_the_packages(tmp_path):
    """A file the JAX store writes loads in the port's, and back; both
    merge on flush rather than overwrite."""
    path = str(tmp_path / "shared.json")
    j = jcache.SelectionCache(path)
    j.put("k1", JFormat.ELL)
    j.put_decision("k2", JFormat.DIA, "pallas", {"tm": 512}, tag="cpu-interp")
    j.put_raw("kernel:x", jkt.KernelRecord("CSR", "spmv", {"tm": 8}, 1.0, 2.0).to_json())
    t = SelectionCache(path)
    assert t.get("k1") == tf.Format.ELL
    assert t.get_decision("k2") == (tf.Format.DIA, "pallas", {"tm": 512}, "cpu-interp")
    assert KernelRecord.from_json(t.get_raw("kernel:x")).cfg == {"tm": 8}
    t.put_decision("k3", tf.Format.SELL, "cuda", {"c": 32, "sigma": 256, "tt": 4}, kt.CUDA_TAG)
    t.put_raw("kernel:y", KernelRecord("SELL", "spmm_t", {"tt": 4}, 1.0, 3.0).to_json())
    back = jcache.SelectionCache(path)
    assert back.get_decision("k3") == (JFormat.SELL, "cuda", {"c": 32, "sigma": 256, "tt": 4},
                                       kt.CUDA_TAG)
    assert back.get("k1") == JFormat.ELL  # the port's flush kept the JAX entries
    assert jkt.KernelRecord.from_json(back.get_raw("kernel:y")).speedup == pytest.approx(3.0)
    with metrics.scope() as s:
        assert SelectionCache(path).get_decision("missing") is None
        assert SelectionCache(path).get("k1") == tf.Format.ELL
        assert s.delta("selection.cache_miss") == 1 and s.delta("selection.cache_hit") == 1
    (tmp_path / "bad.json").write_text("[1, 2]")
    assert len(SelectionCache(str(tmp_path / "bad.json"))) == 0


def test_jax_interp_pin_is_never_replayed(store, monkeypatch):
    """JAX's cached policy pins a Pallas config under ``cpu-interp``; the
    port's cached policy finds the same decision (same key), keeps its
    format and re-derives the pin from its own records (none: unpinned),
    and the JAX kernel record never answers the port's lookup."""
    monkeypatch.setenv("REPRO_FORCE_INTERPRET", "1")
    Aj, At = coo_pair(PATTERNS["banded"]())
    fmt = JPolicy("ml").select(Aj).best
    fj = JFeatures.from_coo(Aj)
    jkt.default_kernel_cache().put_raw(
        jkt.kernel_key(fmt, fj.m, fj.n, fj.nnz),
        jkt.KernelRecord(fmt.name, "spmv", {"tm": 256}, 10.0, 100.0).to_json())
    cold = JPolicy("cached", cache=jcache.SelectionCache(store)).select(Aj)
    assert cold.backend == "pallas" and cold.cfg == {"tm": 256}
    rep = FormatPolicy("cached", cache=store).select(At)
    assert rep.mode == "cached" and rep.best.name == fmt.name
    assert (rep.backend, rep.cfg) == (None, None)
    A = tconv.convert(At, tf.Format[fmt.name])
    assert kt.best_config(A) is None
    assert tops.kernel_route(A) == ("ref", None)


# ---------------------------------------------------------------------------
# grids and the tuner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["CSR", "ELL", "SELL", "HYB", "DIA", "BSR"])
def test_default_grid_contains_default_config(fmt):
    coo = coo_pair(PATTERNS["powerlaw"]())[1]
    A = tconv.convert(coo, tf.Format[fmt], **({"block_size": 8} if fmt == "BSR" else {}))
    for op in kt.OPS:
        if type(A) not in kops.cuda_registry(op):
            continue
        for w in (1, 3, 256):
            grid = kt.default_grid(A, op=op, ncols=w)
            base = kops.default_config(A, op=op, ncols=w)
            if fmt == "SELL":
                base = dict({"c": A.c, "sigma": A.sigma}, **base)
            assert grid[0] == base and len(grid) == len({json.dumps(g, sort_keys=True)
                                                         for g in grid})
            assert kt.default_grid(A, smoke=True, op=op, ncols=w)[0] == base
            if op == "spmm_t" and fmt not in ("HYB", "BSR"):  # BSR takes no knob
                tts = {g.get("tt") for g in grid}
                assert tts == ({1, 2, 4, 8} if w == 256 else {1, 2, 4} if w == 3 else {1})


@pytest.mark.parametrize("fmt", ["CSR", "ELL", "HYB", "SELL"])
def test_default_grid_holds_both_spmm_t_schedules(fmt):
    """At ncols = 256 the grid times the token-major schedule at every tile
    and the row (SELL: slice) schedule (entries without ``xt``); at ncols =
    1 only the row schedule. HYB's tail runs its ELL part's schedule."""
    A = tconv.convert(coo_pair(PATTERNS["powerlaw"]())[1], tf.Format[fmt])

    def knobs(g):
        return [g["ell"], g["csr"]] if fmt == "HYB" else [g]
    for smoke in (False, True):
        grid = kt.default_grid(A, smoke=smoke, op="spmm_t", ncols=256)
        xts = {kops._xt(k) for g in grid for k in knobs(g)}
        assert 0 in xts and 128 in xts
        if not smoke:
            assert xts == {0, *kcm.XT_TILES}
        for g in grid:
            assert len({kops._xt(k) for k in knobs(g)}) == 1
    assert all(kops._xt(k) == 0 for g in kt.default_grid(A, op="spmm_t", ncols=1)
               for k in knobs(g))


@pytest.mark.parametrize("fmt", ["ELL", "HYB"])
def test_default_grid_holds_both_ell_spmm_schedules(fmt):
    """ELL's Y = A @ B at Kb = 256: the default (``xt`` 128) first, then
    the row schedule (no ``xt``) and every tile; HYB's ELL part the same,
    its CSR tail never an ``xt``. At Kb = 4 only the row schedule."""
    A = tconv.convert(coo_pair(PATTERNS["powerlaw"]())[1], tf.Format[fmt])

    def ell(g):
        return g["ell"] if fmt == "HYB" else g
    for smoke in (False, True):
        grid = kt.default_grid(A, smoke=smoke, op="spmm", ncols=256)
        assert grid[0] == kops.default_config(A, op="spmm", ncols=256)
        assert kops._xt(ell(grid[0])) == 128 and kops._xt(ell(grid[1])) == 0
        xts = [kops._xt(ell(g)) for g in grid]
        assert xts == ([128, 0, 32, 64] if not smoke else [128, 0, 32])
        if fmt == "HYB":
            assert all("xt" not in g["csr"] and "tt" not in g["csr"] for g in grid)
    grid = kt.default_grid(A, op="spmm", ncols=4)
    assert grid[0] == kops.default_config(A, op="spmm", ncols=4)
    assert all(kops._xt(ell(g)) == 0 for g in grid) and len(grid) > 1  # vec brackets


def test_tune_kernel_persists_its_winner(tmp_path, monkeypatch):
    """The stubbed timer gives the reference 1 s and the grid's configs the
    listed times: the record keeps the fastest cfg with both times, under a
    ``kernel:`` key, and a fresh handle finds it."""
    A = _csr("powerlaw")
    grid = kt.default_grid(A, op="spmm_t", ncols=256)
    times = iter([1.0] + [0.5 + 0.1 * ((i * 7) % len(grid)) for i in range(len(grid))])
    monkeypatch.setattr(kt, "time_fn", lambda fn, *a, **kw: next(times))
    path = str(tmp_path / "k.json")
    X = torch.ones(256, A.shape[1])
    rec = kt.tune_kernel(A, X, op="spmm_t", cache=SelectionCache(path), iters=1, inner=1)
    assert rec.cfg == grid[0] and rec.kernel_us == pytest.approx(0.5e6)
    assert rec.ref_us == pytest.approx(1e6) and rec.speedup == pytest.approx(2.0)
    fresh = kt.best_config(A, op="spmm_t", ncols=256, cache=SelectionCache(path))
    assert fresh == rec
    assert kt.best_config(A, op="spmm_t", ncols=1, cache=SelectionCache(path)) is None
    with open(path) as f:
        assert all(k.startswith("kernel:") for k in json.load(f))
    with pytest.raises(ValueError, match="no spmv kernel"):
        kt.tune_kernel(coo_pair(PATTERNS["random"]())[1], cache=SelectionCache(path))


def test_tune_kernel_times_sell_geometry_on_a_rebuilt_container(tmp_path, monkeypatch):
    S = tconv.convert(coo_pair(PATTERNS["powerlaw"]())[1], tf.Format.SELL)
    grid = kt.default_grid(S, op="spmm", ncols=4)
    assert [(g["c"], g["sigma"]) for g in grid] == [(32, 256), (64, 512)]
    seen = []

    def fake_time(fn, x, **kw):
        a = getattr(fn, "__defaults__", None)
        if a:
            seen.append(a[0].c)
        return {0: 1.0, 1: 0.9, 2: 0.3}[len(seen)]
    monkeypatch.setattr(kt, "time_fn", fake_time)
    rec = kt.tune_kernel(S, torch.ones(S.shape[1], 4), op="spmm",
                         cache=SelectionCache(str(tmp_path / "k.json")))
    assert seen == [32, 64] and rec.cfg == {"c": 64, "sigma": 512}
    assert kt._cfg_operand(S, {"c": 8, "sigma": 16}).c == 8
    assert kt._cfg_operand(S, {"c": 32, "sigma": 256}) is S


def test_default_store_sees_writers_without_a_stat_a_call(store, monkeypatch):
    """A flush by any store of this process is seen by the next lookup; a
    write by another process (the file replaced behind the store's back) is
    seen once ``STAT_EVERY_S`` has passed since the last stat."""
    A = _csr()
    monkeypatch.setattr(kt, "STAT_EVERY_S", 3600.0)
    assert kt.best_config(A) is None
    _seed(A, "spmv", 1.0, 2.0, {"vec": 4})  # this process: seen at once
    assert kt.best_config(A).cfg == {"vec": 4}
    other = json.load(open(store))
    key = kt.kernel_key(A.format, A.shape[0], A.shape[1], A.nnz, device=A.device)
    other[key] = KernelRecord("CSR", "spmv", {"vec": 8}, 1.0, 2.0).to_json()
    with open(store, "w") as f:
        json.dump(other, f, indent=0)  # another process: no flush counted here
    assert kt.best_config(A).cfg == {"vec": 4}
    monkeypatch.setattr(kt, "STAT_EVERY_S", 0.0)
    assert kt.best_config(A).cfg == {"vec": 8}


# ---------------------------------------------------------------------------
# routing: auto runs a kernel only where a measurement says it wins
# ---------------------------------------------------------------------------


def test_kernel_route_with_a_seeded_cache(store, card_tag):
    A = _csr()
    cfg = {"vec": 8, "tt": 4}
    with metrics.scope() as s:
        assert tops.kernel_route(A, op="spmm_t", ncols=256) == ("ref", None)  # no record
        _seed(A, "spmm_t", 100.0, 50.0, cfg, ncols=256)
        assert tops.kernel_route(A, op="spmm_t", ncols=256) == ("ref", None)  # lost: veto
        _seed(A, "spmm_t", 50.0, 100.0, cfg, ncols=256)
        assert tops.kernel_route(A, op="spmm_t", ncols=256) == ("cuda", cfg)  # won
        assert tops.kernel_route(DynamicMatrix(A), op="spmm_t", ncols=200) == ("cuda", cfg)
        assert tops.kernel_route(A, op="spmm_t", ncols=1) == ("ref", None)  # b0: no record
        assert tops.kernel_route(A, op="spmm", ncols=256) == ("ref", None)  # another op
        assert (s.delta("kernel.route.ref"), s.delta("kernel.route.veto"),
                s.delta("kernel.route.cuda")) == (3, 1, 2)
    assert kt.best_config(A, op="spmm_t", ncols=256, backend="cpu-interp") is None


def test_kernel_route_off_the_card_is_ref(store):
    """Unpatched, this process is on the CPU: a winning record under the
    card's tag is never consulted for a CPU container, and the CPU tag
    never routes to a kernel either."""
    A = _csr()
    rec = KernelRecord("CSR", "spmv", {"vec": 4}, 1.0, 100.0)
    SelectionCache(store).put_raw(
        kt.kernel_key(A.format, A.shape[0], A.shape[1], A.nnz, backend=kt.CUDA_TAG),
        rec.to_json())
    _seed(A, "spmv", 1.0, 100.0, {"vec": 4})  # under the CPU tag
    assert kt.backend_tag(A.device) == kt.CPU_TAG
    with metrics.scope() as s:
        assert tops.kernel_route(A) == ("ref", None)
        assert s.delta("kernel.route.ref") == 1
    x = torch.ones(A.shape[1])
    assert torch.equal(tops.spmv(A, x, backend="auto"), tops.spmv(A, x, backend="ref"))


def test_resolve_config_prefers_explicit_then_record_then_default(store):
    A = _csr()
    base = kops.default_config(A, op="spmm_t", ncols=256)
    assert kops.resolve_config(A, None, "spmm_t", 256) == base
    _seed(A, "spmm_t", 9.0, 1.0, {"vec": 2, "tt": 1}, ncols=256)  # a loser still names knobs
    assert kops.resolve_config(A, None, "spmm_t", 256) == {"vec": 2, "tt": 1}
    assert kops.resolve_config(A, {"vec": 16}, "spmm_t", 256) == {"vec": 16}
    assert kops._pick({"vec": 16}, "tt", A, "spmm_t", 256) == base["tt"]
    assert kops.resolve_config(A, None, "spmm_t", 1) == kops.default_config(A, op="spmm_t",
                                                                             ncols=1)


@pytest.mark.parametrize("fmt", ["CSR", "SELL"])
def test_default_grid_holds_the_three_ab_schedules(fmt):
    """CSR's and SELL's Y = A @ B at Kb >= 32: the default first, then the
    row schedule (neither knob), every ``xt`` tile and every ``tc`` strip,
    never both knobs in one entry (SELL: on its own geometry); at Kb <= 8
    the row schedule alone."""
    A = tconv.convert(coo_pair(PATTERNS["powerlaw"]())[1], tf.Format[fmt])
    geometry = {"c": A.c, "sigma": A.sigma} if fmt == "SELL" else {}
    for kb in (32, 64, 256):
        grid = kt.default_grid(A, op="spmm", ncols=kb)
        assert grid[0] == dict(geometry, **kops.default_config(A, op="spmm", ncols=kb))
        own = [g for g in grid if all(g.get(k) == v for k, v in geometry.items())]
        scheds = {(kops._xt(g), kops._xt(g, "tc")) for g in own}
        assert scheds >= {(0, 0), *((x, 0) for x in kcm.XT_TILES),
                          *((0, t) for t in kcm.TC_TILES)}, (kb, scheds)
        assert not any(x and t for x, t in scheds)
    for kb in (1, 8):
        assert all(kops._xt(g) == kops._xt(g, "tc") == 0
                   for g in kt.default_grid(A, op="spmm", ncols=kb))


@pytest.mark.parametrize("fmt", ["CSR", "SELL"])
def test_ab_records_round_trip_through_the_selection_cache(fmt, tmp_path, card_tag):
    """CSR and SELL SpMM records with ``xt`` or ``tc`` survive the record
    JSON string for string (the JAX package writes the same string and reads
    the knobs back), a fresh store handle and the lookup of
    ``resolve_config``; a record with neither knob means the row schedule."""
    path = str(tmp_path / "sel.json")
    A = tconv.convert(coo_pair(PATTERNS["powerlaw"]())[1], tf.Format[fmt])
    geometry = {"c": A.c, "sigma": A.sigma} if fmt == "SELL" else {"vec": 8}
    key = kt.kernel_key(A.format, A.shape[0], A.shape[1], A.nnz, op="spmm", ncols=256,
                        device=A.device)
    for knob in ({"tc": 128}, {"xt": 64}, {"xt": 128}, {}):
        cfg = dict(geometry, **knob)
        rec = _seed(A, "spmm", 600.0, 90000.0, cfg, ncols=256, path=path)
        raw = SelectionCache(path).get_raw(key)
        assert raw == rec.to_json() == jkt.KernelRecord(fmt, "spmm", cfg, 600.0,
                                                        90000.0).to_json()
        assert KernelRecord.from_json(raw).to_json() == raw
        assert jkt.KernelRecord.from_json(raw).cfg == cfg
        fresh = kt.best_config(A, op="spmm", ncols=256, cache=SelectionCache(path))
        assert fresh == rec and fresh.cfg == cfg
        assert kt.best_config(A, op="spmm", ncols=1, cache=SelectionCache(path)) is None
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(CACHE_PATH_ENV, path)
            got = kops.resolve_config(A, None, "spmm", 256)
        assert got == cfg
        assert (kops._xt(got), kops._xt(got, "tc")) == (knob.get("xt", 0), knob.get("tc", 0))


def test_a_record_without_xt_means_the_row_schedule(store):
    """A record stored before the token-major schedule existed (no ``xt``)
    still answers its bucket, and runs the row schedule; one with ``xt``
    runs that tile."""
    A = _csr()
    assert kops._xt(kops.resolve_config(A, None, "spmm_t", 256)) == 128  # the default
    _seed(A, "spmm_t", 1.0, 9.0, {"vec": 8, "tt": 4}, ncols=256)
    cfg = kops.resolve_config(A, None, "spmm_t", 256)
    assert cfg == {"vec": 8, "tt": 4} and kops._xt(cfg) == 0
    _seed(A, "spmm_t", 1.0, 9.0, {"vec": 8, "tt": 4, "xt": 64}, ncols=256)
    assert kops._xt(kops.resolve_config(A, None, "spmm_t", 256)) == 64
    assert kops._xt(None) == kops._xt({}) == kops._xt({"xt": 0}) == 0


def test_xt_round_trips_through_the_selection_cache(tmp_path, card_tag):
    """The knob survives the record JSON, a fresh store handle and a pinned
    decision of the cached policy, and the JAX package reads it back."""
    path = str(tmp_path / "sel.json")
    A = _csr()
    cfg = {"vec": 32, "tt": 8, "xt": 128}
    rec = _seed(A, "spmm_t", 700.0, 45000.0, cfg, ncols=256, path=path)
    fresh = kt.best_config(A, op="spmm_t", ncols=256, cache=SelectionCache(path))
    assert fresh == rec and fresh.cfg == cfg and kops._xt(fresh.cfg) == 128
    assert KernelRecord.from_json(rec.to_json()).cfg == cfg
    SelectionCache(path).put_decision("k-xt", tf.Format.ELL, "cuda", {"ell": cfg}, kt.CUDA_TAG)
    assert SelectionCache(path).get_decision("k-xt") == (tf.Format.ELL, "cuda", {"ell": cfg},
                                                         kt.CUDA_TAG)
    assert jcache.SelectionCache(path).get_decision("k-xt")[2] == {"ell": cfg}


def test_sell_xt_record_round_trips_through_the_selection_cache(tmp_path, card_tag):
    """A SELL SpMM_T record with ``xt`` (and its container geometry)
    survives the record JSON, a fresh store handle and a pinned decision,
    and the JAX package reads both back."""
    path = str(tmp_path / "sel.json")
    A = tconv.convert(coo_pair(PATTERNS["powerlaw"]())[1], tf.Format.SELL)
    cfg = {"c": A.c, "sigma": A.sigma, "tt": 8, "xt": 128}
    rec = _seed(A, "spmm_t", 900.0, 45000.0, cfg, ncols=256, path=path)
    fresh = kt.best_config(A, op="spmm_t", ncols=256, cache=SelectionCache(path))
    assert fresh == rec and fresh.cfg == cfg and kops._xt(fresh.cfg) == 128
    assert KernelRecord.from_json(rec.to_json()).cfg == cfg
    assert kt.best_config(A, op="spmm_t", ncols=1, cache=SelectionCache(path)) is None
    key = kt.kernel_key(A.format, A.shape[0], A.shape[1], A.nnz, op="spmm_t", ncols=256,
                        device=A.device)
    assert jkt.KernelRecord.from_json(jcache.SelectionCache(path).get_raw(key)).cfg == cfg
    SelectionCache(path).put_decision("k-sell-xt", tf.Format.SELL, "cuda", cfg, kt.CUDA_TAG)
    assert SelectionCache(path).get_decision("k-sell-xt") == (tf.Format.SELL, "cuda", cfg,
                                                              kt.CUDA_TAG)
    assert jcache.SelectionCache(path).get_decision("k-sell-xt")[2] == cfg


def test_operator_and_dynamic_matrix_thread_cfg(monkeypatch):
    """``operator(cfg=)``, ``DynamicMatrix.spmm(cfg=)`` and friends hand the
    cfg to the kernel entry point (spied here; the CUDA route is opened to
    CPU tensors, where the entry points run their plain versions)."""
    monkeypatch.setattr(tops, "_cuda_only", lambda backend, t: None)
    seen = []
    for reg, fmt in ((kops.SPMV_CUDA, tf.CSR), (kops.SPMM_CUDA, tf.CSR),
                     (kops.SPMM_T_CUDA, tf.CSR)):
        real = reg[fmt]
        monkeypatch.setitem(reg, fmt, lambda A, v, cfg=None, real=real: (seen.append(cfg),
                                                                          real(A, v, cfg))[1])
    A = _csr()
    x = torch.ones(A.shape[1])
    y = operator(A, backend="cuda", cfg={"vec": 4})(x)
    torch.testing.assert_close(y, tops.spmv(A, x, backend="ref"))
    D = DynamicMatrix(A)
    D.spmm(x[:, None], backend="cuda", cfg={"vec": 8})
    D.spmm_t(x[None, :], backend="cuda", cfg={"vec": 2, "tt": 1})
    D.spmv(x, backend="cuda", cfg={"vec": 16})
    assert seen == [{"vec": 4}, {"vec": 8}, {"vec": 2, "tt": 1}, {"vec": 16}]


# ---------------------------------------------------------------------------
# the cached policy and its users
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern", ["powerlaw", "random"])
def test_cached_policy_miss_then_hit_per_width_bucket(pattern, store, card_tag):
    """A miss takes the ml pick (JAX's ml pick on the same pattern) and pins
    ("cuda", cfg) where the policy's store holds a winning record for that
    width bucket; the next call hits with the same decision, and the other
    bucket stays apart."""
    Aj, At = coo_pair(PATTERNS[pattern]())
    jc = [JFormat[f.name] for f in WEIGHT_CANDIDATES]
    want = JPolicy("ml", candidates=jc).select(Aj).best.name
    fmt = tf.Format[want]
    f = PatternFeatures.from_coo(At)
    rec = KernelRecord(want, "spmm_t", {"tt": 4}, 1.0, 5.0)
    SelectionCache(store).put_raw(kt.kernel_key(fmt, f.m, f.n, f.nnz, op="spmm_t", ncols=256),
                                  rec.to_json())
    pol = FormatPolicy("cached", candidates=WEIGHT_CANDIDATES, cache=store)
    with metrics.scope() as s:
        for ncols, pin in ((256, ("cuda", {"tt": 4})), (1, (None, None))):
            cold = pol.select(At, op="spmm_t", ncols=ncols)
            warm = FormatPolicy("cached", candidates=WEIGHT_CANDIDATES,
                                cache=store).select(At, op="spmm_t", ncols=ncols)
            assert cold.mode == "cached-miss:ml" and warm.mode == "cached"
            assert (cold.best.name, cold.backend, cold.cfg) == (want,) + pin
            assert (warm.best, warm.backend, warm.cfg) == (cold.best, cold.backend, cold.cfg)
        assert s.delta("selection.cache_miss") == 2 and s.delta("selection.cache_hit") == 2


def test_cached_policy_rederives_a_stale_pin(store, card_tag):
    _, At = coo_pair(PATTERNS["powerlaw"]())
    pol = FormatPolicy("cached", candidates=WEIGHT_CANDIDATES, cache=store)
    fmt = pol.select(At, op="spmm", ncols=8).best
    key = SelectionCache.key(PatternFeatures.from_coo(At), WEIGHT_CANDIDATES, "cpu", H100,
                             op_ctx="spmm-b3")
    SelectionCache(store).put_decision(key, fmt, "pallas", {"tm": 64}, tag="tpu-native")
    rep = FormatPolicy("cached", candidates=WEIGHT_CANDIDATES, cache=store).select(
        At, op="spmm", ncols=8)
    assert rep.mode == "cached" and rep.best == fmt and (rep.backend, rep.cfg) == (None, None)


def test_plan_for_takes_sell_geometry_from_a_tuned_record(store):
    _, At = coo_pair(PATTERNS["powerlaw"]())
    S = tconv.convert(At, tf.Format.SELL)
    assert tconv.convert_execute(At, FormatPolicy("cached", cache=store).plan_for(
        At, fmt=tf.Format.SELL, op="spmm_t", ncols=256)).c == 32
    _seed(S, "spmm_t", 1.0, 2.0, {"c": 8, "sigma": 64, "tt": 4}, ncols=256)
    pol = FormatPolicy("cached", cache=store)  # a policy reads its store once
    B = tconv.convert_execute(At, pol.plan_for(At, fmt=tf.Format.SELL, op="spmm_t", ncols=256))
    assert (B.c, B.sigma) == (8, 64)
    C = tconv.convert_execute(At, pol.plan_for(At, fmt=tf.Format.SELL, op="spmm_t", ncols=256,
                                               c=16))
    assert C.c == 16  # a caller's hint wins


def test_linear_sparse_cached_and_auto_on_the_cpu(store):
    rng = np.random.default_rng(31)
    w = prune_magnitude(rng.standard_normal((48, 80)).astype(np.float32), 0.25)
    layer = LinearSparse.from_dense(w, tune="cached", ncols=256, backend="auto", device="cpu")
    jc = [JFormat[f.name] for f in WEIGHT_CANDIDATES]
    Aj, _ = coo_pair(np.ascontiguousarray(w.T), capacity=None)
    assert layer.format.name == JPolicy("ml", candidates=jc).select(Aj).best.name
    x = rng.standard_normal((5, 48)).astype(np.float32)
    with metrics.scope() as s:
        y = layer(torch.from_numpy(x))
        assert s.delta("kernel.route.ref") == 1
    np.testing.assert_allclose(y.numpy(), x.astype(np.float64) @ w, rtol=1e-4, atol=1e-4)
    with metrics.scope() as s:
        again = layer.retune(ncols=1, tune="cached")
        assert s.delta("serve.retune") == 1 and again.backend == "auto"


def test_hpcg_solve_tune_cached_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "sel.json")
    first = hpcg_solve.run((8, 8, 8), "auto", device="cpu", tune="cached", cache=path)
    second = hpcg_solve.run((8, 8, 8), "auto", device="cpu", tune="cached", cache=path)
    assert (first["pick_mode"], second["pick_mode"]) == ("cached-miss:ml", "cached")
    assert first["format"] == second["format"] == "DIA" and second["passed"]
    assert first["iters"] == second["iters"]
    assert hpcg_solve.main(["--grid", "8", "8", "8", "--device", "cpu", "--tune", "cached",
                            "--cache", path]) == 0
    assert "format: DIA (cached pick, cached, kernel cfg None" in capsys.readouterr().out
