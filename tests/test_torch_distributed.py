"""The port's distributed layer (``repro_torch.core.distributed``) against
the JAX package's mesh-free build functions, its single-device results and
a dense float64 oracle, on the CPU.

JAX's own multi-shard path (``shard_map`` over a host mesh) does not run
under the installed JAX, so P > 1 is held to: the bitwise output of JAX's
``plan_partition`` / ``partition_execute_jit`` / ``_split_caps`` /
``split_local_execute_jit`` / ``plan_switch_batch`` /
``convert_execute_batch`` / ``select_batch``; JAX's single-device ``spmv``
and ``cg`` (``backend="ref"``) on the global matrix; the dense float64
product.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.distributed as jd
import repro.core.hpcg as jhpcg
import repro.core.ops as jops
import repro.core.solvers as jsol
from repro.tuning import FormatPolicy as JPolicy
from repro.tuning.cache import SelectionCache as JCache
from repro_torch.core import distributed as td
from repro_torch.core import hpcg
from repro_torch.core.convert import planned_pulls_scope
from repro_torch.core.formats import Format, to_numpy
from repro_torch.core.solvers import cg, operator
from repro_torch.obs import metrics
from repro_torch.tuning import FormatPolicy
from repro_torch.tuning.cache import SelectionCache
from torch_parity import DEV, jax_fields, jconv, tconv
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ALL_FORMATS = (Format.COO, Format.CSR, Format.DIA, Format.ELL, Format.SELL, Format.HYB,
               Format.BSR)
CANDIDATES = (Format.COO, Format.CSR, Format.DIA, Format.ELL, Format.SELL)
SPMV_TOL = 1e-5  # max |y - y64| / max |y64|, the JAX distributed tests' bound


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _stencil(nx=8, ny=8, nz=16):
    p = jhpcg.generate_problem(nx, ny, nz)
    return p.row, p.col, p.val, p.shape


def _random(n=128, density=0.06, seed=5):
    """Random pattern: remote columns reach past the neighbours (gather)."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((n, n)) < density, rng.standard_normal((n, n)), 0)
    a[np.arange(n), np.arange(n)] = 4.0
    r, c = np.nonzero(a)
    return r.astype(np.int64), c.astype(np.int64), a[r, c].astype(np.float32), (n, n)


def _banded(n=128, offsets=(-20, -3, 0, 1, 17), seed=6):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
    r, c = np.concatenate(rows), np.concatenate(cols)
    o = np.lexsort((c, r))
    return r[o], c[o], rng.standard_normal(len(r)).astype(np.float32), (n, n)


def _block_diag(n=128, nb=4, seed=7):
    """Four dense-ish diagonal blocks: block-diagonal at P = 4 (hw 0)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    b = n // nb
    for k in range(nb):
        blk = np.where(rng.random((b, b)) < 0.2, rng.standard_normal((b, b)), 0)
        a[k * b:(k + 1) * b, k * b:(k + 1) * b] = blk
    r, c = np.nonzero(a)
    return r.astype(np.int64), c.astype(np.int64), a[r, c], (n, n)


MATRICES = {"stencil": _stencil, "random": _random, "banded": _banded,
            "block_diag": _block_diag}


def _dense(row, col, val, shape):
    d = np.zeros(shape)
    np.add.at(d, (np.asarray(row), np.asarray(col)), np.asarray(val, np.float64))
    return d


def _same(jc, tc, what=""):
    """Bit-identical fields (nested for HYB), same shapes."""
    a, b = jax_fields(jc), to_numpy(tc)

    def cmp(x, y, path):
        if isinstance(x, dict):
            assert set(x) == set(y), path
            for k in x:
                cmp(x[k], y[k], f"{path}.{k}")
        else:
            assert x.shape == y.shape and x.dtype == y.dtype, (path, x.shape, y.shape)
            np.testing.assert_array_equal(x, y, err_msg=path)
    cmp(a, b, what)
    assert tuple(jc.shape) == tuple(tc.shape)


def _parts_both(row, col, val, shape, nshards, halo_mode="auto"):
    """JAX's and the port's stacked parts (interior, boundary, remote when
    there is a halo, else local, remote) and their plans."""
    jp = jd.plan_partition(row, col, val, shape, nshards, halo_mode=halo_mode)
    tp = td.plan_partition(row, col, val, shape, nshards, halo_mode=halo_mode)
    jl, jr = jd.partition_execute_jit(row, col, val, plan=jp)
    tl, tr = td.partition_execute(row, col, val, tp, device=DEV)
    if jp.remote_empty:
        return jp, tp, [(jl, tl), (jr, tr)]
    caps = jd._split_caps(row, col, val, jp.mp, nshards)
    ji, jb = jd.split_local_execute_jit(jl, jr, mp=jp.mp, icap=caps[0], bcap=caps[1])
    ti, tb = td.split_local_execute(tl, tr, tp.mp, *caps)
    return jp, tp, [(ji, ti), (jb, tb), (jr, tr)]


# ---------------------------------------------------------------------------
# Partition and split: bitwise JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nshards", [1, 2, 4, 8])
def test_stencil_partition_and_split_are_jax_bitwise(nshards):
    row, col, val, shape = _stencil()
    jp = jd.plan_partition(row, col, val, shape, nshards)
    tp = td.plan_partition(row, col, val, shape, nshards)
    assert tp.to_json() == jp.to_json()
    jl, jr = jd.partition_execute_jit(row, col, val, plan=jp)
    tl, tr = td.partition_execute(row, col, val, tp, device=DEV)
    _same(jl, tl, "local")
    _same(jr, tr, "remote")
    caps = td._split_caps(row, col, val, tp.mp, nshards)
    assert caps == jd._split_caps(row, col, val, jp.mp, nshards)
    if nshards > 1:
        ji, jb = jd.split_local_execute_jit(jl, jr, mp=jp.mp, icap=caps[0], bcap=caps[1])
        ti, tb = td.split_local_execute(tl, tr, tp.mp, *caps)
        _same(ji, ti, "interior")
        _same(jb, tb, "boundary")
    # the analytic slab plan is the scanned one plus the split caps
    slab = hpcg.slab_plan(hpcg.generate_problem(8, 8, 16), nshards)
    assert slab.to_json() == jhpcg.slab_plan(jhpcg.generate_problem(8, 8, 16),
                                             nshards).to_json()
    assert slab.local_cap == tp.local_cap and slab.hw == (0 if nshards == 1 else 64)


@pytest.mark.parametrize("name", ["random", "banded", "block_diag"])
def test_general_partitions_are_jax_bitwise(name):
    row, col, val, shape = MATRICES[name]()
    jp, tp, pairs = _parts_both(row, col, val, shape, 4)
    assert tp.to_json() == jp.to_json()
    assert tp.halo_mode == {"random": "gather", "banded": "neighbor",
                            "block_diag": "neighbor"}[name]
    assert tp.remote_empty == (name == "block_diag") and (tp.hw == 0) == tp.remote_empty
    for k, (jc, tc) in enumerate(pairs):
        _same(jc, tc, f"{name} part {k}")


def test_stale_plan_raises_like_jax():
    row, col, val, shape = _stencil()
    plan = td.plan_partition(row, col, val, shape, 4)
    for bad in (dataclasses.replace(plan, local_cap=plan.local_cap - 1),
                dataclasses.replace(plan, hw=plan.hw - 1),
                dataclasses.replace(plan, interior_cap=1, boundary_cap=1)):
        jbad = jd.DistPlan.from_json(bad.to_json())
        with pytest.raises(ValueError, match="stale DistPlan") as te:
            td._check_plan_fits(row, col, bad, val=val)
        with pytest.raises(ValueError) as je:
            jd._check_plan_fits(row, col, jbad, val=val)
        assert str(te.value) == str(je.value)
        with pytest.raises(ValueError, match="stale DistPlan"):
            td.build_dist_matrix(row, col, val, shape, 4, device=DEV, plan=bad)


# ---------------------------------------------------------------------------
# Batched plan / convert / select
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ALL_FORMATS, ids=lambda f: f.name)
def test_batched_plans_and_conversions_are_jax_bitwise(fmt):
    row, col, val, shape = _stencil()
    _, _, pairs = _parts_both(row, col, val, shape, 4)
    kw = {"block_size": 8} if fmt == Format.BSR else {}
    for k, (jc, tc) in enumerate(pairs):
        jpl = jconv.plan_switch_batch(jc, fmt, **kw)
        tpl = tconv.plan_switch_batch(tc, fmt, **kw)
        assert tpl.to_json() == jpl.to_json(), (k, fmt)
        _same(jconv.convert_execute_batch(jc, jpl), tconv.convert_execute_batch(tc, tpl),
              f"part {k} {fmt.name}")


def test_batched_plans_on_a_gather_part_are_jax_bitwise():
    _, _, pairs = _parts_both(*_random(), 4)
    for jc, tc in pairs:
        for fmt in (Format.DIA, Format.ELL, Format.SELL, Format.HYB):
            jpl, tpl = jconv.plan_switch_batch(jc, fmt), tconv.plan_switch_batch(tc, fmt)
            assert tpl.to_json() == jpl.to_json()
            _same(jconv.convert_execute_batch(jc, jpl), tconv.convert_execute_batch(tc, tpl))


def test_batched_ell_overflow_and_dia_union_match_jax():
    row, col, val, shape = _banded()
    _, _, pairs = _parts_both(row, col, val, shape, 4)
    jb, tb = pairs[1]  # boundary: rows hold 1-3 live entries
    with pytest.raises(ValueError) as je:
        jconv.plan_switch_batch(jb, Format.ELL, k=1)
    with pytest.raises(ValueError, match="of part") as te:
        tconv.plan_switch_batch(tb, Format.ELL, k=1)
    assert str(te.value) == str(je.value)
    # each shard's boundary holds some of the diagonals: the plan unions them
    tpl = tconv.plan_switch_batch(tb, Format.DIA)
    per_part = set()
    for p in range(4):
        live = tb.data[p] != 0
        per_part |= set((tb.col[p][live] - tb.row[p][live]).tolist())
    assert tpl.dia_offsets == tuple(sorted(per_part))
    assert tpl.to_json() == jconv.plan_switch_batch(jb, Format.DIA).to_json()


@pytest.mark.parametrize("mode", ["ml", "analytic"])
def test_select_batch_on_the_parts_gives_jax_ids(mode):
    for name in ("stencil", "random"):
        _, _, pairs = _parts_both(*MATRICES[name](), 4)
        for jc, tc in pairs:
            want = np.asarray(JPolicy(mode).select_batch(jc))
            got = FormatPolicy(mode).select_batch(tc)
            np.testing.assert_array_equal(got, want)


def test_build_batched_union_and_per_part_view():
    _, _, pairs = _parts_both(*_stencil(), 4)
    jc, tc = pairs[0]
    from repro.core.dynamic import SwitchDynamicMatrix as JSwitch
    from repro_torch.core.dynamic import SwitchDynamicMatrix
    ids = [0, 2, 3, 1]
    ju = JSwitch.build_batched(jc, CANDIDATES, active_ids=np.asarray(ids, np.int32))
    tu = SwitchDynamicMatrix.build_batched(tc, CANDIDATES, active_ids=ids)
    assert tu.batched and tu.active_id == tuple(ids) and tu.candidates == CANDIDATES
    for jv, tv in zip(ju.variants, tu.variants):
        _same(jv, tv)
    assert tu.part(1).format == Format.DIA and tu.part(1).shape == tc.shape
    np.testing.assert_array_equal(to_numpy(tu.part(1))["data"],
                                  np.asarray(ju.variants[2].data)[1])
    assert tu.activate(Format.CSR).active_id == (1,) * 4
    assert tu.activate_id(3).active_id == (3,) * 4
    assert tu.activate_id([4, 4, 0, 0]).active == (Format.SELL,) * 2 + (Format.COO,) * 2
    with pytest.raises(ValueError, match="4 ids"):
        tu.activate_id([1, 2])
    assert SwitchDynamicMatrix.build_batched(tc, (Format.CSR,)).active_id == (0,) * 4


def test_planned_pulls_of_a_batched_build_match_jax_and_not_p(tmp_path):
    """The split scatter plus per-part batched selection and conversion
    make as many planned pulls as JAX's, whatever the shard count."""
    from repro.core.convert import planned_pulls_scope as jscope

    row, col, val, shape = _stencil(4, 4, 8)
    cands = (Format.COO, Format.CSR, Format.DIA, Format.ELL)
    counts = {}
    for nshards in (2, 8):
        jpol = JPolicy("cached", candidates=cands, cache=JCache(str(tmp_path / f"j{nshards}")))
        tpol = FormatPolicy("cached", candidates=cands,
                            cache=SelectionCache(str(tmp_path / f"t{nshards}")))
        with jscope() as js:
            _, _, jpairs = _parts_both(row, col, val, shape, nshards)
            for jc, _ in jpairs:
                jpol.select_batch(jc)
                for f in cands:
                    jconv.convert_execute_batch(jc, jconv.plan_switch_batch(jc, f))
        with planned_pulls_scope() as ts:
            for _, tc in jpairs:
                tpol.select_batch(tc)
                for f in cands:
                    tconv.convert_execute_batch(tc, tconv.plan_switch_batch(tc, f))
        counts[nshards] = (ts.count, js.count)
    assert counts[2] == counts[8] and counts[2][0] == counts[2][1], counts


# ---------------------------------------------------------------------------
# DistPlan persistence
# ---------------------------------------------------------------------------


def _enriched_jax_plan(row, col, val, shape, nshards):
    jp, _, pairs = _parts_both(row, col, val, shape, nshards)
    caps = jd._split_caps(row, col, val, jp.mp, nshards)
    jp = dataclasses.replace(jp, interior_cap=caps[0], boundary_cap=caps[1],
                             pattern_sig=jd._pattern_sig(row, col, val))
    (ji, _), (jb, _), (jr, _) = pairs
    return jd.plan_dist_formats(ji, jr, jp, CANDIDATES, boundary=jb)


def test_dist_plan_json_is_string_identical_both_ways():
    row, col, val, shape = _stencil()
    jplan = _enriched_jax_plan(row, col, val, shape, 4)
    s = jplan.to_json()
    tplan = td.DistPlan.from_json(s)
    assert tplan.to_json() == s
    assert jd.DistPlan.from_json(tplan.to_json()) == jplan
    assert tplan.interior_plans[2].target == Format.DIA
    bare = td.plan_partition(row, col, val, shape, 8)
    assert td.DistPlan.from_json(bare.to_json()) == bare
    assert jd.DistPlan.from_json(bare.to_json()).to_json() == bare.to_json()
    assert td._pattern_sig(row, col, val) == jd._pattern_sig(row, col, val)


def test_a_jax_written_distplan_record_is_a_hit(tmp_path):
    row, col, val, shape = _stencil()
    jplan = _enriched_jax_plan(row, col, val, shape, 4)
    path = str(tmp_path / "plans.json")
    key = f"distplan:{jd._pattern_sig(row, col, val)}|{shape[0]}x{shape[1]}|P4|auto"
    JCache(path).put_raw(key, jplan.to_json())
    with metrics.scope() as s:
        A = td.build_dist_matrix(row, col, val, shape, 4, device=DEV, mode="multiformat",
                                 tune="analytic", plan_cache=SelectionCache(path))
        assert s.delta("distplan.cache_hit") == 1 and s.delta("distplan.cache_miss") == 0
    assert A.plan.to_json() == jplan.to_json()
    # and a port-written record is read back by JAX
    path2 = str(tmp_path / "plans2.json")
    with metrics.scope() as s:
        B = td.build_dist_matrix(row, col, val, shape, 4, device=DEV, mode="multiformat",
                                 tune="analytic", plan_cache=SelectionCache(path2))
        assert s.delta("distplan.cache_miss") == 1
    assert jd.DistPlan.from_json(JCache(path2).get_raw(key)) == jplan
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape[0]).astype(np.float32))
    torch.testing.assert_close(td.dist_spmv(A, x), td.dist_spmv(B, x), rtol=0, atol=0)


def test_a_changed_live_pattern_replans():
    row, col, val, shape = _stencil()
    A = td.build_dist_matrix(row, col, val, shape, 4, device=DEV, mode="multiformat",
                             tune="analytic")
    assert A.plan.interior_plans is not None and A.plan.pattern_sig is not None
    val2 = val.copy()
    val2[(row != col) & (row % 7 == 0)] = 0  # drop live entries: same caps, new pattern
    with metrics.scope() as s:
        B = td.build_dist_matrix(row, col, val2, shape, 4, device=DEV, mode="multiformat",
                                 tune="analytic", plan=A.plan)
        assert s.delta("replan.pattern_sig") == 1
    assert B.plan.pattern_sig == td._pattern_sig(row, col, val2) != A.plan.pattern_sig
    with metrics.scope() as s:  # the same pattern reuses the memoised plans
        td.build_dist_matrix(row, col, val2, shape, 4, device=DEV, mode="multiformat",
                             tune="analytic", plan=B.plan)
        assert s.delta("replan.pattern_sig") == 0
    x = torch.ones(shape[0])
    y = td.dist_spmv(B, x).double().numpy()
    want = _dense(row, col, val2, shape) @ np.ones(shape[0])
    assert np.abs(y - want).max() <= SPMV_TOL * np.abs(want).max()


def test_a_policy_outside_the_candidates_raises():
    row, col, val, shape = _stencil()
    with pytest.raises(ValueError, match="subset of the build candidates"):
        td.build_dist_matrix(row, col, val, shape, 4, device=DEV, mode="multiformat",
                             candidates=(Format.CSR, Format.DIA),
                             tune=FormatPolicy("ml", candidates=(Format.CSR, Format.ELL)))
    # a subset maps onto the build's variant indices
    A = td.build_dist_matrix(row, col, val, shape, 4, device=DEV, mode="multiformat",
                             tune=FormatPolicy("analytic", candidates=(Format.ELL,)))
    assert A.formats("local") == ("ELL",) * 4 and A.local.candidates == CANDIDATES


# ---------------------------------------------------------------------------
# dist_spmv and the solve
# ---------------------------------------------------------------------------


SPMV_CASES = [("uniform", Format.DIA, Format.COO), ("uniform", Format.CSR, Format.CSR),
              ("uniform", Format.SELL, Format.ELL), ("multiformat", None, None)]


@pytest.mark.parametrize("split", [True, False], ids=["split", "unsplit"])
@pytest.mark.parametrize("case", SPMV_CASES, ids=lambda c: c[0] + ("-" + c[1].name if c[1]
                                                                    else ""))
def test_dist_spmv_matches_float64_and_jax_single_device(case, split):
    mode, lf, rf = case
    row, col, val, shape = _stencil()
    x = np.random.default_rng(1).standard_normal(shape[0]).astype(np.float32)
    want = _dense(row, col, val, shape) @ x.astype(np.float64)
    jA = jconv.convert(jhpcg.to_coo(jhpcg.generate_problem(8, 8, 16)), Format.CSR)
    y_jax = np.asarray(jops.spmv(jA, jnp.asarray(x), backend="ref"))
    kw = dict(local_format=lf, remote_format=rf) if lf else dict(tune="ml")
    for nshards in (2, 4, 8):
        A = td.build_dist_matrix(row, col, val, shape, nshards, device=DEV, mode=mode,
                                 split=split, **kw)
        assert A.split == split
        with metrics.scope() as s:
            y = td.dist_spmv(A, torch.from_numpy(x)).numpy()
            assert s.delta("halo.bytes") == nshards * 2 * 64 * 4
        scale = np.abs(want).max()
        assert np.abs(y - want).max() <= SPMV_TOL * scale
        assert np.abs(y - y_jax).max() <= SPMV_TOL * scale


@pytest.mark.parametrize("name", ["random", "banded", "block_diag"])
def test_dist_spmv_on_general_partitions(name):
    row, col, val, shape = MATRICES[name]()
    x = np.random.default_rng(2).standard_normal(shape[0]).astype(np.float32)
    want = _dense(row, col, val, shape) @ x.astype(np.float64)
    for mode in ("uniform", "multiformat"):
        A = td.build_dist_matrix(row, col, val, shape, 4, device=DEV, mode=mode,
                                 tune="analytic")
        with metrics.scope() as s:
            y = td.dist_spmv(A, torch.from_numpy(x)).double().numpy()
            assert (s.delta("halo.bytes") == 0) == A.remote_empty
        assert np.abs(y - want).max() <= SPMV_TOL * np.abs(want).max(), (name, mode)


def test_halo_gather_matches_the_host_partitioner():
    """The gathered halo, with zeros where an edge shard has no neighbour,
    feeds each shard's remote triplets the x values partition_coo names."""
    for name in ("stencil", "banded", "random"):
        row, col, val, shape = MATRICES[name]()
        A = td.build_dist_matrix(row, col, val, shape, 4, device=DEV)
        host = td.partition_coo(row, col, val, shape, 4)
        x = torch.arange(1, shape[0] + 1, dtype=torch.float32)
        halo = td._halo(A, x)
        for p in range(4):
            rr, rc, rv = host.remote[p]
            hp = td._remote_in(A, halo, p)
            gc = col[(row // A.mp == p) & (col // A.mp != p)]
            np.testing.assert_array_equal(hp[torch.from_numpy(rc)].numpy(), x[gc].numpy())
        if A.halo_mode == "neighbor":
            assert not halo[0, :A.hw].any() and not halo[-1, A.hw:].any()
            assert halo.shape == (4, 2 * A.hw)


def test_dist_spmv_phases_add_up():
    row, col, val, shape = _stencil()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape[0]).astype(np.float32))
    for mode in ("uniform", "multiformat"):
        A = td.build_dist_matrix(row, col, val, shape, 4, device=DEV, mode=mode, tune="ml",
                                 local_format=Format.CSR, remote_format=Format.COO)
        ph = {p: td.dist_spmv_phase(A, x, p) for p in td.PHASES}
        torch.testing.assert_close(ph["local"] + ph["exchange"], ph["full"],
                                   rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(ph["interior"] + ph["boundary"], ph["local"],
                                   rtol=1e-6, atol=1e-5)
        assert torch.equal(ph["full"], td.dist_spmv(A, x))
    U = td.build_dist_matrix(row, col, val, shape, 4, device=DEV, split=False)
    with pytest.raises(ValueError, match="needs a split matrix"):
        td.dist_spmv_phase(U, x, "interior")
    with pytest.raises(ValueError, match="not in"):
        td.dist_spmv_phase(U, x, "halo")


def test_activate_dist_roundtrips():
    row, col, val, shape = _stencil()
    A = td.build_dist_matrix(row, col, val, shape, 4, device=DEV, mode="multiformat",
                             tune="ml")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(shape[0]).astype(np.float32))
    y0 = td.dist_spmv(A, x)
    ids0 = A.local.active_id
    B = td.activate_dist(A, "local", Format.CSR)
    assert B.formats("local") == ("CSR",) * 4 and B.formats("remote") == A.formats("remote")
    torch.testing.assert_close(td.dist_spmv(B, x), y0, rtol=1e-5, atol=1e-5)
    C = td.activate_dist(B, "local", ids0)
    assert torch.equal(td.dist_spmv(C, x), y0)
    D = td.activate_dist(td.activate_dist(A, "boundary", 3), "remote", [0, 1, 0, 1])
    assert D.formats("boundary") == ("ELL",) * 4
    assert D.formats("remote") == ("COO", "CSR", "COO", "CSR")
    torch.testing.assert_close(td.dist_spmv(D, x), y0, rtol=1e-5, atol=1e-5)
    U = td.build_dist_matrix(row, col, val, shape, 4, device=DEV)
    with pytest.raises(TypeError, match="multiformat"):
        td.activate_dist(U, "local", Format.CSR)
    with pytest.raises(ValueError, match="no boundary"):
        td.activate_dist(td.build_dist_matrix(row, col, val, shape, 4, device=DEV,
                                              mode="multiformat", tune="ml", split=False),
                         "boundary", 0)


@pytest.mark.parametrize("grid,nshards", [((8, 8, 16), 4), ((8, 8, 16), 8), ((16, 16, 16), 4)])
@pytest.mark.parametrize("mode", ["uniform", "multiformat"])
def test_dist_cg_within_one_iteration_of_jax_single_device(grid, nshards, mode):
    prob = hpcg.generate_problem(*grid)
    plan = hpcg.slab_plan(prob, nshards)
    A = td.build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, nshards, device=DEV,
                             mode=mode, tune="ml", local_format=Format.DIA,
                             remote_format=Format.COO, plan=plan, check_plan=False)
    b = torch.from_numpy(hpcg.rhs_for_ones(prob))
    res = cg(operator(A), b, tol=1e-6, maxiter=500)
    jprob = jhpcg.generate_problem(*grid)
    jA = jconv.convert(jhpcg.to_coo(jprob), Format.CSR)
    jres = jsol.cg(lambda v: jops.spmv(jA, v, backend="ref"),
                   jnp.asarray(jhpcg.rhs_for_ones(jprob)), tol=1e-6, maxiter=500)
    assert abs(res.iters - int(jres.iters)) <= 1
    assert float((res.x - 1).abs().max()) < 1e-3


def test_build_from_partition_problem_parts_and_device_default(monkeypatch):
    prob = hpcg.generate_problem(8, 8, 16)
    local, remote, plan = hpcg.partition_problem(prob, 4, device=DEV)
    A = td.build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, 4, device=DEV,
                             plan=plan, check_plan=False, parts=(local, remote))
    B = td.build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, 4, device=DEV)
    x = torch.ones(prob.shape[0])
    assert torch.equal(td.dist_spmv(A, x), td.dist_spmv(B, x))
    with pytest.raises(ValueError, match="do not match"):
        td.build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, 4, device=DEV,
                             plan=plan, parts=(remote, local))
    with pytest.raises(ValueError, match="nz % P"):
        hpcg.slab_plan(prob, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, 4)
    assert td.distribute_vector(np.ones(4), DEV, torch.float32).dtype == torch.float32
