"""The port's launch plumbing against the JAX package's: sharding rules,
batch and cache specs, input specs, the dry-run's policy and per-device
argument bytes on both production meshes, the mesh helpers, the train
entry point's meshes, and the process settings (``repro_torch.env``).

JAX's side gets a ``FakeMesh`` (``.shape``, ``.axis_names``), as
``tests/test_launch.py`` gives it: its rules read nothing else, so no
512-device process is needed. JAX's ``build_step`` runs with ``jax.jit`` and
``NamedSharding`` stood in by recorders, which gives its abstract arguments
and their partition specs without a compile.
"""
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import repro.launch.sharding as jshd
from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import input_specs as jinput_specs
from repro.configs.shapes import skip_reason as jskip_reason
from repro.configs.shapes import token_input_specs as jtoken_input_specs
from repro.launch import mesh as jmesh
from repro.models import build_model as jbuild_model
from repro.models.spec import P as JSpecP
from repro_torch import env
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, input_specs, skip_reason, token_input_specs
from repro_torch.core.compat import PartitionSpec, leading_axis_spec
from repro_torch.launch import dryrun, mesh as tmesh, sharding as shd, train
from repro_torch.models import build_model, sharding_ctx
from repro_torch.models.spec import P as SpecP
from torch_training import one_torch_thread  # noqa: F401  (autouse)

ARCHS = list_archs()
MESHES = {"pod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16))}
CELLS = [(a, s, m) for a in ARCHS for s in SHAPES for m in MESHES]
LIVE_CELLS = [c for c in CELLS if not skip_reason(get_config(c[0]), c[1])]
DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.int8): torch.int8}


class FakeMesh:
    def __init__(self, axes, sizes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, sizes))


def _meshes(name):
    axes, sizes = MESHES[name]
    return FakeMesh(axes, sizes), tmesh.make_mesh(sizes, axes)


def _flat(tree, path=()):
    """{path: leaf} of a nested dict (JAX's trees are dicts here too)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {path: tree}


def _same_pspecs(port_tree, jax_tree):
    got, want = _flat(port_tree), _flat(jax_tree)
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], PartitionSpec), k
        assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])


def _same_shapes(port_tree, jax_tree):
    got, want = _flat(port_tree), _flat(jax_tree)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == DTYPES[jnp.dtype(want[k].dtype)], k


# ---------------------------------------------------------------------------
# Sharding rules, batch and cache specs
# ---------------------------------------------------------------------------

RULES = ["train", "decode", "serve_large"]


def _rules(pkg, name):
    mod = jshd if pkg == "jax" else shd
    if name == "train":
        return mod.TRAIN_RULES
    if name == "decode":
        return mod.DECODE_RULES
    return dict(mod.DECODE_RULES, embed="data")  # the prefill/decode override > 1e10


def test_rule_tables_are_jaxs():
    assert shd.TRAIN_RULES == jshd.TRAIN_RULES
    assert shd.DECODE_RULES == jshd.DECODE_RULES


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch, rules, mesh_name):
    fake, mesh = _meshes(mesh_name)
    want = jshd.param_pspecs(jbuild_model(jget_config(arch)).specs(), fake, _rules("jax", rules))
    got = shd.param_pspecs(build_model(get_config(arch)).specs(), mesh, _rules("torch", rules))
    _same_pspecs(got, want)


@pytest.mark.parametrize("arch,shape,mesh_name", LIVE_CELLS)
def test_batch_and_cache_pspecs_match_jax(arch, shape, mesh_name):
    fake, mesh = _meshes(mesh_name)
    jcfg, cfg = jget_config(arch), get_config(arch)
    cell = SHAPES[shape]
    if cell.kind != "decode":
        labels = cell.kind == "train"
        want = jshd.batch_pspec(fake, jtoken_input_specs(jcfg, JSHAPES[shape], labels))
        got = shd.batch_pspec(mesh, token_input_specs(cfg, cell, labels))
        _same_pspecs(got, want)
        return
    jm, m = jbuild_model(jcfg), build_model(cfg)
    quant = (False, True) if cfg.family in ("dense", "moe", "vlm") else (False,)
    for q in quant:  # the bf16 and the int8 caches; hybrid's k/v beside its states
        jc = jm.cache_specs(cell.global_batch, cell.seq_len, kv_quant=q)
        c = m.cache_specs(cell.global_batch, cell.seq_len, kv_quant=q)
        _same_shapes(c, jc)
        _same_pspecs(shd.cache_pspec(mesh, c, cfg), jshd.cache_pspec(fake, jc, jcfg))


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_reasons_match_jax(arch):
    for shape in SHAPES:
        assert skip_reason(get_config(arch), shape) == jskip_reason(jget_config(arch), shape)


@pytest.mark.parametrize("arch,shape", sorted({(a, s) for a, s, _ in LIVE_CELLS}))
def test_input_specs_match_jax(arch, shape):
    jcfg, cfg = jget_config(arch), get_config(arch)
    _same_shapes(input_specs(cfg, shape), jinput_specs(jcfg, shape))
    if SHAPES[shape].kind != "decode":
        for labels in (False, True):
            _same_shapes(token_input_specs(cfg, SHAPES[shape], labels),
                         jtoken_input_specs(jcfg, JSHAPES[shape], labels))


# ---------------------------------------------------------------------------
# The dry-run: policy and per-device argument bytes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jdry():
    """JAX's dry-run module. Its import writes a 512-device ``XLA_FLAGS``;
    the backend is started first and the variable restored, so this process
    and its children keep the default device view."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


def _jax_step_args(jdry, monkeypatch, arch, shape, fake):
    """JAX's ``build_step`` arguments and ``in_shardings``, no compile."""
    import repro.launch.sharding
    monkeypatch.setattr(jdry, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(repro.launch.sharding, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: kw)
    cfg = jget_config(arch)
    kw, args = jdry.build_step(jbuild_model(cfg), cfg, shape, fake)
    return args, kw["in_shardings"]


def _jax_part_bytes(args, pspecs, fake):
    """The dry-run's formula on JAX's leaves: bytes over the product of the
    sizes of the axes each spec shards."""
    leaves = jax.tree.leaves(args)
    specs = jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(specs)
    total = 0
    for a, ps in zip(leaves, specs):
        n = 1
        for e in ps:
            for ax in (e if isinstance(e, tuple) else (e,)):
                n *= fake.shape[ax] if ax is not None else 1
        total += math.prod(a.shape) * jnp.dtype(a.dtype).itemsize // n
    return total


@pytest.mark.parametrize("arch,shape,mesh_name", CELLS)
def test_dryrun_cell_matches_jax(jdry, monkeypatch, arch, shape, mesh_name):
    fake, mesh = _meshes(mesh_name)
    before = sharding_ctx.get_policy()
    rec = dryrun.cell_record(arch, shape, mesh_name == "multipod", save=False, verbose=False)
    assert sharding_ctx.get_policy() == before  # recorded, never set
    jcfg, cell = jget_config(arch), JSHAPES[shape]
    assert rec["skip"] == jskip_reason(jcfg, shape)
    if rec["skip"]:
        return
    assert rec["n_params"] == jcfg.n_params()
    assert rec["n_active_params"] == jcfg.n_active_params()
    assert rec["chips"] == int(np.prod(list(fake.shape.values())))
    assert rec["tokens"] == cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    # the arguments of the set_policy call of JAX's compile_cell
    dp = tuple(a for a in ("pod", "data") if a in fake.axis_names)
    pol = rec["policy"]
    assert (pol["dp"], pol["tp"], pol["sp"]) == (
        dp if len(dp) > 1 else dp[0], "model", jdry.sp_axis(jcfg) if cell.kind == "train" else None)
    if cell.kind == "train":
        assert rec["accum_steps"] == jdry.accum_steps(jcfg, cell)
        assert dryrun.sp_axis(get_config(arch)) == jdry.sp_axis(jcfg)

    args, in_sh = _jax_step_args(jdry, monkeypatch, arch, shape, fake)
    parts = {"train": ("params", "opt_state", "batch"), "prefill": ("params", "batch"),
             "decode": ("params", "cache", "tokens", "pos")}[cell.kind]
    want = {p: _jax_part_bytes(a, s, fake) for p, a, s in zip(parts, args, in_sh)}
    want["total"] = sum(want.values())
    assert rec["argument_bytes"] == want
    # the arguments themselves: param dtype, the int8 decision, every spec
    margs, mps = dryrun.step_args(build_model(get_config(arch)), get_config(arch),
                                  SHAPES[shape], mesh)
    _same_shapes(margs["params"], args[0])
    _same_pspecs(mps["params"], in_sh[0])
    if cell.kind == "train":
        _same_shapes({"m": margs["opt_state"]["m"], "v": margs["opt_state"]["v"]},
                     {"m": args[1].m, "v": args[1].v})
        _same_pspecs(mps["batch"], in_sh[2])
    elif cell.kind == "decode":
        assert rec["kv_quant"] == (args[1]["k"].dtype == jnp.int8 if "k" in args[1] else False)
        _same_shapes(margs["cache"], args[1])
        _same_pspecs(mps["cache"], in_sh[1])
        assert tuple(mps["tokens"]) == tuple(in_sh[2]) == ()


def test_dryrun_cli_writes_its_own_records(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "stablelm_1_6b", "--shape", "train_4k",
                        "--mesh", "both"]) == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["stablelm_1_6b__train_4k__multipod.json",
                     "stablelm_1_6b__train_4k__pod.json"]
    assert "2 cells, 0 skipped" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# tests/test_launch.py's FakeMesh cases, against both packages
# ---------------------------------------------------------------------------

PKGS = {"jax": (jshd, JSpecP, jmesh), "torch": (shd, SpecP, tmesh)}


def _tensor_spec(pkg, shape, dtype_name):
    if pkg == "jax":
        return jax.ShapeDtypeStruct(shape, getattr(jnp, dtype_name))
    return torch.empty(shape, dtype=getattr(torch, dtype_name), device="meta")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_spec_to_pspec_divisibility_fallback(pkg):
    mod, SP, _ = PKGS[pkg]
    fake = FakeMesh(("data", "model"), (16, 16))
    assert tuple(mod.spec_to_pspec(SP((40, 128), ("heads", "embed")), fake,
                                   mod.TRAIN_RULES)) == (None, "data")
    assert tuple(mod.spec_to_pspec(SP((5120, 27392), ("embed", "mlp")), fake,
                                   mod.TRAIN_RULES)) == ("data", "model")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_spec_to_pspec_no_axis_reuse(pkg):
    mod, SP, _ = PKGS[pkg]
    ps = mod.spec_to_pspec(SP((16, 16, 16), ("mlp", "heads", "kv")),
                           FakeMesh(("data", "model"), (4, 4)), mod.TRAIN_RULES)
    assert list(ps) == ["model", None, None]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_batch_pspec_divisibility(pkg):
    mod = PKGS[pkg][0]
    sp = mod.batch_pspec(FakeMesh(("data", "model"), (16, 16)), {
        "tokens": _tensor_spec(pkg, (256, 128), "int32"),
        "odd": _tensor_spec(pkg, (3, 128), "int32")})
    assert tuple(sp["tokens"]) == ("data", None)
    assert tuple(sp["odd"]) == (None, None)
    sp = mod.batch_pspec(FakeMesh(("pod", "data", "model"), (2, 16, 16)),
                         {"tokens": _tensor_spec(pkg, (64, 8), "int32")})
    assert tuple(sp["tokens"]) == (("pod", "data"), None)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_cache_pspec_kv_vs_seq(pkg):
    mod = PKGS[pkg][0]
    fake = FakeMesh(("data", "model"), (16, 16))
    # kv divisible -> head sharding
    ps = mod.cache_pspec(fake, {"k": _tensor_spec(pkg, (24, 128, 4096, 32, 64), "bfloat16")},
                         None)
    assert tuple(ps["k"]) == (None, "data", None, "model", None)
    # kv NOT divisible -> sequence sharding
    ps = mod.cache_pspec(fake, {"k": _tensor_spec(pkg, (64, 128, 32768, 40, 128), "bfloat16")},
                         None)
    assert tuple(ps["k"]) == (None, "data", "model", None, None)
    # neither divides -> replicated heads and sequence; batch 3 not over data
    ps = mod.cache_pspec(fake, {"v": _tensor_spec(pkg, (2, 3, 40, 5, 8), "bfloat16"),
                                "v_scale": _tensor_spec(pkg, (2, 3, 40, 5), "bfloat16"),
                                "ssm": _tensor_spec(pkg, (2, 16, 24, 8, 4), "float32"),
                                "conv": _tensor_spec(pkg, (2, 16, 3, 40), "bfloat16"),
                                "other": _tensor_spec(pkg, (2, 16), "float32")}, None)
    assert {k: tuple(v) for k, v in ps.items()} == {
        "v": (None, None, None, None, None), "v_scale": (None, None, None, None),
        "ssm": (None, "data", None, None, None), "conv": (None, "data", None, None),
        "other": (None, None)}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_mesh_helpers(pkg):
    m = PKGS[pkg][2]
    local = m.make_mesh((1, 1), ("data", "model"))
    assert m.dp_axes(local) == ("data",)
    assert m.tp_axis(local) == "model"
    assert m.flat_axes(local) == ("data", "model")
    assert m.tp_axis(m.make_mesh((1,), ("data",))) is None


def test_production_mesh_descriptors():
    for multi_pod, axes, sizes in ((False, ("data", "model"), (16, 16)),
                                   (True, ("pod", "data", "model"), (2, 16, 16))):
        m = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert m.axis_names == axes and tuple(m.shape.values()) == sizes
        assert list(m.shape) == list(axes) and dryrun.chips(m) == math.prod(sizes)
        assert tmesh.dp_axes(m) == tuple(a for a in ("pod", "data") if a in axes)


def test_partition_spec_and_leading_axis_spec():
    assert leading_axis_spec("data", 3) == ("data", None, None)
    assert tuple(leading_axis_spec(("pod", "data"), 2)) == tuple(JP(("pod", "data"), None))
    ps = PartitionSpec(None, "model")
    assert ps == (None, "model") and repr(ps) == "PartitionSpec(None, 'model')"
    import copy
    import pickle
    assert copy.deepcopy(ps) == ps and pickle.loads(pickle.dumps(ps)) == ps
    x = torch.ones(4, 2)
    assert shd.with_dp_constraint(x, tmesh.make_mesh((1, 1), ("data", "model"))) is x


# ---------------------------------------------------------------------------
# launch/train.py's meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod,ranks", [(False, 256), (True, 512)])
def test_train_production_mesh_prints_layout_and_raises(capsys, multi_pod, ranks):
    argv = ["--arch", "stablelm_1_6b", "--mesh", "production", "--batch", "256",
            "--seq", "4096"] + (["--multi-pod"] if multi_pod else [])
    before = sharding_ctx.get_policy()
    with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
        train.main(argv)
    assert sharding_ctx.get_policy() == before
    out = capsys.readouterr().out
    assert "params/blocks/attn/wq: [None, 'data', 'model']" in out
    assert "[bytes a device] params" in out


def test_train_local_mesh_takes_its_steps(monkeypatch):
    seen = []  # the policy each step runs under
    make = train.make_train_step

    def recording(*a, **kw):
        step_fn = make(*a, **kw)

        def step(state, batch):
            seen.append(sharding_ctx.get_policy())
            return step_fn(state, batch)
        return step
    monkeypatch.setattr(train, "make_train_step", recording)
    before = sharding_ctx.get_policy()
    out = train.main(["--arch", "stablelm_1_6b", "--smoke", "--steps", "2", "--batch", "2",
                      "--seq", "16", "--log-every", "1", "--device", "cpu", "--mesh", "local"])
    assert [s for s, _ in out["losses"]] == [0, 1]
    assert all(np.isfinite(v) for _, v in out["losses"])
    # JAX's make_train_step policy on (1, 1) in every step, the caller's after
    assert seen == [sharding_ctx.Policy("data", "model", None)] * 2
    assert sharding_ctx.get_policy() == before


@pytest.mark.parametrize("kind", ["train_4k", "decode_32k"])
def test_launch_leaves_the_process_policy_as_it_was(kind):
    mine = sharding_ctx.Policy("x", "y", "z")
    with sharding_ctx.policy(mine.dp, mine.tp, mine.sp):
        rec = dryrun.cell_record("stablelm_1_6b", kind, True, save=False, verbose=False)
        assert sharding_ctx.get_policy() == mine
        with pytest.raises(ValueError, match="needs 256 ranks"):
            train.main(["--arch", "stablelm_1_6b", "--mesh", "production"])
        assert sharding_ctx.get_policy() == mine
    assert rec["policy"]["dp"] == ("pod", "data") and rec["policy"]["tp"] == "model"


# ---------------------------------------------------------------------------
# Process settings
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_env(monkeypatch):
    monkeypatch.setattr(env, "_applied", None)
    for var in (env.WORKSPACE_VAR, "REPRO_BACKEND"):  # unset now, restored after
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    return monkeypatch


@pytest.mark.parametrize("arg,var,want", [(None, None, "cuda"), (None, "CPU", "cpu"),
                                          ("CUDA", "cpu", "cuda"), ("cpu", None, "cpu")])
def test_resolve_backend(fresh_env, arg, var, want):
    if var is not None:
        fresh_env.setenv("REPRO_BACKEND", var)
    assert env.resolve_backend(arg) == want


def test_env_apply_sets_the_workspace_only_when_unset(fresh_env):
    assert env.describe()[env.WORKSPACE_VAR] is None
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    got = env.apply("cpu", host_devices=8)
    assert os.environ[env.WORKSPACE_VAR] == env.WORKSPACE
    assert got[env.WORKSPACE_VAR] == env.WORKSPACE and got["workspace_from"] == "env.apply"
    assert got["backend"] == "cpu" and got["host_devices"] == 8
    # the cpu backend leaves the TF32 switches alone, and describe reads them live
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == tf32
    assert env.describe()["tf32"] == {"matmul": tf32[0], "cudnn": tf32[1]}
    assert env.describe() == got


def test_env_apply_keeps_a_callers_workspace(fresh_env):
    fresh_env.setenv(env.WORKSPACE_VAR, ":16:8")
    got = env.apply("cpu")
    assert os.environ[env.WORKSPACE_VAR] == ":16:8"
    assert got[env.WORKSPACE_VAR] == ":16:8" and got["workspace_from"] == "caller"
    assert env.apply("cpu")[env.WORKSPACE_VAR] == ":16:8"  # idempotent
