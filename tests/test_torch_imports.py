"""Import hygiene of the PyTorch port: it never imports JAX or the JAX
package, not even a JAX-free module there; it keeps its own copies."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$|,)", re.M)


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from repro.core import ops", "import repro.core.ops", "  from repro import x",
                "import repro"):
        assert FORBIDDEN.search(bad), bad
    for good in ("import repro_torch", "from repro_torch.core import ops",
                 "# the JAX package (repro.core.ops)", "import torch"):
        assert not FORBIDDEN.search(good), good


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_source_imports_neither_jax_nor_repro(path):
    with open(path) as f:
        hits = [m.group(0).strip() for m in FORBIDDEN.finditer(f.read())]
    assert not hits, f"{os.path.relpath(path, ROOT)}: {hits}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(n for n in sys.modules if n.startswith('repro_torch'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    loaded = set(p.stdout.split())
    assert len(loaded) >= 20  # every module of the port was imported
    assert {"repro_torch.core.autotune", "repro_torch.kernels.ell_spmv",
            "repro_torch.kernels.sell_spmv", "repro_torch.kernels.bsr_spmm",
            "repro_torch.tuning.engines", "repro_torch.kernels.csr_spmm",
            "repro_torch.kernels.ell_spmm", "repro_torch.kernels.sell_spmm",
            "repro_torch.models", "repro_torch.models.linear_sparse",
            "repro_torch.tuning.cache", "repro_torch.tuning.kernel_tune",
            "repro_torch.core.distributed", "repro_torch.mg.dist",
            "repro_torch.configs", "repro_torch.configs.registry",
            "repro_torch.configs.shapes", "repro_torch.configs.minitron_8b",
            "repro_torch.configs.stablelm_1_6b", "repro_torch.models.spec",
            "repro_torch.models.layers", "repro_torch.models.flash",
            "repro_torch.models.attention", "repro_torch.models.sharding_ctx",
            "repro_torch.models.transformer", "repro_torch.models.model",
            "repro_torch.models.weights", "repro_torch.launch",
            "repro_torch.launch.serve", "repro_torch.models.moe",
            "repro_torch.models.mamba2", "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.configs.llama4_scout_17b_a16e", "repro_torch.configs.mamba2_2_7b",
            "repro_torch.configs.zamba2_2_7b", "repro_torch.configs.internvl2_26b",
            "repro_torch.configs.hubert_xlarge", "repro_torch.data.pipeline",
            "repro_torch.optim.adamw", "repro_torch.optim.grad_compress",
            "repro_torch.checkpoint.ckpt", "repro_torch.launch.train",
            "repro_torch.train_moe_sparse", "repro_torch.serve_decode",
            "repro_torch.env", "repro_torch.core.compat", "repro_torch.launch.mesh",
            "repro_torch.launch.sharding", "repro_torch.launch.dryrun",
            "repro_torch.launch.pipeline"} <= loaded


def test_every_arch_config_is_the_ports_own():
    """``get_config`` loads the port's copy of each architecture file."""
    code = (
        "import sys\n"
        "from repro_torch.configs import get_config, list_archs\n"
        "for a in list_archs():\n"
        "    get_config(a); get_config(a, smoke=True)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=120)
    assert p.returncode == 0, p.stderr
