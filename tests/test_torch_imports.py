"""The port runs where there is no JAX: neither `repro_torch` nor
`chip_smoke.py` imports `jax` or anything of the JAX package `repro`."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SMOKE = REPO / "chip_smoke.py"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)(\.|\s|,|$)|from\s+(jax|repro)(\.|\s))",
    re.MULTILINE)


def _port_modules():
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch.")]


SLICE_MODULES = (  # the serving, trainer, simulator, generation and mesh
                   # slices
    "repro_torch.serve.engine", "repro_torch.kernels.ops",
    "repro_torch.core.topology", "repro_torch.core.hierarchy",
    "repro_torch.core.prng", "repro_torch.core.protocol",
    "repro_torch.core.mllsgd", "repro_torch.core.simulator",
    "repro_torch.core.timeline", "repro_torch.optim.optimizers",
    "repro_torch.data.pipeline", "repro_torch.train.train_step",
    "repro_torch.train.checkpoint", "repro_torch.launch.harness",
    "repro_torch.launch.train", "repro_torch.interop", "repro_torch.tree",
    "repro_torch.core.packing", "repro_torch.core.baselines",
    "repro_torch.core.outer", "repro_torch.kernels.hier_mix",
    "repro_torch.serve.serve_step", "repro_torch.models.mamba",
    "repro_torch.models.moe", "repro_torch.launch.mesh",
    "repro_torch.core.collectives")


def test_every_module_of_the_port_is_checked():
    """The import checks below walk the whole package, the trainer's
    modules included."""
    found = set(_port_modules())
    assert set(SLICE_MODULES) <= found, sorted(set(SLICE_MODULES) - found)


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    code = (
        "import importlib, importlib.util, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(SMOKE)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax_import():
    sources = sorted(PORT.rglob("*.py")) + [SMOKE]
    assert len(sources) > 10
    for path in sources:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"


def test_forbidden_pattern_catches_the_import_forms():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.models import model", "import repro.serve",
                 "  from repro import kernels"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.models import model",
                 "import jaxtyping_free_name as x"):
        assert not FORBIDDEN.search(line), line
