"""The port stands alone: genparticlefilters_tpu_torch and chip_smoke.py
never import JAX or the JAX package, and every module of the port imports
on a machine without a GPU, triton or nvcc."""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "genparticlefilters_tpu_torch"
_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+"
                  r"genparticlefilters_tpu\b(?!_)|from\s+"
                  r"genparticlefilters_tpu\b(?!_))", re.M)


def test_no_jax_import():
    paths = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(paths) > 10
    bad = {str(p.relative_to(ROOT)): _JAX.findall(p.read_text())
           for p in paths}
    assert not any(bad.values()), {k: v for k, v in bad.items() if v}


def test_every_module_imports():
    import genparticlefilters_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in ("ops.fused_gather", "ops.gather", "smc.resize",
                 "models.multi_object", "parallel", "parallel.distributed",
                 "smc.translate", "utils.stratification",
                 "models.stochastic_volatility", "models.tempered",
                 "utils.device"):
        assert f"genparticlefilters_tpu_torch.{name}" in names
    for name in names:
        importlib.import_module(name)


def test_new_modules_import_without_jax_or_triton():
    """ops/gather, smc/resize, smc/translate, smc/update,
    utils/stratification, utils/device, core/gfi and core/combinators
    (with MapCombinator), interop, the multi-object, stochastic-volatility
    and tempered models and parallel import in a fresh interpreter where
    jax and triton cannot be imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'triton'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import genparticlefilters_tpu_torch.ops.gather\n"
        "import genparticlefilters_tpu_torch.smc.resize\n"
        "import genparticlefilters_tpu_torch.models.multi_object\n"
        "import genparticlefilters_tpu_torch.models.stochastic_volatility\n"
        "import genparticlefilters_tpu_torch.models.tempered\n"
        "import genparticlefilters_tpu_torch.smc.translate\n"
        "import genparticlefilters_tpu_torch.utils.stratification\n"
        "import genparticlefilters_tpu_torch.parallel\n"
        "import genparticlefilters_tpu_torch.core.combinators\n"
        "import genparticlefilters_tpu_torch.core.gfi\n"
        "import genparticlefilters_tpu_torch.smc.update\n"
        "import genparticlefilters_tpu_torch.interop\n"
        "import genparticlefilters_tpu_torch.utils.device\n"
        "from genparticlefilters_tpu_torch import MapCombinator, propose\n"
        "assert not any(m.split('.')[0] in ('jax', 'triton')\n"
        "               for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
