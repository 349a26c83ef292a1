"""The port stands alone: genparticlefilters_tpu_torch and chip_smoke.py
never import JAX or the JAX package, and every module of the port imports
on a machine without a GPU, triton or nvcc."""

import importlib
import pkgutil
import re
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
    assert "genparticlefilters_tpu_torch.ops.fused_gather" in names
    for name in names:
        importlib.import_module(name)
