"""The port stands alone: genparticlefilters_tpu_torch and chip_smoke.py
never import JAX or the JAX package, and every module of the port imports
on a machine without a GPU, triton or nvcc."""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

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
                 "parallel.mesh",
                 "smc.translate", "utils.stratification",
                 "models.stochastic_volatility", "models.tempered",
                 "utils.device", "utils.checkpoint", "utils.profiling",
                 "config", "smc.capture", "ops.graph_cond",
                 "ops.max_scan"):
        assert f"genparticlefilters_tpu_torch.{name}" in names
    for name in names:
        importlib.import_module(name)


#: the JAX package's public names the port leaves out, with the reason
NOT_PORTED = {}


def test_every_public_name_of_the_jax_package_is_ported():
    """Every name in the JAX package's ``__all__`` lists (core, smc,
    core/batching.py, utils, config) exists in the port's counterpart."""
    pytest.importorskip("jax")
    import genparticlefilters_tpu.config as jcfg
    import genparticlefilters_tpu.core as jcore
    import genparticlefilters_tpu.core.batching as jbatch
    import genparticlefilters_tpu.parallel as jpar
    import genparticlefilters_tpu.smc as jsmc
    import genparticlefilters_tpu.utils as jutils
    import genparticlefilters_tpu_torch as tg
    import genparticlefilters_tpu_torch.config as tcfg
    import genparticlefilters_tpu_torch.core.batching as tbatch
    import genparticlefilters_tpu_torch.utils as tutils
    pairs = [(jcore.__all__, tg.core), (jsmc.__all__, tg.smc),
             (jbatch.__all__, tbatch), (jutils.__all__, tutils),
             (jpar.__all__, tg.parallel),
             ([n for n in vars(jcfg) if not n.startswith("_") and n not in (
                 "annotations", "contextlib", "clustered_gather",
                 "use_clustered_gather")], tcfg)]
    missing = [n for names, mod in pairs for n in names
               if not hasattr(mod, n) and n not in NOT_PORTED]
    assert not missing, missing
    # the parallel layer exports the JAX package's names, and only those
    assert sorted(tg.parallel.__all__) == sorted(jpar.__all__)
    assert tg.parallel.mesh.PARTICLE_AXIS == "p"
    # the config names JAX keeps for its Pallas path are left out on
    # purpose (README): the port's gathers pick their route by device
    assert not hasattr(tcfg, "use_clustered_gather")


@pytest.mark.parametrize("model", ["object_motion", "linear_gaussian",
                                   "stochastic_volatility", "tempered",
                                   "multi_object"])
def test_every_public_model_name_of_the_jax_package_is_ported(model):
    """Each model module of the port exports every name of its JAX
    counterpart's ``__all__`` (object motion's ``object_motion_filter_impl``
    and ``obs_at_t`` and linear Gaussian's ``lg_obs_at_t`` among them)."""
    pytest.importorskip("jax")
    jmod = importlib.import_module(f"genparticlefilters_tpu.models.{model}")
    tmod = importlib.import_module(
        f"genparticlefilters_tpu_torch.models.{model}")
    missing = [n for n in jmod.__all__ if n not in tmod.__all__
               or not hasattr(tmod, n)]
    assert not missing, missing


def test_new_modules_import_without_jax_or_triton():
    """ops/gather, smc/resize, smc/translate, smc/update,
    utils/stratification, utils/device, utils/checkpoint,
    utils/profiling, config, core/batching, core/gfi and core/combinators
    (with MapCombinator), interop, the multi-object, stochastic-volatility
    and tempered models, parallel (with the mesh), smc/capture (with the
    object-motion model's compiled driver) and ops/graph_cond import in a
    fresh interpreter where jax and triton cannot be imported."""
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
        "import genparticlefilters_tpu_torch.parallel.mesh\n"
        "from genparticlefilters_tpu_torch.parallel import (particle_mesh,\n"
        "    shard_state, state_sharding, state_pspecs,\n"
        "    replicated_sharding)\n"
        "import genparticlefilters_tpu_torch.core.combinators\n"
        "import genparticlefilters_tpu_torch.core.gfi\n"
        "import genparticlefilters_tpu_torch.smc.update\n"
        "import genparticlefilters_tpu_torch.interop\n"
        "import genparticlefilters_tpu_torch.utils.device\n"
        "import genparticlefilters_tpu_torch.utils.checkpoint\n"
        "import genparticlefilters_tpu_torch.utils.profiling\n"
        "import genparticlefilters_tpu_torch.config\n"
        "import genparticlefilters_tpu_torch.core.batching\n"
        "from genparticlefilters_tpu_torch import (mvnormal, student_t,\n"
        "    NONE, batched_choice_entry)\n"
        "from genparticlefilters_tpu_torch.core.batching import vmap_gfi\n"
        "from genparticlefilters_tpu_torch.utils import save_state, Timer\n"
        "from genparticlefilters_tpu_torch import MapCombinator, propose\n"
        "import genparticlefilters_tpu_torch.smc.capture\n"
        "from genparticlefilters_tpu_torch import device_cond, capture\n"
        "from genparticlefilters_tpu_torch.ops.graph_cond import (\n"
        "    if_node, capture_body, versions)\n"
        "from genparticlefilters_tpu_torch.models.object_motion import (\n"
        "    object_motion_filter_impl, object_motion_filter_captured,\n"
        "    obs_at_t)\n"
        "from genparticlefilters_tpu_torch.models.linear_gaussian import (\n"
        "    lg_obs_at_t)\n"
        "assert not any(m.split('.')[0] in ('jax', 'triton')\n"
        "               for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
