"""Build and load the package's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``genparticlefilters_tpu_torch/_build/`` (git-ignored), named by a
hash of the source so an edited source rebuilds, and loaded with
``ctypes``. :func:`load_libraries` runs one ``nvcc`` per source, all at
once. Nothing here runs at import time; a missing ``nvcc`` or a failed
compile raises. :func:`launch_on` calls a bound entry point on a device's
current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["load_library", "load_libraries", "load_all", "build_info",
           "launch_on", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> (ctypes library, build record); filled at first use
_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def _compile(name: str) -> dict:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    record = {"name": name, "source": str(src.relative_to(_PKG.parent)),
              "library": str(out), "seconds": 0.0, "cached": True,
              "ptxas": ""}
    if out.exists():
        return record
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    record.update(seconds=seconds, cached=False,
                  ptxas=(proc.stdout + proc.stderr).strip())
    return record


def load_library(name: str, bind) -> ctypes.CDLL:
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``, building it at
    first use. ``bind(lib)`` sets every function's ``argtypes`` and
    ``restype`` once, right after loading."""
    return load_libraries({name: bind})[name]


def load_libraries(binds: dict) -> dict:
    """``{name: library}`` for ``binds`` (``{name: bind}``, as for
    :func:`load_library`). The libraries not yet loaded are compiled side
    by side, one ``nvcc`` process each, before any is loaded."""
    todo = [name for name in binds if name not in _LOADED]
    if todo:
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            records = list(pool.map(_compile, todo))
        for name, record in zip(todo, records):
            lib = ctypes.CDLL(record["library"])
            binds[name](lib)
            _LOADED[name] = (lib, record)
    return {name: _LOADED[name][0] for name in binds}


def load_all() -> dict:
    """Build side by side and load every kernel of the package: G1
    (``stairs_gather``), G2 (``stairs_gather_u``), G3 (``gather_parents``),
    G4 (``merge_count``), G5 (``max_scan``), the ESS check
    (``ess_check``) and the conditional-node shim (``graph_cond``).
    Returns ``{name: library}``."""
    from .ess_check import _LIB as _LIB_ESS, _bind as _bind_ess
    from .fused_gather import _LIB, _LIB_U, _bind, _bind_u
    from .gather import _LIB as _LIB_G3, _bind as _bind_g3
    from .graph_cond import _LIB as _LIB_IF, _bind as _bind_if
    from .max_scan import _LIB as _LIB_G5, _bind as _bind_g5
    from .merge_count import _LIB as _LIB_G4, _bind as _bind_g4
    return load_libraries({_LIB: _bind, _LIB_U: _bind_u, _LIB_G3: _bind_g3,
                           _LIB_G4: _bind_g4, _LIB_G5: _bind_g5,
                           _LIB_ESS: _bind_ess, _LIB_IF: _bind_if})


def build_info(name: str) -> dict:
    """What the build of ``name`` did: source, library path, compile
    seconds (0 when a built library was reused) and nvcc's ``-Xptxas -v``
    report. Raises if the library has not been loaded."""
    return dict(_LOADED[name][1])


def launch_on(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)``, the bound C entry point called with the raw
    handle of ``device``'s current stream (no ``torch.cuda.Stream`` object
    is built), on that device. Returns what ``fn`` returns."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
