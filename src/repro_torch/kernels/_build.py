"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its own
(with the shared headers ``csrc/*.cuh``) into
``build/repro_torch_kernels/<name>-<hash>.so`` under the repository root, at
first use. The hash covers the source, the headers and the flags, so an
edited source rebuilds and an unchanged one loads the cached library. Nothing
here runs at import: CPU-only installs import this module without a CUDA
toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# -Xptxas -v records registers/spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one source beyond NVCC_FLAGS. tick: -fmad=false, so that the power
# expression rounds like the plain version's separate multiplies and adds
# (bit-identical brake sets); no --use_fast_math anywhere (the tick ring's
# NaN sentinels need a real isnan()).
SOURCE_FLAGS = {"tick": ("-fmad=false",)}


def flags(name: str) -> tuple:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME
    (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: named by a hash of
    the source, the shared headers ``csrc/*.cuh`` and the source's flags."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + "\0".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for one source unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    _, err = proc.communicate()
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{err}")
    out.with_suffix(".log").write_text(err)
    os.replace(tmp, out)  # atomic: a concurrent reader sees all or nothing


def build(names: Iterable[str]) -> None:
    """Build the named sources, one ``nvcc`` each, all started together."""
    procs = [(n, _start(n)) for n in names]
    errors: List[str] = []
    for name, proc in procs:
        if proc is None:
            continue
        try:
            _finish(name, proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def sources() -> List[str]:
    """Names of every CUDA source of the port (``csrc/*.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_log(name: str) -> str:
    """ptxas's report (registers, shared memory, spills) of the last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
