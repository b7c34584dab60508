"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/repro_torch_kernels/<name>-<hash>.so`` at the repository root,
where ``<hash>`` covers the source, every shared header ``csrc/*.cuh`` (found
through ``-I csrc``) and the flags, so an edited source or header rebuilds
and an unchanged one loads at once. ``build(names)`` starts one ``nvcc`` per
missing library, all together, and waits for them. The ``ptxas`` register and
shared-memory report of each build is kept beside its library
(``<name>-<hash>.log``).

Nothing here runs at import time: the CPU tests import every module of the
port on hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda); "
                           "the port's CUDA kernels build on first use")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names) -> dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, in parallel.
    Returns ``{name: path of the .so}``; raises with nvcc's output on a
    failed build."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        todo[name].with_suffix(".log").write_text(log)
        os.replace(tmp, todo[name])      # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """The ``nvcc``/``ptxas`` output kept from building ``name``."""
    return _target(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
