"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own,
with ``nvcc`` for ``sm_90a``, into ``build/kernels/<name>-<hash>.so`` at
the root of the checkout; the hash covers the source and the flags, so a
changed source rebuilds and an unchanged one loads the cached library.
Nothing is compiled when a module is imported: the first wrapper call that
needs a library builds it, or :func:`build` builds several at once, one
``nvcc`` process per source, all started together.  A build holds a lock
on ``build/kernels/.lock``, so processes that start together (the ranks of
a data-parallel run) build each library once: the others wait and load it.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def library_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, keyed by the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(SRC_DIR) if n.endswith(".cuh"))
    for src in [name + ".cu"] + headers:
        with open(os.path.join(SRC_DIR, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> None:
    """Compile every named source whose library is missing, in parallel.
    Raises with nvcc's output if any compile fails."""
    names = list(names)
    if all(os.path.exists(library_path(n)) for n in names):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_missing(names)


def _build_missing(names) -> None:
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return
    nvcc = _nvcc()
    procs = []
    for name in todo:
        target = library_path(name)
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(SRC_DIR, name + ".cu")]
        procs.append((target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for target, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{target}: nvcc exited {proc.returncode}\n"
                          f"{out.decode(errors='replace')}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, target)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
