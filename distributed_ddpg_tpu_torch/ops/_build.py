"""Builds the port's CUDA kernels from csrc/ with nvcc and loads them.

Each kernel source csrc/<name>.cu has a plain C interface and is compiled
at first use, on the machine with the card, into
distributed_ddpg_tpu_torch/build/lib<name>-<hash>.so (the directory is
git-ignored), then loaded with ctypes. The hash covers the source and the
flags, so an edited source rebuilds and an unchanged one is reused.
`build_all` starts one nvcc per source together and waits for all of them.

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
       -Xcompiler -fPIC -Xptxas -v -o build/lib<name>.so csrc/<name>.cu
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}

# Launches of each hand-written kernel in this process, counted by its
# wrapper where it launches (chip_smoke.py zeroes and reads them).
KERNEL_LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels build on the machine with the card"
        )
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named kernel not yet built, one nvcc each, all started
    together. Returns name -> the compiler's output (ptxas register and
    spill report), "" for a library that was already built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(_target(name))
    return _loaded[name]
