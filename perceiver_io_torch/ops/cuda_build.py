"""Build and load the port's hand-written CUDA kernels.

Every ``perceiver_io_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds. Each library's file
name is keyed by a hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so editing one kernel rebuilds that one only, and an unchanged
source is loaded as it is. The build happens at first use (or in ``build()``,
which starts one ``nvcc`` per source, all at once), into
``perceiver_io_torch/_build/`` (git-ignored).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
# called as fn(name, seconds, built) each time library() loads a source for the
# first time in this process: seconds of its build (when nvcc ran: built) and
# load. The compile watchdog (obs/watchdog.py) counts these loads.
_load_listeners: List[Callable[[str, float, bool], None]] = []
# ptxas -v lines kept in build()'s report: the kernel's name, its registers, its
# spills, and any warning (a setmaxnreg it ignored, wgmma it serialised)
_PTXAS_WORDS = ("Compiling entry function", "Used", "spill", "warning", "Performance")


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``), sorted."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home}/bin); the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    text = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Compile the named kernel libraries (default: every source) that are
    not built yet, one ``nvcc`` each, all started together. Raises with the
    compiler's output if one fails. Returns, per source, ``{"seconds": wall
    seconds of its nvcc or None when it was already built, "ptxas": the
    compiler's lines naming each kernel, its registers and its spills}``."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    running = {}
    for name in names:
        target = _target(name)
        if target.exists():
            report[name] = {"seconds": None, "ptxas": []}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": seconds, "ptxas": [line.strip() for line in log.splitlines()
                                                      if any(w in line for w in _PTXAS_WORDS)]}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def add_load_listener(fn: Callable[[str, float, bool], None]) -> None:
    """Call ``fn(name, seconds, built)`` at each first load of a library in
    this process (once per listener, however often it is added)."""
    if fn not in _load_listeners:
        _load_listeners.append(fn)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        t0 = time.perf_counter()
        built = build([name])[name]["seconds"] is not None
        _libs[name] = ctypes.CDLL(str(_target(name)))
        seconds = time.perf_counter() - t0
        for fn in list(_load_listeners):
            fn(name, seconds, built)
    return _libs[name]
