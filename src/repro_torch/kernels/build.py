"""Build the CUDA sources under `csrc/` with nvcc and load them with
ctypes.

Each source is compiled for Hopper (`-gencode arch=compute_90a,
code=sm_90a`) into a shared library with a plain C interface, at first
use, into `build/` at the repository root (listed in `.gitignore`). The
library's file name carries a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. `build()`
starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("dht_probe", "flash_attention", "flash_attention_wgmma",
           "ssd_scan")


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit's nvcc")
    return path


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every source in `names` that has no library yet, one nvcc
    process per source, all started together. Returns {name: nvcc's
    output (ptxas register and shared-memory report)} for the ones
    built, and raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, out)           # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def timed_build(names=SOURCES):
    """`build()` plus its wall time in seconds."""
    t0 = time.perf_counter()
    logs = build(names)
    return logs, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (built first if missing)."""
    build((name,))
    return ctypes.CDLL(str(lib_path(name)))
