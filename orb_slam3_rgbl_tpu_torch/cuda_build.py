"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the root of
the checkout (the hash of the source names the library, so an edited
source rebuilds), with nvcc's ``-Xptxas -v`` report beside it in
``lib<name>-<hash>.so.ptxas.txt``, read back on a cached build.
``build_all`` starts one ``nvcc`` per source at once.
Nothing here runs at import time.

Every kernel wrapper adds one to ``launch_counts[<kernel>]`` where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
SOURCES = ("frontend", "brief", "launch_floor", "gba")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts = {"fast_and_blur": 0, "brief_continuous": 0, "brief_blocks": 0,
                 "gba_hv": 0, "gba_pose_sum": 0, "gba_cg_update": 0, "gba_cg_direction": 0,
                 "gba_pair_hv": 0, "gba_linearize": 0, "gba_pose_blocks": 0, "gba_cost": 0,
                 "gba_apply_step": 0}
ptxas_log: dict = {}      # source name → nvcc's -Xptxas -v report

_libs: dict = {}
_lock = threading.Lock()


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns {name: library path}; raises with nvcc's output if
    any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path) and os.path.exists(path + ".ptxas.txt"):
            with open(path + ".ptxas.txt") as f:
                ptxas_log[n] = f.read()
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        ptxas_log[n] = out
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{out}")
        else:
            with open(paths[n] + ".ptxas.txt", "w") as f:
                f.write(out)
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib
