"""Build and load the hand-written CUDA kernels under `repro_torch/csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library, loaded with ctypes (pointers as c_void_p, the
stream from `torch.cuda.current_stream().cuda_stream`). Builds happen at
first use, into `build/kernels/` at the repository root, keyed by a hash of
the source and the flags; every missing library is compiled at once, one
`nvcc` process per source, started together. `--use_fast_math` is
deliberately absent: it would flush the 1e-30 floor of the Neumann residual
test and change rounding.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("neumann", "minplus")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Launch counts of every kernel, by name. Each wrapper adds one where it
# launches its kernel and nowhere else, so a run can show that its main path
# went through the kernels (chip_smoke.py resets and reads these).
LAUNCHES = {"neumann_cols": 0, "neumann_rows": 0, "minplus": 0, "minplus_argmin": 0}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library in parallel; return {name: .so path}.

    The compiler's output (including `-Xptxas=-v` register and shared-memory
    counts) is kept beside each library as `<lib>.log`."""
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            paths[n].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, paths[n])  # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler output kept for `name`'s library ('' if built elsewhere)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building all sources first
    if any is missing. Raises RuntimeError without a GPU or nvcc."""
    lib = _LIBS.get(name)
    if lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"repro_torch: kernel '{name}' needs a CUDA device, and none is available"
            )
        lib = ctypes.CDLL(str(build_all()[name]))
        _LIBS[name] = lib
    return lib


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on `t`'s device, as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"repro_torch: {what} launch failed with CUDA error {err}")
