"""The port's hand-written CUDA sources (csrc/) and their nvcc build.

`build_libraries(names)` compiles the named sources of SOURCES into build/
at first use, all nvcc processes started together, each into a shared
library named by a hash of its source and flags, so a warm build/ builds
nothing. The kernels' modules load their library from it:
ops/rasterizer_cuda.py (the raster kernels) and ops/depthwise_cuda.py (the
MBConv block's depthwise half) build the pose path's three (SERVING) at the
first call of either; ops/nms_cuda.py builds the detector's NMS alone, at
the first Mask R-CNN call, so that the pose path's set-up never waits for it.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"setup": CSRC / "raster_setup.cu", "resolve": CSRC / "raster_resolve.cu",
           "dw_bn_silu_squeeze": CSRC / "dw_bn_silu_squeeze.cu", "nms": CSRC / "nms.cu"}
SERVING = ("setup", "resolve", "dw_bn_silu_squeeze")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the raster kernels repeat their plain versions' arithmetic op for op (no FMA
# contraction); the depthwise kernel's float32 sums contract into FMAs
FMA_SOURCES = ("dw_bn_silu_squeeze",)


def nvcc_flags(name: str) -> tuple[str, ...]:
    """nvcc's flags for SOURCES[name]."""
    if name not in FMA_SOURCES:
        return NVCC_FLAGS
    return tuple("-fmad=true" if f == "-fmad=false" else f for f in NVCC_FLAGS)


def nvcc_path() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_libraries(names: tuple = SERVING) -> dict[str, tuple[pathlib.Path, str]]:
    """Compile each named source into build/ where that build is missing, all
    nvcc processes started together.

    Returns {name: (path of the shared library, nvcc's report: '' when the
    build was already there)}. File names carry a hash of source and flags.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    out, running = {}, {}
    for name in names:
        src = SOURCES[name]
        flags = nvcc_flags(name)
        digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"libcosypose_{src.stem}_{digest}.so"
        if lib.exists():
            out[name] = (lib, "")
            continue
        tmp = BUILD_DIR / f"libcosypose_{src.stem}_{digest}.{os.getpid()}.so"
        running[name] = (lib, tmp, subprocess.Popen(
            [nvcc, *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in running.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name].name} ({proc.returncode}):\n{report}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, report)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out
