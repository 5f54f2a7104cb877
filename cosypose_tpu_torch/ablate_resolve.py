"""Where the resolve kernel's time goes: csrc/raster_resolve.cu timed with
parts of it removed, at the main path's render inputs, on a CUDA card.

    python -m cosypose_tpu_torch.ablate_resolve          # from the repo root

Each variant is the kernel's source with one text replacement (VARIANTS),
built with the kernel's own nvcc flags into build/ablate/, all builds started
together. Times are means of CUDA events over 50 launches; a variant that
removes work also changes the image, so only 'full' is the kernel's output.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from . import demo
from .ops import nvcc_build as nb
from .ops import rasterizer_cuda as rc

# name -> (text of csrc/raster_resolve.cu, its replacement); "full" is the kernel
VARIANTS = {
    "full": None,
    # every listed row evaluated at every pixel: no cull
    "no cull": ("may = row_may_cover(row_at<WINDOWED>(rows_b, r), covers[s], wx0, wx1, wy0, wy1);",
                "may = true;"),
    # binning and cull as they are, no row evaluated
    "no evaluation": ("            unsigned keep = __ballot_sync(kAll, may);\n",
                      "            unsigned keep = __ballot_sync(kAll, may);\n"
                      "            if (keep == 0x7fffffffu && lane == 31) iz = 2.f;\n"
                      "            keep = 0u;\n"),
    # the block prologue and the stores of empty pixels only
    "prologue and stores": ("for (int cb = c0; cb < c1 && listed < Kc; cb += 32) {",
                            "for (int cb = c0; cb < c0; cb += 32) {"),
}
BATCH, IMAGE, RENDER, LOD = 128, (480, 640), (240, 320), 512


def build(out_dir) -> dict:
    """{name: shared library} of each variant."""
    source = nb.SOURCES["resolve"].read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, swap in VARIANTS.items():
        text = source if swap is None else source.replace(*swap)
        if text == source and swap is not None:
            raise RuntimeError(f"variant {name!r}: its text is not in {nb.SOURCES['resolve']}")
        src = (out_dir / name.replace(" ", "_")).with_suffix(".cu")
        src.write_text(text)
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [nb.nvcc_path(), *nb.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{report}")
        libs[name] = lib
    return libs


def main(tiles=((16, 32), (8, 64), (32, 32))) -> int:
    if not torch.cuda.is_available():
        print("ablate_resolve: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    first = demo.first_render_inputs(BATCH, IMAGE, RENDER, LOD, dev)
    rows, _, order = rc.setup(first["tri_verts"], first["tri_valid"], first["TCO"],
                              first["K_crop"], RENDER, first["colors"])
    libs = build(nb.BUILD_DIR / "ablate")
    H, W = RENDER
    B, Fp = rows.shape[:2]
    rgb = torch.empty(B, 3, H, W, device=dev)
    depth = torch.empty(B, H, W, device=dev)
    print(torch.cuda.get_device_name(0))
    for tile in tiles:
        nty, ntx = rc.tile_grid(RENDER, tile)
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).cosypose_raster_resolve
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]

            def launch():
                err = fn(rows.data_ptr(), order.data_ptr(), rgb.data_ptr(), depth.data_ptr(), None,
                         B, Fp, rc.chunk_budget(1024, Fp), H, W, *tile, nty, ntx, 0,
                         dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name!r}: cudaError {err}")

            for _ in range(3):
                launch()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                launch()
            end.record()
            torch.cuda.synchronize()
            print(f"tile {tile} {name:20s} {start.elapsed_time(end) / 50:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
