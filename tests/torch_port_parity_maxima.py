"""Largest differences between the port and the JAX package on the CPU parity
cases of tests/test_torch_port_rasterizer.py and tests/test_torch_port_slice.py.

    python -m tests.torch_port_parity_maxima     # from the repo root

Prints one JSON object: for each case and output, the max abs difference, and
for masks and attributes the count of pixels that differ. The tests hold these
to their tolerances; this script reports how far inside them the port lies.
"""

import json

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

from tests import test_torch_port_rasterizer as R  # noqa: E402
from tests import test_torch_port_slice as S  # noqa: E402


def _err(port, ref) -> float:
    return float(np.abs(port.numpy() - np.asarray(ref)).max())


def _raster(port, ref) -> dict:
    out = {"rgb": _err(port.rgb, ref.rgb), "depth": _err(port.depth, ref.depth),
           "mask_px_differ": int((port.mask.numpy() != np.asarray(ref.mask)).sum())}
    if ref.attr is not None:
        out["attr_px_differ"] = int((port.attr.numpy() != np.asarray(ref.attr)).sum())
    return out


def main():
    res = {}
    for name, make in R.CASES.items():
        c = make()
        for tile in [(16, 16), (8, 32)]:
            res[f"raster/binned/{name}/tile{tile[0]}x{tile[1]}"] = _raster(*R.run_binned(c, tile))
        res[f"raster/plain/{name}"] = _raster(*R.run_plain(c))

    weights = S.make_weights()
    port, ref, _ = S.run_forward(weights)
    res["slice/forward"] = {k: _err(port[k], ref[k]) for k in (*S.KEYS, "TCO_final")}
    for init in ("v0", "z-up+auto-depth"):
        port_final, port, ref_final, ref = S.run_coarse_refine(weights, init)
        res[f"slice/coarse_refine/{init}"] = {
            t: max(_err(port[k].tensors[t], ref[k].tensors[t]) for k in ref)
            for t in ("poses", "poses_input", "K_crop", "boxes_rend", "boxes_crop")}
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
