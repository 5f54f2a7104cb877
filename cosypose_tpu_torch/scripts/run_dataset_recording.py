"""Synthetic dataset recording CLI (port of
cosypose_tpu/scripts/run_dataset_recording.py).

Named configs for ycbv-like (640x480) and tless-like (720x540) 1M-frame sets
and the built-in procedural tiers, recorded by the scene sampler into BOP
layout, on the card unless --device says otherwise:

  python -m cosypose_tpu_torch.scripts.run_dataset_recording --config procedural \
      [--debug] [--n-workers N] [--texture-dir PATH] [--device cpu]

``--config procedural`` (and -canon, -solo, -texsolo) records the built-in
procedural object set: no downloaded model packs needed. With --n-workers,
chunks fan out over spawned processes, each with its own sampler on --device.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
from functools import partial

from ..config import LOCAL_DATA_DIR

logger = logging.getLogger(__name__)

# the procedural tiers' shared settings: 240x320 at focal 530-540 px, 10 views a
# scene; a pile of 3-7 objects in the cage, or one object floating without it
_PROCEDURAL = dict(resolution=(240, 320), focal=(530.0, 540.0))
_PILE = dict(camera_distance_interval=(0.45, 1.0), n_objects_interval=(3, 8),
             min_visible_pixels=150, n_views_per_scene=10)
_SOLO = dict(_PILE, n_objects_interval=(1, 2), place_mode="floating", p_cage=0.0)

# object ds, resolution, focal interval, n frames[, p_textured, sampler kwargs]
CONFIGS = {
    "ycbv-1M": dict(obj="ycbv.models", resolution=(480, 640), focal=(1060.0, 1080.0),
                    n_frames=1_000_000),
    "tless-1M": dict(obj="tless.cad", resolution=(540, 720), focal=(1060.0, 1080.0),
                     n_frames=1_000_000),
    "procedural": dict(_PROCEDURAL, obj="procedural", n_frames=20_000, sampler_kwargs=_PILE),
    # canonical object appearance (textured cage only): refiner regression
    # data where renders match observations — object texture randomization
    # decouples appearance from the mesh colors the refiner renders with,
    # which suppresses the render-and-compare learning signal at small
    # sample budgets
    "procedural-canon": dict(_PROCEDURAL, obj="procedural", n_frames=20_000, p_textured=0.0,
                             sampler_kwargs=_PILE),
    # clean tier for refiner learnability regressions: ONE canonical-
    # appearance object floating on a bare background (no cage, no pile) —
    # the render-vs-observation compare signal is not buried under clutter,
    # so generalizing refinement is demonstrable at small sample budgets
    # (the cluttered tiers reproduce the reference's 80.6M-sample physics)
    "procedural-solo": dict(_PROCEDURAL, obj="procedural", n_frames=8_000, p_textured=0.0,
                            sampler_kwargs=_SOLO),
    # rotation-learnable solo tier: sine-textured objects whose appearance
    # determines orientation (the two-tone solo objects are rotationally
    # near-ambiguous — measured, see procedural_objects._vertex_colors_sine);
    # the SE(3)-noise refiner arms train/evaluate here
    "procedural-texsolo": dict(_PROCEDURAL, obj="procedural-tex", n_frames=8_000,
                               p_textured=0.0, sampler_kwargs=_SOLO),
}


def _make_sampler(config: str, ds_root=None, texture_dir=None, n_objects_interval=None,
                  device="cuda"):
    """Build the sampler for a named config on `device` (the fan-out factory)."""
    from ..data.datasets_cfg import make_object_dataset
    from ..data.texture_dataset import TextureDataset
    from ..ops.mesh_db import build_mesh_db
    from ..recording import RecordingSceneSampler
    from ..recording.textures import TextureSampler

    cfg = CONFIGS[config]
    obj_ds = make_object_dataset(cfg["obj"], ds_root=ds_root)
    mesh_db = build_mesh_db(obj_ds.mesh_specs(), device=device)
    textures = TextureDataset(texture_dir) if texture_dir else None
    kwargs = dict(cfg.get("sampler_kwargs", {}))
    if n_objects_interval:
        kwargs["n_objects_interval"] = n_objects_interval
    return RecordingSceneSampler(
        mesh_db, resolution=cfg["resolution"], focal_interval=cfg["focal"],
        texture_sampler=TextureSampler(texture_dataset=textures,
                                       p_textured=cfg.get("p_textured", 0.8)),
        **kwargs)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, choices=list(CONFIGS))
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--ds-root", default=None)
    parser.add_argument("--chunk-size", type=int, default=100)
    parser.add_argument("--n-workers", type=int, default=0,
                        help="fan recording out over N worker processes")
    parser.add_argument("--n-frames", type=int, default=None)
    parser.add_argument("--texture-dir", default=None,
                        help="directory of PNG texture images (else procedural noise textures)")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    from ..recording import record_dataset

    cfg = CONFIGS[args.config]
    factory = partial(_make_sampler, args.config, ds_root=args.ds_root,
                      texture_dir=args.texture_dir, device=args.device)
    n_frames = args.n_frames or (10 if args.debug else cfg["n_frames"])
    chunk_size = min(args.chunk_size, n_frames)
    n_chunks = max(1, n_frames // chunk_size)
    out = pathlib.Path(args.out) if args.out else (
        LOCAL_DATA_DIR / "synt_datasets" / (args.config + ("-debug" if args.debug else "")))
    record_dataset(factory() if args.n_workers == 0 else None, out, n_chunks=n_chunks,
                   n_frames_per_chunk=chunk_size, n_workers=args.n_workers,
                   sampler_factory=factory)
    logger.info(f"Recorded {n_chunks} chunks into {out}")
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
