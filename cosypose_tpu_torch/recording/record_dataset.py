"""Chunked, resumable synthetic dataset recording in BOP layout (port of
cosypose_tpu/recording/record_dataset.py).

Fixed-size chunks (seeds from the chunk id), a ledger of completed chunks to
resume from, train/val split keys; each chunk is one BOP scene directory
<ds_dir>/train_synt/<chunk_id> (rgb/, depth/, mask_visib/ PNGs and the
scene_camera / scene_gt / scene_gt_info JSON), readable by data.bop.BOPDataset
of either package. PNGs are written by utils/png.py. The fan-out spawns
worker processes that each build their own sampler on the caller's device.
Time spent encoding and writing PNGs is added to the sampler's
`times["write"]`.
"""

from __future__ import annotations

import json
import logging
import pathlib
import time

import numpy as np

from ..utils.png import imwrite

logger = logging.getLogger(__name__)


def record_chunk(sampler, ds_dir, chunk_id: int, n_frames_per_chunk: int = 100):
    """Generate one chunk → BOP scene dir <ds_dir>/train_synt/<chunk_id>."""
    scene_dir = pathlib.Path(ds_dir) / "train_synt" / f"{chunk_id:06d}"
    (scene_dir / "rgb").mkdir(parents=True, exist_ok=True)
    (scene_dir / "mask_visib").mkdir(exist_ok=True)
    (scene_dir / "depth").mkdir(exist_ok=True)

    cams, gts, gt_infos = {}, {}, {}
    # multi-view scenes: one sampled scene yields several frames
    n_views = max(1, int(sampler.n_views_per_scene))
    pending = []
    t_write = 0.0
    for view_id in range(n_frames_per_chunk):
        seed = chunk_id * n_frames_per_chunk + view_id
        if not pending:
            pending = list(sampler.sample_scene_frames(
                seed, min(n_views, n_frames_per_chunk - view_id)))
        rgb, mask, obs = pending.pop(0)
        t0 = time.perf_counter()
        imwrite(scene_dir / "rgb" / f"{view_id:06d}.png", rgb)
        depth = obs["camera"].get("depth")
        if depth is not None:
            depth_mm = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
            imwrite(scene_dir / "depth" / f"{view_id:06d}.png", depth_mm)
        t_write += time.perf_counter() - t0
        cam = obs["camera"]
        TWC = cam["TWC"]
        TCW = np.linalg.inv(TWC)
        cams[str(view_id)] = dict(
            cam_K=np.asarray(cam["K"]).reshape(-1).tolist(),
            cam_R_w2c=TCW[:3, :3].reshape(-1).tolist(),
            cam_t_w2c=(TCW[:3, 3] * 1000.0).tolist(),
            depth_scale=1.0,
        )
        gt_rows, info_rows = [], []
        for n, obj in enumerate(obs["objects"]):
            TCO = TCW @ obj["TWO"]
            gt_rows.append(dict(
                obj_id=int(obj["label"].split("_")[-1]),
                cam_R_m2c=TCO[:3, :3].reshape(-1).tolist(),
                cam_t_m2c=(TCO[:3, 3] * 1000.0).tolist(),
            ))
            x1, y1, x2, y2 = obj["bbox"]
            ox1, oy1, ox2, oy2 = obj.get("bbox_obj", obj["bbox"])
            info_rows.append(dict(
                visib_fract=float(obj.get("visib_fract", 1.0)),
                bbox_visib=[int(x1), int(y1), int(x2 - x1), int(y2 - y1)],
                bbox_obj=[int(ox1), int(oy1), int(ox2 - ox1), int(oy2 - oy1)],
            ))
            t0 = time.perf_counter()
            m = (mask == obj["id_in_segm"]).astype(np.uint8) * 255
            imwrite(scene_dir / "mask_visib" / f"{view_id:06d}_{n:06d}.png", m)
            t_write += time.perf_counter() - t0
        gts[str(view_id)] = gt_rows
        gt_infos[str(view_id)] = info_rows

    (scene_dir / "scene_camera.json").write_text(json.dumps(cams))
    (scene_dir / "scene_gt.json").write_text(json.dumps(gts))
    (scene_dir / "scene_gt_info.json").write_text(json.dumps(gt_infos))
    sampler.times["write"] += t_write
    return chunk_id


def _record_worker(sampler_factory, ds_dir, chunk_ids, n_frames_per_chunk, ledger):
    """One fan-out worker: builds its own sampler, records its chunk slice."""
    sampler = sampler_factory()
    for cid in chunk_ids:
        record_chunk(sampler, ds_dir, cid, n_frames_per_chunk)
        with open(ledger, "a") as f:  # O_APPEND single-line write: atomic
            f.write(f"{cid}\n")


def record_dataset(sampler, ds_dir, n_chunks: int, n_frames_per_chunk: int = 100,
                   train_fraction: float = 0.95, n_workers: int = 0, sampler_factory=None):
    """Resumable chunk ledger + train/val split keys.

    With ``n_workers > 0`` and a picklable zero-argument ``sampler_factory``
    (one that builds the sampler on the caller's device), pending chunks fan
    out over spawned worker processes; the ledger keeps the fan-out resumable
    as in the serial path.
    """
    ds_dir = pathlib.Path(ds_dir)
    ds_dir.mkdir(parents=True, exist_ok=True)
    ledger = ds_dir / "chunks_recorded.txt"
    done = set()
    if ledger.exists():
        done = {int(line) for line in ledger.read_text().split() if line.strip()}
    pending = [c for c in range(n_chunks) if c not in done]

    if n_workers > 0 and sampler_factory is not None and len(pending) > 1:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        slices = [pending[i::n_workers] for i in range(n_workers)]
        procs = [ctx.Process(target=_record_worker,
                             args=(sampler_factory, ds_dir, s, n_frames_per_chunk, ledger))
                 for s in slices if s]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"{len(bad)} recording workers failed (exit codes {bad}); "
                               f"re-run to resume from the ledger")
        logger.info(f"recorded {len(pending)} chunks on {len(procs)} workers")
    else:
        # the serial path also serves the fan-out's degenerate cases (one
        # pending chunk): build the sampler from the factory when only that
        # was given
        if sampler is None:
            if sampler_factory is None:
                raise ValueError("record_dataset needs a sampler or a sampler_factory")
            sampler = sampler_factory()
        for chunk_id in pending:
            record_chunk(sampler, ds_dir, chunk_id, n_frames_per_chunk)
            with open(ledger, "a") as f:
                f.write(f"{chunk_id}\n")
            logger.info(f"recorded chunk {chunk_id + 1}/{n_chunks}")

    n_train = int(train_fraction * n_chunks)
    split = dict(train=[f"{c:06d}" for c in range(n_train)],
                 val=[f"{c:06d}" for c in range(n_train, n_chunks)])
    (ds_dir / "split_keys.json").write_text(json.dumps(split))
    return ds_dir
