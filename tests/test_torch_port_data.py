"""Port parity: the PIL- and pandas-free data layer against PIL and the JAX
package on the CPU.

The PNG codec against PIL (files PIL writes, every row filter, files the port
writes), the numpy Pillow operations against PIL at several sizes and
factors, BOPDataset and the dataset registry against the JAX package over the
same directories (index cache included), the augmentations and PoseDataset
against the JAX package's from the same seeds, the loader workers' streams,
and the training CLI at a tiny size. The data is a set the port records from
the two cubes of tests/test_pose_predictor.py at 96x128.

Tolerances: all exact. The codec is lossless, the Pillow operations repeat
Pillow's integer and float32 arithmetic op for op, and the random streams
are the JAX package's, so every array is compared with np.array_equal.
"""

import dataclasses
import io
import json
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageFilter

from cosypose_tpu.data import augmentations as jaug
from cosypose_tpu.data import datasets_cfg as jcfg
from cosypose_tpu.data.bop import BOPDataset as JBOPDataset
from cosypose_tpu.data.pose_dataset import PoseDataset as JPoseDataset
from cosypose_tpu_torch.data import augmentations as taug
from cosypose_tpu_torch.data import datasets_cfg as tcfg
from cosypose_tpu_torch.data import pillow_ops
from cosypose_tpu_torch.data.bop import INDEX_FILE, BOPDataset, BOPObjectDataset
from cosypose_tpu_torch.data.pose_dataset import PoseDataset
from cosypose_tpu_torch.data.wrappers import PartialSampler
from cosypose_tpu_torch.models.pose_predictor import PosePredictorConfig
from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
from cosypose_tpu_torch.recording import RecordingSceneSampler, record_dataset
from cosypose_tpu_torch.scripts import run_pose_training as train_cli
from cosypose_tpu_torch.training import pose_training as tpt
from cosypose_tpu_torch.training.configs import RunConfig
from cosypose_tpu_torch.training.train_pose import ConcatDataset, make_loader, seed_worker
from cosypose_tpu_torch.utils import png
from cosypose_tpu_torch.utils.jpeg import JPEGError
from tests.test_pose_predictor import cube_specs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The fast tier runs several test processes side by side on the CPU's
    cores; PyTorch's own thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(h, w, c, dtype=np.uint8, seed=0):
    """Noise over a gradient: rows on which each PNG filter has its use."""
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    grad = np.add.outer(np.arange(h), 2 * np.arange(w)) * (top // (h + 2 * w))
    a = grad[..., None] + rng.randint(0, top // 8, (h, w, c))
    return (a % (top + 1)).astype(dtype)[..., 0] if c == 1 else (a % (top + 1)).astype(dtype)


MODES = {"L": (1, np.uint8), "LA": (2, np.uint8), "RGB": (3, np.uint8), "RGBA": (4, np.uint8),
         "I;16": (1, np.uint16)}


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reads_what_pillow_writes(mode):
    c, dtype = MODES[mode]
    for h, w in ((1, 1), (7, 13), (40, 57)):
        a = _image(h, w, c, dtype, seed=h)
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG")
        ref = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
        out = png.decode(buf.getvalue())
        assert out.dtype == ref.dtype and np.array_equal(out, ref) and np.array_equal(out, a)


def _filtered_png(a: np.ndarray, ftype: int) -> bytes:
    """A PNG of `a` (8-bit RGB or 16-bit L) whose rows all use filter `ftype`,
    filtered by the PNG specification's formulas, byte by byte."""
    depth = 8 * a.dtype.itemsize
    rows = (a.astype(">u2") if depth == 16 else a).view(np.uint8).reshape(a.shape[0], -1)
    bpp = (3 if a.ndim == 3 else 1) * depth // 8
    out = bytearray()
    prev = [0] * rows.shape[1]
    for r in rows.tolist():
        out.append(ftype)
        for x, v in enumerate(r):
            left = r[x - bpp] if x >= bpp else 0
            up, ul = prev[x], (prev[x - bpp] if x >= bpp else 0)
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = left
            elif ftype == 2:
                pred = up
            elif ftype == 3:
                pred = (left + up) // 2
            else:
                p = left + up - ul
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                pred = left if pa <= pb and pa <= pc else (up if pb <= pc else ul)
            out.append((v - pred) % 256)
        prev = r

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", a.shape[1], a.shape[0], depth, 2 if a.ndim == 3 else 0, 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reads_every_row_filter(ftype):
    for a in (_image(9, 11, 3, seed=ftype), _image(6, 10, 1, np.uint16, seed=ftype)):
        data = _filtered_png(a, ftype)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), a)  # a valid PNG
        out = png.decode(data)
        assert out.dtype == a.dtype and np.array_equal(out, a)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16"])
def test_pillow_reads_what_the_port_writes(mode, tmp_path):
    c, dtype = MODES[mode]
    a = _image(33, 47, c, dtype, seed=5)
    png.imwrite(tmp_path / "x.png", a)
    with Image.open(tmp_path / "x.png") as im:
        ref = np.asarray(im)
    assert np.array_equal(ref, a) and np.array_equal(png.imread(tmp_path / "x.png"), a)


def test_png_header_errors_and_jpeg(tmp_path):
    a = _image(21, 34, 3)
    png.imwrite(tmp_path / "x.png", a)
    assert png.image_size(tmp_path / "x.png") == (21, 34)
    data = bytearray(png.encode(a))
    data[40] ^= 0xFF  # inside the IDAT chunk
    with pytest.raises(png.PNGError, match="CRC"):
        png.decode(bytes(data))
    interlaced = _filtered_png(_image(3, 4, 3), 0)
    ihdr = interlaced[16:29][:-1] + b"\x01"
    body = b"IHDR" + ihdr
    interlaced = interlaced[:12] + body + struct.pack(">I", zlib.crc32(body)) + interlaced[33:]
    with pytest.raises(png.PNGError, match="interlaced"):
        png.decode(interlaced)
    # a JPEG reads as Pillow reads it; a truncated one raises a named error
    Image.fromarray(_image(21, 34, 3)).save(tmp_path / "x.jpg", quality=90)
    assert np.array_equal(png.imread(tmp_path / "x.jpg"), np.asarray(Image.open(tmp_path / "x.jpg")))
    assert png.image_size(tmp_path / "x.jpg") == (21, 34)
    (tmp_path / "y.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(30))
    with pytest.raises(JPEGError, match="y.jpg: truncated JPEG data"):
        png.imread(tmp_path / "y.jpg")
    with pytest.raises(JPEGError, match="y.jpg: truncated JPEG data"):
        png.image_size(tmp_path / "y.jpg")


RESIZES = [((96, 128), (48, 64)), ((540, 720), (240, 320)), ((37, 53), (18, 17)),
           ((20, 30), (41, 75)), ((64, 96), (64, 50)), ((64, 96), (77, 96)), ((30, 40), (30, 40))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_pillow(src, dst):
    rgb = _image(*src, 3, seed=src[0])
    ref = np.asarray(Image.fromarray(rgb).resize(dst[::-1], Image.BILINEAR))
    assert np.array_equal(pillow_ops.resize_bilinear(rgb, dst), ref)
    ids = np.random.RandomState(1).randint(0, 9, src).astype(np.int32)
    ref = np.asarray(Image.fromarray(ids, mode="I").resize(dst[::-1], Image.NEAREST))
    out = pillow_ops.resize_nearest(ids, dst)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)


@pytest.mark.parametrize("radius", [0.5, 1.0, 1.37, 2.0, 2.99])
def test_gaussian_blur_matches_pillow(radius):
    for shape in ((45, 61), (3, 200), (120, 160)):
        rgb = _image(*shape, 3, seed=shape[0])
        ref = np.asarray(Image.fromarray(rgb).filter(ImageFilter.GaussianBlur(radius=radius)))
        assert np.array_equal(pillow_ops.gaussian_blur(rgb, radius), ref)


ENHANCERS = {"sharpness": (pillow_ops.sharpness, ImageEnhance.Sharpness),
             "contrast": (pillow_ops.contrast, ImageEnhance.Contrast),
             "brightness": (pillow_ops.brightness, ImageEnhance.Brightness),
             "colour": (pillow_ops.colour, ImageEnhance.Color)}


@pytest.mark.parametrize("name", list(ENHANCERS))
def test_enhancers_match_pillow(name):
    ours, theirs = ENHANCERS[name]
    for shape in ((2, 5), (33, 47), (240, 320)):
        rgb = _image(*shape, 3, seed=shape[1])
        for f in (0.0, 0.37, 1.0, 2.5, 19.9, 49.9):
            assert np.array_equal(ours(rgb, f), np.asarray(theirs(Image.fromarray(rgb)).enhance(f)))
    assert np.array_equal(pillow_ops.luminance(rgb), np.asarray(Image.fromarray(rgb).convert("L")))


# -- the BOP reader, the registry and the augmentations ----------------------


def port_specs(specs):
    return [MeshSpec(**dataclasses.asdict(s)) for s in specs]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """<root>/synt_datasets/cubes: 3 chunks of 3 frames the port records."""
    root = tmp_path_factory.mktemp("data")
    sampler = RecordingSceneSampler(
        build_mesh_db(port_specs(cube_specs()), device="cpu"), resolution=(96, 128),
        n_objects_interval=(2, 5), min_visible_pixels=10, border_check=False,
        camera_distance_interval=(0.5, 0.9), n_views_per_scene=3)
    record_dataset(sampler, root / "synt_datasets" / "cubes", n_chunks=3, n_frames_per_chunk=3,
                   train_fraction=0.7)
    return root


def assert_items_equal(a, b):
    (ar, am, ao), (br, bm, bo) = a, b
    assert ar.dtype == br.dtype and np.array_equal(ar, br)
    assert am.dtype == bm.dtype and np.array_equal(am, bm)
    assert ao["frame_info"] == bo["frame_info"]
    assert ao["camera"].keys() == bo["camera"].keys()
    for k, v in ao["camera"].items():
        assert np.array_equal(np.asarray(v), np.asarray(bo["camera"][k])), k
    assert len(ao["objects"]) == len(bo["objects"])
    for x, y in zip(ao["objects"], bo["objects"]):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k


@pytest.mark.parametrize("load_depth", [False, True])
def test_bop_dataset_matches_jax(data_root, load_depth):
    ds_dir = data_root / "synt_datasets" / "cubes"
    jds = JBOPDataset(ds_dir, split="train_synt", load_depth=load_depth)
    tds = BOPDataset(ds_dir, split="train_synt", load_depth=load_depth, cache_in_memory=True)
    assert len(tds) == len(jds) == 9
    for i in range(len(jds)):
        assert_items_equal(jds[i], tds[i])
        assert_items_equal(jds[i], tds[i])  # from the in-memory cache


def test_bop_index_cache_is_shared(data_root, tmp_path):
    import shutil

    src = data_root / "synt_datasets" / "cubes" / "train_synt"
    for writer, reader in ((JBOPDataset, BOPDataset), (BOPDataset, JBOPDataset)):
        shutil.rmtree(tmp_path / "ds", ignore_errors=True)
        shutil.copytree(src, tmp_path / "ds" / "train_synt")
        (tmp_path / "ds" / "train_synt" / INDEX_FILE).unlink(missing_ok=True)
        writer(tmp_path / "ds", split="train_synt")
        cache = tmp_path / "ds" / "train_synt" / INDEX_FILE
        text = cache.read_text()
        # the cache is what the reader uses: drop the last frame from it
        index = json.loads(text)
        cache.write_text(json.dumps({k: v[:-1] for k, v in index.items()}))
        assert len(reader(tmp_path / "ds", split="train_synt")) == 8
        expected = text
    assert text == expected and json.loads(text)["view_id"][:3] == [0, 1, 2]


def test_bop_aggregate_mask_and_jpeg_frames(data_root, tmp_path):
    import shutil

    scene = tmp_path / "ds" / "test" / "000000"
    shutil.copytree(data_root / "synt_datasets" / "cubes" / "train_synt" / "000000", scene)
    _, mask, _ = BOPDataset(tmp_path / "ds", split="test")[1]
    Image.fromarray((mask * 40).astype(np.uint8)).save(scene / "mask_visib" / "000001_all.png")
    tds, jds = BOPDataset(tmp_path / "ds", split="test"), JBOPDataset(tmp_path / "ds", split="test")
    assert_items_equal(jds[1], tds[1])
    assert tds[1][1].max() == 40 * mask.max()
    # a JPEG frame (the .png fallback) reads as the JAX package reads it
    Image.open(scene / "rgb" / "000002.png").save(scene / "rgb" / "000002.jpg", quality=85)
    (scene / "rgb" / "000002.png").unlink()
    assert_items_equal(jds[2], tds[2])
    (scene / "rgb" / "000002.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(30))
    with pytest.raises(JPEGError, match="000002.jpg: truncated JPEG data"):
        tds[2]


def test_bop_object_dataset_matches_jax(tmp_path):
    info = {"2": {"diameter": 120.5, "symmetries_discrete": [list(np.eye(4).reshape(-1))]},
            "1": {"diameter": 80.0, "symmetries_continuous": [{"axis": [0, 0, 1],
                                                               "offset": [0, 0, 0]}]},
            "13": {}}
    models = tmp_path / "bop_datasets" / "ycbv" / "models"
    models.mkdir(parents=True)
    (models / "models_info.json").write_text(json.dumps(info))
    j, t = jcfg.make_object_dataset("ycbv.models", ds_root=tmp_path), \
        tcfg.make_object_dataset("ycbv.models", ds_root=tmp_path)
    assert isinstance(t, BOPObjectDataset) and len(t) == len(j) == 3
    assert [t[i] for i in range(3)] == [j[i] for i in range(3)]
    for a, b in zip(j.mesh_specs(), t.mesh_specs()):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for name in ("procedural", "procedural-tex"):
        ja, ta = jcfg.make_object_dataset(name), tcfg.make_object_dataset(name)
        assert ja.labels == ta.labels
        assert all(np.array_equal(a.colors, b.colors) for a, b in zip(ja.specs, ta.specs))


@pytest.mark.parametrize("split", ["train", "val"])
def test_make_scene_dataset_synthetic_splits(data_root, split):
    j = jcfg.make_scene_dataset(f"synthetic.cubes.{split}", ds_root=data_root)
    t = tcfg.make_scene_dataset(f"synthetic.cubes.{split}", ds_root=data_root)
    assert len(t) == len(j) == (6 if split == "train" else 3)
    assert t.cache_in_memory == j.cache_in_memory is True
    for col in ("scene_id", "view_id"):
        assert t.frame_index[col].tolist() == j.frame_index[col].tolist()
    assert_items_equal(j[len(j) - 1], t[len(t) - 1])


def test_make_scene_dataset_bop_names(tmp_path):
    root = tmp_path / "bop_datasets"
    for ds, split in (("ycbv", "test"), ("ycbv", "train_pbr"), ("tless", "test_primesense")):
        for scene in (48, 50):
            d = root / ds / split / f"{scene:06d}"
            d.mkdir(parents=True)
            (d / "scene_camera.json").write_text(json.dumps({str(v): {} for v in range(4)}))
    (root / "ycbv" / "keyframe.txt").write_text("0048/000001\n0050/000003\n0050/000000\n")
    (root / "ycbv" / "test_targets_bop19.json").write_text(json.dumps(
        [{"scene_id": 50, "im_id": 2, "obj_id": 1}, {"scene_id": 48, "im_id": 0, "obj_id": 3}]))
    for name in ("ycbv.test", "ycbv.test.keyframes", "ycbv.test.bop19", "ycbv.train.pbr",
                 "tless.primesense.test"):
        j, t = jcfg.make_scene_dataset(name, ds_root=tmp_path), \
            tcfg.make_scene_dataset(name, ds_root=tmp_path)
        assert t.split == j.split
        for col in ("scene_id", "view_id"):
            assert t.frame_index[col].tolist() == j.frame_index[col].tolist(), name
    assert len(t) == 8 and len(tcfg.make_scene_dataset("ycbv.test.keyframes",
                                                       ds_root=tmp_path)) == 3


def _observation(data_root, idx):
    rgb, mask, obs = BOPDataset(data_root / "synt_datasets" / "cubes", split="train_synt")[idx]
    return (jaug.SceneObservation(rgb, mask, obs), taug.SceneObservation(rgb, mask, obs))


def assert_obs_equal(a, b):
    assert_items_equal((a.rgb, a.mask, a.obs), (b.rgb, b.mask, b.obs))


@pytest.mark.parametrize("resize", [(48, 64), (240, 320), (96, 128), (100, 120)])
def test_crop_resize_matches_jax(data_root, resize):
    for idx in (0, 4):
        j, t = _observation(data_root, idx)
        assert_obs_equal(jaug.CropResizeToAspect(resize)(j), taug.CropResizeToAspect(resize)(t))


def test_background_augmentation_matches_jax(data_root, tmp_path):
    paths = []
    for i, shape in enumerate(((50, 70), (96, 128), (200, 100))):
        paths.append(tmp_path / f"bg{i}.png")
        Image.fromarray(_image(*shape, 3, seed=i)).save(paths[-1])
    Image.fromarray(_image(30, 30, 1, seed=9)).save(tmp_path / "gray.png")
    paths.append(tmp_path / "gray.png")
    ja = jaug.BackgroundAugmentation(paths, p=0.7)
    ta = taug.BackgroundAugmentation(paths, p=0.7)
    for idx in range(6):
        j, t = _observation(data_root, idx)
        assert_obs_equal(ja(j), ta(t))


@pytest.mark.parametrize("p", [0.4, 1.0])
def test_color_jitter_matches_jax(data_root, p):
    for seed in range(3):
        ja, ta = jaug.ColorJitterAugmentation(p=p, seed=seed), taug.ColorJitterAugmentation(p, seed)
        for idx in range(3):
            j, t = _observation(data_root, idx)
            assert_obs_equal(ja(j), ta(t))


def test_grayscale_and_center_crop_match_jax(data_root):
    jg, tg = jaug.GrayScale(p=0.5, seed=1), taug.GrayScale(p=0.5, seed=1)
    for idx in range(4):
        j, t = _observation(data_root, idx)
        assert_obs_equal(jg(j), tg(t))
        assert_obs_equal(jaug.CenterCrop((64, 80))(j), taug.CenterCrop((64, 80))(t))


def assert_pose_items_equal(a, b):
    assert a.keys() == b.keys() and a["label"] == b["label"]
    for k in ("image", "K", "TCO", "bbox"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("jitter", [False, True])
def test_pose_dataset_items_match_jax(data_root, jitter):
    """With the data loaded in one process, the port's item stream is the
    JAX package's: the same object picks, retries and jitter draws."""
    for resize in ((96, 128), (48, 64)):
        j = JPoseDataset(jcfg.make_scene_dataset("synthetic.cubes.train", ds_root=data_root),
                         resize=resize, apply_rgb_augmentation=jitter, visib_fract_th=0.5)
        t = PoseDataset(tcfg.make_scene_dataset("synthetic.cubes.train", ds_root=data_root),
                        resize=resize, apply_rgb_augmentation=jitter, visib_fract_th=0.5)
        for idx in [0, 3, 5, 3, 1, 0, 2, 4]:
            assert_pose_items_equal(j[idx], t[idx])
        batch = t.collate_fn([t[i] for i in range(4)])
        assert batch["images"].shape == (4, 3, *resize) and batch["images"].dtype == torch.uint8
        assert batch["K"].dtype == torch.float32 and len(batch["labels"]) == 4


def test_pose_dataset_retries_frames_without_a_valid_object(data_root):
    scene_ds = tcfg.make_scene_dataset("synthetic.cubes.train", ds_root=data_root)
    areas = [max((o["bbox"][2] - o["bbox"][0]) * (o["bbox"][3] - o["bbox"][1])
                 for o in scene_ds[i][2]["objects"]) for i in range(len(scene_ds))]
    min_area = float(np.median(areas))  # about half the frames have no object this large
    j = JPoseDataset(jcfg.make_scene_dataset("synthetic.cubes.train", ds_root=data_root),
                     resize=(96, 128), min_area=min_area)
    probe = PoseDataset(scene_ds, resize=(96, 128), min_area=min_area)
    skipped = [i for i in range(len(probe)) if probe.get_data(i) is None]
    t = PoseDataset(scene_ds, resize=(96, 128), min_area=min_area)
    assert skipped, "want a frame without an object above the threshold"
    for idx in skipped * 2:
        assert_pose_items_equal(j[idx], t[idx])
    none = PoseDataset(t.scene_ds, visib_fract_th=2.0)
    with pytest.raises(ValueError, match="10 retries"):
        none[0]


def test_seed_worker_gives_each_worker_its_own_streams(data_root, monkeypatch):
    scene_ds = tcfg.make_scene_dataset("synthetic.cubes.train", ds_root=data_root)
    draws = {}
    for epoch, worker in ((0, 0), (0, 1), (1, 0), (0, 0)):
        pd = PoseDataset(scene_ds, resize=(96, 128))
        both = ConcatDataset([(pd, 2)])
        info = type("Info", (), {"dataset": both})()
        monkeypatch.setattr(torch.utils.data, "get_worker_info", lambda: info)
        seed_worker(epoch, worker)
        draws.setdefault((epoch, worker), []).append(
            (pd.rng.random(), pd.rgb_aug.rng.random()))
    assert draws[(0, 0)][0] == draws[(0, 0)][1]           # reproducible
    assert len({d[0] for d in draws.values()}) == 3        # distinct across epochs and workers
    fresh = PoseDataset(scene_ds, resize=(96, 128))
    assert (fresh.rng.random(), fresh.rgb_aug.rng.random()) not in {
        d[0] for d in draws.values()}                      # and from the main process's streams


def test_loader_workers_draw_their_own_jitter(data_root):
    ds = ConcatDataset([(PoseDataset(tcfg.make_scene_dataset("synthetic.cubes.train",
                                                             ds_root=data_root),
                                     resize=(96, 128)), 1)])

    def images(n_workers):
        loader = make_loader(ds, PartialSampler(ds, 6, seed=0), 3, n_workers, False, epoch=0)
        return [b["images"] for b in loader]

    main, workers = images(0), images(2)
    assert len(main) == len(workers) == 2
    assert any(not torch.equal(a, b) for a, b in zip(main, workers))


def tiny_run_cfg(name, debug=False):
    """procedural-refiner cut to a CPU test: B0, 48x64 renders, batch 2."""
    tcfg_ = tpt.PoseTrainConfig(
        predictor=PosePredictorConfig(backbone="efficientnet-b0", render_size=(48, 64),
                                      n_points_crop=64),
        n_iterations=2, n_points_loss=100, input_generator="gt+noise", batch_size=2,
        epoch_size=4, n_epochs=1, n_epochs_warmup=1)
    return RunConfig(run_id="tiny-procedural", train=tcfg_,
                     train_ds_names=(("synthetic.cubes.train", 1),),
                     val_ds_names=(("synthetic.cubes.val", 1),), object_ds_name="procedural",
                     n_dataloader_workers=0, input_resize=(96, 128))


def test_training_cli_on_recorded_data(data_root, tmp_path, monkeypatch):
    # procedural-refiner has a validation set, so the CLI builds the evaluation
    # bundle; with no recorded procedural-4k set under this root it stops at
    # the missing data, not at the evaluation
    with pytest.raises(FileNotFoundError, match="missing split dir"):
        train_cli.main(["--config", "procedural-refiner", "--device", "cpu",
                        "--ds-root", str(tmp_path / "no_data")])
    monkeypatch.setattr(train_cli, "make_cfg", tiny_run_cfg)
    state, run_dir = train_cli.main(["--config", "tiny", "--ds-root", str(data_root),
                                     "--exp-dir", str(tmp_path), "--no-eval-bundle",
                                     "--n-epochs", "2", "--device", "cpu"])
    assert state.step == 4 and run_dir == tmp_path / "tiny-procedural"
    log = [json.loads(line) for line in (run_dir / "log.txt").read_text().splitlines()]
    assert np.isfinite(log[0]["train/loss_total"]) and "val/loss_total" in log[1]
