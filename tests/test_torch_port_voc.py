"""Port parity: the JPEG-backed data paths against the JAX package on the CPU.

VOC background pasting (VOCBackgroundAugmentation, PoseDataset(voc_root=))
over the committed VOC-layout tree of tests/torch_port_data/jpeg, a BOP
split whose frames are JPEG files Pillow writes, JPEG textures, and the
frame-size probe of the dataset registry; then CMYK and YCCK JPEGs through
the BOP reader (which slices Pillow's raw array, as the JAX package does),
the texture dataset and the background paste (which convert to RGB as
Pillow does, from the mode the decoder names). The data is the set
tests/test_torch_port_data.py records from two cubes at 96x128.

Tolerances: all exact. The JPEG decode equals Pillow's, the resize repeats
Pillow's arithmetic and the random streams are drawn in the JAX package's
order, so every array is compared with np.array_equal.
"""

import random
import shutil

import numpy as np
import pytest
from PIL import Image

from cosypose_tpu.data import augmentations as jaug
from cosypose_tpu.data import datasets_cfg as jcfg
from cosypose_tpu.data.bop import BOPDataset as JBOPDataset
from cosypose_tpu.data.pose_dataset import PoseDataset as JPoseDataset
from cosypose_tpu.data.texture_dataset import TextureDataset as JTextureDataset
from cosypose_tpu_torch.data import augmentations as taug
from cosypose_tpu_torch.data import datasets_cfg as tcfg
from cosypose_tpu_torch.data import pillow_ops
from cosypose_tpu_torch.data.bop import BOPDataset
from cosypose_tpu_torch.data.pose_dataset import PoseDataset
from cosypose_tpu_torch.data.texture_dataset import TextureDataset
from cosypose_tpu_torch.utils import jpeg
from tests.test_torch_port_data import (_observation, assert_items_equal, assert_obs_equal,  # noqa: F401
                                        assert_pose_items_equal, data_root, one_torch_thread)
from tests import torch_port_make_jpeg_fixtures as fx
from tests.torch_port_make_jpeg_fixtures import ROOT, VOC_ROOT, expected


def test_voc_tree_lists_its_jpegs_and_nothing_where_absent(tmp_path):
    paths = taug.VOCBackgroundAugmentation(VOC_ROOT).image_paths
    assert paths == jaug.VOCBackgroundAugmentation(VOC_ROOT).image_paths
    assert [p.name for p in paths] == sorted(p.name for p in (VOC_ROOT / "JPEGImages").iterdir())
    assert len(paths) == 6
    assert taug.VOCBackgroundAugmentation(tmp_path).image_paths == []


@pytest.mark.parametrize("p", [1.0, 0.3])
def test_voc_background_augmentation_matches_jax(data_root, p):
    ja = jaug.VOCBackgroundAugmentation(VOC_ROOT, p=p, rng=random.Random(3))
    ta = taug.VOCBackgroundAugmentation(VOC_ROOT, p=p, rng=random.Random(3))
    pasted = 0
    for idx in list(range(9)) * 2:
        j, t = _observation(data_root, idx)
        jo, to = ja(j), ta(t)
        assert_obs_equal(jo, to)
        pasted += not np.array_equal(to.rgb, t.rgb)
    assert pasted == 18 if p == 1.0 else 0 < pasted < 18


def test_voc_background_is_the_decoded_resized_image(data_root):
    """Where the mask is 0 the pixels are the VOC image, decoded and resized
    to the frame; the foreground is untouched."""
    arrays = expected()
    rng = random.Random(5)
    aug = taug.VOCBackgroundAugmentation(VOC_ROOT, p=1.0, rng=random.Random(5))
    for idx in range(4):
        _, t = _observation(data_root, idx)
        rng.random()
        path = rng.choice(aug.image_paths)
        out = aug(t)
        bg = pillow_ops.resize_bilinear(arrays[str(path.relative_to(VOC_ROOT.parents[1]))],
                                        t.rgb.shape[:2])
        fg = t.mask > 0
        assert fg.any() and (~fg).any()
        assert np.array_equal(out.rgb[~fg], bg[~fg]) and np.array_equal(out.rgb[fg], t.rgb[fg])


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("p", [1.0, 0.3])
def test_pose_dataset_with_voc_root_matches_jax(data_root, jitter, p):
    """PoseDataset(voc_root=...): items equal the JAX package's item for
    item at 0 workers (images byte-equal), the VOC paste (p 0.3 as built,
    or 1.0) taking precedence over a list of background paths."""
    scene = "synthetic.cubes.train"
    j = JPoseDataset(jcfg.make_scene_dataset(scene, ds_root=data_root), resize=(96, 128),
                     apply_rgb_augmentation=jitter, voc_root=VOC_ROOT,
                     background_image_paths=["unused.png"], visib_fract_th=0.5)
    t = PoseDataset(tcfg.make_scene_dataset(scene, ds_root=data_root), resize=(96, 128),
                    apply_rgb_augmentation=jitter, voc_root=VOC_ROOT,
                    background_image_paths=["unused.png"], visib_fract_th=0.5)
    assert isinstance(t.background_aug, taug.VOCBackgroundAugmentation)
    assert t.background_aug.p == 0.3
    j.background_aug.p = t.background_aug.p = p
    for idx in [0, 3, 5, 3, 1, 0, 2, 4, 5, 2]:
        assert_pose_items_equal(j[idx], t[idx])


def test_pose_dataset_reseed_covers_the_voc_stream(data_root):
    scene_ds = tcfg.make_scene_dataset("synthetic.cubes.train", ds_root=data_root)
    a, b = (PoseDataset(scene_ds, resize=(96, 128), voc_root=VOC_ROOT) for _ in range(2))
    a.reseed(11)
    b.reseed(11)
    assert a.background_aug.rng.random() == b.background_aug.rng.random()
    b.reseed(12)
    assert a.background_aug.rng.getstate() != b.background_aug.rng.getstate()


@pytest.fixture(scope="module")
def jpeg_split(data_root, tmp_path_factory):
    """The recorded cubes as a BOP 'test' split with JPEG frames (Pillow,
    quality 90, 4:2:0), one of them grayscale."""
    root = tmp_path_factory.mktemp("jpeg_split")
    scene = root / "ds" / "test" / "000000"
    shutil.copytree(data_root / "synt_datasets" / "cubes" / "train_synt" / "000000", scene)
    for png_path in sorted((scene / "rgb").glob("*.png")):
        im = Image.open(png_path)
        if png_path.stem.endswith("1"):
            im = im.convert("L")
        im.save(png_path.with_suffix(".jpg"), quality=90)
        png_path.unlink()
    return root / "ds"


@pytest.mark.parametrize("load_depth", [False, True])
def test_bop_dataset_over_jpeg_frames_matches_jax(jpeg_split, load_depth):
    jds = JBOPDataset(jpeg_split, split="test", load_depth=load_depth)
    tds = BOPDataset(jpeg_split, split="test", load_depth=load_depth)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        assert_items_equal(jds[i], tds[i])
    rgb = tds[1][0]
    assert rgb.shape[2] == 3 and np.array_equal(rgb[..., 0], rgb[..., 2])   # the L frame


def test_frame_size_probe_reads_the_jpeg_header(jpeg_split, tmp_path, monkeypatch):
    ds = BOPDataset(jpeg_split, split="test")
    assert tcfg._frame_size(ds) == (96, 128)
    with Image.open(jpeg_split / "test" / "000000" / "rgb" / "000000.jpg") as im:
        assert (im.height, im.width) == (96, 128)
    # the registry's cache gate uses that size: a budget of exactly the split's bytes keeps it
    shutil.copytree(jpeg_split / "test", tmp_path / "synt_datasets" / "j" / "train_synt")
    monkeypatch.setattr(tcfg, "CACHE_BUDGET_BYTES", 3 * 96 * 128 * 3)
    assert tcfg.make_scene_dataset("synthetic.j.train", ds_root=tmp_path).cache_in_memory
    assert jcfg.make_scene_dataset("synthetic.j.train", ds_root=tmp_path).cache_in_memory
    monkeypatch.setattr(tcfg, "CACHE_BUDGET_BYTES", 3 * 96 * 128 * 3 - 1)
    assert not tcfg.make_scene_dataset("synthetic.j.train", ds_root=tmp_path).cache_in_memory
    (jpeg_split / "test" / "000000" / "rgb" / "000000.jpg").rename(tmp_path / "moved.jpg")
    try:
        assert tcfg._frame_size(ds) == (480, 640)
    finally:
        (tmp_path / "moved.jpg").rename(jpeg_split / "test" / "000000" / "rgb" / "000000.jpg")


def test_texture_dataset_over_the_voc_jpegs_matches_jax():
    jds, tds = JTextureDataset(VOC_ROOT), TextureDataset(VOC_ROOT)
    assert len(tds) == len(jds) == 6
    for i in (0, 2, 5):
        assert tds[i].dtype == np.float32 and np.array_equal(jds[i], tds[i])


def test_a_broken_voc_image_stops_the_paste(data_root, tmp_path):
    (tmp_path / "JPEGImages").mkdir()
    (tmp_path / "JPEGImages" / "bad.jpg").write_bytes(b"\xff\xd8\xff\xdb\x00")
    aug = taug.VOCBackgroundAugmentation(tmp_path, p=1.0)
    with pytest.raises(jpeg.JPEGError, match="bad.jpg"):
        aug(_observation(data_root, 0)[1])


# -- CMYK JPEGs: the readers carry the decoder's mode ------------------------------

CMYK_FIXTURES = [ROOT / "small_cmyk_q90.jpg", ROOT / "small_ycck_2211.jpg",
                 ROOT / "frame_cmyk_q90.jpg"]


@pytest.fixture(scope="module")
def cmyk_split(data_root, tmp_path_factory):
    """The recorded cubes as a BOP 'test' split with JPEG frames: Pillow's
    CMYK (Adobe), a YCCK one by the fixtures' encoder and an RGB one."""
    root = tmp_path_factory.mktemp("cmyk_split")
    scene = root / "ds" / "test" / "000000"
    shutil.copytree(data_root / "synt_datasets" / "cubes" / "train_synt" / "000000", scene)
    for i, png_path in enumerate(sorted((scene / "rgb").glob("*.png"))):
        rgb = np.asarray(Image.open(png_path).convert("RGB"))
        cmyk = np.concatenate([255 - rgb, rgb[..., :1] // 3], -1)
        data = [fx.pillow_jpeg(cmyk, quality=90), fx.encode(cmyk, colour="ycck"),
                fx.pillow_jpeg(rgb, quality=90)][i % 3]
        png_path.with_suffix(".jpg").write_bytes(data)
        png_path.unlink()
    return root / "ds"


def test_bop_dataset_over_cmyk_frames_matches_jax(cmyk_split):
    """The JAX package slices Pillow's raw array: a CMYK frame's first three
    channels as Pillow presents them."""
    jds, tds = JBOPDataset(cmyk_split, split="test"), BOPDataset(cmyk_split, split="test")
    assert len(tds) == len(jds) == 3
    for i in range(3):
        assert_items_equal(jds[i], tds[i])
    frame = cmyk_split / "test" / "000000" / "rgb" / "000000.jpg"
    assert np.array_equal(tds[0][0], np.asarray(Image.open(frame))[..., :3])


def test_texture_dataset_converts_cmyk_and_rgba_as_jax(tmp_path):
    for path in CMYK_FIXTURES:
        shutil.copy(path, tmp_path / path.name)
    rgba = fx.cmyk_content(21, 30, seed=3)     # four channels that are RGBA in a PNG
    Image.fromarray(rgba, "RGBA").save(tmp_path / "rgba.png")
    jds, tds = JTextureDataset(tmp_path), TextureDataset(tmp_path)
    assert len(tds) == len(jds) == 4
    for i in range(4):
        assert tds[i].dtype == np.float32 and np.array_equal(jds[i], tds[i]), tds.index[i]
    with Image.open(tmp_path / "small_cmyk_q90.jpg") as im:
        assert im.mode == "CMYK"
        rgb = np.asarray(im.convert("RGB"))
    assert np.array_equal(tds[tds.index.index(tmp_path / "small_cmyk_q90.jpg")],
                          rgb.astype(np.float32) / 255.0)
    assert not np.array_equal(rgb, np.asarray(im)[..., :3])   # not a slice of the channels


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_background_augmentation_over_cmyk_matches_jax(data_root, p):
    ja = jaug.BackgroundAugmentation(CMYK_FIXTURES, p=p, rng=random.Random(5))
    ta = taug.BackgroundAugmentation(CMYK_FIXTURES, p=p, rng=random.Random(5))
    for idx in list(range(9)):
        j, t = _observation(data_root, idx)
        assert_obs_equal(ja(j), ta(t))


@pytest.fixture(scope="module")
def gray_split(data_root, tmp_path_factory):
    """The recorded cubes as a BOP 'test' split with grayscale PNG frames:
    16-bit (Pillow's mode I;16), 8-bit (L) and one left as it was (RGB)."""
    root = tmp_path_factory.mktemp("gray_split")
    scene = root / "ds" / "test" / "000000"
    shutil.copytree(data_root / "synt_datasets" / "cubes" / "train_synt" / "000000", scene)
    for i, png_path in enumerate(sorted((scene / "rgb").glob("*.png"))):
        gray = np.asarray(Image.open(png_path).convert("L"))
        if i % 3 == 0:
            Image.fromarray(gray.astype(np.uint16) * 257 + 3).save(png_path)
        elif i % 3 == 1:
            Image.fromarray(gray).save(png_path)
    return root / "ds"


def test_bop_dataset_over_grayscale_frames_matches_jax(gray_split):
    """A 2-D frame, 8- or 16-bit, is repeated to three channels as in JAX."""
    jds, tds = JBOPDataset(gray_split, split="test"), BOPDataset(gray_split, split="test")
    assert len(tds) == len(jds) == 3
    with Image.open(gray_split / "test" / "000000" / "rgb" / "000000.png") as im:
        assert im.mode == "I;16"
    for i in range(3):
        assert_items_equal(jds[i], tds[i])
    assert tds[0][0].dtype == np.uint16 and tds[0][0].shape == (*tds[0][1].shape, 3)
