"""Port parity: the JAX package's public names that the port lacked until
its public surface was closed, each held to the JAX name on the same seeded
inputs: VisibilityWrapper, make_urdf_dataset, PoseData / PoseBatch,
PoseDataset.make_batch, DetectionDataset(seed=), masked_boxes_from_uv,
save_ply, BatchedMeshes.n_objects / n_sym / select / SelectedMeshes,
sample_points(deterministic=, seed=), DEBUG_DATA_DIR, Timer.reset and
ICPRefiner(resolution=).

Tolerance: none. Each is host numpy or a gather, so every array is equal.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosypose_tpu import config as jconfig
from cosypose_tpu.data import datasets_cfg as jcfg
from cosypose_tpu.data import detection_dataset as jdd
from cosypose_tpu.data.bop import BOPDataset as JBOPDataset
from cosypose_tpu.data.pose_dataset import PoseDataset as JPoseDataset
from cosypose_tpu.data.wrappers import VisibilityWrapper as JVisibilityWrapper
from cosypose_tpu.integrated.icp_refiner import ICPRefiner as JICPRefiner
from cosypose_tpu.ops import camera as jcam
from cosypose_tpu.ops import mesh_db as jdb
from cosypose_tpu.ops import mesh_io as jio
from cosypose_tpu.utils.timer import Timer as JTimer
from cosypose_tpu_torch import config as tconfig
from cosypose_tpu_torch.data import datasets_cfg as tcfg
from cosypose_tpu_torch.data import detection_dataset as tdd
from cosypose_tpu_torch.data.bop import BOPDataset
from cosypose_tpu_torch.data.pose_dataset import PoseBatch, PoseData, PoseDataset
from cosypose_tpu_torch.data.wrappers import VisibilityWrapper
from cosypose_tpu_torch.integrated.icp_refiner import ICPRefiner
from cosypose_tpu_torch.ops import camera as tcam
from cosypose_tpu_torch.ops import mesh_db as tdb
from cosypose_tpu_torch.ops import mesh_io as tio
from cosypose_tpu_torch.utils.timer import Timer
from tests.test_data import build_bop_fixture
from tests.test_torch_port_mesh_db import specs


@pytest.fixture(scope="module")
def bop_root(tmp_path_factory):
    return build_bop_fixture(tmp_path_factory.mktemp("bop"))


def _obs_objects(obs):
    return [(o["label"], o.get("visib_fract"), np.asarray(o["TWO"]).tolist()) for o in obs]


@pytest.mark.parametrize("th", [0.0, 0.1, 0.5, 1.0])
def test_visibility_wrapper_matches_jax(bop_root, th):
    ref = JVisibilityWrapper(JBOPDataset(bop_root, split="test"), visib_fract_th=th)
    got = VisibilityWrapper(BOPDataset(bop_root, split="test"), visib_fract_th=th)
    assert len(got) == len(ref)
    assert list(got.frame_index["view_id"]) == list(ref.frame_index["view_id"])
    for i in range(len(ref)):
        (jr, jm, jo), (tr, tm, to) = ref[i], got[i]
        assert np.array_equal(jr, tr) and np.array_equal(jm, tm)
        assert _obs_objects(to["objects"]) == _obs_objects(jo["objects"])
    if th == 0.1:   # the JAX package's own case (tests/test_data.py): 0.05 is dropped
        assert len(got[0][2]["objects"]) == 1


def test_visibility_wrapper_keeps_objects_without_visib_fract():
    frame = (np.zeros((2, 2, 3), np.uint8), np.zeros((2, 2), np.uint8),
             dict(objects=[dict(label="a"), dict(label="b", visib_fract=0.2)]))
    for wrapper in (JVisibilityWrapper, VisibilityWrapper):
        objects = wrapper([frame], visib_fract_th=0.5)[0][2]["objects"]
        assert [o["label"] for o in objects] == ["a"]
        assert len(frame[2]["objects"]) == 2   # the wrapped frame is not changed


def test_make_urdf_dataset_is_the_object_dataset(bop_root):
    root = bop_root.parents[1]
    ref = jcfg.make_urdf_dataset("cubes", ds_root=root)
    got = tcfg.make_urdf_dataset("cubes", ds_root=root)
    want = tcfg.make_object_dataset("cubes", ds_root=root)
    assert len(got) == len(ref) == len(want) == 2
    for i in range(len(ref)):
        assert got[i] == want[i]
        assert got[i]["label"] == ref[i]["label"]


def test_make_batch_matches_jax(bop_root):
    kw = dict(resize=(48, 64), visib_fract_th=0.0)
    ref = JPoseDataset(JBOPDataset(bop_root, split="test"), **kw)
    got = PoseDataset(BOPDataset(bop_root, split="test"), **kw)
    ids = [0, 2, 1, 0]
    jb, tb = ref.make_batch(ids), got.make_batch(ids)
    assert set(tb) == {f.name for f in dataclasses.fields(PoseData)}
    batch = PoseBatch(**tb)
    for f in ("images", "K", "TCO", "bboxes"):
        a, b = getattr(batch, f).numpy(), getattr(jb, f)
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert batch.images.dtype == torch.uint8 and batch.K.dtype == torch.float32
    assert batch.labels == jb.labels
    assert PoseBatch is PoseData and PoseDataset.collate_fn is not None


def test_detection_dataset_takes_the_seed(bop_root):
    labels = {"obj_000001": 0, "obj_000002": 1}
    assert "seed" in inspect.signature(tdd.DetectionDataset).parameters
    jds, tds = JBOPDataset(bop_root, split="test"), BOPDataset(bop_root, split="test")
    kw = dict(resize=(48, 64), min_area=4.0)
    for got in (tdd.DetectionDataset(tds, labels, seed=0, **kw),
                tdd.DetectionDataset(tds, labels, **kw)):
        ref = jdd.DetectionDataset(jds, labels, seed=0, **kw)
        for i in range(len(got)):
            r, t = ref[i], got[i]
            for k in r:
                assert np.array_equal(t[k], r[k]), (i, k)
    other = tdd.DetectionDataset(tds, labels, seed=5, **kw)
    assert other.rgb_aug.rng.random() == __import__("random").Random(5).random()


def test_masked_boxes_from_uv_matches_jax():
    rng = np.random.RandomState(0)
    uv = rng.uniform(-50, 300, (4, 9, 2)).astype(np.float32)
    valid = rng.uniform(size=(4, 9)) > 0.4
    valid[2] = False          # no valid row: (inf, inf, -inf, -inf)
    valid[3] = True
    ref = np.asarray(jcam.masked_boxes_from_uv(jnp.asarray(uv), jnp.asarray(valid)))
    got = tcam.masked_boxes_from_uv(torch.as_tensor(uv), torch.as_tensor(valid)).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(got[2], [np.inf, np.inf, -np.inf, -np.inf])
    assert np.array_equal(got[3], tcam.boxes_from_uv(torch.as_tensor(uv))[3].numpy())


@pytest.mark.parametrize("colors", ["none", "unit", "bytes"])
@pytest.mark.parametrize("faces", [True, False])
def test_save_ply_matches_jax_and_round_trips(tmp_path, colors, faces):
    rng = np.random.RandomState(1)
    verts = rng.normal(0, 40, (17, 3))
    tris = rng.randint(0, 17, (11, 3)) if faces else None
    cols = {"none": None, "unit": rng.uniform(size=(17, 3)),
            "bytes": rng.randint(0, 256, (17, 3)).astype(np.float64)}[colors]
    jio.save_ply(tmp_path / "jax.ply", verts, tris, cols)
    tio.save_ply(tmp_path / "port.ply", verts, tris, cols)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    v, f, c = tio.load_ply(str(tmp_path / "port.ply"))
    assert np.array_equal(v, verts.astype(np.float32).astype(np.float64))
    assert np.array_equal(f, tris if faces else np.zeros((0, 3), np.int64))
    if cols is None:
        assert c is None
    else:
        u8 = (np.clip(cols, 0, 255) * (255.0 if cols.max() <= 1 else 1.0)).astype(np.uint8)
        assert np.array_equal(c, u8 / 255.0)
    tio.save_ply(tmp_path / "ascii.ply", verts, tris, cols, binary=False)
    va, fa, ca = tio.load_ply(str(tmp_path / "ascii.ply"))
    assert np.allclose(va, verts, atol=5e-7) and np.array_equal(fa, f)
    assert (ca is None) == (c is None) and (ca is None or np.array_equal(ca, c))


def test_batched_meshes_select_and_counts_match_jax():
    ref = jdb.build_mesh_db(specs("mixed", jdb))
    got = tdb.build_mesh_db(specs("mixed", tdb), device="cpu")
    assert (got.n_objects, got.n_sym) == (ref.n_objects, ref.n_sym) == (3, ref.symmetries.shape[1])
    ids = np.array([2, 0, 1, 2, 0])
    rs, ts = ref.select(jnp.asarray(ids)), got.select(torch.as_tensor(ids))
    assert isinstance(ts, tdb.SelectedMeshes)
    for f in ("points", "valid", "symmetries", "sym_valid"):
        a = getattr(ts, f)
        assert a.device == got.device and np.array_equal(a.numpy(), np.asarray(getattr(rs, f))), f


@pytest.mark.parametrize("deterministic,seed", [(True, 0), (True, 3), (False, 3), (False, 11)])
def test_sample_points_seed_matches_jax(deterministic, seed):
    ref = jdb.build_mesh_db(specs("mixed", jdb))
    got = tdb.build_mesh_db(specs("mixed", tdb), device="cpu")
    ids = np.array([1, 2, 0])
    a = got.sample_points(torch.as_tensor(ids), 40, deterministic=deterministic, seed=seed)
    b = ref.sample_points(jnp.asarray(ids), 40, deterministic=deterministic, seed=seed)
    assert np.array_equal(a.numpy(), np.asarray(b))


def test_debug_data_dir_matches_jax(monkeypatch, tmp_path):
    import importlib

    assert tconfig.DEBUG_DATA_DIR == jconfig.DEBUG_DATA_DIR
    assert tconfig.DEBUG_DATA_DIR == tconfig.LOCAL_DATA_DIR / "debug_data"
    monkeypatch.setenv("COSYPOSE_TPU_DEBUG_DIR", str(tmp_path))
    try:
        assert importlib.reload(tconfig).DEBUG_DATA_DIR == importlib.reload(jconfig).DEBUG_DATA_DIR \
            == tmp_path
    finally:
        monkeypatch.undo()
        importlib.reload(tconfig)
        importlib.reload(jconfig)


def test_timer_reset_matches_jax():
    for timer in (JTimer(), Timer()):
        timer.start()
        timer.pause()
        timer.elapsed = 3.0
        assert timer.reset() is timer
        assert (timer.start_time, timer.elapsed, timer.is_running) == (None, 0.0, False)
        timer.resume()
        assert timer.is_running
        timer.reset()
        assert not timer.is_running and timer.stop().total_seconds() == 0.0


def test_icp_refiner_takes_the_resolution():
    db = tdb.build_mesh_db(specs("mixed", tdb), device="cpu")
    assert ICPRefiner(db).resolution == JICPRefiner(None).resolution == (240, 320)
    assert ICPRefiner(db, resolution=(480, 640)).resolution == (480, 640)
