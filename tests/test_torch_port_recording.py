"""Port parity: synthetic scene recording against the JAX package on the CPU.

The procedural objects and textures, the sampler's placement, cage and
cameras (the same np.random.RandomState draws), SceneRenderer, a sampled
scene's frames, and record_dataset's BOP output. The JAX package renders on
the CPU through its XLA rasterizer at tile (24, 64), the port through the
plain versions of its kernels at tile (8, 320): the images agree while no
tile reaches its triangle budget, which test_scene_budget_is_not_reached
shows. Small scenes: the two cubes of tests/test_pose_predictor.py at
96x128, as tests/test_recording.py records them.

Tolerances: specs, textures, placements, cameras, masks, instance ids and
boxes exactly equal; rgb within 1 of 255 (a colour within rounding of a
1/255 step lands on either side of it, and the quantization truncates);
depth within 1 mm (whole millimetres, truncated); GT JSON within 1e-3 mm;
visibility fractions exactly equal.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

from cosypose_tpu.data.bop import BOPDataset as JBOPDataset
from cosypose_tpu.data.procedural_objects import make_procedural_specs as j_specs
from cosypose_tpu.data.texture_dataset import TextureDataset as JTextureDataset
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.recording import RecordingSceneSampler as JSampler
from cosypose_tpu.recording import record_dataset as j_record_dataset
from cosypose_tpu.recording import scene_sampler as j_scene_sampler
from cosypose_tpu.recording import textures as jtex
from cosypose_tpu.rendering import SceneRenderer as JSceneRenderer
from cosypose_tpu.scripts import run_dataset_recording as j_cli
from cosypose_tpu_torch.data.bop import BOPDataset
from cosypose_tpu_torch.data.datasets_cfg import make_scene_dataset
from cosypose_tpu_torch.data.procedural_objects import ProceduralObjectDataset, make_procedural_specs
from cosypose_tpu_torch.data.texture_dataset import TextureDataset
from cosypose_tpu_torch.ops import rasterizer_cuda as rc
from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
from cosypose_tpu_torch.ops.transforms import invert_T
from cosypose_tpu_torch.recording import RecordingSceneSampler, record_dataset
from cosypose_tpu_torch.recording import scene_sampler
from cosypose_tpu_torch.recording import textures as ttex
from cosypose_tpu_torch.rendering import SceneRenderer
from cosypose_tpu_torch.rendering.scene_renderer import SCENE_BUDGET, SCENE_TILE
from cosypose_tpu_torch.scripts import run_dataset_recording as cli
from cosypose_tpu_torch.utils import png
from cosypose_tpu_torch.utils.jpeg import JPEGError
from tests.test_pose_predictor import cube_specs

RES = (96, 128)
SAMPLER = dict(resolution=RES, n_objects_interval=(3, 5), min_visible_pixels=10,
               border_check=False, camera_distance_interval=(0.5, 0.9), place_mode="pile",
               p_cage=1.0, n_views_per_scene=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The fast tier runs several test processes side by side on the CPU's
    cores; PyTorch's own thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_specs(specs):
    return [MeshSpec(**dataclasses.asdict(s)) for s in specs]


@pytest.fixture(scope="module")
def dbs():
    """(JAX mesh db, port mesh db on the CPU) of the two cubes."""
    return j_build_mesh_db(cube_specs()), build_mesh_db(port_specs(cube_specs()), device="cpu")


def samplers(dbs, p_textured=0.8, **kw):
    jdb, tdb = dbs
    kw = dict(SAMPLER, **kw)
    return (JSampler(jdb, texture_sampler=jtex.TextureSampler(p_textured=p_textured), **kw),
            RecordingSceneSampler(tdb, texture_sampler=ttex.TextureSampler(p_textured=p_textured),
                                  **kw))


def assert_frames_match(jframes, tframes):
    assert len(jframes) == len(tframes) > 0
    for (jr, jm, jo), (tr, tm, to) in zip(jframes, tframes):
        assert np.array_equal(jm, tm)
        assert np.abs(jr.astype(int) - tr).max() <= 1
        assert np.abs(jo["camera"]["depth"] - to["camera"]["depth"]).max() <= 1e-3 + 1e-6
        assert np.array_equal(jo["camera"]["K"], to["camera"]["K"])
        assert np.array_equal(jo["camera"]["TWC"], to["camera"]["TWC"])
        assert [o["label"] for o in jo["objects"]] == [o["label"] for o in to["objects"]]
        for a, b in zip(jo["objects"], to["objects"]):
            assert np.array_equal(a["TWO"], b["TWO"])
            assert np.array_equal(a["bbox"], b["bbox"])
            assert np.array_equal(a["bbox_obj"], b["bbox_obj"])
            assert a["visib_fract"] == b["visib_fract"] and a["id_in_segm"] == b["id_in_segm"]


def test_demo_cubes_are_the_tests_cubes():
    from cosypose_tpu_torch import demo

    for a, b in zip(cube_specs(), demo.cube_specs()):
        assert a.label == b.label
        assert np.array_equal(a.vertices, b.vertices) and np.array_equal(a.faces, b.faces)


@pytest.mark.parametrize("texture", ["twotone", "sine"])
def test_procedural_specs_equal(texture):
    for a, b in zip(j_specs(3, seed=2, texture=texture),
                    make_procedural_specs(3, seed=2, texture=texture)):
        assert a.label == b.label
        for k in ("vertices", "faces", "colors"):
            assert getattr(a, k).dtype == getattr(b, k).dtype
            assert np.array_equal(getattr(a, k), getattr(b, k))
    ds = ProceduralObjectDataset(texture=texture)
    assert len(ds) == 8 and ds.labels[-1] == "obj_000008"
    # 20 x 32 vertices, 2 x 19 x 32 triangles: 1216 rows a procedural object
    assert ds.mesh_specs()[0].faces.shape == (1216, 3)


def _png_textures(tmp_path):
    d = tmp_path / "textures" / "sub"
    d.mkdir(parents=True)
    for i in range(3):
        rgb = np.random.RandomState(i).randint(0, 256, (16 + i, 20, 3)).astype(np.uint8)
        png.imwrite(d / f"tex{i}.png", rgb)
    return tmp_path / "textures"


@pytest.mark.parametrize("kind", ["procedural", "triplanar", "sampler"])
def test_textures_equal(kind, tmp_path):
    tv = np.random.RandomState(0).uniform(-0.05, 0.05, size=(40, 3, 3))
    if kind == "procedural":
        outs = [m.procedural_corner_colors(tv, np.random.RandomState(5)) for m in (jtex, ttex)]
    elif kind == "triplanar":
        tex = np.random.RandomState(1).uniform(0, 1, size=(32, 32, 3)).astype(np.float32)
        outs = [m.triplanar_corner_colors(tv, tex, np.random.RandomState(5)) for m in (jtex, ttex)]
    else:
        root = _png_textures(tmp_path)
        outs = []
        for m, ds in ((jtex, JTextureDataset(root)), (ttex, TextureDataset(root))):
            s, rng = m.TextureSampler(texture_dataset=ds, p_textured=0.6), np.random.RandomState(3)
            outs.append(np.stack([c if c is not None else np.zeros_like(tv, np.float32)
                                  for c in (s.apply(tv, rng) for _ in range(6))]))
    assert outs[0].dtype == outs[1].dtype and np.array_equal(outs[0], outs[1])


def test_texture_dataset_reads_pngs_and_refuses_jpeg(tmp_path):
    root = _png_textures(tmp_path)
    jds, tds = JTextureDataset(root), TextureDataset(root)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        assert np.array_equal(jds[i], tds[i]) and tds[i].dtype == np.float32
    # JPEG textures read as Pillow's convert("RGB") gives them; a broken one
    # raises a named error
    Image.fromarray((np.arange(17 * 23 * 3) % 251).astype(np.uint8).reshape(17, 23, 3)).save(
        root / "sub" / "tex9.jpg", quality=80)
    Image.fromarray((np.arange(9 * 11) % 253).astype(np.uint8).reshape(9, 11)).save(
        root / "texa.jpeg", quality=60)
    jds, tds = JTextureDataset(root), TextureDataset(root)
    assert len(tds) == len(jds) == 5
    for i in range(5):
        assert np.array_equal(jds[i], tds[i]) and tds[i].shape[2] == 3
    (root / "sub" / "tex9.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(16))
    with pytest.raises(JPEGError, match="tex9.jpg"):
        TextureDataset(root)[3]


def test_mask_stats_equal():
    mask = np.random.RandomState(0).uniform(size=(5, 12, 17)) > 0.97
    mask[1] = False
    j_counts, j_box = j_scene_sampler._mask_stats(mask)
    t_counts, t_box = scene_sampler.mask_stats(torch.as_tensor(mask))
    assert np.array_equal(np.asarray(j_counts), t_counts.numpy())
    assert np.array_equal(np.asarray(j_box), t_box.numpy())


@pytest.mark.parametrize("place_mode", ["pile", "floating"])
def test_placement_cage_and_cameras_equal(dbs, place_mode):
    js, ts = samplers(dbs, place_mode=place_mode, n_objects_interval=(4, 6))
    for seed in range(3):
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        jo, to = js._sample_objects(jr), ts._sample_objects(tr)
        assert [o["label"] for o in jo] == [o["label"] for o in to]
        for a, b in zip(jo, to):
            assert np.array_equal(a["TWO"], b["TWO"])
            assert ("colors" in a) == ("colors" in b)
            assert "colors" not in a or np.array_equal(a["colors"], b["colors"])
        for a, b in zip(js._cage_geometry(jr), ts._cage_geometry(tr)):
            for k in ("tri_verts", "colors"):
                assert np.array_equal(a["geometry"][k], b["geometry"][k])
        for a, b in zip([js._sample_camera(jr) for _ in range(3)],
                        [ts._sample_camera(tr) for _ in range(3)]):
            assert np.array_equal(a["K"], b["K"]) and np.array_equal(a["TWC"], b["TWC"])
        assert jr.randint(1 << 30) == tr.randint(1 << 30)  # the streams stay in step


def test_pile_rests_without_penetration(dbs):
    ts = RecordingSceneSampler(dbs[1], n_objects_interval=(6, 9))
    rng = np.random.RandomState(3)
    labels = [dbs[1].labels[rng.randint(len(dbs[1].labels))] for _ in range(8)]
    placed = ts._place_pile(labels, rng)
    for p in placed:
        assert p["t"][2] >= p["r_c"] - 1e-9
    for i in range(len(placed)):
        for j in range(i + 1, len(placed)):
            d = np.linalg.norm(placed[i]["t"] - placed[j]["t"])
            assert d >= placed[i]["r_c"] + placed[j]["r_c"] - 1e-6
    assert any(p["t"][2] > p["r_c"] + 1e-6 for p in placed)


def _scene(sampler, seed=4):
    rng = np.random.RandomState(seed)
    objs = sampler._sample_objects(rng)
    return objs + sampler._cage_geometry(rng), [sampler._sample_camera(rng) for _ in range(3)]


@pytest.mark.parametrize("path", ["batched", "per_camera"])
def test_scene_renderer_matches_jax(dbs, path):
    js, ts = samplers(dbs, n_objects_interval=(4, 5))
    scene, cams = _scene(ts)
    if path == "per_camera":  # cameras of different resolutions: one render call each
        cams[1] = dict(cams[1], resolution=(64, 96))
    ref = JSceneRenderer(dbs[0]).render_scene(scene, cams, render_depth=True)
    before = dict(rc.RASTER_KERNEL.launches)
    out = SceneRenderer(dbs[1]).render_scene(scene, cams, render_depth=True)
    assert rc.RASTER_KERNEL.launches == before  # CPU tensors: the plain versions
    for r, o in zip(ref, out):
        assert np.array_equal(r["instance_ids"], o["instance_ids"])
        assert np.array_equal(r["mask"], o["mask"])
        assert set(np.unique(o["instance_ids"]).tolist()) >= {0, 1, 2}
        if path == "batched":  # quantized: rgb in 1/255 steps, depth in mm
            assert np.abs(r["rgb"] - o["rgb"]).max() <= 1 / 255 + 1e-6
            assert np.abs(r["depth"] - o["depth"]).max() <= 1e-3 + 1e-6
        else:
            assert np.abs(r["rgb"] - o["rgb"]).max() <= 1e-4
            assert np.abs(r["depth"] - o["depth"]).max() <= 1e-4


def test_scene_budget_is_not_reached():
    """No tile of a recorded scene lists as many chunks as the budget allows,
    at the port's tile (8, 320) nor at the JAX package's CPU tile (24, 64),
    so the two rasterizers agree: on the test scenes, and on a full-width
    procedural scene of 7 objects and the cage (8,872 rows, budget 6144)."""
    cubes = RecordingSceneSampler(build_mesh_db(port_specs(cube_specs()), device="cpu"),
                                  **dict(SAMPLER, n_objects_interval=(4, 5)))
    proc = RecordingSceneSampler(
        build_mesh_db(make_procedural_specs(), device="cpu"), resolution=(240, 320),
        focal_interval=(530.0, 540.0), camera_distance_interval=(0.45, 1.0),
        n_objects_interval=(7, 8), texture_sampler=ttex.TextureSampler(p_textured=0.8))
    for sampler, seed in ((cubes, 4), (proc, 0)):
        scene, cams = _scene(sampler, seed)
        tv, valid, colors, ids = sampler.renderer.soup(scene)
        n = len(cams)

        def bc(x):
            return torch.as_tensor(x)[None].expand(n, *x.shape)

        TCW = invert_T(torch.as_tensor(np.stack([c["TWC"] for c in cams])))
        K = torch.as_tensor(np.stack([c["K"] for c in cams]))
        rows, key = rc.setup_plain(bc(tv), bc(valid), TCW, K, sampler.resolution, bc(colors),
                                   tri_attr=bc(ids.astype(np.float32)))
        order = rc.sort_order(key)
        budget = rc.chunk_budget(min(tv.shape[0], SCENE_BUDGET), rows.shape[1])
        for tile in (SCENE_TILE, (24, 64)):
            _, _, counts = rc.bin_chunks(rows, order, sampler.resolution, tile, 1 << 30)
            assert 0 < int(counts.max()) < budget, (tile, int(counts.max()), budget)
    assert tv.shape[0] == 7 * 1216 + 5 * 72


def test_sample_scene_frames_matches_jax(dbs):
    js, ts = samplers(dbs)
    assert_frames_match(js.sample_scene_frames(7, 3), ts.sample_scene_frames(7, 3))
    assert ts.counts["scene_renders"] >= 1 and ts.counts["amodal_renders"] >= 1
    assert_frames_match([js.sample_frame(11)], [ts.sample_frame(11)])


def _json(scene_dir, name):
    return json.loads((scene_dir / name).read_text())


def _assert_close(a, b, atol=1e-3):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_close(a[k], b[k], atol)
    elif isinstance(a, list) and a and isinstance(a[0], (dict, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_close(x, y, atol)
    else:
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                   rtol=0, atol=atol)


def test_record_dataset_matches_jax(dbs, tmp_path):
    js, ts = samplers(dbs)
    jdir = j_record_dataset(js, tmp_path / "jax", n_chunks=2, n_frames_per_chunk=4)
    tdir = record_dataset(ts, tmp_path / "port", n_chunks=2, n_frames_per_chunk=4)
    assert (tdir / "chunks_recorded.txt").read_text().split() == ["0", "1"]
    assert _json(tdir, "split_keys.json") == _json(jdir, "split_keys.json") == dict(
        train=["000000"], val=["000001"])
    for chunk in ("000000", "000001"):
        j_scene, t_scene = jdir / "train_synt" / chunk, tdir / "train_synt" / chunk
        for name in ("scene_camera.json", "scene_gt.json", "scene_gt_info.json"):
            _assert_close(_json(j_scene, name), _json(t_scene, name))  # 1e-3 mm
        files = sorted(p.relative_to(j_scene) for p in j_scene.rglob("*.png"))
        assert files == sorted(p.relative_to(t_scene) for p in t_scene.rglob("*.png"))
        for f in files:
            from PIL import Image

            ref = np.asarray(Image.open(j_scene / f)).astype(int)
            out = png.imread(t_scene / f).astype(int)
            assert ref.shape == out.shape
            assert np.abs(ref - out).max() <= (0 if f.parts[0] == "mask_visib" else 1), f
    # both packages' readers see the same frames in the port's recording
    jds, tds = JBOPDataset(tdir, split="train_synt"), BOPDataset(tdir, split="train_synt")
    assert len(tds) == len(jds) == 8
    for i in range(8):
        (jr, jm, jo), (tr, tm, to) = jds[i], tds[i]
        assert np.array_equal(jr, tr) and np.array_equal(jm, tm)
        assert [o["label"] for o in jo["objects"]] == [o["label"] for o in to["objects"]]


def test_record_dataset_resumes_from_its_ledger(dbs, tmp_path):
    _, ts = samplers(dbs)
    ds_dir = tmp_path / "synt_datasets" / "synt"
    ds_dir.mkdir(parents=True)
    (ds_dir / "chunks_recorded.txt").write_text("0\n")
    record_dataset(ts, ds_dir, n_chunks=3, n_frames_per_chunk=1, train_fraction=0.7)
    assert (ds_dir / "chunks_recorded.txt").read_text().split() == ["0", "1", "2"]
    assert not (ds_dir / "train_synt" / "000000").exists()   # done before: not recorded again
    assert sorted(p.name for p in (ds_dir / "train_synt").iterdir()) == ["000001", "000002"]
    assert _json(ds_dir, "split_keys.json") == dict(train=["000000", "000001"], val=["000002"])
    assert len(make_scene_dataset("synthetic.synt.val", ds_root=tmp_path)) == 1


def tiny_sampler():
    """A picklable factory for the fan-out test: the cubes at 32x48 on the CPU."""
    return RecordingSceneSampler(build_mesh_db(port_specs(cube_specs()), device="cpu"),
                                 resolution=(32, 48), n_objects_interval=(1, 3),
                                 min_visible_pixels=5, border_check=False,
                                 camera_distance_interval=(0.5, 0.9), amodal_stats=False)


def test_record_dataset_fans_out_over_workers(tmp_path):
    ds_dir = record_dataset(None, tmp_path / "synt", n_chunks=3, n_frames_per_chunk=1,
                            n_workers=2, sampler_factory=tiny_sampler)
    assert sorted(int(x) for x in (ds_dir / "chunks_recorded.txt").read_text().split()) == [0, 1, 2]
    assert len(BOPDataset(ds_dir, split="train_synt")) == 3


def test_recording_cli_configs_and_tiny_run(monkeypatch, tmp_path):
    assert cli.CONFIGS == j_cli.CONFIGS
    for name in ("procedural", "procedural-canon"):
        ts = cli._make_sampler(name, device="cpu")
        js = j_cli._make_sampler(name)
        for k in ("resolution", "focal_interval", "n_objects_interval", "n_views_per_scene",
                  "camera_distance_interval", "min_visible_pixels", "place_mode", "p_cage"):
            assert getattr(ts, k) == getattr(js, k), k
        assert ts.texture_sampler.p_textured == js.texture_sampler.p_textured
        assert np.array_equal(ts.radii, js.radii)
    # the CLI end to end on the CPU, at a tiny size: one procedural object, 2 views
    monkeypatch.setitem(cli.CONFIGS, "tiny", dict(
        obj="procedural", resolution=(32, 48), focal=(530.0, 540.0), n_frames=4, p_textured=0.0,
        sampler_kwargs=dict(camera_distance_interval=(0.25, 0.35), n_objects_interval=(1, 2),
                            min_visible_pixels=5, n_views_per_scene=2, place_mode="floating",
                            p_cage=0.0, border_check=False)))
    out = cli.main(["--config", "tiny", "--out", str(tmp_path / "synt_datasets" / "tiny"),
                    "--chunk-size", "2", "--device", "cpu"])
    ds = make_scene_dataset("synthetic.tiny.train", ds_root=tmp_path)
    assert out.exists() and len(ds) == 2 and ds.cache_in_memory
    rgb, mask, obs = ds[0]
    assert rgb.shape == (32, 48, 3) and mask.max() >= 1 and obs["objects"]
