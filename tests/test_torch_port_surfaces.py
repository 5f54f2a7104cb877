"""The port's inspection surfaces and remaining CLIs against the JAX package's
on the CPU: the prediction overlay and the scene renderings (through the
raster operators' plain versions), the rest of TensorCollection, utils/misc,
the matplotlib plotter, the HTML dashboard, the results tables, the COLMAP
model IO, and a small run of each new CLI (on tests/test_data.py's BOP
fixture where it reads a dataset).

Same inputs on both sides, from numpy seeds. Tolerances: the overlay and the
scene renderings within one uint8 level of the JAX images, except where a
pixel centre lies within rounding of a triangle edge (ROADMAP §3: XLA:CPU
contracts the plane evaluation into an FMA, the port rounds each op), at
most 11 pixels as there; everything on the host (HTML, tables, COLMAP files,
PLY text, masks, random draws) exactly equal.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.utils import colmap_io as jcolmap
from cosypose_tpu.utils import misc as jmisc
from cosypose_tpu.utils.tensor_collection import PandasTensorCollection
from cosypose_tpu.utils.tensor_collection import TensorCollection as JTensorCollection
from cosypose_tpu.visualization import dashboard as jdash
from cosypose_tpu.visualization import plotter as jplotter
from cosypose_tpu.visualization.multiview import make_scene_renderings as j_scene_renderings
from cosypose_tpu.visualization.singleview import render_prediction_overlay as j_overlay
from cosypose_tpu.scripts import convert_models as j_convert
from cosypose_tpu.scripts import preprocess_bop_dataset as j_preprocess
from cosypose_tpu.scripts import print_results_table as j_table
from cosypose_tpu.scripts import render_readme_tables as j_readme
from cosypose_tpu_torch.ops import rasterizer_cuda as rc
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.scripts import (convert_models, make_dashboard, preprocess_bop_dataset,
                                        print_results_table, render_readme_tables,
                                        run_bop20_eval_multi, run_colmap_reconstruction,
                                        test_dataset, test_render_objects)
from cosypose_tpu_torch.utils import colmap_io, misc, png
from cosypose_tpu_torch.utils.tensor_collection import TensorCollection
from cosypose_tpu_torch.visualization import dashboard, plotter
from cosypose_tpu_torch.visualization.multiview import make_scene_renderings
from cosypose_tpu_torch.visualization.singleview import render_prediction_overlay
from tests.test_colmap_io import _toy_model
from tests.test_data import build_bop_fixture
from tests.test_pose_predictor import cube_specs
from tests.test_torch_port_slice import port_specs

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
EDGE_PIXELS = 11   # ROADMAP §3: pixel-centre edges, FMA vs separately rounded planes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The fast tier runs several test processes side by side on the CPU's
    cores; PyTorch's own thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dbs():
    """(JAX mesh db, port mesh db on the CPU) of the two test cubes."""
    return j_build_mesh_db(cube_specs()), build_mesh_db(port_specs(), device="cpu")


@pytest.fixture(scope="module")
def bop(tmp_path_factory):
    """The BOP fixture's data root (<root>/bop_datasets/cubes)."""
    return build_bop_fixture(tmp_path_factory.mktemp("bop")).parents[1]


def _pose(seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-np.pi, np.pi, 3)
    cx, sx, cy, sy, cz, sz = np.cos(a[0]), np.sin(a[0]), np.cos(a[1]), np.sin(a[1]), \
        np.cos(a[2]), np.sin(a[2])
    TCO = np.eye(4, dtype=np.float32)
    TCO[:3, :3] = (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
                   @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                   @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))
    TCO[:3, 3] = [rng.uniform(-0.03, 0.03), rng.uniform(-0.03, 0.03), rng.uniform(0.4, 0.6)]
    return TCO


def _differing(a, b, levels=1):
    return int((np.abs(a.astype(int) - b.astype(int)) > levels).any(-1).sum())


@pytest.mark.parametrize("label,seed", [("obj_000001", 0), ("obj_000002", 1), ("obj_000002", 2)])
def test_prediction_overlay_matches_jax(dbs, label, seed):
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (96, 128, 3), np.uint8)
    K = np.array([[150.0, 0, 64], [0, 150.0, 48], [0, 0, 1]], np.float32)
    TCO = _pose(seed)
    want = j_overlay(dbs[0], rgb, TCO, K, label)
    launches = dict(rc.RASTER_KERNEL.launches)
    got = render_prediction_overlay(dbs[1], rgb, TCO, K, label)
    assert rc.RASTER_KERNEL.launches == launches  # CPU tensors: the plain versions
    assert got.shape == want.shape and got.dtype == np.uint8
    assert _differing(got, want) <= EDGE_PIXELS
    assert (got != rgb).any(-1).sum() > 100  # the object was drawn


def test_scene_renderings_match_jax(dbs):
    TWO = np.stack([_pose(3), _pose(4), _pose(5)])
    TWO[:, :3, 3] = [[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.14, 0.005, 0.0]]
    infos = dict(label=np.array(["obj_000001", "obj_000002", "obj_000002"]),
                 score=np.array([0.9, 0.8, 0.7]))
    want = j_scene_renderings(PandasTensorCollection(pd.DataFrame(infos), TWO=jnp.asarray(TWO)),
                              None, dbs[0], n_frames=4, resolution=(96, 128), orbit_radius=0.8)
    got = make_scene_renderings(TensorCollection(infos, TWO=torch.as_tensor(TWO)), None, dbs[1],
                                n_frames=4, resolution=(96, 128), orbit_radius=0.8)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape == (96, 128, 3) and g.dtype == np.uint8
        assert _differing(g, w) <= EDGE_PIXELS and g.any()


def test_tensor_collection_methods_match_jax():
    rng = np.random.RandomState(0)
    a, b, c = (rng.normal(size=s).astype(np.float32) for s in ((3, 4, 4), (3, 2), (3, 4, 4)))
    j, t = JTensorCollection(poses=jnp.asarray(a)), TensorCollection({}, poses=torch.as_tensor(a))
    for coll, conv in ((j, jnp.asarray), (t, torch.as_tensor)):
        coll.register_tensor("boxes", conv(b))
        coll.poses = conv(c)            # writes through to the tensor
        coll.note = "kept as attribute"
    assert list(j.tensors) == list(t.tensors) == ["poses", "boxes"]
    assert t.note == j.note and "note" not in t.tensors
    jn, tn = j.to_numpy(), t.to_numpy()
    for k in ("poses", "boxes"):
        assert isinstance(tn.tensors[k], np.ndarray)
        np.testing.assert_array_equal(tn.tensors[k], jn.tensors[k])
    np.testing.assert_array_equal(tn[[2, 0]].poses, c[[2, 0]])
    assert repr(t) == repr(j)
    for coll in (j, t):
        coll.delete_tensor("boxes")
    assert list(j.tensors) == list(t.tensors) == ["poses"]
    with pytest.raises(ValueError):
        t.register_tensor("short", torch.zeros(2))
    labelled = TensorCollection(dict(label=np.array(["a", "b", "c"])), poses=torch.as_tensor(a))
    assert repr(labelled).startswith(repr(t).split("\n")[0]) and "label" in repr(labelled)


def test_misc_matches_jax():
    with jmisc.temp_numpy_seed(7):
        want = np.random.rand(5)
    before = np.random.get_state()[1].copy()
    with misc.temp_numpy_seed(7):
        got = np.random.rand(5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.random.get_state()[1], before)  # restored
    assert misc.get_total_memory_mb() > 0 and jmisc.get_total_memory_mb() > 0
    assert misc.assign_gpu() is None and misc.patch_tqdm() is None


def test_plotter_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.uniform(size=(3, 24, 32)).astype(np.float32)
    ren = (rng.uniform(size=(24, 32, 3)) * (rng.uniform(size=(24, 32, 1)) > 0.5)).astype(
        np.float32)
    boxes = np.array([[2, 3, 10, 12], [5, 1, 20, 9]], np.float32)
    infos = dict(label=np.array(["obj_a", "obj_b"]), score=np.array([0.9, 0.25]))
    jdets = PandasTensorCollection(pd.DataFrame(infos), bboxes=jnp.asarray(boxes))
    tdets = TensorCollection(infos, bboxes=torch.as_tensor(boxes))
    axes = {}
    for name, p, dets in (("jax", jplotter.Plotter(), jdets), ("port", plotter.Plotter(), tdets)):
        ax = p.plot_image(img)
        p.plot_detections(ax, dets)
        axes[name] = (ax, p.plot_overlay(img * 255, ren), p)
    (ja, ja2, _), (ta, ta2, tp) = axes["jax"], axes["port"]
    np.testing.assert_array_equal(ta.images[0].get_array(), ja.images[0].get_array())
    np.testing.assert_array_equal(ta2.images[0].get_array(), ja2.images[0].get_array())
    assert [t.get_text() for t in ta.texts] == [t.get_text() for t in ja.texts] \
        == ["obj_a 0.90", "obj_b 0.25"]
    assert [r.get_bbox().bounds for r in ta.patches] == [r.get_bbox().bounds for r in ja.patches]
    tp.save(ta, tmp_path / "dets.png")
    assert png.imread(tmp_path / "dets.png").ndim == 3

    run = tmp_path / "run-a"
    run.mkdir()
    records = [{"epoch": i, "train/loss_total": 1.0 / (i + 1)} for i in range(3)]
    (run / "log.txt").write_text("\n".join(json.dumps(r) for r in records) + "\n")
    jfig = jplotter.plot_training_logs([run])
    tfig = plotter.plot_training_logs([run], out_path=tmp_path / "logs.png")
    jl, tl = jfig.axes[0].lines[0], tfig.axes[0].lines[0]
    np.testing.assert_array_equal(tl.get_xydata(), jl.get_xydata())
    assert (tmp_path / "logs.png").exists()


@pytest.fixture()
def run_dirs(tmp_path):
    """Two runs as the port's trainer writes them: config.yaml is JSON."""
    dirs = []
    for name, lr, losses in [("run-a", 1e-3, [0.5, 0.3, 0.2]), ("run-b", 3e-4, [0.6, 0.4, 0.35])]:
        d = tmp_path / "exp" / name
        d.mkdir(parents=True)
        (d / "config.yaml").write_text(json.dumps(dict(run_id=name, lr=lr, batch_size=32,
                                                       train=dict(n_iterations=3)), indent=2))
        records = [dict(epoch=i, **{"train/loss_total": v, "test/iter=3/ADD_median": 0.1 * i,
                                    "eval/val/ADD_AUC": 0.05 * i})
                   for i, v in enumerate(losses)]
        (d / "log.txt").write_text("\n".join(json.dumps(r) for r in records) + "\n")
        dirs.append(d)
    return dirs


def test_dashboard_matches_jax(run_dirs, tmp_path):
    runs, jruns = dashboard.load_runs(run_dirs), jdash.load_runs(run_dirs)
    assert runs == jruns
    assert dashboard.config_diff(runs) == jdash.config_diff(jruns) != []
    for prefix in ("train/", "eval/", "test/"):
        assert dashboard.discover_fields(runs, prefix) == jdash.discover_fields(jruns, prefix)
    got = dashboard.make_dashboard(run_dirs, tmp_path / "port.html").read_text()
    assert got == jdash.make_dashboard(run_dirs, tmp_path / "jax.html").read_text()
    assert "run-b" in got and "train/loss_total" in got
    out = make_dashboard.main(["--exp-dir", str(run_dirs[0].parent),
                               "--out", str(tmp_path / "cli.html")])
    assert out.read_text() == got
    (run_dirs[0] / "config.yaml").write_text("lr: 0.001\n")
    with pytest.raises(ValueError, match="JSON"):
        dashboard.load_runs(run_dirs)


def _pair_stats(add, dxy, dz, frac, rot):
    return dict(ADD_mean=add, ADD_median=add, ADD_p90=2 * add, dxy_mean=dxy, dz_mean=dz,
                frac_ADD_lt_0p1d=frac, rot_deg_median=rot)


PAYLOADS = {
    "per_pair_rot": dict(run_id="r", dataset="d", n_iterations=2, per_pair={
        "init": _pair_stats(0.03, 0.01, 0.02, 0.1, 5.0),
        "iteration=1": _pair_stats(0.015, 0.005, 0.012, 0.4, 2.0),
        "iteration=2": _pair_stats(0.012, 0.004, 0.01, 0.5, 1.0)},
        matched_auc={"init": {"AUC": 0.1}, "refined": {"AUC": 0.5}}),
    "per_pair_trans": dict(run_id="r", dataset="d", n_iterations=1, per_pair={
        "init": _pair_stats(0.02, 0.01, 0.01, 0.2, 0.006),
        "iteration=1": _pair_stats(0.01, 0.005, 0.006, 0.6, 0.005)}),
    "detection": dict(detector="det", dataset="d", metrics={
        "bbox@0.5": dict(recall=0.8, AP=0.3, mAP=0.25, n_gt=100, n_matched=80),
        "mask@0.5": dict(recall=0.5, AP=0.2, mAP=0.15, n_gt=100)}),
    "summary": dict(detector="det", summary={"recall@0.5": 0.8, "mAP": 0.3, "mask_mIoU": 0.6}),
}


@pytest.mark.parametrize("kind", list(PAYLOADS))
def test_results_tables_match_jax(kind, tmp_path, capsys):
    payload = PAYLOADS[kind]
    if "per_pair" in payload:
        assert print_results_table.per_pair_table(payload) == j_table.per_pair_table(payload)
    assert print_results_table.detection_table(payload) == j_table.detection_table(payload)
    path = tmp_path / f"{kind}.json"
    path.write_text(json.dumps(payload))
    print_results_table.main([str(path)])
    got = capsys.readouterr().out
    j_table.main([str(path)])
    assert got == capsys.readouterr().out and got.startswith("### ")


def test_readme_tables_match_jax(tmp_path):
    text = (REPO / "README.md").read_text()
    assert render_readme_tables._BLOCK.findall(text)
    assert render_readme_tables.render_blocks(text, REPO) == j_readme.render_blocks(text, REPO)
    present = [m for m in render_readme_tables._BLOCK.finditer(text)
               if (REPO / m.group("path")).exists()]
    assert {m.group("kind") for m in present} >= {"per_pair", "multiview", "bop19_ar",
                                                  "detection", "step_breakdown"}
    mutated = text
    for m in present:  # every block with its artifact, stale by one row
        mutated = mutated.replace(m.group(0), m.group(0).replace(
            "<!-- /rendered-from -->", "| fake row |\n<!-- /rendered-from -->"))
    _, drifted, _ = render_readme_tables.render_blocks(mutated, REPO, check=True)
    assert drifted == [m.group("path") for m in present]
    readme = tmp_path / "README.md"
    readme.write_text(mutated)
    assert render_readme_tables.main(["--check", "--readme", str(readme)]) == 1
    assert render_readme_tables.main(["--readme", str(readme)]) == 0
    assert render_readme_tables.main(["--check", "--readme", str(readme)]) == 0
    assert readme.read_text() == j_readme.render_blocks(mutated, REPO)[0]


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_io_crosses_with_jax(ext, tmp_path):
    model = _toy_model()
    colmap_io.write_model(*model, tmp_path / "port", ext=ext)
    jcolmap.write_model(*model, tmp_path / "jax", ext=ext)
    for name in ("cameras", "images", "points3D"):
        assert (tmp_path / "port" / f"{name}{ext}").read_bytes() == \
            (tmp_path / "jax" / f"{name}{ext}").read_bytes()
    got, want = colmap_io.read_model(tmp_path / "jax"), jcolmap.read_model(tmp_path / "port")
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            for field, value in vars(w[k]).items():
                np.testing.assert_array_equal(getattr(g[k], field), value)
    np.testing.assert_allclose(got[1][1].qvec2rotmat(), want[1][1].qvec2rotmat())


def test_render_objects_and_dataset_clis(bop):
    launches = dict(rc.RASTER_KERNEL.launches)
    renders = test_render_objects.main(["--object-ds", "cubes.models", "--ds-root", str(bop),
                                        "--device", "cpu"])
    assert renders.shape == (2, 3, 240, 320) and (renders.flatten(1).sum(1) > 0).all()
    assert rc.RASTER_KERNEL.launches == launches
    n, dt = test_dataset.main(["--dataset", "cubes.test", "--ds-root", str(bop), "--n-frames",
                               "3", "--batch-size", "2"])
    assert n == 3 and dt > 0


def test_preprocess_bop_dataset_matches_jax(tmp_path, monkeypatch):
    roots = {k: build_bop_fixture(tmp_path / k).parents[1] for k in ("port", "jax")}
    written = preprocess_bop_dataset.main(["--dataset", "cubes.test", "--ds-root",
                                           str(roots["port"])])
    monkeypatch.setattr(sys, "argv", ["preprocess", "--dataset", "cubes.test", "--ds-root",
                                      str(roots["jax"])])
    j_preprocess.main()
    assert len(written) == 3
    from PIL import Image

    for path in written:
        twin = roots["jax"] / path.relative_to(roots["port"])
        got = png.imread(path)
        np.testing.assert_array_equal(got, np.asarray(Image.open(twin)))
        assert set(np.unique(got).tolist()) == {0, 1, 2}


def test_convert_models_matches_jax(bop, tmp_path, monkeypatch):
    models = bop / "bop_datasets" / "cubes" / "models"
    written = convert_models.main(["--models-dir", str(models), "--out-dir",
                                   str(tmp_path / "port"), "--max-faces", "6"])
    monkeypatch.setattr(sys, "argv", ["convert", "--models-dir", str(models), "--out-dir",
                                      str(tmp_path / "jax"), "--max-faces", "6"])
    j_convert.main()
    assert [p.name for p in written] == ["obj_000001.ply", "obj_000002.ply"]
    for path in written:
        assert path.read_text() == (tmp_path / "jax" / path.name).read_text()
    assert (tmp_path / "port" / "models_info.json").read_text() == \
        (models / "models_info.json").read_text()


def test_colmap_reconstruction_prepares_workspaces(bop, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "no-colmap"))
    dirs = run_colmap_reconstruction.main(["--dataset", "cubes", "--nviews", "2", "--ds-root",
                                           str(bop), "--out-dir", str(tmp_path / "colmap")])
    assert len(dirs) == 2  # 3 views of one scene in groups of at most 2
    linked = sorted(p.name for d in dirs for p in (d / "images").iterdir())
    assert linked == ["000000.png", "000001.png", "000002.png"]
    assert all((d / "images" / n).resolve().exists() for d in dirs
               for n in (p.name for p in (d / "images").iterdir()))
    assert run_colmap_reconstruction.main(["--dataset", "cubes", "--nviews", "2", "--ds-root",
                                           str(bop), "--out-dir", str(tmp_path / "colmap"),
                                           "--max-groups", "1"]) == dirs[:1]


FAKE_TOOLKIT = '''import argparse, json, pathlib
p = argparse.ArgumentParser()
for a in ("--renderer_type", "--result_filenames", "--results_path", "--eval_path"):
    p.add_argument(a)
a = p.parse_args()
out = pathlib.Path(a.eval_path)
out.mkdir(parents=True, exist_ok=True)
(out / "scores_bop19.json").write_text(json.dumps({"csv": pathlib.Path(a.result_filenames).name}))
'''


@pytest.mark.parametrize("serial", [True, False])
def test_bop20_eval_multi_over_each_dataset(tmp_path, serial, capsys):
    toolkit = tmp_path / "toolkit"
    (toolkit / "scripts").mkdir(parents=True)
    (toolkit / "scripts" / "eval_bop19.py").write_text(FAKE_TOOLKIT)
    for ds in ("ycbv", "tless"):
        d = tmp_path / "results" / "bop-1" / f"dataset={ds}"
        d.mkdir(parents=True)
        (d / f"pred_{ds}-test.csv").write_text("scene_id,im_id,obj_id,score,R,t,time\n")
    (tmp_path / "results" / "bop-1" / "dataset=empty").mkdir()
    args = ["--result-id", "bop-1", "--results-dir", str(tmp_path / "results"),
            "--bop-toolkit-dir", str(toolkit), "--device", "cpu"]
    run_bop20_eval_multi.main(args + (["--serial"] if serial else []))
    out = capsys.readouterr().out
    for ds in ("tless", "ycbv"):
        assert json.dumps({"csv": f"pred_{ds}-test.csv"}) in out


def test_new_clis_run_as_modules(tmp_path):
    """`python -m` entry points (argument parsing, __main__ guard)."""
    run = subprocess.run([sys.executable, "-m", "cosypose_tpu_torch.scripts.print_results_table",
                          "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and "--detection" in run.stdout
