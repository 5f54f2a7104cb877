"""The serving export and the inspection surfaces of the port on the CPU: the
raster kernels as registered operators, `serving.export_pose_model` /
`load_exported` against the JAX package's `jax.export` artifact and against
the port's own eager forward, the profiler, the per-stage bench and the
raster bounds.

The JAX side is tests/test_serving_export.py's setting: `small_cfg`
(EfficientNet-B0, 48×64 renders) on `cube_specs`, B=2, 120×160 frames. Its
12 triangles stay under every binning budget, so the JAX CPU path and the
port's plain versions render the same images. Weights: the slice tests' JAX
variables (tests/test_torch_port_slice.make_weights), carried to the port by
utils/weights.jax_pose_variables_to_state_dict.

Tolerances: the port's program against JAX's artifact within the slice
tests' atol 1e-4 + rtol 1e-6 (the two frameworks' float32 convolutions and
crop boxes differ in their last bits); the port's program against its own
eager forward within 1e-6 (the same ATen ops on the same inputs: expect 0);
the operators' fake shapes equal to the real ones.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosypose_tpu.integrated import LoadedPoseModel as JLoadedPoseModel
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.serving.export import export_pose_model as j_export
from cosypose_tpu.serving.export import load_exported as j_load
from cosypose_tpu_torch import demo
from cosypose_tpu_torch.integrated.pose_predictor import LoadedPoseModel
from cosypose_tpu_torch.models.pose_predictor import PosePredictor, gather_mesh_data
from cosypose_tpu_torch.ops import rasterizer_cuda as rc
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.ops.raster_bounds import resolve_bound, setup_bound
from cosypose_tpu_torch.ops.render import render
from cosypose_tpu_torch.scripts import bench_stages
from cosypose_tpu_torch.serving import export_pose_model, load_exported
from cosypose_tpu_torch.training.train_pose import train_pose
from cosypose_tpu_torch.utils import profiling
from cosypose_tpu_torch.utils.weights import jax_pose_variables_to_state_dict
from tests.test_pose_predictor import cube_specs, small_cfg
from tests.test_torch_port_slice import ATOL, RTOL, inputs, make_weights, port_cfg, port_specs
from tests.test_torch_port_train_loop import IMAGE, tiny_cfg

B, HW = 2, (120, 160)
REPO = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The fast tier runs several test processes side by side on the CPU's
    cores; PyTorch's own thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX LoadedPoseModel, port LoadedPoseModel on the CPU) with the same
    weights: the JAX variables carried to the port by the weight bridge."""
    jpp, v, _ = make_weights()
    jmodel = JLoadedPoseModel(jpp, v, j_build_mesh_db(cube_specs()), init_method="v0")
    pp = PosePredictor(port_cfg(), device="cpu")
    pp.net.load_state_dict(jax_pose_variables_to_state_dict(v, small_cfg().backbone))
    return jmodel, LoadedPoseModel(pp, build_mesh_db(port_specs(), device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def blobs(models):
    """The port's exported programs, by number of iterations."""
    return {n: export_pose_model(models[1], B, HW, n_iterations=n) for n in (1, 2)}


def eager(model, n_iterations, images, K, TCO, labels):
    md = gather_mesh_data(model.mesh_db, torch.as_tensor(labels).long(),
                          model.predictor.cfg.n_points_crop)
    return model.predictor.forward(md, torch.as_tensor(images), torch.as_tensor(K),
                                   torch.as_tensor(TCO), n_iterations)["TCO_final"]


@pytest.mark.parametrize("n_iterations", [1, 2])
def test_export_matches_jax_export(models, blobs, n_iterations, tmp_path):
    jmodel, _ = models
    images, K, TCO, labels = inputs(B)
    jfn = j_load(j_export(jmodel, batch_size=B, image_hw=HW, n_iterations=n_iterations,
                          platforms=("cpu",)))
    want = np.asarray(jfn(jnp.asarray(images), jnp.asarray(K), jnp.asarray(TCO),
                          jnp.asarray(labels)))
    path = tmp_path / "refiner.pt2"
    path.write_bytes(blobs[n_iterations])
    got = load_exported(path, device="cpu")(images, K, TCO, labels)
    assert got.shape == (B, 4, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert np.abs(want - TCO).max() > 1e-3  # the head moved every pose


@pytest.mark.parametrize("n_iterations", [1, 2])
def test_export_round_trip_matches_eager(models, blobs, n_iterations):
    _, model = models
    images, K, TCO, labels = inputs(B)
    got = load_exported(blobs[n_iterations], device="cpu")(images, K, TCO, labels)
    want = eager(model, n_iterations, images, K, TCO, labels)
    assert (got - want).abs().max().item() <= 1e-6


def test_bf16_export_keeps_the_autocast(models):
    """The bf16 backbone runs under torch.autocast; the exported program
    computes what the eager one does."""
    _, model = models
    pp = PosePredictor(dataclasses.replace(port_cfg(), compute_dtype=torch.bfloat16),
                       device="cpu")
    pp.net.load_state_dict(model.predictor.net.state_dict())
    bf16 = LoadedPoseModel(pp, model.mesh_db, device="cpu")
    images, K, TCO, labels = inputs(B)
    got = load_exported(export_pose_model(bf16, B, HW, n_iterations=2), device="cpu")(
        images, K, TCO, labels)
    want = eager(bf16, 2, images, K, TCO, labels)
    assert (got - want).abs().max().item() <= 1e-6
    assert (want - eager(model, 2, images, K, TCO, labels)).abs().max().item() > 0


def test_exported_program_calls_the_raster_operators(blobs):
    """One call of each registered operator an iteration, and the crop points
    and mesh as buffers (no host data in the graph)."""
    import io

    program = torch.export.load(io.BytesIO(blobs[2]))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("cosypose.raster_setup.default") == 2
    assert targets.count("cosypose.raster_resolve.default") == 2
    assert {"tri_verts", "tri_colors", "tri_valid", "crop_points"} <= set(program.state_dict)
    assert program.example_inputs is None  # the frames it was traced with stay out of it
    launches = dict(rc.RASTER_KERNEL.launches)
    load_exported(blobs[2], device="cpu")(*inputs(B))
    assert rc.RASTER_KERNEL.launches == launches  # CPU tensors: the plain versions


def test_fresh_process_loads_with_the_operators_alone(blobs, tmp_path):
    """A process that imports torch and the operators' modules, and nothing
    else of the port (no checkpoint, no mesh files), runs the artifact."""
    import subprocess
    import sys

    path = tmp_path / "refiner.pt2"
    path.write_bytes(blobs[2])
    images, K, TCO, labels = inputs(B)
    np.savez(tmp_path / "inputs.npz", images=images, K=K, TCO=TCO, labels=labels)
    code = (
        "import sys, numpy as np, torch\n"
        "import cosypose_tpu_torch.ops.depthwise_cuda, cosypose_tpu_torch.ops.rasterizer_cuda\n"
        "torch.set_num_threads(1)  # as this process: the same summation order\n"
        f"program = torch.export.load({str(path)!r})\n"
        f"x = np.load({str(tmp_path / 'inputs.npz')!r})\n"
        "with torch.no_grad():\n"
        "    out = program.module()(*(torch.as_tensor(x[k]) for k in ('images', 'K', 'TCO')),\n"
        "                           torch.as_tensor(x['labels']).long())\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "print(sorted(m for m in sys.modules if m.startswith('cosypose_tpu')))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300,
                         env={**__import__("os").environ, "PYTHONPATH": str(REPO)})
    assert run.returncode == 0, run.stderr[-2000:]
    # the ops package imports the modules it re-exports, as the JAX package's
    # does (and they the utils package); the operators' modules load their
    # nvcc build (ops.nvcc_build), and the depthwise one counts its launches in
    # utils.profiling: no model, predictor, data, training or serving code is
    # loaded
    loaded = __import__("ast").literal_eval(run.stdout.strip().splitlines()[-1])
    assert loaded == ["cosypose_tpu_torch"] + [f"cosypose_tpu_torch.{m}" for m in (
        "config", "ops", "ops.camera", "ops.cropping", "ops.depthwise_cuda", "ops.losses",
        "ops.mesh_db", "ops.mesh_io", "ops.mesh_ops", "ops.nvcc_build", "ops.pose_ops",
        "ops.rasterizer", "ops.rasterizer_cuda", "ops.render", "ops.roi_align", "ops.symmetric",
        "ops.symmetries", "ops.transform", "ops.transforms", "utils", "utils.device",
        "utils.distributed", "utils.logging", "utils.profiling", "utils.tensor_collection",
        "utils.timer")]
    want = load_exported(blobs[2], device="cpu")(images, K, TCO, labels)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want.numpy())


def _setup_args(with_attr: bool):
    first = demo.first_render_inputs(2, (480, 640), (48, 64), 64, "cpu")
    attr = torch.arange(first["tri_valid"].numel(), dtype=torch.float32).reshape(2, -1) \
        if with_attr else None
    return (first["tri_verts"], first["tri_valid"], first["TCO"], first["K_crop"], [48, 64],
            first["colors"], 0.05, attr)


@pytest.mark.parametrize("op", ["raster_setup", "raster_resolve", "raster_resolve_attr"])
def test_raster_operators_opcheck_and_fake_shapes(op):
    """torch.library.opcheck (schema, autograd registration, fake tensors,
    AOT dispatch) on the CPU implementation, and the fake implementation's
    shapes and types equal to the real outputs'."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with_attr = op == "raster_resolve_attr"
    sargs = _setup_args(with_attr)
    if op == "raster_setup":
        fn, args = rc.raster_setup_op, sargs
    else:
        rows, _, order = rc.raster_setup_op(*sargs)
        fn, args = rc.raster_resolve_op, (rows, order, [48, 64], [16, 32], 1024,
                                          with_attr)
    torch.library.opcheck(fn, args)
    real = fn(*args)
    with FakeTensorMode() as mode:
        fake = fn(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args])
    assert [(f.shape, f.dtype) for f in fake] == [(r.shape, r.dtype) for r in real]
    if op == "raster_resolve":
        assert real[2].numel() == 0  # no attribute: the empty tensor that stands for None


def test_profiling_trace_holds_the_annotation(tmp_path):
    first = demo.first_render_inputs(2, (480, 640), (48, 64), 64, "cpu")
    with profiling.trace(tmp_path / "trace") as prof:
        with profiling.annotate("served_request"):
            render(first["tri_verts"], first["tri_valid"], first["TCO"], first["K_crop"],
                   image_size=(48, 64), colors=first["colors"])
    names = {e["name"] for e in json.loads(prof.trace_path.read_text())["traceEvents"]}
    assert prof.trace_path.parent == tmp_path / "trace"
    assert {"served_request", "cosypose::raster_setup", "cosypose::raster_resolve"} <= names


def test_train_pose_traces_under_the_environment_variable(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.ENV_VAR, str(tmp_path / "traces"))
    db = build_mesh_db(demo.demo_specs(), render_max_faces=64, device="cpu")
    data = {"train": [(demo.DemoPoseDataset(4, IMAGE, seed=0), 1)]}
    train_pose(tiny_cfg(n_epochs=1), data, db, exp_dir=tmp_path / "runs", device="cpu")
    (trace,) = (tmp_path / "traces").glob("trace_*.json")
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert "cosypose::raster_resolve" in names
    assert profiling._ACTIVE["profiler"] is None


def test_bench_stages_writes_every_stage(tmp_path):
    out = tmp_path / "stages.json"
    rows = bench_stages.main(["--batch", "2", "--reps", "1", "--render-lod", "64", "--device",
                              "cpu", "--json", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rows))
    assert [r["stage"] for r in rows] == [
        "crop(roi_align)", "raster setup kernel", "raster resolve kernel",
        "raster full (setup+resolve)",
        "backbone efficientnet-b3 bf16", "pose update", "full iteration"]
    for r in rows:
        assert {"stage", "ms", "ms_per_call", "gflop", "tflops", "mfu_pct", "calls", "launches",
                "launches_per_call", "device"} <= set(r)
        assert r["ms"] > 0 and r["device"] == "cpu" and r["mfu_pct"] is None
        assert r["launches"] == {"raster_setup": 0, "raster_resolve": 0}
    by_stage = {r["stage"]: r for r in rows}
    for name in ("raster setup kernel", "raster resolve kernel"):
        assert by_stage[name]["bound_ms"] > 0 and by_stage[name]["pct_of_bound"] is None
    assert by_stage["backbone efficientnet-b3 bf16"]["gflop"] > 0


def test_raster_bounds_at_the_main_path_shape():
    """B=128 at 240x320, the demo spheres at LOD 512 (Fp=176): both kernels
    are bound by bytes, 0.0479 ms for resolve and 0.0014 ms for setup at
    3.35 TB/s, as PERF.md records."""
    first = demo.first_render_inputs(128, (480, 640), (240, 320), 512, "cpu")
    args = (first["tri_verts"], first["tri_valid"], first["TCO"], first["K_crop"], (240, 320),
            first["colors"])
    rows, key, order = rc.setup(*args)
    assert rows.shape == (128, 176, rc.ROW)
    r_ms, r_by, visits, r_bytes = resolve_bound(rows, order, (240, 320), (16, 32),
                                                1024, False)
    s_ms, s_by, s_bytes = setup_bound(first["tri_verts"], first["tri_valid"], first["colors"],
                                      None, rows, key)
    assert (r_by, s_by) == ("bytes", "bytes")
    assert r_bytes == 4 * 128 * 176 * 32 + 8 * 128 * 176 + 4 * 128 * 240 * 320 * 4
    # setup: corners and colours, validity, poses and intrinsics in; rows, keys, order out
    assert s_bytes == 2 * 4 * 128 * 176 * 9 + 128 * 176 + 4 * 128 * 25 + (4 * 33 + 8) * 128 * 176
    assert round(r_ms, 4) == 0.0479 and round(s_ms, 4) == 0.0014
    assert 0 < visits * 20 / 67e12 * 1e3 < r_ms
