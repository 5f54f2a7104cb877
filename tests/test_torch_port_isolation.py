"""The port stands alone: importing any of its modules, or chip_smoke.py,
loads neither jax nor the JAX package, nor PIL, pandas, scikit-learn,
matplotlib or yaml (which the card's machine does not have)."""

import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for p in (REPO / "cosypose_tpu_torch").rglob("*.py") if p.name != "__init__.py"
)


def _loaded_after(statement: str) -> list[str]:
    code = (f"import sys; {statement}; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'cosypose_tpu', 'PIL', 'pandas', 'sklearn', "
            "'matplotlib', 'yaml')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    return ast.literal_eval(out.stdout.strip().splitlines()[-1])


def test_every_port_module_is_listed():
    assert "cosypose_tpu_torch.ops.rasterizer_cuda" in MODULES
    assert "cosypose_tpu_torch.integrated.pose_predictor" in MODULES
    assert "cosypose_tpu_torch.training.train_pose" in MODULES
    assert "cosypose_tpu_torch.data.wrappers" in MODULES
    assert "cosypose_tpu_torch.recording.scene_sampler" in MODULES
    assert "cosypose_tpu_torch.data.pose_dataset" in MODULES
    assert "cosypose_tpu_torch.utils.png" in MODULES
    for name in ("table", "data_utils", "meters", "bop_metrics", "eval_runners", "runner_utils",
                 "pred_runners", "bop_export", "eval_bundle"):
        assert f"cosypose_tpu_torch.evaluation.{name}" in MODULES
    assert "cosypose_tpu_torch.ops.symmetric" in MODULES
    assert "cosypose_tpu_torch.scripts.run_procedural_accuracy" in MODULES
    assert "cosypose_tpu_torch.scripts.run_bop_eval" in MODULES
    for name in ("models.wide_resnet", "models.corrnet", "models.detector",
                 "integrated.detector", "data.detection_dataset", "training.detector_training",
                 "bop_config", "scripts.run_detector_training", "scripts.run_detection_eval",
                 "scripts.run_bop_inference"):
        assert f"cosypose_tpu_torch.{name}" in MODULES
    for name in ("ops.mesh_ops", "ops.transform", "utils.timer", "integrated.icp_refiner",
                 "multiview.matching_cext", "multiview.ransac", "multiview.bundle_adjustment",
                 "integrated.multiview_predictor", "evaluation.saved_detections",
                 "visualization.multiview", "scripts.run_cosypose_eval",
                 "scripts.run_custom_scenario", "scripts.bench_multiview"):
        assert f"cosypose_tpu_torch.{name}" in MODULES


def test_data_parallel_modules_are_listed():
    for name in ("utils.distributed", "utils.logging", "parallel.ddp", "parallel.spawn",
                 "parallel.dryrun", "parallel.rank_checks", "scripts.example_multichip",
                 "scripts.bench_scaling"):
        assert f"cosypose_tpu_torch.{name}" in MODULES


def test_serving_and_surface_modules_are_listed():
    for name in ("serving.export", "ops.raster_bounds", "utils.profiling", "utils.misc",
                 "utils.colmap_io", "visualization.singleview", "visualization.plotter",
                 "visualization.dashboard", "scripts.bench_stages", "scripts.convert_models",
                 "scripts.preprocess_bop_dataset", "scripts.print_results_table",
                 "scripts.render_readme_tables", "scripts.make_dashboard",
                 "scripts.run_bop20_eval_multi", "scripts.run_colmap_reconstruction",
                 "scripts.test_dataset", "scripts.test_render_objects"):
        assert f"cosypose_tpu_torch.{name}" in MODULES


def test_jpeg_modules_are_listed():
    for name in ("utils.jpeg", "utils.jpeg_cext", "data.augmentations", "data.pose_dataset",
                 "data.texture_dataset", "data.datasets_cfg", "ops.roi_align"):
        assert f"cosypose_tpu_torch.{name}" in MODULES


def test_port_imports_no_jax():
    assert _loaded_after("; ".join(f"import {m}" for m in MODULES)) == []


def test_chip_smoke_imports_no_jax():
    assert _loaded_after("import chip_smoke") == []

