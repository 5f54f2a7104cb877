"""Port parity: the subpackage-level names. Every name that an `__init__.py`
of the JAX package re-exports (`from .mod import a, b`, read with `ast`, so
no JAX import is needed) is bound in the port's subpackage of the same name,
to the very object of the port's module, and is not a module. The names left
out are exactly EXCLUDED, each with its reason."""

import ast
import importlib
import pathlib
import types

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "cosypose_tpu"

# (subpackage, name) -> why the port has no such name
EXCLUDED = {
    ("ops", "rasterize_pallas"): "the Pallas kernel's work is done by the CUDA kernels of "
                                 "ops/rasterizer_cuda.py (setup and resolve)",
    ("parallel", "make_mesh"): "the JAX device mesh is replaced by parallel/ddp.py's "
                               "DataParallel over torch.distributed",
    ("parallel", "fsdp_shardings"): "the mesh's parameter shardings are replaced by FSDP2 "
                                    "(DataParallel's param_mode='fsdp')",
    ("utils", "PandasTensorCollection"): "the port has no pandas: TensorCollection with dict "
                                         "infos is its counterpart",
}
# (subpackage, JAX module) -> the port's module of those names
MODULE_OF = {("parallel", "mesh"): "ddp"}


def jax_exports() -> dict:
    """{subpackage: [(module, name), ...]} from the JAX package's __init__ files."""
    out = {}
    for init in sorted(JAX_PKG.glob("*/__init__.py")):
        names = [(node.module, a.asname or a.name) for node in ast.parse(init.read_text()).body
                 if isinstance(node, ast.ImportFrom) and node.level == 1 for a in node.names]
        if names:
            out[init.parent.name] = names
    return out


EXPORTS = jax_exports()


def test_the_jax_subpackages_are_read():
    assert {"ops", "models", "integrated", "data", "evaluation", "multiview", "utils",
            "visualization", "parallel", "training"} <= set(EXPORTS)
    assert ("render", "render") in EXPORTS["ops"] and len(EXPORTS["ops"]) == 38


@pytest.mark.parametrize("sub", sorted(EXPORTS))
def test_subpackage_exports_the_jax_names(sub):
    pkg = importlib.import_module(f"cosypose_tpu_torch.{sub}")
    missing = set()
    for mod, name in EXPORTS[sub]:
        if not hasattr(pkg, name):
            missing.add((sub, name))
            continue
        obj = getattr(pkg, name)
        assert not isinstance(obj, types.ModuleType), f"{sub}.{name} is a module"
        source = importlib.import_module(
            f"cosypose_tpu_torch.{sub}.{MODULE_OF.get((sub, mod), mod)}")
        assert getattr(source, name) is obj, f"{sub}.{name} is not {source.__name__}.{name}"
    assert missing == {k for k in EXCLUDED if k[0] == sub}


def test_exclusions_are_exactly_the_missing_names():
    listed = {(sub, name) for sub, names in EXPORTS.items() for _, name in names}
    assert set(EXCLUDED) <= listed
    for sub, name in EXCLUDED:
        assert not hasattr(importlib.import_module(f"cosypose_tpu_torch.{sub}"), name)


def test_version_equals_the_jax_package():
    tree = ast.parse((JAX_PKG / "__init__.py").read_text())
    version = next(node.value.value for node in tree.body if isinstance(node, ast.Assign)
                   and node.targets[0].id == "__version__")
    import cosypose_tpu_torch

    assert cosypose_tpu_torch.__version__ == version == "0.1.0"


def test_shadowed_submodules_stay_importable():
    """ops binds `render` and `roi_align` as functions (as the JAX package
    does); their modules are reached by their full names."""
    from cosypose_tpu_torch import ops
    from cosypose_tpu_torch.ops.render import render
    from cosypose_tpu_torch.ops.roi_align import roi_align, roi_align_gather

    assert ops.render is render and ops.roi_align is roi_align
    assert callable(roi_align_gather)
    assert importlib.import_module("cosypose_tpu_torch.ops.roi_align").roi_align is roi_align
