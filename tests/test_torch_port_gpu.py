"""The CUDA raster kernel against its plain PyTorch version, on the card.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips where
there is none (decided at run time, never at import). Run them on a machine
with a card: `python -m pytest tests/test_torch_port_gpu.py -m gpu`.

The kernel repeats the plain version's arithmetic op for op (no FMA
contraction, IEEE division), so the expected error is 0; the tolerance is
atol 1e-4 on depth and rgb, with mask and attribute exactly equal.
"""

import numpy as np
import pytest
import torch

from cosypose_tpu_torch import demo
from cosypose_tpu_torch.models.pose_predictor import (PosePredictor, PosePredictorConfig,
                                                      gather_mesh_data)
from cosypose_tpu_torch.ops import rasterizer_cuda
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db

pytestmark = pytest.mark.gpu
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def demo_scene(device, B=8, image=(240, 320), lod=512, seed=0):
    """The demo spheres at crop-like poses: the main path's kernel inputs."""
    db = build_mesh_db(demo.demo_specs(), render_max_faces=lod, device=device)
    rng = np.random.RandomState(seed)
    label_ids = torch.as_tensor(rng.randint(0, 2, B), device=device)
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, :2, 3] = rng.uniform(-0.02, 0.02, (B, 2))
    TCO[:, 2, 3] = rng.uniform(0.5, 1.0, B)
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = rng.uniform(600, 1500, B)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = image[1] / 2, image[0] / 2, 1.0
    return (db.tri_verts[label_ids], db.tri_valid[label_ids], torch.as_tensor(TCO, device=device),
            torch.as_tensor(K, device=device), db.tri_colors[label_ids])


def _compare(kernel_out, plain_out, with_attr):
    (rgb_k, depth_k, attr_k), (rgb_p, depth_p, attr_p) = kernel_out, plain_out
    assert (depth_k - depth_p).abs().max().item() <= ATOL
    assert (rgb_k - rgb_p).abs().max().item() <= ATOL
    assert torch.equal(depth_k > 0, depth_p > 0)
    if with_attr:
        assert torch.equal(attr_k, attr_p)


@pytest.mark.parametrize("budget", [1024, 40])
@pytest.mark.parametrize("tile", [(16, 16), (8, 32), (32, 32)])
def test_kernel_matches_plain(cuda, tile, budget):
    tv, valid, TCO, K, colors = demo_scene(cuda)
    image = (240, 320)
    coef, idx, counts = rasterizer_cuda.prepare(tv, valid, TCO, K, image, colors, tile, budget)
    launches = dict(rasterizer_cuda.RASTER_KERNEL.launches)
    out = rasterizer_cuda.RASTER_KERNEL(coef, idx, counts, image, tile)
    torch.cuda.synchronize()
    assert rasterizer_cuda.RASTER_KERNEL.launches == {
        "raster_resolve": launches["raster_resolve"] + 1,
        "raster_resolve_attr": launches["raster_resolve_attr"]}
    _compare(out, rasterizer_cuda.resolve_plain(coef, idx, counts, image, tile), False)
    assert (out[1] > 0).float().mean() > 0.05


def test_kernel_attr_variant(cuda):
    """Two overlapping instances in one item: the winner's instance id."""
    tv, valid, TCO, K, colors = demo_scene(cuda, B=2)
    T0 = TCO[0].clone()
    shift = torch.tensor([0.03, 0.0, 0.1], device=cuda)
    tv_cam0 = tv[0] @ T0[:3, :3].T + T0[:3, 3]
    tv2 = torch.cat([tv_cam0, tv_cam0 + shift])[None]
    valid2 = torch.cat([valid[0], valid[0]])[None]
    n = valid.shape[1]
    attr = torch.cat([torch.full((n,), 1.0), torch.full((n,), 2.0)])[None].to(cuda)
    eye = torch.eye(4, device=cuda)[None]
    image, tile = (240, 320), (16, 16)
    coef, idx, counts = rasterizer_cuda.prepare(tv2, valid2, eye, K[:1], image, tile=tile,
                                                tri_attr=attr)
    out = rasterizer_cuda.RASTER_KERNEL(coef, idx, counts, image, tile, with_attr=True)
    _compare(out, rasterizer_cuda.resolve_plain(coef, idx, counts, image, tile, True), True)
    assert set(out[2].unique().tolist()) == {0.0, 1.0, 2.0}


def test_kernel_refuses_bad_inputs(cuda):
    tv, valid, TCO, K, colors = demo_scene(cuda, B=2)
    coef, idx, counts = rasterizer_cuda.prepare(tv, valid, TCO, K, (64, 64), colors, (16, 16))
    with pytest.raises(ValueError):
        rasterizer_cuda.RASTER_KERNEL(coef.double(), idx, counts, (64, 64), (16, 16))
    with pytest.raises(ValueError):
        rasterizer_cuda.RASTER_KERNEL(coef, idx.long(), counts, (64, 64), (16, 16))
    with pytest.raises(ValueError):
        rasterizer_cuda.RASTER_KERNEL(coef, idx, counts, (64, 64), (64, 64))  # 4096 threads


def test_pose_predictor_card_matches_cpu(cuda):
    """The slice in fp32 with TF32 off, on the card (kernel) and on the CPU
    (plain version). Tolerance 1e-3 on TCO: cuDNN and oneDNN sum the
    backbone's convolutions in different orders."""
    cfg = PosePredictorConfig(backbone="efficientnet-b0", render_size=(96, 128),
                              n_points_crop=200)
    images, K, TCO, label_ids = demo.make_inputs(2, 240, 320)
    outs, weights = {}, None
    for dev in ("cpu", "cuda"):
        pp = PosePredictor(cfg, device=dev)
        db = build_mesh_db(demo.demo_specs(), render_max_faces=512, device=dev)
        md = gather_mesh_data(db, torch.as_tensor(label_ids, device=dev).long(), 200)
        args = [torch.as_tensor(a, device=dev) for a in (images, K, TCO)]
        if weights is None:
            demo.demo_weights(pp, md, *args, torch.Generator().manual_seed(1))
            weights = pp.net.state_dict()
        pp.net.load_state_dict(weights)
        outs[dev] = pp.forward(md, *args, n_iterations=2)["TCO_final"].cpu()
    assert (outs["cuda"] - outs["cpu"]).abs().max().item() <= 1e-3
    assert (outs["cpu"] - torch.as_tensor(TCO)).abs().max().item() > 1e-3
