"""The CUDA raster kernels against their plain PyTorch versions, and the
train step on the card against the CPU, on the card.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips where
there is none (decided at run time, never at import). Run them on a machine
with a card: `python -m pytest tests/test_torch_port_gpu.py -m gpu`.

Tolerances: the resolve kernel repeats its plain version's arithmetic op for
op (no FMA contraction, IEEE division), so the expected error is 0; it is held
at atol 1e-4 on depth and rgb, with mask and attribute exactly equal. The
setup kernel is held at rasterizer_cuda.SETUP_TOL (a few ulps from PyTorch's
summation order, explained there). A whole render on the card against the CPU
may differ where a pixel centre lies within rounding of an edge: such pixels
(mask differs, or rgb/depth beyond 1e-4) are counted and bounded. The
train-step tests state their tolerances where they are. The MBConv block's
depthwise kernel is held to its plain version within
depthwise_cuda.error_limit: each side rounds y to its dtype once and sums
its float32 terms in its own order.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cosypose_tpu_torch import demo
from cosypose_tpu_torch.models.efficientnet import EfficientNet, MBConvBlock
from cosypose_tpu_torch.models.pose_predictor import (PosePredictor, PosePredictorConfig,
                                                      gather_mesh_data)
from cosypose_tpu_torch.ops import depthwise_cuda, rasterizer_cuda
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.ops.render import render
from cosypose_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu
ATOL = 1e-4
IMAGE = (240, 320)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def demo_scene(device, B=8, image=IMAGE, lod=512, seed=0):
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


def tie_soup(B=3, F=45, seed=0, device="cpu", image=(48, 64)):
    """Triangles whose second half repeats the first (equal keys), item 1 all
    invalid (every key +inf), rows above the image (negative keys) and, for
    F % 8 != 0, padding rows (key +inf): (tri_verts, tri_valid, TCO, K,
    colors) on `device`, with the principal point near the image's top."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-0.1, 0.1, (B, F, 1, 3))
    tv = c + rng.uniform(-0.01, 0.01, (B, F, 3, 3))
    tv[:, F // 2:] = tv[:, :F - F // 2]
    valid = rng.uniform(size=(B, F)) > 0.1
    valid[min(1, B - 1)] = False
    TCO = np.tile(np.eye(4), (B, 1, 1))
    TCO[:, 2, 3] = rng.uniform(0.5, 1.0, B)
    f = 2.5 * image[1]
    K = np.tile(np.array([[f, 0, image[1] / 2], [0, f, image[0] / 8], [0, 0, 1]]), (B, 1, 1))
    colors = rng.uniform(0, 1, (B, F, 3, 3))
    return tuple(torch.as_tensor(a, dtype=torch.float32 if a.dtype != bool else torch.bool,
                                 device=device).contiguous() for a in (tv, valid, TCO, K, colors))


def _compare(kernel_out, plain_out, with_attr):
    (rgb_k, depth_k, attr_k), (rgb_p, depth_p, attr_p) = kernel_out, plain_out
    assert (depth_k - depth_p).abs().max().item() <= ATOL
    assert (rgb_k - rgb_p).abs().max().item() <= ATOL
    assert torch.equal(depth_k > 0, depth_p > 0)
    if with_attr:
        assert torch.equal(attr_k, attr_p)


def test_setup_matches_plain(cuda):
    scene = demo_scene(cuda)
    launches = dict(rasterizer_cuda.RASTER_KERNEL.launches)
    rows, key, order = rasterizer_cuda.RASTER_KERNEL.setup(*scene[:4], IMAGE, scene[4])
    torch.cuda.synchronize()
    assert rasterizer_cuda.RASTER_KERNEL.launches["raster_setup"] == launches["raster_setup"] + 1
    assert torch.equal(order, torch.sort(key, dim=1, stable=True).indices)
    plain = rasterizer_cuda.setup_plain(*scene[:4], IMAGE, scene[4])
    err = rasterizer_cuda.setup_error(rows, key, *plain, IMAGE)
    assert err["valid_differs"] == 0 and err["attr"] == 0
    assert err["plane"] <= rasterizer_cuda.SETUP_TOL
    assert err["bbox_key"] <= rasterizer_cuda.SETUP_TOL
    assert (rows[..., rasterizer_cuda.LANE_VALID] != 0).float().mean() > 0.9


@pytest.mark.parametrize("budget", [1024, 40])
@pytest.mark.parametrize("tile", [(16, 16), (8, 32), (16, 32), (32, 32), (64, 64)])
def test_resolve_matches_plain(cuda, tile, budget):
    """Tiles (32, 32) and (64, 64) are ragged on the 240-row image."""
    scene = demo_scene(cuda)
    rows, _, order = rasterizer_cuda.RASTER_KERNEL.setup(*scene[:4], IMAGE, scene[4])
    launches = dict(rasterizer_cuda.RASTER_KERNEL.launches)
    out = rasterizer_cuda.RASTER_KERNEL.resolve(rows, order, IMAGE, tile, budget)
    torch.cuda.synchronize()
    assert rasterizer_cuda.RASTER_KERNEL.launches == dict(
        launches, raster_resolve=launches["raster_resolve"] + 1)
    _compare(out, rasterizer_cuda.resolve_plain_binned(rows, order, IMAGE, tile, budget), False)
    assert (out[1] > 0).float().mean() > 0.05
    if budget == 40:  # the budget does bind
        _, _, counts = rasterizer_cuda.bin_chunks(rows, order, IMAGE, tile, budget)
        assert int(counts.max()) == 5


def test_resolve_attr_variant(cuda):
    """Two overlapping instances in one item: the winner's instance id."""
    tv, valid, TCO, K, colors = demo_scene(cuda, B=2)
    T0 = TCO[0].clone()
    shift = torch.tensor([0.03, 0.0, 0.1], device=cuda)
    tv_cam0 = tv[0] @ T0[:3, :3].T + T0[:3, 3]
    tv2 = torch.cat([tv_cam0, tv_cam0 + shift])[None].contiguous()
    valid2 = torch.cat([valid[0], valid[0]])[None].contiguous()
    n = valid.shape[1]
    attr = torch.cat([torch.full((n,), 1.0), torch.full((n,), 2.0)])[None].to(cuda)
    eye = torch.eye(4, device=cuda)[None]
    tile = (16, 16)
    rows, _, order = rasterizer_cuda.RASTER_KERNEL.setup(tv2, valid2, eye, K[:1].contiguous(),
                                                         IMAGE, tri_attr=attr)
    out = rasterizer_cuda.RASTER_KERNEL.resolve(rows, order, IMAGE, tile, with_attr=True)
    _compare(out, rasterizer_cuda.resolve_plain_binned(rows, order, IMAGE, tile, 1024, True), True)
    assert set(out[2].unique().tolist()) == {0.0, 1.0, 2.0}


def test_kernels_refuse_bad_inputs(cuda):
    tv, valid, TCO, K, colors = demo_scene(cuda, B=2)
    kernels = rasterizer_cuda.RASTER_KERNEL
    with pytest.raises(ValueError):
        kernels.setup(tv.double(), valid, TCO, K, (64, 64))
    with pytest.raises(ValueError):
        kernels.setup(tv, valid.float(), TCO, K, (64, 64))
    rows, _, order = kernels.setup(tv, valid, TCO, K, (64, 64), colors)
    with pytest.raises(ValueError):
        kernels.resolve(rows.double(), order, (64, 64), (16, 16))
    with pytest.raises(ValueError):
        kernels.resolve(rows, order.int(), (64, 64), (16, 16))
    with pytest.raises(ValueError):
        kernels.resolve(rows, order, (64, 64), (4, 8))    # not whole warps
    with pytest.raises(ValueError):
        kernels.setup(tv, valid, TCO, K, (64, 64), cluster=-1, run_rows=0)   # runs of no row
    with pytest.raises(ValueError):
        kernels.setup(tv, valid, TCO, K, (64, 64), cluster=9)


def test_render_card_matches_cpu(cuda):
    """render() on the card (both kernels) against the CPU (plain versions)."""
    scene = demo_scene(cuda)
    on_card = render(*scene[:4], image_size=IMAGE, colors=scene[4])
    on_cpu = render(*[x.cpu() for x in scene[:4]], image_size=IMAGE, colors=scene[4].cpu())
    rgb_d = (on_card.rgb.cpu() - on_cpu.rgb).abs().amax(1)
    depth_d = (on_card.depth.cpu() - on_cpu.depth).abs()
    off = (on_card.mask.cpu() != on_cpu.mask) | (rgb_d > ATOL) | (depth_d > ATOL)
    assert on_cpu.mask.float().mean() > 0.05
    assert int(off.sum()) <= 1e-4 * off.numel(), int(off.sum())


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


def test_train_step_card_matches_cpu(cuda):
    """One train step (B0, 48x64, batch 8, 2 iterations) on the card against
    the CPU from the same weights, batch and draws, at the tolerances the CPU
    tests state between two float32 implementations of the step
    (chip_smoke.train_step_card_vs_cpu)."""
    import chip_smoke

    errs = chip_smoke.train_step_card_vs_cpu()
    assert all(e <= tol for e, tol in errs.values()), errs


def _train_setup(device, remat, drop_connect_rate=0.5):
    from cosypose_tpu_torch.training import pose_training as tpt
    from cosypose_tpu_torch.training.train_pose import collate

    import chip_smoke

    cfg = chip_smoke.small_train_cfg()
    cfg = dataclasses.replace(cfg, predictor=dataclasses.replace(
        cfg.predictor, remat=remat, drop_connect_rate=drop_connect_rate))
    db = build_mesh_db(demo.demo_specs(), render_max_faces=512, device=device)
    state = tpt.create_train_state(cfg, device)
    ds = demo.DemoPoseDataset(cfg.batch_size, (240, 320), seed=2)
    host = collate([ds[i] for i in range(len(ds))])
    batch = {k: host[k].to(device) for k in ("images", "K", "TCO", "bboxes")}
    batch["label_ids"] = db.ids_for(host["labels"])
    draws = tpt.draw_step(cfg, state.pp, cfg.batch_size, db.points.shape[1],
                          torch.Generator().manual_seed(0))
    return tpt, cfg, db, state, batch, draws


def test_remat_on_and_off_agree_on_the_card(cuda):
    """torch.utils.checkpoint replays the forward in backward: with the same
    drop-connect masks, and the running statistics moved once. cuDNN may
    pick other algorithms in the replay, so gradients are held at 5e-4 of
    each tensor's max, the CPU tests' float32 tolerance."""
    runs = {}
    for remat in (True, False):
        tpt, cfg, db, state, batch, draws = _train_setup(cuda, remat)
        loss, _ = tpt.pose_loss(state.pp, cfg, db, batch, draws)
        loss.backward()
        net = state.pp.net
        runs[remat] = (float(loss.detach()), {n: p.grad.clone() for n, p in net.named_parameters()},
                       {n: b.clone() for n, b in net.named_buffers()})
    (l1, g1, b1), (l0, g0, b0) = runs[True], runs[False]
    assert abs(l1 / l0 - 1) <= 1e-5
    for n in g0:
        if not n.endswith("_bn2.bias"):
            assert float((g1[n] - g0[n]).abs().max()) <= 5e-4 * float(g0[n].abs().max()), n
    for n in b0:
        assert torch.allclose(b1[n].float(), b0[n].float(), rtol=1e-5, atol=1e-6), n


def test_train_step_launches_the_raster_kernels(cuda):
    """A train step of n iterations launches each raster kernel n times."""
    tpt, cfg, db, state, batch, draws = _train_setup(cuda, True, 0.0)
    before = dict(rasterizer_cuda.RASTER_KERNEL.launches)
    tpt.make_train_step(cfg, db)(state, batch, draws)
    torch.cuda.synchronize()
    after = rasterizer_cuda.RASTER_KERNEL.launches
    assert after["raster_setup"] - before["raster_setup"] == cfg.n_iterations
    assert after["raster_resolve"] - before["raster_resolve"] == cfg.n_iterations


def test_resolve_attr_at_the_scene_shape(cuda):
    """The attribute variant at a full-width procedural scene (8 objects and
    the cage, more than 8,872 rows an item, 10 cameras, tile (8, 320), budget
    6144), the shape the recording path gives it: equal to its plain version,
    on rows from the setup kernel, which is within SETUP_TOL of its own."""
    import chip_smoke

    args, ids = chip_smoke.scene_inputs(cuda)
    rows, _, order = chip_smoke.setup_vs_plain(args, ids)[:3]  # raises beyond SETUP_TOL
    res = args[4]
    assert rows.shape[1] >= 8872
    budget = min(rows.shape[1], 6144)
    out = rasterizer_cuda.RASTER_KERNEL.resolve(rows, order, res, (8, 320), budget, True)
    torch.cuda.synchronize()
    plain = rasterizer_cuda.resolve_plain_binned(rows, order, res, (8, 320), budget, True)
    assert all(torch.equal(k, p) for k, p in zip(out, plain))
    assert set(out[2].unique().tolist()) >= {0.0, 1.0, 8.0}


def test_resolve_at_the_amodal_shape(cuda):
    """The plain variant at the amodal re-render's shape, its inputs taken
    from the sampler's own call (10 views x 8 objects, 1216 rows, 240x320,
    tile (24, 320), budget 768): setup within SETUP_TOL of its plain
    version, resolve equal to its plain version."""
    import chip_smoke

    args, tile, budget = chip_smoke.amodal_inputs(cuda)
    assert tuple(args[0].shape[:2]) == (80, 1216) and (tile, budget) == ((24, 320), 768)
    rows, _, order = chip_smoke.setup_vs_plain(args)[:3]
    out = rasterizer_cuda.RASTER_KERNEL.resolve(rows, order, args[4], tile, budget)
    torch.cuda.synchronize()
    plain = rasterizer_cuda.resolve_plain_binned(rows, order, args[4], tile, budget)
    assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])
    assert (out[1] > 0).any()


# rows an item past one block of kernel A (16,384) and one window of kernel B
# (10,560) on an H100: just past both, a ycbv-1M scene soup (8 x 8,192 + the
# cage), 8 full blocks, and past the largest cluster
LARGE_ROWS = (16_392, 65_896, 131_072, 262_144)


@pytest.mark.parametrize("F", LARGE_ROWS)
def test_resolve_takes_any_row_count(cuda, F):
    """Kernel B on two items of F rows (chip_smoke.large_soup: small
    triangles over the whole image), above one window: the binning launch
    equal to bin_chunks, and the listed resolve bit-equal to
    resolve_plain_binned, with and without the attribute, with the budget
    reached at once (40 rows) and at the scene's 6,144 (reached part-way
    down the lists from 131,072 rows) at 240x320, and not at all (every row,
    a budget above one window) on a 2048x64 image that spreads the rows over
    128 tile rows; a call is one binning launch and one resolve launch."""
    import chip_smoke

    kernels = rasterizer_cuda.RASTER_KERNEL
    assert F > kernels.window_rows(cuda)
    for image, tile, budgets in (((240, 320), (8, 320), (40, 6144)), ((2048, 64), (16, 32), (F,))):
        args, attr = chip_smoke.large_soup(2, F, image, seed=F, device=cuda)
        rows, _, order = kernels.setup(*args[:4], image, args[4], tri_attr=attr)
        for budget in budgets:
            srt, idx, counts = rasterizer_cuda.bin_chunks(rows, order, image, tile, budget)
            got = kernels.bin_chunks(rows, order, image, tile, budget)
            torch.cuda.synchronize()
            assert torch.equal(got[0], idx) and torch.equal(got[1], counts), (image, budget)
            plain = rasterizer_cuda.resolve_plain(srt, idx, counts, image, tile, True)
            for with_attr in (True, False):
                before = dict(kernels.launches)
                out = kernels.resolve(rows, order, image, tile, budget, with_attr)
                torch.cuda.synchronize()
                assert kernels.launches == dict(
                    before, raster_resolve_bin=before["raster_resolve_bin"] + 1,
                    raster_resolve_listed=before["raster_resolve_listed"] + 1)
                assert all(torch.equal(a, b) for a, b in zip(out, plain[:2 + with_attr])), (
                    image, budget, with_attr)
            assert (out[1] > 0).any()
        counts = rasterizer_cuda.bin_chunks(rows, order, image, tile, 1 << 30)[2]
        assert int(counts.max()) > rasterizer_cuda.chunk_budget(budgets[0], F) or budgets[0] == F


def test_listed_resolve_equals_the_one_window_path(cuda):
    """Kernel B's listed resolve (binning launch, then each tile's list
    staged 2,048 rows at a time) called on items that fit one window: lists
    cut at 3 chunks, part-way and not at all (364 chunks on the one-tile
    image, two stagings), at tiles of 1 to 48 slices: bit-equal
    to the one-window path, with and without the attribute."""
    kernels = rasterizer_cuda.RASTER_KERNEL
    tv, valid, TCO, K, colors = tie_soup(3, 4803, seed=1, device=cuda, image=(48, 64))
    attr = torch.arange(3 * 4803, device=cuda, dtype=torch.float32).reshape(3, 4803) % 7 + 1
    rows, _, order = kernels.setup(tv, valid, TCO, K, (48, 64), colors, tri_attr=attr)
    assert rows.shape[1] <= kernels.window_rows(cuda)
    for tile in ((8, 8), (16, 48), (48, 64)):
        counts = rasterizer_cuda.bin_chunks(rows, order, (48, 64), tile, 1 << 30)[2]
        for budget in (24, 200, 4808):
            for with_attr in (True, False):
                one = kernels.resolve(rows, order, (48, 64), tile, budget, with_attr)
                lists = kernels.bin_chunks(rows, order, (48, 64), tile, budget)
                out = kernels.resolve_listed(rows, order, *lists, (48, 64), tile, with_attr)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(out[:2 + with_attr],
                                                             one[:2 + with_attr])), (tile, budget)
    assert 8 * int(counts.max()) > 2048  # the one-tile lists: two stagings


def test_kernels_take_more_than_65535_items(cuda):
    """70,000 items of 8 rows at 8x8: kernel B takes 65,535 items a launch
    (grid.y) and launches again for the rest, so the batch has no limit (as
    the JAX package takes any batch); both kernels against their plain
    versions, two launches of kernel B counted."""
    kernels = rasterizer_cuda.RASTER_KERNEL
    tv, valid, TCO, K, colors = tie_soup(70_000, 8, seed=3, device=cuda, image=(8, 8))
    rows, key, order = kernels.setup(tv, valid, TCO, K, (8, 8), colors)
    assert torch.equal(order, torch.sort(key, dim=1, stable=True).indices)
    before = kernels.launches["raster_resolve"]
    out = kernels.resolve(rows, order, (8, 8), (8, 8))
    assert kernels.launches["raster_resolve"] == before + 2
    torch.cuda.synchronize()
    plain = rasterizer_cuda.resolve_plain_binned(rows, order, (8, 8), (8, 8))
    assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])
    assert (out[1] > 0).any(dim=(1, 2)).sum() > 1000


def test_main_path_render_is_two_launches(cuda):
    """render() at the main path's B=128 x 176 rows (demo spheres, LOD 512,
    240x320) launches kernel A and kernel B once each and no rank kernel."""
    first = demo.first_render_inputs(128, (480, 640), (240, 320), 512, cuda)
    assert first["tri_verts"].shape[:2] == (128, 176)
    kernels = rasterizer_cuda.RASTER_KERNEL
    before = dict(kernels.launches)
    render(first["tri_verts"], first["tri_valid"], first["TCO"], first["K_crop"],
           image_size=(240, 320), colors=first["colors"])
    torch.cuda.synchronize()
    assert {k: kernels.launches[k] - before[k] for k in before} == {
        "raster_setup": 1, "raster_setup_merge": 0, "raster_resolve": 1, "raster_resolve_attr": 0,
        "raster_resolve_bin": 0, "raster_resolve_listed": 0}


def test_recorded_frame_card_matches_cpu(cuda, tmp_path):
    """One small scene recorded on the card (kernels) and on the CPU (plain
    versions): GT, boxes, visible fractions, rgb and masks equal, depth
    within 1 mm (chip_smoke.record_card_vs_cpu)."""
    import chip_smoke

    errs, _ = chip_smoke.record_card_vs_cpu(tmp_path)
    assert all(e <= tol for e, tol in errs.values()), errs


def test_vsd_card_matches_cpu(cuda):
    """One group's VSD (2 estimates and 2 GTs of a demo cube at 240x320,
    BatchRenderer's tile and budget) on the card (kernels) and on the CPU
    (plain versions), against the same scene depth. Depth where both draw
    within the kernel tests' 1e-4; the pixels whose mask differs, and those
    whose place in e_VSD differs (chip_smoke.vsd_pixel_states: in the union,
    matched at some τ), within 1e-4 of the pixels, as the render test holds
    masks; the VSD errors then differ by at most 2 such pixels over the
    smallest union, and not at all when none differs."""
    import chip_smoke
    from cosypose_tpu_torch.evaluation import bop_metrics
    from cosypose_tpu_torch.rendering.scene_renderer import BatchRenderer

    K = np.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]])
    gts = [np.eye(4), np.eye(4)]
    gts[0][:3, 3], gts[1][:3, 3] = (0.03, 0.01, 0.6), (-0.05, -0.02, 0.7)
    ests = [g.copy() for g in gts]
    ests[0][:3, 3] += (0.004, -0.002, 0.01)
    ests[1][:3, :3] = np.array([[0.96, -0.28, 0], [0.28, 0.96, 0], [0, 0, 1]])
    runs, scene = {}, None
    for dev in ("cpu", "cuda"):
        db = build_mesh_db(demo.cube_specs(), device=dev)
        diam = db.infos["obj_000001"]["diameter_m"]
        renderer = BatchRenderer(db)
        lids, poses, Ks = bop_metrics.vsd_render_inputs(0, ests, gts, K)
        depth = renderer.render(lids, poses, Ks, resolution=IMAGE, render_depth=True).depth.cpu()
        if scene is None:   # the GTs' nearest surface, from the CPU render
            d = depth[len(ests):].numpy()
            scene = np.where(d > 0, d, np.inf).min(0)
            scene = np.where(np.isfinite(scene), scene, 0).astype(np.float32)
        runs[dev] = (depth.numpy(), bop_metrics._vsd_matrix(renderer, 0, ests, gts, K, scene, diam))
    (d_cpu, M_cpu), (d_card, M_card) = runs["cpu"], runs["cuda"]
    both = (d_cpu > 0) & (d_card > 0)
    assert np.abs(d_cpu - d_card)[both].max() <= ATOL
    assert int(((d_cpu > 0) != (d_card > 0)).sum()) <= 1e-4 * d_cpu.size
    vsd_px = union = 0
    for a in range(len(ests)):
        for b in range(len(gts)):
            (u_c, m_c), (u_k, m_k) = (chip_smoke.vsd_pixel_states(d[a], d[len(ests) + b], scene,
                                                                  diam) for d in (d_cpu, d_card))
            vsd_px += int(((u_c != u_k) | (m_c != m_k).any(0)).sum())
            union = min(union, int(u_c.sum())) if union else int(u_c.sum())
    assert vsd_px <= 1e-4 * d_cpu[0].size * len(ests) * len(gts)
    assert np.abs(M_card - M_cpu).max() <= 2 * vsd_px / union
    assert M_cpu.shape == (2, 2, 10) and M_cpu[0, 0].min() < M_cpu[0, 1].min()


def test_detector_card_matches_cpu(cuda):
    """CenterNet (WideResNet-18, 21 classes) at 240x320, fp32, seeded weights:
    head outputs within 1e-3 (cuDNN vs oneDNN summation order); the decoded
    detections (both cls_modes, NMS on) equal as sets except at most 2 of 64
    an image, where a near-tie peak or score moves."""
    from cosypose_tpu_torch.models.detector import (CenterNetDetector, DetectorConfig,
                                                    decode_detections, init_detector_weights)
    x = torch.as_tensor(np.random.RandomState(0).uniform(size=(2, 3, 240, 320)),
                        dtype=torch.float32)
    for cls_mode in ("percls", "softmax"):
        model = CenterNetDetector(DetectorConfig(cls_mode=cls_mode)).eval()
        init_detector_weights(model, torch.Generator().manual_seed(0))
        with torch.no_grad():
            cpu = model(x)
            card = model.to(cuda)(x.to(cuda))
        for k in cpu:
            assert (card[k].cpu() - cpu[k]).abs().max().item() <= 1e-3, k
        dets = {dev: decode_detections({k: v.to(dev) for k, v in cpu.items()}, 64)
                for dev in ("cpu", cuda)}
        for b in range(2):
            sets = [{(int(c), tuple(np.round(bx.tolist(), 3))) for c, bx, s in
                     zip(d["class_ids"][b].cpu(), d["boxes"][b].cpu(), d["scores"][b].cpu())
                     if s > 0} for d in dets.values()]
            assert len(sets[0] ^ sets[1]) <= 4 and len(sets[0]) > 0


@pytest.mark.parametrize("config", ["procedural-refiner-mini", "procedural-diag-corr-flat-lk"])
def test_posenet_backbones_card_matches_cpu(cuda, config):
    """The WideResNet-18 and CorrNet (flatten + lk pooling, 9 channels)
    predictors of two configs, in fp32 on the card and on the CPU: TCO within
    1e-3 after 2 iterations."""
    from cosypose_tpu_torch.training.configs import make_cfg

    cfg = dataclasses.replace(make_cfg(config).train.predictor, compute_dtype=torch.float32,
                              n_points_crop=200)
    images, K, TCO, label_ids = demo.make_inputs(2, 240, 320)
    outs, weights = {}, None
    for dev in ("cpu", "cuda"):
        pp = PosePredictor(cfg, device=dev)
        weights = weights or pp.net.state_dict()
        pp.net.load_state_dict(weights)
        w = pp.net.pose_fc.weight
        with torch.no_grad():  # a random pose kernel: the iterations move the pose
            w.copy_(5e-3 * torch.randn(w.shape, generator=torch.Generator().manual_seed(2)))
        db = build_mesh_db(demo.demo_specs(), render_max_faces=512, device=dev)
        md = gather_mesh_data(db, torch.as_tensor(label_ids, device=dev).long(), 200)
        args = [torch.as_tensor(a, device=dev) for a in (images, K, TCO)]
        outs[dev] = pp.forward(md, *args, n_iterations=2)["TCO_final"].cpu()
    assert (outs["cuda"] - outs["cpu"]).abs().max().item() <= 1e-3


def _icp_inputs(device):
    """Cubes at 120x160: GT depth rendered on the CPU, poses 1 cm / 2 cm
    off, the depth rendered there; the last detection sees no depth."""
    db = build_mesh_db(demo.cube_specs(), device="cpu")
    rng = np.random.RandomState(0)
    B = 6
    ids = torch.as_tensor([0, 1] * 3)
    K = torch.tensor([[300.0, 0, 80], [0, 300, 60], [0, 0, 1]]).repeat(B, 1, 1)
    TCO = torch.eye(4).repeat(B, 1, 1)
    TCO[:, :3, 3] = torch.as_tensor(rng.uniform(-0.05, 0.05, (B, 3)) + [0, 0, 0.5]).float()
    bad = TCO.clone()
    bad[:, 0, 3] += 0.01
    bad[:, 2, 3] += 0.02
    observed = render(db.tri_verts[ids], db.tri_valid[ids], TCO, K, image_size=(120, 160)).depth
    observed[-1] = 0.0
    rendered = render(db.tri_verts[ids], db.tri_valid[ids], bad, K, image_size=(120, 160)).depth
    return [t.to(device) for t in (bad, rendered, observed, K)]


def test_icp_card_matches_cpu(cuda):
    """ICP on the same rendered and observed depth: the card's torch.linalg.svd
    (cuSOLVER) against LAPACK, including iterations without an inlier. Poses
    within 1e-3, flags equal, the depth-less detection unchanged."""
    from cosypose_tpu_torch.integrated.icp_refiner import _icp_refine_batch

    args = _icp_inputs("cpu")
    ref, ok_ref = _icp_refine_batch(*args, n_iterations=10)
    got, ok = _icp_refine_batch(*[a.to(cuda) for a in args], n_iterations=10)
    assert ok.cpu().tolist() == ok_ref.tolist() == [True] * 5 + [False]
    assert (got.cpu() - ref).abs().max().item() <= 1e-3
    assert torch.equal(got[-1].cpu(), args[0][-1])


def _matched(device):
    from cosypose_tpu_torch.multiview.ransac import multiview_candidate_matching
    from cosypose_tpu_torch.scripts import bench_multiview

    db = build_mesh_db(bench_multiview.cube_specs(3), aabb=True, keep_geometry=False,
                       device=device)
    cands, cams, _ = bench_multiview.make_scenario(4, 6, 3, 2, 2, noise_t=0.004, noise_deg=2.0)
    return db, cams, multiview_candidate_matching(cands, db, n_ransac_iter=2000)


def test_topk_scoring_card_matches_cpu(cuda):
    """RANSAC with the top-k scoring on the card and on the CPU: the same
    matched candidates and objects, the same best view pairs, TC1C2 within
    1e-5."""
    _, _, ref = _matched("cpu")
    _, _, got = _matched(cuda)
    for k in ("cand_id", "obj_id", "view_id"):
        assert got["filtered_candidates"].infos[k].tolist() == \
            ref["filtered_candidates"].infos[k].tolist()
    for k in ("view1", "view2"):
        assert got["pairs_TC1C2"].infos[k].tolist() == ref["pairs_TC1C2"].infos[k].tolist()
    assert (got["pairs_TC1C2"].TC1C2 - ref["pairs_TC1C2"].TC1C2).abs().max().item() <= 1e-5


def test_lm_card_matches_cpu(cuda):
    """Bundle adjustment of the matched scene on the card and on the CPU from
    the same matches: iterations within one, loss within 2e-5, object poses
    within 5e-4 (tests/test_torch_port_multiview.py's tolerances)."""
    from cosypose_tpu_torch.multiview.bundle_adjustment import MultiviewRefinement

    db, cams, match = _matched("cpu")
    out = {}
    for dev in ("cpu", cuda):
        db_d = db.to(dev)
        out[str(dev)] = MultiviewRefinement(match["filtered_candidates"], cams,
                                            match["pairs_TC1C2"], db_d).solve(n_iterations=100)
    a, b = out["cpu"], out[str(cuda)]
    assert abs(a["n_lm_iterations"] - b["n_lm_iterations"]) <= 1
    assert abs(a["final_loss"] - b["final_loss"]) <= 2e-5
    assert (a["objects"].TWO - b["objects"].TWO.cpu()).abs().max().item() <= 5e-4


def test_two_gloo_ranks_on_the_card_match_one_process(cuda):
    """chip_smoke phase 10(b) at a small size: the B0 48x64 step at a global
    batch of 8 on two gloo ranks sharing the card (4 rows each) against one
    process at 8 on the card, from the same weights, batch and draws, within
    the card-vs-CPU tolerances of one step (chip_smoke.step_errors); each
    rank launches both raster kernels once an iteration."""
    import chip_smoke
    from cosypose_tpu_torch.parallel import rank_checks
    from cosypose_tpu_torch.parallel.spawn import spawn

    tpt, cfg, db, state, batch, draws = _train_setup(cuda, remat=False, drop_connect_rate=0.2)
    sd0 = {k: v.detach().cpu().clone() for k, v in state.pp.net.state_dict().items()}
    ref = chip_smoke.step_snapshot(state.pp.net, tpt.make_train_step(cfg, db)(state, batch, draws))
    case = dict(cfg=cfg, specs=[dataclasses.asdict(s) for s in demo.demo_specs()],
                render_max_faces=512, param_mode="replicated", init=sd0,
                batch={k: v.cpu().numpy() for k, v in batch.items()}, draws=[draws],
                keep=("grads",))
    ranks = spawn(rank_checks.pose_steps, 2, (case,), backend="gloo", device="cuda:0",
                  timeout_s=300)
    errs = chip_smoke.step_errors(chip_smoke.rank_snapshot(ranks[0]["steps"][0]), ref, cfg)
    assert not {k: v for k, v in errs.items() if not v[0] <= v[1]}, errs
    want = {"raster_setup": cfg.n_iterations, "raster_resolve": cfg.n_iterations,
            "raster_resolve_attr": 0, "raster_setup_merge": 0,
            "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    assert [r["launches"] for r in ranks] == [want, want]


def test_global_batchnorm_two_ranks_on_the_card(cuda):
    """BatchNorm over the global batch on two gloo ranks sharing the card:
    output, input gradient, weight and bias gradients within 1e-5 and the
    flax running update within 1e-6 of the full-batch layer on the card."""
    from cosypose_tpu_torch.models.efficientnet import BatchNorm2d
    from cosypose_tpu_torch.parallel import rank_checks
    from cosypose_tpu_torch.parallel.spawn import spawn

    rng = np.random.RandomState(11)
    C = 6
    case = dict(x=(3.0 + 2.0 * rng.normal(size=(8, C, 12, 10))).astype(np.float32),
                dy=rng.normal(size=(8, C, 12, 10)).astype(np.float32),
                weight=rng.uniform(0.5, 1.5, C).astype(np.float32),
                bias=rng.normal(size=C).astype(np.float32),
                running_mean=rng.normal(size=C).astype(np.float32),
                running_var=rng.uniform(0.5, 1.5, C).astype(np.float32), eps=1e-3, momentum=0.9)
    got = spawn(rank_checks.batchnorm, 2, (case,), backend="gloo", device="cuda:0",
                timeout_s=300)
    layer = BatchNorm2d(C, eps=1e-3, flax_momentum=0.9).to(cuda)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(layer, k).copy_(torch.as_tensor(case[k]))
    x = torch.as_tensor(case["x"], device=cuda).requires_grad_(True)
    y = layer(x)
    (y * torch.as_tensor(case["dy"], device=cuda)).sum().backward()
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), y.detach().cpu(), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]), x.grad.cpu(), atol=1e-5, rtol=0)
    torch.testing.assert_close(sum(g["dweight"] for g in got), layer.weight.grad.cpu(),
                               atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(sum(g["dbias"] for g in got), layer.bias.grad.cpu(), atol=1e-5,
                               rtol=1e-6)
    for g in got:
        torch.testing.assert_close(g["running_mean"], layer.running_mean.cpu(), atol=1e-6,
                                   rtol=1e-6)
        torch.testing.assert_close(g["running_var"], layer.running_var.cpu(), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("op", ["raster_setup", "raster_resolve", "raster_resolve_attr"])
def test_raster_operators_opcheck_on_the_card(cuda, op):
    """torch.library.opcheck on CUDA tensors: the CUDA implementation (the
    kernel) against the fake one, schema, autograd registration and AOT
    dispatch; each call launches the kernel."""
    tv, valid, TCO, K, colors = demo_scene(cuda, B=4)
    with_attr = op == "raster_resolve_attr"
    attr = torch.arange(valid.numel(), dtype=torch.float32, device=cuda).reshape(valid.shape) \
        if with_attr else None
    sargs = (tv, valid, TCO, K, list(IMAGE), colors, 0.05, attr)
    if op == "raster_setup":
        fn, args = rasterizer_cuda.raster_setup_op, sargs
    else:
        rows, _, order = rasterizer_cuda.raster_setup_op(*sargs)
        fn, args = rasterizer_cuda.raster_resolve_op, (rows, order, list(IMAGE), [16, 32], 1024,
                                                       with_attr)
    name = "raster_resolve_attr" if with_attr else op
    before = rasterizer_cuda.RASTER_KERNEL.launches[name]
    torch.library.opcheck(fn, args)
    torch.cuda.synchronize()
    assert rasterizer_cuda.RASTER_KERNEL.launches[name] > before


def test_exported_refiner_matches_eager_on_the_card(cuda):
    """The exported bf16 B3 refiner (2 iterations, B=8) against its eager
    forward on the card: equal within 1e-5, one launch of each raster kernel
    and 26 of the depthwise kernel an iteration of a call."""
    from cosypose_tpu_torch.integrated.pose_predictor import LoadedPoseModel
    from cosypose_tpu_torch.serving import export_pose_model, load_exported

    B, n_it = 8, 2
    cfg = PosePredictorConfig(compute_dtype=torch.bfloat16)
    db = build_mesh_db(demo.demo_specs(), render_max_faces=512, device=cuda)
    pp = PosePredictor(cfg, device=cuda)
    images, K, TCO, labels = demo.make_inputs(B)
    md = gather_mesh_data(db, torch.as_tensor(labels, device=cuda).long(), cfg.n_points_crop)
    args = [torch.as_tensor(a, device=cuda) for a in (images, K, TCO)]
    demo.demo_weights(pp, md, *args, torch.Generator().manual_seed(1))
    blob = export_pose_model(LoadedPoseModel(pp, db, device=cuda), B, images.shape[-2:],
                             n_iterations=n_it)
    fn = load_exported(blob, device=cuda)
    before = dict(rasterizer_cuda.RASTER_KERNEL.launches)
    before_dw = depthwise_cuda.DW_KERNEL.launches
    got = fn(images, K, TCO, labels)
    torch.cuda.synchronize()
    launched = {k: rasterizer_cuda.RASTER_KERNEL.launches[k] - before[k] for k in before}
    assert launched == {"raster_setup": n_it, "raster_resolve": n_it, "raster_resolve_attr": 0,
                        "raster_setup_merge": 0,
                        "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    # the B3's depthwise halves, as the registered operator in the program
    assert depthwise_cuda.DW_KERNEL.launches - before_dw == 26 * n_it
    want = pp.forward(md, *args, n_iterations=n_it)["TCO_final"]
    assert (got - want).abs().max().item() <= 1e-5
    assert (want - args[2]).abs().max().item() > 1e-4


B3_DW_SHAPES = sorted(set(EfficientNet("efficientnet-b3").depthwise_shapes((240, 320))))


def _shape_id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", B3_DW_SHAPES, ids=_shape_id)
def test_dw_kernel_matches_plain_at_the_b3_shapes(cuda, shape):
    """The MBConv depthwise kernel at each of B3's 14 depthwise shapes at B=64,
    bf16 (the serving cell's iteration): within error_limit of its plain
    version (bf16: each side rounds y once, 2^-8 of |y|, so a value may land
    one bf16 step away; the float32 sums' order, 2^-17 of the terms' size),
    and equal to a second call bit for bit (one group of threads sums each
    plane, in a fixed order)."""
    import chip_smoke

    with torch.inference_mode():
        assert chip_smoke.dw_check(chip_smoke.dw_inputs(shape, 64, torch.bfloat16, 0, cuda)[0]) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [B3_DW_SHAPES[0], B3_DW_SHAPES[-1], (7, 3, 2, 13, 17),
                                   (5, 5, 2, 9, 11), (6, 5, 2, 10, 7), (4, 5, 1, 3, 4),
                                   (3, 3, 2, 1, 1), (2, 5, 1, 9, 3000)], ids=_shape_id)
def test_dw_kernel_matches_plain_at_odd_sizes_and_dtypes(cuda, shape, dtype):
    """Every dtype the kernel takes, at odd sizes (stride-2 padding asymmetric,
    planes not 16-byte aligned, inputs smaller than the kernel, a band above
    48 KB of shared memory), within error_limit, deterministic."""
    import chip_smoke

    with torch.inference_mode():
        assert chip_smoke.dw_check(chip_smoke.dw_inputs(shape, 3, dtype, 1, cuda)[0]) <= 1


def test_dw_operator_opcheck_on_the_card(cuda):
    """torch.library.opcheck of cosypose::dw_bn_silu_squeeze on CUDA tensors:
    the kernel against the fake implementation, schema and dispatch."""
    import chip_smoke

    args = chip_smoke.dw_inputs((6, 5, 2, 15, 20), 2, torch.bfloat16, 0, cuda)[0]
    before = depthwise_cuda.DW_KERNEL.launches
    torch.library.opcheck(depthwise_cuda.dw_bn_silu_squeeze_op, args)
    torch.cuda.synchronize()
    assert depthwise_cuda.DW_KERNEL.launches > before


def _dw_launches(fn):
    """(launches of the depthwise kernel, its program counter) over fn()."""
    before = depthwise_cuda.DW_KERNEL.launches
    with profiling.tracing():
        fn()
    torch.cuda.synchronize()
    counters = profiling.collect()["counters"].values()
    return (depthwise_cuda.DW_KERNEL.launches - before,
            sum(c.get("dw_bn_silu_squeeze", 0) for c in counters))


def test_dw_kernel_launches_26_per_eval_b3_call_and_none_in_train(cuda):
    """An eval B3 call on the card launches the kernel once a block (26), and
    the program's counter reads the same; a train-mode step, or an eval
    forward that records a gradient, launches none."""
    net = EfficientNet("efficientnet-b3").to(cuda)
    x = torch.rand(2, 6, 64, 96, device=cuda)

    def serve():
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            net(x)

    def train():
        net(x).float().square().mean().backward()

    net.eval()
    assert _dw_launches(serve) == (26, 26)
    assert _dw_launches(train) == (0, 0)
    net.train()
    assert _dw_launches(train) == (0, 0)


def test_mbconv_train_mode_is_unchanged_on_the_card(cuda):
    """A train-mode block (batch statistics, drop-connect, autograd) against
    the unfused forward the block ran before its depthwise kernel: forward
    and running statistics bit for bit; gradients within 1e-6 of each
    tensor's max (the order of cuDNN's backward reductions)."""
    torch.manual_seed(0)
    blocks = [MBConvBlock(16, 16, 5, 1, 6, 0.25, drop_rate=0.3).to(cuda).train()
              for _ in range(2)]
    blocks[1].load_state_dict(blocks[0].state_dict())
    keep = torch.tensor([True, False, True, True], device=cuda)
    x = torch.randn(4, 16, 15, 20, device=cuda)

    def unfused(b, x):
        inp = x
        x = F.silu(b._bn0(b._expand_conv(x)))
        x = F.silu(b._bn1(b._depthwise_conv(x)))
        s = b._se_expand(F.silu(b._se_reduce(x.mean(dim=(2, 3), keepdim=True))))
        x = b._bn2(b._project_conv(x * torch.sigmoid(s)))
        x = torch.where(keep[:, None, None, None], x / (1.0 - b.drop_rate),
                        torch.zeros((), dtype=x.dtype, device=cuda))
        return x + inp

    outs, grads = [], []
    for b, fwd in zip(blocks, (lambda b, x: b(x, keep), unfused)):
        xi = x.clone().requires_grad_(True)
        out = fwd(b, xi)
        out.square().sum().backward()
        outs.append(out)
        grads.append([xi.grad] + [p.grad for p in b.parameters()])
    assert torch.equal(outs[0], outs[1])
    for g0, g1 in zip(*grads):
        assert float((g0 - g1).abs().max()) <= 1e-6 * float(g1.abs().max())
    for name, buf in blocks[0].state_dict().items():
        assert torch.equal(buf, blocks[1].state_dict()[name]), name


def test_jpeg_decoders_on_the_cards_host(cuda):
    """The committed fixtures through the library (built with g++ there) and
    the numpy decoder, both equal to the Pillow arrays stored beside them
    (arithmetic-coded, lossless, CMYK and YCCK files among them), and a
    decoded frame on the card equal to the one on the host."""
    import importlib.util
    import pathlib

    from cosypose_tpu_torch.utils import jpeg, jpeg_cext

    # loaded from its path: the card's machine may have another `tests` package
    path = pathlib.Path(__file__).with_name("torch_port_make_jpeg_fixtures.py")
    spec = importlib.util.spec_from_file_location("torch_port_make_jpeg_fixtures", path)
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    ROOT = fx.ROOT
    expected = fx.expected()
    assert {"frame_arith_420_q90.jpg", "small_arith_progressive_422.jpg", "frame_cmyk_q90.jpg",
            "small_ycck_2211.jpg", "small_lossless_420_p6.jpg"} <= set(expected)
    for rel, ref in expected.items():
        data = (ROOT / rel).read_bytes()
        assert np.array_equal(jpeg_cext.decode(data, rel), ref), rel
        assert np.array_equal(jpeg.decode(data, rel), ref), rel
    frame = jpeg_cext.decode((ROOT / "frame_420_q95.jpg").read_bytes())
    assert torch.equal(torch.as_tensor(frame).to(cuda).cpu(), torch.as_tensor(frame))


@pytest.mark.parametrize("impl", ["shift", "dense"])
def test_depthwise_lowerings_on_the_card(cuda, impl):
    """`+dw<impl>` against the grouped conv on the card from the same weights:
    fp32 within the CPU backbone tests' 1e-4, bf16 under autocast within the
    CPU test's 0.05 of the features' largest magnitude."""
    torch.manual_seed(0)
    nets = {}
    for name in ("efficientnet-b0", f"efficientnet-b0+dw{impl}"):
        pp = PosePredictor(PosePredictorConfig(backbone=name, render_size=(64, 96)), device=cuda)
        nets[name] = pp.net.eval()
    base, alt = nets.values()
    alt.load_state_dict(base.state_dict())
    x = torch.rand(4, 6, 64, 96, device=cuda)
    with torch.no_grad():
        ref, got = base.backbone(x), alt.backbone(x)
        assert float((got - ref).abs().max()) <= ATOL
        with torch.autocast("cuda", dtype=torch.bfloat16):
            ref16, got16 = base.backbone(x).float(), alt.backbone(x).float()
    assert float((got16 - ref16).abs().max() / ref16.abs().max()) <= 0.05


def sliver_inputs(B=16, F=64, seed=3):
    """(tri_verts, tri_valid, TCO, K) numpy: F // 2 pole triangles whose first
    two corners lie a few nm apart, then ordinary triangles, at crop-like
    poses and intrinsics."""
    rng = np.random.RandomState(seed)
    pole = np.array([0.0, 0.0, -0.0537], np.float32)
    ring = rng.uniform(-0.03, 0.03, (F, 3)).astype(np.float32)
    tv = np.stack([pole + rng.uniform(-5e-9, 5e-9, (F, 3)),
                   pole + rng.uniform(-5e-9, 5e-9, (F, 3)), ring], 1).astype(np.float32)
    tv = np.broadcast_to(tv, (B, F, 3, 3)).copy()
    tv[:, F // 2:] = rng.uniform(-0.05, 0.05, (B, F // 2, 3, 3))
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        TCO[b, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    TCO[:, :3, 3] = np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B),
                              rng.uniform(0.4, 1.0, B)], 1)
    K = np.tile(np.array([[2000.0, 0, 150], [0, 2000.0, 110], [0, 0, 1]], np.float32), (B, 1, 1))
    return tv, np.ones((B, F), bool), TCO, K


def test_setup_kernel_equals_plain_bit_for_bit_on_slivers(cuda):
    """Kernel A against setup_plain on the card at pole slivers (corners a few
    nm apart, degenerate up to rounding) and ordinary triangles: both round
    the corners, the projection and the sums over corners op for op in the
    same order, so validity, the barycentric and 1/z planes, the boxes and
    the keys are equal, and the colour planes within SETUP_TOL."""
    args = [torch.as_tensor(a, device=cuda) for a in sliver_inputs()]
    rows_k, key_k, _ = rasterizer_cuda.setup(*args, (240, 320))
    rows_p, key_p = rasterizer_cuda.setup_plain(*args, (240, 320))
    colour = slice(12, 21)
    exact = [i for i in range(rows_k.shape[-1]) if not colour.start <= i < colour.stop]
    assert torch.equal(rows_k[..., exact], rows_p[..., exact]) and torch.equal(key_k, key_p)
    err = rasterizer_cuda.setup_error(rows_k.cpu(), key_k.cpu(), rows_p.cpu(), key_p.cpu(),
                                      (240, 320), K=args[3].cpu())
    assert err["valid_differs"] == 0 and err["plane"] <= rasterizer_cuda.SETUP_TOL, err


# PERF.md §6's shapes of kernel A (items x rows, render size), and the largest
# soups: the amodal re-render, a procedural scene of 10 cameras, kernel B's
# row cap
SETUP_SHAPES = {"main path": (128, None, (240, 320)), "VSD": (8, 1216, (240, 320)),
                "ICP": (7, 1216, (240, 320)), "mini refiner": (64, 1216, (120, 160)),
                "VOC training": (32, 1216, (240, 320)), "amodal": (80, 1216, (240, 320)),
                "scene": (10, 10088, (240, 320)), "ties": (5, 45, (48, 64))}


@pytest.mark.parametrize("shape", [*SETUP_SHAPES, "one window of kernel B"])
def test_setup_order_equals_torch_sort(cuda, shape):
    """Kernel A's order against torch.sort(ykey, dim=1, stable=True).indices
    on the card, element for element, for every cluster size (the launcher's
    choice, one block an item, 2 and 8): the same rows, keys and order each
    time, and rows within SETUP_TOL of setup_plain with validity equal. The
    soups tie keys (repeated triangles, an all-invalid item, padding rows)
    and put rows above the image (negative keys)."""
    kernels = rasterizer_cuda.RASTER_KERNEL
    if shape == "main path":
        first = demo.first_render_inputs(128, (480, 640), (240, 320), 512, cuda)
        args = (first["tri_verts"], first["tri_valid"], first["TCO"], first["K_crop"],
                first["colors"])
        image = (240, 320)
    else:
        B, F, image = SETUP_SHAPES.get(shape, (2, kernels.window_rows(cuda), (240, 320)))
        args = tie_soup(B, F, seed=F + B, device=cuda, image=image)
    first_out = None
    for cluster in (0, 1, 2, 8):
        out = kernels.setup(*args[:4], image, args[4], cluster=cluster)
        torch.cuda.synchronize()
        rows, key, order = out
        assert torch.equal(order, torch.sort(key, dim=1, stable=True).indices), cluster
        if first_out is None:
            first_out = out
        assert all(torch.equal(a, b) for a, b in zip(out, first_out)), cluster
    err = rasterizer_cuda.setup_error(rows, key, *rasterizer_cuda.setup_plain(
        *args[:4], image, args[4]), image, K=args[3])
    assert err["valid_differs"] == 0 and err["plane"] <= rasterizer_cuda.SETUP_TOL, err
    assert err["bbox_key"] <= rasterizer_cuda.SETUP_TOL, err


@pytest.mark.parametrize("F", LARGE_ROWS)
def test_setup_takes_any_row_count(cuda, F):
    """Kernel A on two items of F rows, more than one block sorts
    (sort_block_rows(), 16,384 on an H100): the launcher's choice (sorted
    runs and their merge, at run_rows(): the shortest power of two from 256
    that makes the runs launch one wave), the runs at every length the
    launcher may choose (256 to 16,384 rows), and every cluster size that
    holds F, each giving the same rows, keys and order, the order equal to
    torch.sort(key, dim=1, stable=True) element for element, the rows within
    SETUP_TOL of setup_plain; the merge launched, once a pass, only with
    runs."""
    kernels = rasterizer_cuda.RASTER_KERNEL
    block = kernels.sort_block_rows(cuda)
    assert block == 16_384 and F > block
    args = tie_soup(2, F, seed=F, device=cuda, image=(240, 320))
    need = -(-F // block)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kernels.setup_plan(2, F, cuda) == -1
    run = kernels.run_rows(2, F, cuda)
    assert run == next(r for r in (256, 512, 1024, 2048, 4096, 8192, 16384)
                       if 2 * -(-F // r) <= sms or r == block)
    first = None
    choices = [(0, None)] + [(-1, r) for r in (256, 512, 1024, 2048, 4096, 8192, 16384)] + [
        (c, None) for c in range(need, 9)]
    for cluster, run_rows in choices:
        before = dict(kernels.launches)
        out = kernels.setup(*args[:4], (240, 320), args[4], cluster=cluster, run_rows=run_rows)
        torch.cuda.synchronize()
        passes = kernels.merge_passes(F, run_rows or run) if cluster <= 0 else 0
        assert {k: kernels.launches[k] - before[k] for k in before} == {
            "raster_setup": 1, "raster_setup_merge": passes, "raster_resolve": 0,
            "raster_resolve_attr": 0,
            "raster_resolve_bin": 0, "raster_resolve_listed": 0}, (cluster, run_rows)
        rows, key, order = out
        assert torch.equal(order, torch.sort(key, dim=1, stable=True).indices), (cluster, run_rows)
        first = first or out
        assert all(torch.equal(a, b) for a, b in zip(out, first)), (cluster, run_rows)
    err = rasterizer_cuda.setup_error(rows, key, *rasterizer_cuda.setup_plain(
        *args[:4], (240, 320), args[4]), (240, 320), K=args[3])
    assert err["valid_differs"] == 0 and err["plane"] <= rasterizer_cuda.SETUP_TOL, err
    assert err["bbox_key"] <= rasterizer_cuda.SETUP_TOL, err
    if need > 1:
        with pytest.raises(ValueError, match="do not hold"):
            kernels.setup(*args[:4], (240, 320), args[4], cluster=need - 1)


def test_composite_keys_order_as_torch_sort_on_the_card(cuda):
    """The kernel's key map (sort_composite_keys) orders as torch.sort does on
    the card, on keys with ties, +-0.0, +-inf, NaNs of both signs and other
    payloads, denormals and negative keys, in rows short and long enough for
    both of torch.sort's paths."""
    bits = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF, 0x7F800000, 0xFF800000,
                     0x80000000, 0, 1, 0x80000001, 0x00400000, 0x80400000, 0x3F800000,
                     0xBF800000], np.uint32)
    special = torch.as_tensor(bits.view(np.float32))
    rng = np.random.RandomState(0)
    for n in (5, 14, 700, 5000):
        picks = rng.randint(0, len(bits), (3, n))
        keys = special[picks].to(cuda)
        keys[1] = torch.as_tensor(rng.normal(size=n).astype(np.float32)).round()
        want = torch.sort(keys, dim=1, stable=True).indices
        assert torch.equal(rasterizer_cuda.sort_composite_keys(keys), want), n


def test_render_launches_two_kernels_and_no_sort(cuda):
    """One render() call on the card launches kernel A and kernel B once each
    and no sort kernel: read from a torch.profiler trace in a fresh process
    (chip_smoke.render_kernel_names), where the profiler still sees the card
    (PERF.md §7)."""
    import json
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    code = (f"import json, sys; sys.path.insert(0, {str(repo)!r}); import chip_smoke; "
            "from cosypose_tpu_torch import demo; "
            "from cosypose_tpu_torch.ops.render import render; "
            "f = demo.first_render_inputs(8, (480, 640), (240, 320), 512, 'cuda'); "
            "print(json.dumps(chip_smoke.render_kernel_names(lambda: render(f['tri_verts'], "
            "f['tri_valid'], f['TCO'], f['K_crop'], image_size=(240, 320), "
            "colors=f['colors']))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=repo, check=True)
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert sum("raster_setup_kernel" in n for n in names) == 1, names
    assert sum("raster_resolve_kernel" in n for n in names) == 1, names
    assert not [n for n in names if "sort" in n.lower()], names
