"""Port parity: the binned rasterizer (the plain versions of the setup and
resolve kernels, with the sort between) against JAX
`rasterize_pallas(interpret=True)`, and the port's plain `rasterize` against
JAX `rasterize`; and the resolve kernel's cull rule, `row_may_cover`.

Cases are those of tests/test_rasterizer_pallas.py plus a budget-overflow
case and the demo spheres. Tolerances: rgb and depth atol 1e-4; mask and
attribute exactly equal. The cull must leave the image unchanged to the bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.ops.rasterizer import rasterize as j_rasterize
from cosypose_tpu.ops.rasterizer_pallas import rasterize_pallas
from cosypose_tpu_torch import demo
from cosypose_tpu_torch.ops import nvcc_build, rasterizer_cuda
from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
from cosypose_tpu_torch.ops.rasterizer import first_k_true
from cosypose_tpu_torch.ops.rasterizer import rasterize as t_rasterize
from cosypose_tpu_torch.ops.render import render
from tests.test_rasterizer import cube_mesh, make_K
from tests.test_torch_port_gpu import sliver_inputs

ATOL = 1e-4
IMAGE = (48, 80)


def case_random_poses():
    rng = np.random.RandomState(0)
    verts, tris = cube_mesh(0.12)
    B = 3
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        TCO[b, :3, :3] = Q
        TCO[b, :3, 3] = [rng.uniform(-0.03, 0.03), rng.uniform(-0.03, 0.03),
                         rng.uniform(0.45, 0.8)]
    tv = verts[tris][None].repeat(B, axis=0)
    return dict(tv=tv, valid=np.ones((B, tris.shape[0]), bool), TCO=TCO,
                K=make_K(B, fx=200, fy=200, cx=40, cy=24), attr=None, budget=768)


def case_two_instances():
    verts, tris = cube_mesh(0.1)
    F = tris.shape[0]
    tv1 = verts[tris] + np.array([-0.04, 0.0, 0.6], np.float32)
    tv2 = verts[tris] + np.array([0.04, 0.01, 0.7], np.float32)
    attr = np.concatenate([np.full(F, 1.0), np.full(F, 2.0)])[None].astype(np.float32)
    return dict(tv=np.concatenate([tv1, tv2])[None], valid=np.ones((1, 2 * F), bool),
                TCO=np.eye(4, dtype=np.float32)[None],
                K=make_K(1, fx=200, fy=200, cx=40, cy=24), attr=attr, budget=768)


def case_small_budget():
    verts, tris = cube_mesh(0.12)
    B = 2
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, 2, 3] = [0.5, 0.7]
    return dict(tv=verts[tris][None].repeat(B, axis=0),
                valid=np.ones((B, tris.shape[0]), bool), TCO=TCO,
                K=make_K(B, fx=200, fy=200, cx=40, cy=24), attr=None, budget=16)


CASES = {"random_poses": case_random_poses, "two_instances": case_two_instances,
         "small_budget": case_small_budget}


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _compare(port, ref, with_attr):
    np.testing.assert_allclose(port.depth.numpy(), np.asarray(ref.depth), atol=ATOL, rtol=0)
    np.testing.assert_allclose(port.rgb.numpy(), np.asarray(ref.rgb), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    if with_attr:
        np.testing.assert_array_equal(port.attr.numpy(), np.asarray(ref.attr))


def run_binned(c, tile):
    """(port render, JAX rasterize_pallas(interpret=True)) of one case."""
    ref = rasterize_pallas(_j(c["tv"]), _j(c["valid"]), _j(c["TCO"]), _j(c["K"]),
                           image_size=IMAGE, interpret=True, tri_attr=_j(c["attr"]),
                           max_tris_per_tile=c["budget"])
    port = render(_t(c["tv"]), _t(c["valid"]), _t(c["TCO"]), _t(c["K"]), image_size=IMAGE,
                  tile=tile, max_tris_per_tile=c["budget"], tri_attr=_t(c["attr"]))
    return port, ref


def run_plain(c):
    """(port rasterize, JAX rasterize) of one case."""
    ref = j_rasterize(_j(c["tv"]), _j(c["valid"]), _j(c["TCO"]), _j(c["K"]),
                      image_size=IMAGE, tri_attr=_j(c["attr"]))
    port = t_rasterize(_t(c["tv"]), _t(c["valid"]), _t(c["TCO"]), _t(c["K"]),
                       image_size=IMAGE, tri_attr=_t(c["attr"]))
    return port, ref


@pytest.mark.parametrize("tile", [(16, 16), (8, 32)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_binned_matches_pallas_interpret(name, tile):
    c = CASES[name]()
    port, ref = run_binned(c, tile)
    _compare(port, ref, c["attr"] is not None)
    assert port.mask.any()
    if c["attr"] is not None:
        assert set(np.unique(port.attr.numpy())) == {0.0, 1.0, 2.0}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_rasterize_matches_jax_rasterize(name):
    c = CASES[name]()
    port, ref = run_plain(c)
    _compare(port, ref, c["attr"] is not None)


def _sphere_case(B=3, lod=512):
    """Demo spheres at the LOD of the main path, seen through crop-like intrinsics."""
    ref_db = j_build_mesh_db([MeshSpec(**vars(s)) for s in demo.demo_specs()],
                             render_max_faces=lod)
    rng = np.random.RandomState(5)
    label_ids = np.arange(B) % 2
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, :2, 3] = rng.uniform(-0.01, 0.01, (B, 2))
    TCO[:, 2, 3] = rng.uniform(0.6, 0.9, B)
    return dict(tv=np.asarray(ref_db.tri_verts)[label_ids],
                colors=np.asarray(ref_db.tri_colors)[label_ids],
                valid=np.asarray(ref_db.tri_valid)[label_ids], TCO=TCO,
                K=make_K(B, fx=500, fy=500, cx=64, cy=24))


@pytest.mark.parametrize("budget", [1024, 40])
def test_budget_overflow_drops_the_same_chunks(budget):
    """At equal tiles, a budget below a tile's overlap (40 triangles = 5 chunks)
    drops the same highest sorted chunk ids as the Pallas path."""
    c = _sphere_case()
    image, tile = (48, 128), (24, 128)
    ref = rasterize_pallas(_j(c["tv"]), _j(c["valid"]), _j(c["TCO"]), _j(c["K"]),
                           image_size=image, colors=_j(c["colors"]), tile=tile,
                           max_tris_per_tile=budget, interpret=True)
    port = render(_t(c["tv"]), _t(c["valid"]), _t(c["TCO"]), _t(c["K"]), image_size=image,
                  colors=_t(c["colors"]), tile=tile, max_tris_per_tile=budget)
    _compare(port, ref, False)
    rows, ykey = rasterizer_cuda.setup_plain(_t(c["tv"]), _t(c["valid"]), _t(c["TCO"]),
                                             _t(c["K"]), image, _t(c["colors"]))
    _, _, counts = rasterizer_cuda.bin_chunks(rows, rasterizer_cuda.sort_order(ykey), image,
                                              tile, budget)
    assert (int(counts.max()) == budget // 8) == (budget == 40)


def test_tile_shape_does_not_change_the_image():
    """Within budget, the image is the same for every tile shape, to the bit."""
    c = _sphere_case()
    outs = [render(_t(c["tv"]), _t(c["valid"]), _t(c["TCO"]), _t(c["K"]), image_size=(48, 128),
                   tile=tile) for tile in [(16, 16), (8, 32), (32, 32), (20, 24)]]
    for o in outs[1:]:
        assert torch.equal(o.rgb, outs[0].rgb) and torch.equal(o.depth, outs[0].depth)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_first_k_true_is_ordered_compaction(k):
    rng = np.random.RandomState(k)
    ov = rng.uniform(size=(4, 5, 12)) < 0.4
    idx, counts = first_k_true(torch.as_tensor(ov), k)
    for b in range(4):
        for t in range(5):
            want = np.flatnonzero(ov[b, t])[:k]
            assert counts[b, t] == len(want)
            np.testing.assert_array_equal(idx[b, t, :len(want)].numpy(), want)


def test_resolve_refuses_other_devices():
    rows = torch.zeros(1, 8, rasterizer_cuda.ROW, device="meta")
    order = torch.zeros(1, 8, dtype=torch.long, device="meta")
    with pytest.raises(ValueError):
        rasterizer_cuda.resolve(rows, order, (8, 8), (8, 8))
    tv = torch.zeros(1, 8, 3, 3, device="meta")
    with pytest.raises(ValueError):
        rasterizer_cuda.setup(tv, torch.ones(1, 8, dtype=torch.bool, device="meta"),
                              torch.eye(4, device="meta")[None], torch.eye(3, device="meta")[None],
                              (8, 8))
    # the kernels' wrappers take CUDA tensors only: no silent CPU path
    with pytest.raises(ValueError):
        rasterizer_cuda.RASTER_KERNEL.resolve(torch.zeros(1, 8, rasterizer_cuda.ROW),
                                              torch.zeros(1, 8, dtype=torch.long), (8, 8), (8, 8))


def _screen_case(corners_uv, z, attr=None):
    """Triangles given by their pixel coordinates (B,F,3,2) and camera depths
    (B,F,3), under fx = fy = 1, cx = cy = 0 and TCO = I: with depths powers of
    2, the corners project exactly where they are given."""
    uv = np.asarray(corners_uv, np.float32)
    z = np.asarray(z, np.float32)
    tv = np.concatenate([uv * z[..., None], z[..., None]], -1)
    B, Fn = tv.shape[:2]
    K = np.tile(np.diag([1.0, 1.0, 1.0]).astype(np.float32), (B, 1, 1))
    return dict(tv=tv, valid=np.ones((B, Fn), bool), TCO=np.tile(np.eye(4, dtype=np.float32),
                                                                  (B, 1, 1)), K=K, colors=None)


def _slivers(image=(48, 80), B=2, n=96, seed=3):
    """Long thin triangles (third corner ~1e-3 px off the edge), sub-pixel
    triangles, and ordinary ones, at depths 0.5, 1, 2."""
    rng = np.random.RandomState(seed)
    H, W = image
    p = rng.uniform([0, 0], [W, H], (B, n, 2))
    q = rng.uniform([0, 0], [W, H], (B, n, 2))
    t = rng.uniform(0, 1, (B, n, 1))
    off = rng.normal(size=(B, n, 2)) * 1e-3
    sliver = np.stack([p, q, p + t * (q - p) + off], 2)
    tiny = p[..., None, :] + rng.uniform(-0.02, 0.02, (B, n, 3, 2))
    big = p[..., None, :] + rng.uniform(-8, 8, (B, n, 3, 2))
    uv = np.concatenate([sliver, tiny, big], 1)
    z = 2.0 ** rng.randint(-1, 2, uv.shape[:3])
    return _screen_case(uv, z)


def _pixel_centre_edges(image=(48, 80), B=2, n=128, seed=4):
    """Triangles whose corners sit on pixel centres, so their edges pass
    through pixel centres (axis-aligned, diagonal and arbitrary), at depths
    0.5 to 4 and tilted, overlapping one another."""
    rng = np.random.RandomState(seed)
    H, W = image
    base = rng.randint([0, 0], [W, H], (B, n, 1, 2))
    shape = rng.randint(-6, 7, (B, n, 3, 2))
    shape[:, : n // 2, 1] = shape[:, : n // 2, 0] + [5, 0]   # an axis-aligned edge
    shape[:, : n // 2, 2] = shape[:, : n // 2, 0] + [0, 5]
    uv = (base + shape).astype(np.float32) + 0.5
    z = 2.0 ** rng.randint(-1, 3, uv.shape[:3])
    return _screen_case(uv, z)


CULL_CASES = {"spheres": lambda: _sphere_case(), "slivers": _slivers,
              "pixel_centre_edges": _pixel_centre_edges}


@pytest.mark.parametrize("tile", [(8, 32), (16, 16), (16, 48)])
@pytest.mark.parametrize("name", sorted(CULL_CASES))
def test_cull_never_skips_a_winning_row(name, tile):
    """resolve_plain with each row masked per warp by row_may_cover (the rule
    the resolve kernel culls by) equals resolve_plain without it, to the bit.
    Tile (16, 48) is ragged on the 80-px-wide image."""
    c = CULL_CASES[name]()
    image = (48, 128) if name == "spheres" else (48, 80)
    rows, ykey = rasterizer_cuda.setup_plain(_t(c["tv"]), _t(c["valid"]), _t(c["TCO"]),
                                             _t(c["K"]), image, _t(c["colors"]))
    srt, idx, counts = rasterizer_cuda.bin_chunks(rows, rasterizer_cuda.sort_order(ykey), image,
                                                  tile, 1024)
    full = rasterizer_cuda.resolve_plain(srt, idx, counts, image, tile)
    culled = rasterizer_cuda.resolve_plain(srt, idx, counts, image, tile, cull=True)
    assert torch.equal(full[0], culled[0]) and torch.equal(full[1], culled[1])
    assert (full[1] > 0).any()
    # the rule does cull: most (listed row, warp) pairs are skipped
    _, *rect = rasterizer_cuda.warp_rects(image, tile)
    listed = torch.arange(idx.shape[2]) < counts[..., None].long()          # (B, T, Kc)
    row_ids = (idx.long()[..., None] * 8 + torch.arange(8)).flatten(2)       # (B, T, Kc*8)
    listed_rows = torch.gather(srt, 1, row_ids.flatten(1)[..., None].expand(-1, -1, 32))
    listed_rows = listed_rows.reshape(*row_ids.shape, 32)
    may = rasterizer_cuda.row_may_cover(listed_rows[:, :, :, None],
                                        *[r[None, :, None] for r in rect])  # (B, T, Kc*8, n_w)
    live = listed.repeat_interleave(8, -1)[..., None].expand_as(may)
    assert may[live].float().mean() < 0.5


def test_row_may_cover_is_tight_at_a_pixel():
    """On a one-pixel rectangle the rule keeps a row exactly where the pixel
    centre is inside (up to its slack) and in front of the camera."""
    c = _screen_case([[[[10.5, 10.5], [20.5, 10.5], [10.5, 20.5]]]], [[[1.0, 1.0, 1.0]]])
    rows, _ = rasterizer_cuda.setup_plain(_t(c["tv"]), _t(c["valid"]), _t(c["TCO"]), _t(c["K"]),
                                          (48, 80))
    row = rows[0, 0]
    for (x, y), inside in [((10.5, 10.5), True), ((15.5, 15.5), True), ((15.5, 15.6), False),
                           ((10.4, 12.5), False), ((30.5, 30.5), False)]:
        assert bool(rasterizer_cuda.row_may_cover(row, x, x, y, y)) == inside, (x, y)
    assert not bool(rasterizer_cuda.row_may_cover(rows[0, 1], 0.5, 79.5, 0.5, 47.5))  # padding


@pytest.mark.parametrize("name", ["spheres", "pixel_centre_edges"])
def test_setup_tolerance_covers_float32_rounding(name):
    """SETUP_TOL, the tolerance of the setup kernel, measured on what float32
    rounding alone does: on triangles of a pixel or more, setup_plain in
    float32 lies within an eighth of it from float64, while a lane moved by
    1e-3 of its value lies beyond it. (Sub-pixel slivers are ill-conditioned
    for any float32 formulation of the planes, ~600 u from float64, and are
    not what the tolerance is about: two float32 versions share their
    barycentric lanes there.)"""
    c = CULL_CASES[name]()
    args = [_t(c[k]) for k in ("tv", "valid", "TCO", "K")]
    rows, key = rasterizer_cuda.setup_plain(*args, (48, 80), _t(c["colors"]))
    exact = rasterizer_cuda.setup_plain(*[a.double() if a.is_floating_point() else a for a in args],
                                        (48, 80), None if c["colors"] is None
                                        else _t(c["colors"]).double())
    err = rasterizer_cuda.setup_error(rows, key, *exact, (48, 80))
    assert err["valid_differs"] == 0 and err["attr"] == 0
    assert err["plane"] <= rasterizer_cuda.SETUP_TOL / 8
    assert err["bbox_key"] <= rasterizer_cuda.SETUP_TOL / 8
    moved = rows.clone()
    moved[..., 9] *= 1 + 1e-3
    assert rasterizer_cuda.setup_error(moved, key, rows, key, (48, 80))["plane"] \
        > rasterizer_cuda.SETUP_TOL


@pytest.mark.parametrize("fx,cx", [(2000.0, -1500.0), (4000.0, -3000.0), (8000.0, -6000.0)])
def test_setup_tolerance_under_crop_intrinsics(fx, cx):
    """Crop intrinsics of a far-off pose put the principal point thousands of
    pixels outside the image, and u = fx·x/z + cx cancels two large terms:
    float32 then lies beyond SETUP_TOL of float64 on the bbox lanes when they
    are measured against the image size (measured: 5.9e-6 at cx = -6000),
    and within an eighth of it when measured against the terms (setup_error
    with K)."""
    c = _sphere_case()
    K = np.array(c["K"], np.float32)
    K[:, 0, 0] = K[:, 1, 1] = fx
    K[:, 0, 2], K[:, 1, 2] = cx, cx / 2
    TCO = c["TCO"].copy()
    TCO[:, 0, 3] = (64 - cx) / fx * TCO[:, 2, 3]   # the spheres stay in the image
    TCO[:, 1, 3] = (24 - cx / 2) / fx * TCO[:, 2, 3]
    args = [_t(a) for a in (c["tv"], c["valid"], TCO, K)]
    rows, key = rasterizer_cuda.setup_plain(*args, (48, 128), _t(c["colors"]))
    exact = rasterizer_cuda.setup_plain(*[a.double() if a.is_floating_point() else a
                                          for a in args], (48, 128), _t(c["colors"]).double())
    err = rasterizer_cuda.setup_error(rows, key, *exact, (48, 128), K=args[3])
    assert err["valid_differs"] == 0
    assert err["bbox_key"] <= rasterizer_cuda.SETUP_TOL / 8
    assert err["plane"] <= rasterizer_cuda.SETUP_TOL
    if cx == -6000.0:
        assert rasterizer_cuda.setup_error(rows, key, *exact, (48, 128))["bbox_key"] \
            > rasterizer_cuda.SETUP_TOL


def test_cover_box_holds_subpixel_triangles():
    """Sub-pixel triangles (edges 3e-5 to 1e-3 px, just above the degenerate
    area) have float32 planes whose inside tests pass at pixels far from their
    corners. Every such pixel lies in the row's cover box, which the resolve
    kernel culls by; a bbox widened by a pixel would miss some of them."""
    H, W = 240, 320
    rng = np.random.RandomState(0)
    n = 160
    p = rng.uniform([100, 80], [300, 220], (n, 1, 2))
    uv = p + rng.normal(size=(n, 3, 2)) * 10 ** rng.uniform(-4.5, -3, (n, 1, 1))
    c = _screen_case(uv[None], np.ones((1, n, 3)))
    rows, _ = rasterizer_cuda.setup_plain(_t(c["tv"]), _t(c["valid"]), _t(c["TCO"]), _t(c["K"]),
                                          (H, W))
    rows = rows[0, :n][rows[0, :n, rasterizer_cuda.LANE_VALID] != 0]
    px = torch.arange(W).float()[None, None, :] + 0.5
    py = torch.arange(H).float()[None, :, None] + 0.5
    inside = torch.ones(len(rows), H, W, dtype=torch.bool)
    for i in range(3):
        r = rows[:, None, None]
        inside &= r[..., i] * px + r[..., i + 3] * py + r[..., i + 6] >= -1e-6
    assert len(rows) > n // 2 and inside.any()

    def outside(box, margin):
        b = box[:, None, None]
        return ((px < b[..., 0] - margin) | (px > b[..., 2] + margin)
                | (py < b[..., 1] - margin) | (py > b[..., 3] + margin))

    lanes = rasterizer_cuda.LANE_COVER, rasterizer_cuda.LANE_BBOX
    assert not (inside & outside(rows[:, lanes[0]:lanes[0] + 4], 0)).any()
    assert (inside & outside(rows[:, lanes[1]:lanes[1] + 4], 1)).any()


def test_ablation_variants_match_the_kernel_source():
    """Each variant of the resolve kernel's ablation replaces text that the
    kernel source holds exactly once, so the ablation times what it names."""
    from cosypose_tpu_torch.ablate_resolve import VARIANTS

    source = nvcc_build.SOURCES["resolve"].read_text()
    for name, swap in VARIANTS.items():
        assert swap is None or source.count(swap[0]) == 1, name


# -- documented divergences (ROADMAP §3) ------------------------------------------

SPHERE_POSES_BEYOND = 76       # depth pixels beyond 1e-4 at 240x320, measured
GRAZING_F64_ERR = 1.5e-3       # either package's depth error there, vs float64
PIXEL_CENTRE_EDGE_PIXELS = 11  # mask pixels that differ from the Pallas path, measured


def _depth_f64(tv, TCO, K, b, y, x):
    """The nearest triangle's depth at pixel (y, x) of item b in float64:
    pixel centre (x + 0.5, y + 0.5), barycentric 1/z interpolation."""
    T, Kb = np.asarray(TCO[b], np.float64), np.asarray(K[b], np.float64)
    pc = np.asarray(tv[b], np.float64) @ T[:3, :3].T + T[:3, 3]
    z = pc[..., 2]
    uv = (pc @ Kb.T)[..., :2] / z[..., None]
    a, b_, c = uv[:, 0], uv[:, 1], uv[:, 2]
    px, py = x + 0.5, y + 0.5

    def edge(p, q):
        return (q[:, 0] - p[:, 0]) * (py - p[:, 1]) - (q[:, 1] - p[:, 1]) * (px - p[:, 0])

    area = (b_[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b_[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    w = [edge(b_, c) / area, edge(c, a) / area, edge(a, b_) / area]
    inside = (w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0) & (z > 0).all(1)
    iz = w[0] / z[:, 0] + w[1] / z[:, 1] + w[2] / z[:, 2]
    return np.where(inside, 1.0 / iz, np.inf).min()


def test_spheres_at_240x320_depth_divergence_is_documented():
    """The demo spheres (LOD 512) at 16 random poses, 240x320, against JAX
    `rasterize` (which agrees with the interpret-mode Pallas path here):
    masks equal, depth within 1e-4 except at most the measured count of
    pixels. There both packages sit on grazing planes, where float32 rounds
    the depth by up to ~1e-3 m: each lies within GRAZING_F64_ERR of a float64
    render (measured: port 1.37e-3, JAX 1.26e-3; neither is closer at every
    pixel, the port at 20 of 76)."""
    db = j_build_mesh_db([MeshSpec(**vars(s)) for s in demo.demo_specs()], render_max_faces=512)
    rng = np.random.RandomState(0)
    B = 16
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        Q[:, 0] *= np.sign(np.linalg.det(Q))
        TCO[b, :3, :3] = Q
        TCO[b, :3, 3] = [rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02),
                         rng.uniform(0.5, 0.8)]
    labels = np.arange(B) % 2
    tv, valid = np.asarray(db.tri_verts)[labels], np.asarray(db.tri_valid)[labels]
    K = make_K(B, fx=400, fy=400, cx=160, cy=120)
    ref = j_rasterize(_j(tv), _j(valid), _j(TCO), _j(K), image_size=(240, 320))
    port = render(_t(tv), _t(valid), _t(TCO), _t(K), image_size=(240, 320), tile=(24, 320),
                  max_tris_per_tile=768)
    mask = np.asarray(ref.mask)
    np.testing.assert_array_equal(port.mask.numpy(), mask)
    dp, dr = port.depth.numpy(), np.asarray(ref.depth)
    beyond = (np.abs(dp - dr) > ATOL) & mask
    assert 0 < beyond.sum() <= SPHERE_POSES_BEYOND
    d64 = np.array([_depth_f64(tv, TCO, K, b, y, x) for b, y, x in np.argwhere(beyond)])
    assert np.abs(dp[beyond] - d64).max() <= GRAZING_F64_ERR
    assert np.abs(dr[beyond] - d64).max() <= GRAZING_F64_ERR


def test_pixel_centre_edges_divergence_is_documented():
    """Edges through pixel centres against rasterize_pallas(interpret=True):
    XLA evaluates a plane as fma(a, x, b·y) + c, the port rounds each op
    (its kernel's contract), and the inside test's 1e-6 margin lies below
    either rounding; so the measured count of mask pixels differ."""
    c = _pixel_centre_edges()
    ref = rasterize_pallas(_j(c["tv"]), _j(c["valid"]), _j(c["TCO"]), _j(c["K"]),
                           image_size=IMAGE, interpret=True)
    port = render(_t(c["tv"]), _t(c["valid"]), _t(c["TCO"]), _t(c["K"]), image_size=IMAGE)
    differ = int((port.mask.numpy() != np.asarray(ref.mask)).sum())
    assert 0 < differ <= PIXEL_CENTRE_EDGE_PIXELS
    assert np.asarray(ref.mask).sum() == 3324


def _kernel_a_validity(tv_obj, tri_valid, TCO, K, z_near=0.05):
    """Kernel A's corners, projection and validity (csrc/raster_setup.cu),
    emulated in numpy float32, one rounding an op in the kernel's order."""
    f32 = np.float32
    T, v = TCO.astype(f32), tv_obj.astype(f32)
    p = [((T[:, None, None, i, 0] * v[..., 0] + T[:, None, None, i, 1] * v[..., 1])
          + T[:, None, None, i, 2] * v[..., 2]) + T[:, None, None, i, 3] for i in range(3)]
    fx, cx, fy, cy = (K[:, None, None, r, c].astype(f32) for r, c in ((0, 0), (0, 2), (1, 1), (1, 2)))
    zs = np.maximum(p[2], f32(z_near))
    u, w = fx * p[0] / zs + cx, fy * p[1] / zs + cy
    area2 = (u[..., 1] - u[..., 0]) * (w[..., 2] - w[..., 0]) \
        - (u[..., 2] - u[..., 0]) * (w[..., 1] - w[..., 0])
    return np.stack(p, -1), tri_valid & ~(p[2] < f32(z_near)).any(-1) & ~(np.abs(area2) < f32(1e-9))


def test_setup_plain_rounds_corners_as_kernel_a():
    """The plain setup's camera-frame corners equal kernel A's bit for bit, so
    both decide alike on triangles that are degenerate up to rounding: pole
    triangles whose corners lie a few nm apart, which project to equal or to
    one-ulp-apart floats depending on the order of the corner sums."""
    from cosypose_tpu_torch.ops.rasterizer import camera_corners

    tv, valid, TCO, K = sliver_inputs()
    F = tv.shape[1]
    corners, want = _kernel_a_validity(tv, valid, TCO, K)
    got = camera_corners(torch.as_tensor(tv), torch.as_tensor(TCO)).numpy()
    assert np.array_equal(got, corners)
    rows, _ = rasterizer_cuda.setup_plain(torch.as_tensor(tv), torch.as_tensor(valid),
                                          torch.as_tensor(TCO), torch.as_tensor(K), (240, 320))
    is_valid = rows[:, :F, rasterizer_cuda.LANE_VALID].numpy() != 0
    assert np.array_equal(is_valid, want)
    pole_rows = want[:, :F // 2]
    assert pole_rows.any() and not pole_rows.all()   # both decisions occur among the poles
