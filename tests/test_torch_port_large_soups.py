"""Port parity: scene soups above both raster kernels' shared-memory sizes, on
the CPU.

Kernel A sorts an item of more rows than one block holds (16,384 on an H100)
with a cluster of blocks or in sorted runs that a merge kernel merges pass by
pass; above one window of shared memory (10,560 rows) kernel B bins each
item's chunks once in a launch of its own and resolves each tile's list. The
card runs them (tests/test_torch_port_gpu.py); here:
  1. the port's SceneRenderer against the JAX package's on a soup of 24,936
     rows (three closed meshes of 8,192 faces, demo.dense_specs, and the
     cage), both on the CPU as tests/test_torch_port_recording.py runs them,
     at cameras where no tile reaches its budget at either package's tile
     (asserted, as test_scene_budget_is_not_reached does); and the port's
     binned render of a soup above one window, every tile's list cut at its
     budget, against rasterize_pallas(interpret=True);
  2. PyTorch models of the kernels' bookkeeping against the whole-list
     functions, on inputs drawn by hypothesis: rank_runs (the clusters'
     ranking of composites across sorted slices of uneven length) and
     merge_runs (the runs merged in pairs, each output tile between two
     co_rank splits) against sort_composite_keys, torch.sort(stable=True)
     and the JAX package's jnp.argsort, co_rank against its definition, and
     bin_chunks_segmented (the binning launch's counts by segment, listed
     from each segment's place) against bin_chunks, at budgets below and
     above the listed count;
  3. the registered operators' fake implementations and the wrappers'
     checks at 262,144 rows an item, and the refusal of a tile that is not
     whole warps.

Tolerances in 1: instance ids and masks equal, rgb within 1/255 and depth
within 1 mm (the recording test's) at all but MAX_EDGE_PIXELS pixels. The
JAX package moves the corners with XLA's dot and the port in the kernel's
order ((r0 v0 + r1 v1) + r2 v2) + t, so about a tenth of these rows' corners
differ in their last bit; on triangles under a pixel wide the inside tests'
rounding then exceeds their 1e-6 slack, and a pixel centre on an edge shared
by two such triangles can fall in neither in one package and show the
surface behind, another instance's or the background where the edge is a
silhouette (39 pixels of 27,648 at these cameras; none on the recording
test's large triangles). The binned render above one window is held to rasterize_pallas at the
rasterizer tests' tolerances (masks and attributes equal, rgb and depth
within 1e-4): its triangles are in the camera frame (TCO the identity), so
both packages' corners, keys and sort are exact, and wider than a pixel.
Everything in 2 and 3 is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cosypose_tpu.ops.mesh_db import MeshSpec as JMeshSpec
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.ops.rasterizer_pallas import rasterize_pallas
from cosypose_tpu.rendering import SceneRenderer as JSceneRenderer
from cosypose_tpu_torch import demo
from cosypose_tpu_torch.ops import rasterizer_cuda as rc
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.ops.render import render
from cosypose_tpu_torch.ops.transforms import invert_T
from cosypose_tpu_torch.recording import RecordingSceneSampler
from cosypose_tpu_torch.rendering import SceneRenderer
from cosypose_tpu_torch.rendering.scene_renderer import SCENE_BUDGET, SCENE_TILE
from tests.test_torch_port_gpu import tie_soup

RES = (144, 96)
FOCAL, DISTANCE, SPACING = 500.0, 0.7, 0.085  # px; camera and object spacing in m
JAX_CPU_TILE = (24, 64)  # cosypose_tpu/ops/render.py's XLA tile, fitted to the image
MAX_EDGE_PIXELS = 69  # 0.25 % of the 2 x 144 x 96 pixels (39 at these cameras)
INF, NAN = float("inf"), float("nan")
SPECIAL = [0.0, -0.0, INF, -INF, NAN, 1e-40, -1e-40, 1.0, -1.0, 12.5, -3.25, 3.4e38]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The fast tier runs several test processes side by side on the CPU's
    cores; PyTorch's own thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rotation(angles):
    """Rotation matrix of x, y, z angles (rad), applied in that order."""
    out = np.eye(3)
    for axis, a in enumerate(angles):
        c, s = np.cos(a), np.sin(a)
        i, j = [k for k in range(3) if k != axis]
        r = np.eye(3)
        r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
        out = r @ out
    return out


def dense_scene(db, seed=0):
    """Three dense objects stacked along the first camera's image y axis, the
    cage (p_cage 1), and two cameras 0.7 m away looking at the stack:
    (obj_infos, cam_infos) as both SceneRenderers take them."""
    rng = np.random.RandomState(seed)
    cage = RecordingSceneSampler(db, resolution=RES, p_cage=1.0)._cage_geometry(rng)
    target = np.array([0.0, 0.0, 0.08])
    cams = []
    for phi in (0.3, 0.5):
        eye = target + DISTANCE * np.array([np.sin(0.5) * np.cos(phi),
                                            np.sin(0.5) * np.sin(phi), np.cos(0.5)])
        zc = (target - eye) / np.linalg.norm(target - eye)
        xc = np.cross(zc, [0.0, 0.0, 1.0])
        xc /= np.linalg.norm(xc)
        TWC = np.eye(4, dtype=np.float32)
        TWC[:3, 0], TWC[:3, 1], TWC[:3, 2], TWC[:3, 3] = xc, np.cross(zc, xc), zc, eye
        K = np.array([[FOCAL, 0, RES[1] / 2], [0, FOCAL, RES[0] / 2], [0, 0, 1]], np.float32)
        cams.append(dict(K=K, TWC=TWC, resolution=RES))
    objs = []
    for i, k in enumerate((-1, 0, 1)):
        TWO = np.eye(4, dtype=np.float32)
        TWO[:3, :3] = rotation(rng.uniform(0, 2 * np.pi, 3))
        TWO[:3, 3] = target + k * SPACING * cams[0]["TWC"][:3, 1]
        objs.append(dict(label=db.labels[i], TWO=TWO))
    return objs + cage, cams


@pytest.fixture(scope="module")
def dense_dbs():
    specs = demo.dense_specs(3)
    return (j_build_mesh_db([JMeshSpec(**dataclasses.asdict(s)) for s in specs]),
            build_mesh_db(specs, device="cpu"))


def test_dense_specs_have_8192_faces(dense_dbs):
    """build_mesh_db's default max_faces (8,192) keeps the meshes whole, in
    both packages."""
    for spec in demo.dense_specs(3):
        assert spec.faces.shape == (8192, 3)
    jdb, tdb = dense_dbs
    assert tuple(tdb.tri_verts.shape) == (3, 8192, 3, 3)
    np.testing.assert_array_equal(np.asarray(jdb.tri_verts), tdb.tri_verts.numpy())


def test_dense_scene_budget_is_not_reached(dense_dbs):
    """No tile lists as many chunks as the port's budget allows at its tile
    (8, 320), nor as many triangles as the JAX package's at its CPU tile, so
    the two rasterizers see every triangle at every pixel."""
    tdb = dense_dbs[1]
    scene, cams = dense_scene(tdb)
    tv, valid, colors, ids = SceneRenderer(tdb).soup(scene)
    assert tv.shape[0] == 3 * 8192 + 5 * 72 > 16_384
    n = len(cams)
    bc = lambda x: torch.as_tensor(x)[None].expand(n, *x.shape)  # noqa: E731
    TCW = invert_T(torch.as_tensor(np.stack([c["TWC"] for c in cams])))
    K = torch.as_tensor(np.stack([c["K"] for c in cams]))
    rows, key = rc.setup_plain(bc(tv), bc(valid), TCW, K, RES, bc(colors))
    budget = min(tv.shape[0], SCENE_BUDGET)
    counts = rc.bin_chunks(rows, rc.sort_order(key), RES, SCENE_TILE, 1 << 30)[2]
    assert 0 < int(counts.max()) < rc.chunk_budget(budget, rows.shape[1])
    th, tw = (next(t for t in range(tile, 0, -1) if size % t == 0)
              for size, tile in zip(RES, JAX_CPU_TILE))  # the JAX rasterizer's fit()
    box, ok = rows[..., rc.LANE_BBOX:rc.LANE_BBOX + 4], rows[..., rc.LANE_VALID] != 0
    most = max(int(((box[..., 0] <= x + tw) & (box[..., 2] >= x) & (box[..., 1] <= y + th)
                    & (box[..., 3] >= y) & ok).sum(1).max())
               for y in range(0, RES[0], th) for x in range(0, RES[1], tw))
    assert 0 < most < budget


def test_scene_renderer_matches_jax_above_16384_rows(dense_dbs):
    jdb, tdb = dense_dbs
    scene, cams = dense_scene(tdb)
    ref = JSceneRenderer(jdb).render_scene(scene, cams, render_depth=True)
    before = dict(rc.RASTER_KERNEL.launches)
    out = SceneRenderer(tdb).render_scene(scene, cams, render_depth=True, resolution=RES)
    assert rc.RASTER_KERNEL.launches == before  # CPU tensors: the plain versions
    off = 0
    for r, o in zip(ref, out):
        assert set(np.unique(o["instance_ids"]).tolist()) == {0, 1, 2, 3}
        off += int(((r["instance_ids"] != o["instance_ids"]) | (r["mask"] != o["mask"])
                    | (np.abs(r["rgb"] - o["rgb"]).max(-1) > 1 / 255 + 1e-6)
                    | (np.abs(r["depth"] - o["depth"]) > 1e-3 + 1e-6)).sum())
    print(f"pixels beyond the tolerances: {off} of {2 * RES[0] * RES[1]}")
    assert off <= MAX_EDGE_PIXELS, off


@settings(max_examples=100, deadline=None, database=None)
@given(st.integers(1, 3), st.integers(1, 90), st.integers(1, 12), st.data())
def test_rank_runs_orders_as_torch_sort(B, Fp, n_runs, data):
    """Kernel A's ranking of composites across sorted runs of uneven length
    (clusters in shared memory, the rank kernel in device memory) against
    the whole-list sort: keys from the special values (ties, +-0.0, +-inf,
    NaN of either sign, denormals) and all finite floats."""
    keys = torch.tensor(data.draw(st.lists(
        st.lists(st.one_of(st.sampled_from(SPECIAL), st.floats(width=32, allow_nan=False)),
                 min_size=Fp, max_size=Fp), min_size=B, max_size=B)), dtype=torch.float32)
    if data.draw(st.booleans()):
        keys[:, Fp // 2:] = keys[:, :Fp - Fp // 2].clone()   # repeated keys: ties across runs
    if data.draw(st.booleans()):
        keys[0, 0] = torch.tensor(-4194304, dtype=torch.int32).view(torch.float32)  # -NaN
    order = rc.rank_runs(keys, -(-Fp // n_runs))  # the last run the shortest
    assert torch.equal(order, rc.sort_composite_keys(keys))
    if not torch.isnan(keys).any():  # on the CPU torch.sort puts every NaN last
        assert torch.equal(order, torch.sort(keys, dim=1, stable=True).indices)


def drawn_keys(data, B, Fp, special):
    """(B, Fp) float32 keys drawn from `special` and from all finite floats,
    the second half of each row repeating the first at will (ties across
    runs)."""
    keys = torch.tensor(data.draw(st.lists(
        st.lists(st.one_of(st.sampled_from(special), st.floats(width=32, allow_nan=False)),
                 min_size=Fp, max_size=Fp), min_size=B, max_size=B)), dtype=torch.float32)
    if data.draw(st.booleans()):
        keys[:, Fp // 2:] = keys[:, :Fp - Fp // 2].clone()
    return keys


@settings(max_examples=100, deadline=None, database=None)
@given(st.integers(1, 3), st.integers(1, 90), st.integers(1, 40), st.integers(1, 24), st.data())
def test_merge_runs_orders_as_torch_sort(B, Fp, run_rows, tile, data):
    """Regime 3's order (sorted runs merged pass by pass, each output tile
    between two co_rank splits) against the whole-list sort: runs of 1 row
    to longer than the item, the last one short, output tiles of 1 row (a
    thread's split) and more; keys from the special values (ties, +-0.0,
    +-inf, NaN of either sign, denormals) and all finite floats."""
    keys = drawn_keys(data, B, Fp, SPECIAL)
    if data.draw(st.booleans()):
        keys[0, 0] = torch.tensor(-4194304, dtype=torch.int32).view(torch.float32)  # -NaN
    order = rc.merge_runs(keys, run_rows, tile)
    assert torch.equal(order, rc.sort_composite_keys(keys))
    if not torch.isnan(keys).any():  # on the CPU torch.sort puts every NaN last
        assert torch.equal(order, torch.sort(keys, dim=1, stable=True).indices)


@settings(max_examples=100, deadline=None, database=None)
@given(st.integers(1, 3), st.integers(1, 90), st.integers(1, 40), st.data())
def test_merge_runs_orders_as_jax_argsort(B, Fp, run_rows, data):
    """The same against the JAX package's argsort (rasterizer_pallas.py:200):
    ties, +-0.0, +-inf and positive NaN, exactly (the two orders part only on
    denormal keys, tests/test_torch_port_setup_order.py)."""
    keys = drawn_keys(data, B, Fp, [0.0, -0.0, INF, -INF, NAN, 1.0, -1.0, 12.5, -3.25, 3.4e38])
    keys = torch.where(keys.abs() < 1.2e-38, torch.zeros_like(keys), keys)  # no denormals
    want = np.asarray(jnp.argsort(jnp.asarray(keys.numpy()), axis=1, stable=True))
    np.testing.assert_array_equal(rc.merge_runs(keys, run_rows).numpy(), want)


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.integers(-50, 50), max_size=40, unique=True), st.data())
def test_co_rank_splits_the_merge(values, data):
    """co_rank(a, b, d) is how many of the d smallest of a and b come from
    a, for every split of distinct values into two sorted lists and every d."""
    picks = data.draw(st.lists(st.booleans(), min_size=len(values), max_size=len(values)))
    a = torch.tensor(sorted(v for v, p in zip(values, picks) if p), dtype=torch.int64)
    b = torch.tensor(sorted(v for v, p in zip(values, picks) if not p), dtype=torch.int64)
    merged = sorted(values)
    for d in range(len(values) + 1):
        assert rc.co_rank(a, b, d) == sum(v in set(a.tolist()) for v in merged[:d])


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 3), st.integers(2, 60), st.integers(0, 2 ** 31 - 1),
       st.sampled_from([(8, 32), (16, 16), (8, 64), (32, 32)]), st.data())
def test_segmented_binning_equals_bin_chunks(B, F, seed, tile, data):
    """Kernel B's binning launch, each tile's chunks counted by segment and
    listed from the segment's place, against bin_chunks over the whole list:
    segments from one chunk to the whole item, budgets from one chunk to
    above every tile's count."""
    image = (48, 64)
    args = tie_soup(B, 8 * F, seed=seed % 100_000, image=image)
    rows, key = rc.setup_plain(*args[:4], image, args[4])
    order = rc.sort_order(key)
    want = rc.bin_chunks(rows, order, image, tile, 1 << 30)
    listed = int(want[2].max())
    segment = data.draw(st.integers(1, F))
    for budget in {8, 8 * max(1, listed // 2), 8 * listed + 8, 8 * F + 8}:
        a = rc.bin_chunks(rows, order, image, tile, budget)
        b = rc.bin_chunks_segmented(rows, order, image, tile, budget, segment)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), (segment, budget)


def wide_soup(F, image, seed=0):
    """F triangles of 3-12 px in the camera frame (TCO the identity) over an
    image, at depths 0.5-1 m, a tenth invalid, with attributes 1-8:
    (tri_verts, tri_valid, TCO, K, colors, attr) as numpy arrays."""
    H, W = image
    rng = np.random.RandomState(seed)
    f = 100.0
    centre = np.stack([rng.uniform(0, W, F), rng.uniform(0, H, F)], -1)[:, None]
    uv = centre + rng.uniform(-6, 6, (F, 3, 2))
    z = np.repeat(rng.uniform(0.5, 1.0, (F, 1, 1)), 3, 1) + rng.uniform(-0.02, 0.02, (F, 3, 1))
    tv = np.concatenate([(uv - np.array([W / 2, H / 2])) * z / f, z], -1)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    out = (tv[None], rng.uniform(size=(1, F)) > 0.1, np.eye(4)[None], K[None],
           rng.uniform(0, 1, (1, F, 3, 3)), rng.randint(1, 9, (1, F)).astype(np.float64))
    return tuple(a.astype(np.float32) if a.dtype != bool else a for a in out)


def test_binned_render_above_one_window_matches_pallas():
    """A soup of 11,000 rows (above one window of kernel B, 10,560) on a
    32x128 image, every tile's list cut at its budget of 40 chunks: the
    port's render (bin_chunks and resolve_plain, kernel B's function) against
    the JAX package's rasterize_pallas(interpret=True) at the same tile
    (8, 128) and budget, with the attribute."""
    image, tile, budget = (32, 128), (8, 128), 320
    tv, valid, TCO, K, colors, attr = wide_soup(11_000, image)
    ref = rasterize_pallas(*(jnp.asarray(a) for a in (tv, valid, TCO, K)), image_size=image,
                           colors=jnp.asarray(colors), tile=tile, max_tris_per_tile=budget,
                           interpret=True, tri_attr=jnp.asarray(attr))
    t = [torch.as_tensor(a) for a in (tv, valid, TCO, K, colors, attr)]
    rows, key = rc.setup_plain(*t[:4], image, t[4], tri_attr=t[5])
    counts = rc.bin_chunks(rows, rc.sort_order(key), image, tile, 1 << 30)[2]
    assert rows.shape[1] > 10_560 and bool((counts > budget // 8).all())  # every list cut
    port = render(*t[:4], image_size=image, colors=t[4], tile=tile, max_tris_per_tile=budget,
                  tri_attr=t[5])
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(port.attr.numpy(), np.asarray(ref.attr))
    np.testing.assert_allclose(port.depth.numpy(), np.asarray(ref.depth), atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.rgb.numpy(), np.asarray(ref.rgb), atol=1e-4, rtol=0)
    assert float(port.mask.float().mean()) > 0.05 and len(np.unique(ref.attr)) == 9


def test_fakes_and_checks_take_262144_rows():
    """The registered operators' fake implementations give the output shapes
    of two items of 262,144 rows, and the wrappers' checks take them: no row
    count is refused anywhere before a launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    B, Fp, image, tile = 2, 262_144, (480, 640), (8, 320)
    with FakeTensorMode():
        tv = torch.empty(B, Fp, 3, 3)
        valid = torch.empty(B, Fp, dtype=torch.bool)
        TCO, K = torch.empty(B, 4, 4), torch.empty(B, 3, 3)
        rows, key, order = rc.raster_setup_op(tv, valid, TCO, K, list(image), None, 0.05,
                                              torch.empty(B, Fp))
        rgb, depth, attr = rc.raster_resolve_op(rows, order, list(image), list(tile),
                                                SCENE_BUDGET, True)
    assert [tuple(x.shape) for x in (rows, key, order)] == [(B, Fp, rc.ROW), (B, Fp), (B, Fp)]
    assert order.dtype == torch.int64
    assert [tuple(x.shape) for x in (rgb, depth, attr)] == [(B, 3, *image), (B, *image),
                                                            (B, *image)]
    meta = dict(device="meta")
    assert rc.check_setup_args(torch.empty(B, Fp - 3, 3, 3, **meta),
                               torch.empty(B, Fp - 3, dtype=torch.bool, **meta),
                               torch.empty(B, 4, 4, **meta), torch.empty(B, 3, 3, **meta),
                               torch.empty(B, Fp - 3, 3, 3, **meta)) == Fp
    rows_m = torch.empty(B, Fp, rc.ROW, **meta)
    order_m = torch.empty(B, Fp, dtype=torch.int64, **meta)
    rc.check_resolve_args(rows_m, order_m, tile)
    for bad in [(4, 8), (8, 12), (0, 64)]:  # not whole warps of 64 pixels
        with pytest.raises(ValueError, match="multiple of 64"):
            rc.check_resolve_args(rows_m, order_m, bad)
    with pytest.raises(ValueError, match="whole chunks"):
        rc.check_resolve_args(torch.empty(B, Fp + 4, rc.ROW, **meta),
                              torch.empty(B, Fp + 4, dtype=torch.int64, **meta), tile)


def test_compare_raster_kernels_needs_a_card():
    """The tool that times both kernels for several checkouts exits 2 and
    times nothing without a card."""
    import subprocess
    import sys

    run = subprocess.run([sys.executable, "-m", "cosypose_tpu_torch.scripts.compare_raster_kernels",
                          "."], capture_output=True, text=True, timeout=300)
    assert run.returncode == 2 and "no CUDA card" in run.stderr and not run.stdout
