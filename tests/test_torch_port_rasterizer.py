"""Port parity: the binned rasterizer (prologue + the kernel's plain version)
against JAX `rasterize_pallas(interpret=True)`, and the port's plain
`rasterize` against JAX `rasterize`.

Cases are those of tests/test_rasterizer_pallas.py plus a budget-overflow
case and the demo spheres. Tolerances: rgb and depth atol 1e-4; mask and
attribute exactly equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.ops.rasterizer import rasterize as j_rasterize
from cosypose_tpu.ops.rasterizer_pallas import rasterize_pallas
from cosypose_tpu_torch import demo
from cosypose_tpu_torch.ops import rasterizer_cuda
from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
from cosypose_tpu_torch.ops.rasterizer import first_k_true
from cosypose_tpu_torch.ops.rasterizer import rasterize as t_rasterize
from cosypose_tpu_torch.ops.render import render
from tests.test_rasterizer import cube_mesh, make_K

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
    _, _, counts = rasterizer_cuda.prepare(_t(c["tv"]), _t(c["valid"]), _t(c["TCO"]),
                                           _t(c["K"]), image, tile=tile, max_tris_per_tile=budget)
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
    coef = torch.zeros(1, 8, 24, device="meta")
    with pytest.raises(ValueError):
        rasterizer_cuda.resolve(coef, torch.zeros(1, 1, 1, dtype=torch.int32, device="meta"),
                                torch.zeros(1, 1, dtype=torch.int32, device="meta"),
                                (8, 8), (8, 8))
