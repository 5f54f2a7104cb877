"""Port parity: mesh IO, symmetries, the mesh database and gather_mesh_data.

All of it is host-side numpy followed by a device upload, so the port must
give exactly the JAX package's arrays (tolerance 0), including the random
padding, the decimated render geometry and the crop-point ids.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosypose_tpu.models.pose_predictor import gather_mesh_data as j_gather
from cosypose_tpu.ops import mesh_db as jdb
from cosypose_tpu.ops import mesh_io as jio
from cosypose_tpu.ops.symmetries import make_bop_symmetries as j_syms
from cosypose_tpu_torch import demo
from cosypose_tpu_torch.models.pose_predictor import gather_mesh_data as t_gather
from cosypose_tpu_torch.ops import mesh_db as tdb
from cosypose_tpu_torch.ops import mesh_io as tio
from cosypose_tpu_torch.ops.symmetries import make_bop_symmetries as t_syms

FIELDS = ("points", "valid", "symmetries", "sym_valid", "tri_verts", "tri_colors", "tri_valid")


def specs(kind, module):
    """The demo spheres, or a cube + small sphere + coloured sphere mix with
    unequal vertex, face and symmetry counts (exercises every padding path)."""
    verts, faces = demo.sphere_mesh()
    if kind == "demo":
        return [module.MeshSpec(label=s.label, vertices=s.vertices, faces=s.faces,
                                symmetries_continuous=s.symmetries_continuous)
                for s in demo.demo_specs()]
    sv, sf = demo.sphere_mesh(n_theta=6, n_phi=8)
    cube = np.array([[x, y, z] for x in (-50, 50) for y in (-50, 50) for z in (-50, 50)], float)
    cube_f = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
                       (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)])
    colors = np.random.RandomState(3).uniform(size=(verts.shape[0], 3))
    flip = [1, 0, 0, 0, 0, -1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1]
    return [
        module.MeshSpec(label="cube", vertices=cube, faces=cube_f, symmetries_discrete=[flip]),
        module.MeshSpec(label="small", vertices=sv * 1000.0, faces=sf),
        module.MeshSpec(label="coloured", vertices=verts * 1000.0, faces=faces, colors=colors,
                        symmetries_continuous=[{"axis": [0, 1, 0], "offset": [0, 0, 0]}]),
    ]


@pytest.mark.parametrize("kind", ["demo", "mixed"])
@pytest.mark.parametrize("render_max_faces", [None, 512])
def test_build_mesh_db_matches(kind, render_max_faces):
    ref = jdb.build_mesh_db(specs(kind, jdb), render_max_faces=render_max_faces)
    port = tdb.build_mesh_db(specs(kind, tdb), render_max_faces=render_max_faces, device="cpu")
    assert port.labels == ref.labels
    assert port.infos == ref.infos
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    if render_max_faces is not None and kind == "demo":
        assert 0 < int(port.tri_valid.sum(1).max()) <= render_max_faces


@pytest.mark.parametrize("n_points", [8, 2000])
def test_gather_mesh_data_and_sample_points(n_points):
    ref_db = jdb.build_mesh_db(specs("mixed", jdb), render_max_faces=512)
    port_db = tdb.build_mesh_db(specs("mixed", tdb), render_max_faces=512, device="cpu")
    label_ids = np.array([2, 0, 1, 2, 2, 0])
    ref = j_gather(ref_db, jnp.asarray(label_ids), n_points)
    port = t_gather(port_db, torch.as_tensor(label_ids), n_points)
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(
        port_db.sample_points(torch.as_tensor(label_ids), n_points).numpy(),
        np.asarray(ref_db.sample_points(jnp.asarray(label_ids), n_points)))
    np.testing.assert_array_equal(port_db.ids_for(["coloured", "cube"]).numpy(), [2, 0])


def test_symmetries_match():
    d = {"symmetries_discrete": [[0, -1, 0, 10, 1, 0, 0, 0, 0, 0, 1, 5, 0, 0, 0, 1]],
         "symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]}
    np.testing.assert_array_equal(t_syms(d, 16), j_syms(d, 16))


def test_ply_roundtrip_and_decimation(tmp_path):
    verts, faces = demo.sphere_mesh()
    colors = np.random.RandomState(4).uniform(size=verts.shape)
    path = tmp_path / "sphere.ply"
    jio.save_ply(path, verts, faces, colors)
    for a, b in zip(tio.load_mesh(str(path), with_colors=True),
                    jio.load_mesh(str(path), with_colors=True)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tio.decimate_mesh(verts, faces, colors, 300),
                    jio.decimate_mesh(verts, faces, colors, 300)):
        np.testing.assert_array_equal(a, b)
