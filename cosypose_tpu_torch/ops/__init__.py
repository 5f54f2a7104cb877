"""Batched 3D math, cropping, losses, the mesh database and the rasterizer
(port of cosypose_tpu/ops/), with the JAX package's subpackage-level names.

`render` and `roi_align` are bound as functions here, so they shadow their
submodules as attributes of this package (as in the JAX package): reach the
modules with `from cosypose_tpu_torch.ops.roi_align import ...`. Left out:
`rasterize_pallas`, whose work the CUDA kernels of `rasterizer_cuda` do
(`setup` and `resolve`, called by `render`)."""

from .transforms import (
    transform_pts,
    invert_T,
    rot6d_to_matrix,
    quat_to_matrix,
    euler_to_matrix,
    pose9d_to_T,
    T_to_pose9d,
    add_pose_noise,
)
from .camera import (
    project_points,
    project_points_robust,
    boxes_from_uv,
    get_K_crop_resize,
)
from .pose_ops import (
    apply_imagespace_predictions,
    TCO_init_from_boxes,
    TCO_init_from_boxes_zup_autodepth,
)
from .cropping import deepim_boxes, deepim_crops
from .roi_align import roi_align
from .losses import (
    loss_CO_symmetric,
    loss_refiner_CO_disentangled,
    loss_refiner_aux_regression,
    compute_ADD_L1_loss,
    compute_ADDS_loss,
)
from .symmetric import (
    symmetric_distance_batched_fast,
    mesh_points_dist,
    reprojected_dist,
    symmetric_distance_reprojected,
    chamfer_dist,
)
from .mesh_ops import get_meshes_bounding_boxes, sample_points
from .rasterizer import rasterize, RenderOutput
from .render import render
from .mesh_db import MeshSpec, BatchedMeshes, build_mesh_db
from .transform import Transform
