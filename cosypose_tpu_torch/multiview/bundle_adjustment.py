"""Stage 3: object-level bundle adjustment by Levenberg–Marquardt (port of
cosypose_tpu/multiview/bundle_adjustment.py).

Object and camera poses are 9D (rot6d + t). At every evaluation each
candidate's observed pose is aligned to the current model over its
symmetries; residuals are the reprojected points' pixel errors, clamped
squared at 25; LM damps ÷9 on accept and ×11 on reject. The jacobian is one
torch.func.jacfwd of the residual vector (D = 9·(objects + views) inputs is
far below R = 2·points·candidates outputs), the pseudo-inverse solve stays on
the device, and the loop is a Python loop that reads its stop flag on the
host each iteration and stops where the JAX package's while_loop stops. The
initialization is the JAX package's host BFS over the view graph.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from ..ops.symmetric import _matmul, _project, symmetric_distance_reprojected
from ..ops.transforms import T_to_pose9d, invert_T, pose9d_to_T
from ..utils.device import synchronize
from ..utils.tensor_collection import TensorCollection
from ..utils.timer import Timer
from .ransac import make_obj_infos


def make_view_groups(pairs_TC1C2) -> dict:
    """Strongly connected components of the view graph: {view_id (sorted),
    view_group}."""
    v1 = np.asarray(pairs_TC1C2.infos["view1"])
    v2 = np.asarray(pairs_TC1C2.infos["view2"])
    views = np.unique(np.concatenate([v1, v2]))
    graph = csr_matrix((np.ones(len(v1)), (np.searchsorted(views, v1),
                                           np.searchsorted(views, v2))),
                       shape=(len(views), len(views)))
    _, ids = connected_components(graph, directed=True, connection="strong")
    return dict(view_id=views, view_group=ids)


class SamplerError(Exception):
    pass


@contextlib.contextmanager
def full_float32():
    """CUDA matmuls in full float32 inside (TF32 off), the setting restored
    after: the JAX package's products here are float32."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def pinv(A: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.pinv's cut-off: singular values at or below
    10·max(M, N)·eps of the largest are dropped (torch.linalg.pinv's
    default, max(M, N)·eps, keeps more of a near-singular A)."""
    rtol = 10.0 * max(A.shape[-2:]) * torch.finfo(A.dtype).eps
    return torch.linalg.pinv(A, rtol=rtol)


def _optimize_lm(TWO_9d0, TCW_9d0, cand_TCO, cand_view_ids, cand_obj_ids, K, obj_points,
                 cand_syms, cand_sym_valid, n_iterations: int = 50,
                 residuals_threshold: float = 25.0, lambd0: float = 1e-3, L_down: float = 9.0,
                 L_up: float = 11.0, eps: float = 1e-5, optimize_cameras: bool = True):
    """The LM loop. Returns (TWO_9d, TCW_9d, final loss (0-dim), iterations)."""
    with full_float32():
        return _lm_loop(TWO_9d0, TCW_9d0, cand_TCO, cand_view_ids, cand_obj_ids, K, obj_points,
                        cand_syms, cand_sym_valid, n_iterations, residuals_threshold, lambd0,
                        L_down, L_up, eps, optimize_cameras)


def _lm_loop(TWO_9d0, TCW_9d0, cand_TCO, cand_view_ids, cand_obj_ids, K, obj_points, cand_syms,
             cand_sym_valid, n_iterations, residuals_threshold, lambd0, L_down, L_up, eps,
             optimize_cameras):
    n_objects, n_views = TWO_9d0.shape[0], TCW_9d0.shape[0]
    n_params_TWO = n_objects * 9
    K_cand = K[cand_view_ids]
    points_cand = obj_points[cand_obj_ids]

    def cand_poses(TWO_9d, TCW_9d):
        return _matmul(pose9d_to_T(TCW_9d)[cand_view_ids], pose9d_to_T(TWO_9d)[cand_obj_ids])

    def aligned_targets(TWO_9d, TCW_9d):
        """Each candidate's observed pose under its symmetry closest, in
        reprojection, to the current model."""
        sym = symmetric_distance_reprojected(cand_TCO, cand_poses(TWO_9d, TCW_9d), K_cand,
                                             points_cand, cand_syms, cand_sym_valid)[1]
        return _matmul(cand_TCO, sym)

    def predicted_uv(flat):
        TWO_9d = flat[:n_params_TWO].reshape(n_objects, 9)
        TCW_9d = flat[n_params_TWO:].reshape(n_views, 9)
        return _project(points_cand, K_cand, cand_poses(TWO_9d, TCW_9d)).reshape(-1)

    def flat(TWO_9d, TCW_9d):
        return torch.cat([TWO_9d.reshape(-1), TCW_9d.reshape(-1)])

    def loss_and_errors(TWO_9d, TCW_9d):
        y = _project(points_cand, K_cand, aligned_targets(TWO_9d, TCW_9d)).reshape(-1)
        errors = y - predicted_uv(flat(TWO_9d, TCW_9d))
        return torch.clamp(errors ** 2, max=residuals_threshold).mean(), errors

    D = n_params_TWO + n_views * 9
    idD = torch.eye(D, dtype=TWO_9d0.dtype, device=TWO_9d0.device)
    TWO_9d, TCW_9d = TWO_9d0, TCW_9d0
    loss = loss_and_errors(TWO_9d, TCW_9d)[0]
    lambd = torch.tensor(lambd0, dtype=TWO_9d0.dtype, device=TWO_9d0.device)
    n = 0
    while n < n_iterations:
        loss, errors = loss_and_errors(TWO_9d, TCW_9d)
        J = torch.func.jacfwd(predicted_uv)(flat(TWO_9d, TCW_9d))          # (R, D)
        A = J.T @ J + lambd * idD
        h = pinv(A) @ (J.T @ errors)
        TWO_new = TWO_9d + h[:n_params_TWO].reshape(n_objects, 9)
        TCW_new = TCW_9d + h[n_params_TWO:].reshape(n_views, 9) if optimize_cameras else TCW_9d
        next_loss = loss_and_errors(TWO_new, TCW_new)[0]
        rho = loss - next_loss
        accept = rho > eps
        if accept:
            TWO_9d, TCW_9d, loss = TWO_new, TCW_new, next_loss
            lambd = torch.clamp(lambd / L_down, min=1e-7)
        else:
            lambd = torch.clamp(lambd * L_up, max=1e7)
        n += 1
        if abs(rho) < eps:
            break
    return TWO_9d, TCW_9d, loss, n


class MultiviewRefinement:
    """Object-level scene refinement of one view group (host bookkeeping and
    BFS initialization; alignment, jacobians and LM on the device of the
    mesh database)."""

    def __init__(self, candidates, cameras, pairs_TC1C2, mesh_db):
        dev = mesh_db.device
        view_ids = np.unique(candidates.infos["view_id"])
        keep = np.isin(pairs_TC1C2.infos["view1"], view_ids) \
            & np.isin(pairs_TC1C2.infos["view2"], view_ids)
        pairs_TC1C2 = pairs_TC1C2[np.flatnonzero(keep)]
        cameras = cameras[np.flatnonzero(np.isin(cameras.infos["view_id"], view_ids))]

        self.cam_infos = cameras.infos
        self.view_to_id = {int(v): n for n, v in enumerate(self.cam_infos["view_id"])}
        self.K = cameras.K.to(dev, torch.float32)
        self.n_views = len(cameras)

        self.obj_infos = make_obj_infos(candidates)
        self.obj_to_id = {int(o): n for n, o in enumerate(self.obj_infos["obj_id"])}
        self.obj_points = mesh_db.points[mesh_db.ids_for(self.obj_infos["label"])]
        self.n_objects = len(self.obj_infos["obj_id"])

        self.cand_TCO = candidates.poses.to(dev, torch.float32)
        cand_labels = mesh_db.ids_for(candidates.infos["label"])
        self.cand_syms = mesh_db.symmetries[cand_labels]
        self.cand_sym_valid = mesh_db.sym_valid[cand_labels]
        self.cand_view_ids = np.asarray([self.view_to_id[int(v)]
                                         for v in candidates.infos["view_id"]], np.int64)
        self.cand_obj_ids = np.asarray([self.obj_to_id[int(o)]
                                        for o in candidates.infos["obj_id"]], np.int64)
        self.n_candidates = len(self.cand_view_ids)

        self.visibility = np.zeros((self.n_objects, self.n_views), dtype=bool)
        self.visibility[self.cand_obj_ids, self.cand_view_ids] = True

        TC2C1 = invert_T(pairs_TC1C2.TC1C2.to(torch.float32)).cpu().numpy()
        self.v2v1_TC2C1 = {(self.view_to_id[int(v2)], self.view_to_id[int(v1)]): T
                           for v1, v2, T in zip(pairs_TC1C2.infos["view1"],
                                                pairs_TC1C2.infos["view2"], TC2C1)}
        self.ov_TCO_cand = {(int(o), int(v)): t for o, v, t in zip(
            self.cand_obj_ids, self.cand_view_ids, self.cand_TCO.cpu().numpy())}

    def sample_initial_TWO_TWC(self, seed):
        """World poses by BFS over the view graph from a random first view,
        each object from its first visible view (numpy float32, the JAX
        package's order of draws)."""
        TWO = np.full((self.n_objects, 4, 4), np.nan, np.float32)
        TWC = np.full((self.n_views, 4, 4), np.nan, np.float32)
        rng = np.random.RandomState(seed)
        views_ordered = rng.permutation(self.n_views)
        objects_ordered = rng.permutation(self.n_objects)

        w = views_ordered[0]
        TWC[w] = np.eye(4)
        initialized = {int(w)}
        to_init = set(range(self.n_views)) - initialized
        for _ in range(20):
            if not to_init:
                break
            for v1 in views_ordered:
                if v1 in to_init:
                    for v2 in views_ordered:
                        if int(v2) not in initialized:
                            continue
                        key = (int(v2), int(v1))
                        if key in self.v2v1_TC2C1:
                            TWC[v1] = TWC[v2] @ self.v2v1_TC2C1[key]
                            to_init.remove(int(v1))
                            initialized.add(int(v1))
                            break
        if to_init:
            raise SamplerError("Cannot find an initialization")

        for o in objects_ordered:
            for v in views_ordered:
                if self.visibility[o, v]:
                    TWO[o] = TWC[v] @ self.ov_TCO_cand[(int(o), int(v))]
                    break
        return TWO, TWC

    def _ids(self):
        dev = self.cand_TCO.device
        return (torch.as_tensor(self.cand_view_ids, device=dev),
                torch.as_tensor(self.cand_obj_ids, device=dev))

    def _mean_aligned_dist(self, TWO_9d, TCW_9d) -> float:
        """The candidates' mean reprojection distance, each at its best
        symmetry, under these poses: the initializations' score."""
        views, objs = self._ids()
        TCO = _matmul(pose9d_to_T(TCW_9d)[views], pose9d_to_T(TWO_9d)[objs])
        return float(symmetric_distance_reprojected(
            self.cand_TCO, TCO, self.K[views], self.obj_points[objs], self.cand_syms,
            self.cand_sym_valid)[0].mean())

    def robust_initialization(self, n_init=1):
        """The best of n_init BFS initializations by mean aligned distance."""
        best = None
        dev = self.cand_TCO.device
        for seed in range(n_init):
            TWO, TWC = (torch.as_tensor(x, device=dev) for x in self.sample_initial_TWO_TWC(seed))
            TWO_9d, TCW_9d = T_to_pose9d(TWO), T_to_pose9d(invert_T(TWC))
            d = self._mean_aligned_dist(TWO_9d, TCW_9d)
            if best is None or d < best[0]:
                best = (d, TWO_9d, TCW_9d)
        return best[1], best[2]

    def solve(self, sample_n_init=1, n_iterations=50, residuals_threshold=25.0,
              optimize_cameras=True) -> dict:
        dev = self.cand_TCO.device
        timer_init, timer_opt, timer_misc = Timer(), Timer(), Timer()
        timer_init.start()
        TWO_9d, TCW_9d = self.robust_initialization(sample_n_init)
        synchronize(dev)
        timer_init.pause()

        timer_opt.start()
        views, objs = self._ids()
        TWO_9d_opt, TCW_9d_opt, loss, n_iter = _optimize_lm(
            TWO_9d, TCW_9d, self.cand_TCO, views, objs, self.K, self.obj_points,
            self.cand_syms, self.cand_sym_valid, n_iterations=n_iterations,
            residuals_threshold=residuals_threshold, optimize_cameras=optimize_cameras)
        synchronize(dev)
        timer_opt.pause()

        timer_misc.start()
        objects, cameras = self.make_scene_infos(TWO_9d_opt, TCW_9d_opt)
        objects_init, cameras_init = self.make_scene_infos(TWO_9d, TCW_9d)
        timer_misc.pause()
        return dict(objects_init=objects_init, cameras_init=cameras_init, objects=objects,
                    cameras=cameras, final_loss=float(loss), n_lm_iterations=int(n_iter),
                    time_init=timer_init.stop(), time_opt=timer_opt.stop(),
                    time_misc=timer_misc.stop())

    def make_scene_infos(self, TWO_9d, TCW_9d):
        objects = TensorCollection(dict(self.obj_infos), TWO=pose9d_to_T(TWO_9d))
        cameras = TensorCollection(dict(self.cam_infos), TWC=invert_T(pose9d_to_T(TCW_9d)),
                                   K=self.K)
        return objects, cameras
