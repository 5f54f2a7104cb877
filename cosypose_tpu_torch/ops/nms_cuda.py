"""Greedy non-maximum suppression over groups of boxes, as one Hopper
kernel, and its plain version.

    keep = batched_nms(boxes, scores, groups, n_groups, iou_threshold, valid)

keeps box i (boxes (N, 4) x1 y1 x2 y2 float32) unless a kept box of its
group (groups (N,) int64 in [0, n_groups)) of higher score, or of equal
score and lower index, overlaps it with an IoU above the threshold; rows
with valid False (None: all valid) are never kept and never suppress. The
order is a stable sort of the scores, descending, so that ties go to the
lower index. Returns keep (N,) bool in the input's order. One launch serves
every group: Mask R-CNN's RPN groups its proposals by (image, level), its
box head its detections by (image, class). torchvision's `batched_nms`
offsets each group's coordinates instead, which rounds the IoU of the
shifted boxes; the groups here are compared by id, on the boxes as given.

`nms_sorted(boxes, offsets, iou_threshold, valid)` is the same on boxes
already laid out by group (offsets (G + 1,) int64), each group in priority
order. On CUDA tensors it is csrc/nms.cu (one launch; the source says how it
is laid out), built by `nvcc_build.build_libraries(("nms",))` at its first
call and called through ctypes; while torch.export or torch.compile traces,
through the registered operator `cosypose::nms`. On CPU tensors it is
`nms_plain`, the kernel's oracle: the same IoU, op for op in float32, then
the greedy scan. `NMS_KERNEL.launches` counts the kernel's launches, and
each one adds 1 to the program's counter `nms` (utils/profiling.py, inside
`tracing()`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.profiling import count
from .nvcc_build import build_libraries

MAX_BOXES = 64 * (47 * 1024 // 8)  # the kernel's removed bits in 47 KB of shared memory


def iou_exceeds(a: torch.Tensor, b: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """(len(a), len(b)) bool: IoU of each pair above the threshold, in the
    kernel's float32 arithmetic (torchvision's nms kernel's): the
    intersection's width and height clamped at 0, the areas as products of
    differences, inter / (area_a + area_b - inter)."""
    left = torch.maximum(a[:, None, 0], b[None, :, 0])
    right = torch.minimum(a[:, None, 2], b[None, :, 2])
    top = torch.maximum(a[:, None, 1], b[None, :, 1])
    bottom = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (right - left).clamp(min=0.0) * (bottom - top).clamp(min=0.0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter) > iou_threshold


def nms_plain(boxes: torch.Tensor, offsets: torch.Tensor, iou_threshold: float,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: each group's IoU matrix, then
    the greedy scan in row order. keep (N,) bool on boxes' device."""
    n = boxes.shape[0]
    keep = np.zeros(n, bool)
    gone_all = np.zeros(n, bool) if valid is None else ~valid.cpu().numpy().astype(bool)
    bounds = offsets.cpu().tolist()
    for start, end in zip(bounds[:-1], bounds[1:]):
        if end <= start:
            continue
        b = boxes[start:end].float()
        hits = iou_exceeds(b, b, iou_threshold).cpu().numpy()
        gone = gone_all[start:end].copy()
        for i in range(end - start):
            if gone[i]:
                continue
            keep[start + i] = True
            gone[i + 1:] |= hits[i, i + 1:]
    return torch.as_tensor(keep, device=boxes.device)


class NmsKernel:
    """ctypes binding of csrc/nms.cu, with its count of launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build_libraries(("nms",))["nms"][0]))
            fn = lib.cosypose_nms
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_float, ptr, i32, ptr]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, boxes, offsets, iou_threshold: float, valid=None) -> torch.Tensor:
        """keep (N,) bool from the kernel. Raises on what it does not take:
        boxes not a contiguous (N, 4) float32 CUDA tensor aligned to 16 bytes,
        offsets not a contiguous int64 vector on its device, valid not a
        contiguous (N,) bool on it, N above MAX_BOXES."""
        dev = boxes.get_device()
        n = boxes.shape[0]
        if dev < 0 or boxes.dtype != torch.float32 or boxes.dim() != 2 \
                or boxes.shape[1] != 4 or not boxes.is_contiguous() \
                or boxes.data_ptr() % 16 or n > MAX_BOXES:
            raise ValueError(f"nms: takes a contiguous (N, 4) float32 CUDA tensor aligned to 16 "
                             f"bytes, N at most {MAX_BOXES}; got {boxes.dtype} "
                             f"{tuple(boxes.shape)} on {boxes.device}")
        if offsets.dtype != torch.int64 or offsets.dim() != 1 or offsets.get_device() != dev \
                or not offsets.is_contiguous():
            raise ValueError(f"nms: offsets must be a contiguous int64 vector on {boxes.device}; "
                             f"got {offsets.dtype} {tuple(offsets.shape)} on {offsets.device}")
        if valid is not None and (valid.dtype != torch.bool or valid.shape != (n,)
                                  or valid.get_device() != dev or not valid.is_contiguous()):
            raise ValueError(f"nms: valid must be a contiguous ({n},) bool on {boxes.device}")
        keep = torch.empty(n, dtype=torch.bool, device=boxes.device)
        groups = offsets.shape[0] - 1
        if n and groups > 0:
            err = self.load()(boxes.data_ptr(), offsets.data_ptr(),
                              None if valid is None else valid.data_ptr(), groups, n,
                              float(iou_threshold), keep.data_ptr(), dev,
                              torch._C._cuda_getCurrentRawStream(dev))
            if err != 0:
                raise RuntimeError(f"nms launch failed: cudaError {err}")
            self.launches += 1
            count("nms")
        else:
            keep.zero_()
        return keep


NMS_KERNEL = NmsKernel()


@torch.library.custom_op("cosypose::nms", mutates_args=(), device_types="cpu",
                         schema="(Tensor boxes, Tensor offsets, Tensor? valid, float iou) "
                                "-> Tensor")
def nms_op(boxes, offsets, valid, iou):
    """CPU: nms_plain."""
    return nms_plain(boxes, offsets, iou, valid)


@nms_op.register_kernel("cuda")
def _nms_cuda(boxes, offsets, valid, iou):
    return NMS_KERNEL(boxes, offsets, iou, valid)


@nms_op.register_fake
def _nms_fake(boxes, offsets, valid, iou):
    return boxes.new_empty(boxes.shape[0], dtype=torch.bool)


def nms_sorted(boxes: torch.Tensor, offsets: torch.Tensor, iou_threshold: float,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """keep (N,) bool of boxes laid out by group (module docstring): the
    kernel on CUDA tensors (the registered operator while torch.export or
    torch.compile traces), the plain version on CPU tensors."""
    if boxes.is_cuda:
        boxes = boxes.float().contiguous()
        if boxes.data_ptr() % 16:
            boxes = boxes.clone()
        args = (boxes, offsets.contiguous(), None if valid is None else valid.contiguous(),
                float(iou_threshold))
        if torch.compiler.is_compiling():
            return nms_op(*args)
        return NMS_KERNEL(args[0], args[1], args[3], args[2])
    if boxes.device.type != "cpu":
        raise ValueError(f"nms: no implementation for device {boxes.device}")
    return nms_plain(boxes, offsets, iou_threshold, valid)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, groups: torch.Tensor, n_groups: int,
                iou_threshold: float, valid: torch.Tensor | None = None) -> torch.Tensor:
    """keep (N,) bool in the input's order (module docstring). No host sync:
    the layout by group comes from two stable sorts and a search."""
    order = torch.sort(scores, descending=True, stable=True).indices
    by_group = torch.sort(groups[order], stable=True)
    order = order[by_group.indices]
    offsets = torch.searchsorted(by_group.values,
                                 torch.arange(n_groups + 1, device=groups.device))
    kept = nms_sorted(boxes[order], offsets, iou_threshold,
                      None if valid is None else valid[order])
    keep = torch.empty_like(kept)
    keep[order] = kept
    return keep
