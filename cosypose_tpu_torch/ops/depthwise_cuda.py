"""The depthwise half of an MBConv block in eval mode as one Hopper kernel,
and its plain version.

    y, s = dw_bn_silu_squeeze(x, weight, bn_weight, bn_bias, running_mean,
                              running_var, eps, kernel, stride)

computes, for x (B, C, H, W) contiguous NCHW (float32, bf16 or fp16), what
models/efficientnet.py MBConvBlock computes between its expand conv and its
SE reduce conv in eval mode:

  y  silu(batchnorm_eval(depthwise_conv_same(x, weight)))  (B, C, OH, OW), x's dtype
  s  y.mean((2, 3))                                         (B, C), x's dtype

with TensorFlow's "SAME" padding (`same_pad`, asymmetric on stride 2, never
materialised), the weight (C, 1, k, k) rounded to x's dtype as autocast
rounds it for the conv, the sums in float32, eval BatchNorm folded from the
running statistics on every call (scale = bn_weight / sqrt(running_var +
eps), shift = bn_bias - running_mean * scale: nothing is cached, so a
reloaded or retrained state is always current), the swish in float32 and y
rounded to x's dtype once. s is the mean of y's values as rounded, summed in
float32. Against the unfused ATen chain (pad, conv, BatchNorm, SiLU, mean)
the only difference is that the conv's and BatchNorm's results are no longer
rounded to x's dtype in between.

On CUDA tensors it is csrc/dw_bn_silu_squeeze.cu (one launch; the source
says how it is laid out and what bounds it), built by
`nvcc_build.build_libraries` with the raster sources and called through
ctypes; while torch.export or torch.compile traces, through the registered
operator `cosypose::dw_bn_silu_squeeze` (a CUDA implementation that
launches the kernel, a CPU one that runs the plain version, a fake one for
the shapes), so that an exported program holds it as one opaque call. On CPU
tensors it is `dw_bn_silu_squeeze_plain`. `DW_KERNEL.launches` counts the
kernel's launches, and each one adds 1 to the program's counter
`dw_bn_silu_squeeze` (utils/profiling.py, inside `tracing()`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.profiling import count
from .nvcc_build import build_libraries

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # the kernel's dtype codes
KERNELS, STRIDES = (3, 5), (1, 2)


def same_pad(n: int, k: int, s: int) -> tuple[int, int, int]:
    """(out, before, after) along one axis of TensorFlow's "SAME" padding:
    out = ceil(n / s), total max((out - 1) * s + k - n, 0), split (p // 2,
    p - p // 2)."""
    out = -(-n // s)
    p = max((out - 1) * s + k - n, 0)
    return out, p // 2, p - p // 2


def dw_bn_silu_squeeze_plain(x, weight, bn_weight, bn_bias, running_mean, running_var,
                             eps: float, kernel: int, stride: int):
    """The kernel's function in PyTorch ops (module docstring): the CPU path,
    and what the card tests hold the kernel to."""
    C, (H, W) = x.shape[1], x.shape[2:]
    _, top, bottom = same_pad(H, kernel, stride)
    _, left, right = same_pad(W, kernel, stride)
    w = weight.to(x.dtype).float()
    z = F.conv2d(F.pad(x.float(), (left, right, top, bottom)), w, None, stride, 0, 1, C)
    scale = bn_weight.float() * (1 / torch.sqrt(running_var.float() + eps))
    shift = bn_bias.float() - running_mean.float() * scale
    y = F.silu(z * scale[:, None, None] + shift[:, None, None]).to(x.dtype)
    return y, y.float().mean((2, 3)).to(x.dtype)


def moved_bytes(B: int, C: int, H: int, W: int, kernel: int, stride: int,
                itemsize: int) -> int:
    """The bytes one call must move at the least: x read once, y and s
    written once (itemsize each element), the weight and the four BatchNorm
    vectors read once (float32). Over EfficientNet-B3's 26 blocks at B=64,
    240x320 and bf16: 2.34 GB."""
    oh, ow = -(-H // stride), -(-W // stride)
    return (B * C * (H * W + oh * ow + 1)) * itemsize + C * (kernel * kernel + 4) * 4


# unit roundoff of each dtype the kernel takes
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def error_limit(x, weight, bn_weight, bn_bias, running_mean, running_var, eps: float,
                kernel: int, stride: int, y: torch.Tensor, rounded_between: bool = False):
    """Elementwise limits (for y (B, C, OH, OW) and for s (B, C), float32) of
    the gap between two computations of dw_bn_silu_squeeze's function from
    the same inputs, y being either one's output.

    With m = |scale| * sum_k |w_k| |x_k| + |shift| (the size of the terms an
    output sums) and u the unit roundoff of x's dtype: each side rounds y
    once (u |y| each), and sums its k*k + 2 float32 terms in its own order
    (under 2^-18 m each side, so 2^-17 m in all; the kernel's fast
    exponential and division, 2 + 1.2 |z| and 2 float32 ulps, move y by less
    than 2^-20 m more); swish's slope, at most 1.1, carries a gap before it
    into y. `rounded_between`: one side also rounds
    the conv's and BatchNorm's results to x's dtype (the unfused ATen chain),
    u m more each. s: the mean of y's limit, each side's rounding of s, and
    2^-14 of mean |y| for the order of a plane's float32 sum."""
    u = UNIT_ROUNDOFF[x.dtype]
    C, (H, W) = x.shape[1], x.shape[2:]
    _, top, bottom = same_pad(H, kernel, stride)
    _, left, right = same_pad(W, kernel, stride)
    w = weight.to(x.dtype).float().abs()
    xa = F.pad(x.float().abs(), (left, right, top, bottom))
    scale = bn_weight.float() * (1 / torch.sqrt(running_var.float() + eps))
    shift = bn_bias.float() - running_mean.float() * scale
    m = F.conv2d(xa, w, None, stride, 0, 1, C) * scale.abs()[:, None, None] \
        + shift.abs()[:, None, None]
    ya = y.float().abs()
    limit_y = 2 * u * ya + 1.1 * (2.0 ** -17 + (2 * u if rounded_between else 0.0)) * m
    ya_mean = ya.mean((2, 3))
    limit_s = limit_y.mean((2, 3)) + 2 * u * ya_mean + 2.0 ** -14 * ya_mean
    return limit_y, limit_s


class DepthwiseKernel:
    """ctypes binding of csrc/dw_bn_silu_squeeze.cu, with its count of
    launches (`launches`) and of their convolution FLOPs (`flops`, 2 k^2
    multiply-adds an output element, as torch's FLOP counter counts the
    grouped conv: a counter of ATen ops does not see inside the launch)."""

    def __init__(self):
        self.launches = 0
        self.flops = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build_libraries()["dw_bn_silu_squeeze"][0]))
            fn = lib.cosypose_dw_bn_silu_squeeze
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [ptr] * 6 + [ctypes.c_float] + [ptr] * 2 + [i32] * 8 + [ptr]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x, weight, bn_weight, bn_bias, running_mean, running_var, eps: float,
                 kernel: int, stride: int):
        """The kernel on CUDA tensors: (y, s). Raises on what it does not
        take: x not a contiguous (B, C, H, W) CUDA tensor of a dtype of
        DTYPES; the parameters not contiguous float32 tensors on
        x's device, the weight (C, 1, kernel, kernel) and the BatchNorm
        vectors (C,); a kernel size or stride outside KERNELS and STRIDES.
        The checks are the host's only work beside the launch: this runs once
        a block of every eval call of the backbone."""
        code = DTYPES.get(x.dtype)
        dev = x.get_device()
        if code is None or dev < 0 or x.dim() != 4 or not x.is_contiguous() \
                or kernel not in KERNELS or stride not in STRIDES:
            raise ValueError(f"dw_bn_silu_squeeze: takes a contiguous (B, C, H, W) CUDA tensor "
                             f"of {sorted(map(str, DTYPES))}, kernel {KERNELS} and stride "
                             f"{STRIDES}; got {x.dtype} {tuple(x.shape)} on {x.device}, kernel "
                             f"{kernel}, stride {stride}")
        B, C, H, W = x.shape
        params = (weight, bn_weight, bn_bias, running_mean, running_var)
        for t, shape in zip(params, ((C, 1, kernel, kernel), (C,), (C,), (C,), (C,))):
            if t.dtype != torch.float32 or t.get_device() != dev or t.shape != shape \
                    or not t.is_contiguous():
                raise ValueError(f"dw_bn_silu_squeeze: each parameter must be a contiguous "
                                 f"float32 tensor on {x.device}, the weight (C, 1, k, k) and "
                                 f"the BatchNorm vectors (C,) for C = {C}, k = {kernel}; got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        y = x.new_empty(B, C, -(-H // stride), -(-W // stride))
        s = x.new_empty(B, C)
        if B * C:
            err = self.load()(x.data_ptr(), weight.data_ptr(), bn_weight.data_ptr(),
                              bn_bias.data_ptr(), running_mean.data_ptr(),
                              running_var.data_ptr(), eps, y.data_ptr(), s.data_ptr(), B, C, H,
                              W, kernel, stride, code, dev,
                              torch._C._cuda_getCurrentRawStream(dev))
            if err != 0:
                raise RuntimeError(f"dw_bn_silu_squeeze launch failed: cudaError {err}")
            self.launches += 1
            self.flops += 2 * kernel * kernel * y.numel()
            count("dw_bn_silu_squeeze")
        return y, s


DW_KERNEL = DepthwiseKernel()


@torch.library.custom_op(
    "cosypose::dw_bn_silu_squeeze", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor weight, Tensor bn_weight, Tensor bn_bias, Tensor running_mean, "
           "Tensor running_var, float eps, int kernel, int stride) -> (Tensor, Tensor)")
def dw_bn_silu_squeeze_op(x, weight, bn_weight, bn_bias, running_mean, running_var, eps, kernel,
                          stride):
    """CPU: dw_bn_silu_squeeze_plain."""
    return dw_bn_silu_squeeze_plain(x, weight, bn_weight, bn_bias, running_mean, running_var,
                                    eps, kernel, stride)


@dw_bn_silu_squeeze_op.register_kernel("cuda")
def _dw_cuda(x, weight, bn_weight, bn_bias, running_mean, running_var, eps, kernel, stride):
    return DW_KERNEL(x, weight, bn_weight, bn_bias, running_mean, running_var, eps, kernel,
                     stride)


@dw_bn_silu_squeeze_op.register_fake
def _dw_fake(x, weight, bn_weight, bn_bias, running_mean, running_var, eps, kernel, stride):
    B, C, H, W = x.shape
    return x.new_empty(B, C, -(-H // stride), -(-W // stride)), x.new_empty(B, C)


def dw_bn_silu_squeeze(x, weight, bn_weight, bn_bias, running_mean, running_var, eps: float,
                       kernel: int, stride: int):
    """(y, s) of the module docstring: the kernel on CUDA tensors (the
    registered operator while torch.export or torch.compile traces, else the
    ctypes launcher directly: the operator's dispatch costs the host more than
    the launch), the plain version on CPU tensors; other devices raise."""
    args = (x, weight, bn_weight, bn_bias, running_mean, running_var, float(eps), int(kernel),
            int(stride))
    if x.is_cuda:
        if torch.compiler.is_compiling():
            return dw_bn_silu_squeeze_op(*args)
        return DW_KERNEL(*args)
    if x.device.type != "cpu":
        raise ValueError(f"dw_bn_silu_squeeze: no implementation for device {x.device}")
    return dw_bn_silu_squeeze_plain(*args)
