"""The MBConv block's depthwise half (ops/depthwise_cuda.py) on the CPU: its
plain version against the unfused chain the block ran before it (the grouped
conv with TF "SAME" padding, eval BatchNorm, swish, the SE squeeze's mean) at
each of EfficientNet-B3's 14 depthwise shapes (batch cut to 2) and at odd
sizes that make stride-2 padding asymmetric, in float32 and under bf16
autocast; the registered operator's CPU and fake implementations; and the
block's own paths off the card (train mode, eval on the CPU), which run the
modules as before. The kernel itself runs on the card only
(tests/test_torch_port_gpu.py).

Tolerances: depthwise_cuda.error_limit, elementwise, with the unfused chain's
extra roundings of the conv's and BatchNorm's results (`rounded_between`):
in float32 the sums' order alone, in bf16 also the roundings the plain
version leaves out.
"""

import pytest
import torch
import torch.nn.functional as F

from cosypose_tpu_torch.models.efficientnet import (BatchNorm2d, DepthwiseConv2dSame,
                                                     EfficientNet, MBConvBlock)
from cosypose_tpu_torch.ops import depthwise_cuda as dwc
from cosypose_tpu_torch.utils import profiling

B3_SHAPES = sorted(set(EfficientNet("efficientnet-b3").depthwise_shapes((240, 320))))
# (C, k, stride, H, W): odd sizes, stride-2 padding asymmetric (more below and
# right), inputs smaller than the kernel, single pixels
ODD_SHAPES = [(7, 3, 2, 13, 17), (5, 5, 2, 9, 11), (6, 5, 2, 10, 7), (3, 3, 1, 5, 9),
              (4, 5, 1, 3, 4), (3, 3, 2, 1, 1), (2, 5, 2, 2, 3)]


def dw_modules(C, k, stride, seed=0):
    """The block's depthwise conv and eval BatchNorm with seeded parameters and
    running statistics away from their initial values."""
    g = torch.Generator().manual_seed(seed)
    dw, bn = DepthwiseConv2dSame(C, k, stride), BatchNorm2d(C).eval()
    with torch.no_grad():
        dw.weight.copy_(torch.randn(dw.weight.shape, generator=g) * 0.3)
        bn.weight.copy_(torch.rand(C, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(C, generator=g) * 0.3)
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.3)
        bn.running_var.copy_(torch.rand(C, generator=g) * 2 + 0.2)
    return dw, bn


def fused_args(x, dw, bn):
    """The function's arguments from the modules, the parameters detached (the
    block calls it where no gradient is recorded)."""
    return (x, dw.weight.detach(), bn.weight.detach(), bn.bias.detach(), bn.running_mean,
            bn.running_var, bn.eps, dw.kernel_size[0], dw.stride[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", B3_SHAPES + ODD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_the_unfused_chain(shape, dtype):
    C, k, stride, H, W = shape
    dw, bn = dw_modules(C, k, stride)
    x = torch.randn(2, C, H, W, generator=torch.Generator().manual_seed(1)).to(dtype)
    with torch.no_grad():
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
            y_ref = F.silu(bn(dw(x)))
            s_ref = y_ref.mean(dim=(2, 3))
        y, s = dwc.dw_bn_silu_squeeze_plain(*fused_args(x, dw, bn))
        limit_y, limit_s = dwc.error_limit(*fused_args(x, dw, bn), y, rounded_between=True)
    assert y.dtype == s.dtype == y_ref.dtype == dtype
    assert y.shape == y_ref.shape == (2, C, -(-H // stride), -(-W // stride))
    assert s.shape == (2, C)
    assert bool(((y.float() - y_ref.float()).abs() <= limit_y).all())
    assert bool(((s.float() - s_ref.float()).abs() <= limit_s).all())


@pytest.mark.parametrize("n,k,s,want", [(120, 3, 2, (60, 0, 1)), (15, 5, 2, (8, 2, 2)),
                                        (30, 3, 2, (15, 0, 1)), (8, 5, 1, (8, 2, 2)),
                                        (13, 3, 2, (7, 1, 1)), (10, 5, 2, (5, 1, 2))])
def test_same_pad(n, k, s, want):
    assert dwc.same_pad(n, k, s) == want


def test_b3_moves_2_34_gb_over_its_26_blocks():
    shapes = EfficientNet("efficientnet-b3").depthwise_shapes((240, 320))
    assert len(shapes) == 26 and len(set(shapes)) == 14
    total = sum(dwc.moved_bytes(64, C, H, W, k, s, 2) for C, k, s, H, W in shapes)
    assert 2.340e9 < total < 2.345e9  # activations 2.3407e9, parameters 1.8e6
    assert 0.698 < total / 3.35e12 * 1e3 < 0.701  # ms at 3.35 TB/s


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    dw, bn = dw_modules(6, 5, 2)
    x = torch.randn(3, 6, 11, 9)
    with torch.no_grad():
        got = dwc.dw_bn_silu_squeeze(*fused_args(x, dw, bn))
        want = dwc.dw_bn_silu_squeeze_plain(*fused_args(x, dw, bn))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_operator_cpu_and_fake_implementations():
    """torch.library.opcheck on CPU tensors: the CPU implementation (the plain
    version) against the fake one, schema and dispatch."""
    dw, bn = dw_modules(5, 3, 2)
    x = torch.randn(2, 5, 9, 12)
    torch.library.opcheck(dwc.dw_bn_silu_squeeze_op, fused_args(x, dw, bn))
    with torch.no_grad():
        got = dwc.dw_bn_silu_squeeze_op(*fused_args(x, dw, bn))
        want = dwc.dw_bn_silu_squeeze_plain(*fused_args(x, dw, bn))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_kernel_refuses_what_it_does_not_take():
    """The launcher raises before any build on tensors it does not take."""
    dw, bn = dw_modules(4, 3, 1)
    before = dwc.DW_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        dwc.DW_KERNEL(*fused_args(torch.randn(1, 4, 8, 8), dw, bn))
    with pytest.raises(ValueError, match="no implementation"):
        dwc.dw_bn_silu_squeeze(*fused_args(torch.randn(1, 4, 8, 8, device="meta"), dw, bn))
    assert dwc.DW_KERNEL.launches == before


def unfused_block_forward(block, x, keep=None):
    """MBConvBlock.forward as it was before its depthwise half had a kernel."""
    inp = x
    if block.has_expand:
        x = F.silu(block._bn0(block._expand_conv(x)))
    x = F.silu(block._bn1(block._depthwise_conv(x)))
    s = x.mean(dim=(2, 3), keepdim=True)
    s = block._se_expand(F.silu(block._se_reduce(s)))
    x = x * torch.sigmoid(s)
    x = block._bn2(block._project_conv(x))
    if not block.residual:
        return x
    if keep is not None:
        keep_prob = 1.0 - block.drop_rate
        x = torch.where(keep[:, None, None, None], x / keep_prob, torch.zeros((), dtype=x.dtype))
    return x + inp


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_the_block_off_the_card_runs_the_modules_as_before(train):
    """Train mode (forward and backward, the running statistics' update,
    drop-connect) and eval on the CPU: bit for bit the unfused forward."""
    torch.manual_seed(0)
    blocks = [MBConvBlock(16, 16, 5, 1, 6, 0.25, drop_rate=0.3) for _ in range(2)]
    blocks[1].load_state_dict(blocks[0].state_dict())
    for b in blocks:
        b.train(train)
    x = torch.randn(4, 16, 9, 11)
    keep = torch.tensor([True, False, True, True]) if train else None
    outs, grads = [], []
    for b, fwd in zip(blocks, (lambda b, x: b(x, keep), lambda b, x: unfused_block_forward(b, x,
                                                                                          keep))):
        xi = x.clone().requires_grad_(train)
        out = fwd(b, xi)
        if train:
            out.square().sum().backward()
            grads.append([xi.grad] + [p.grad for p in b.parameters()])
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    for name, buf in blocks[0].state_dict().items():
        assert torch.equal(buf, blocks[1].state_dict()[name]), name


def test_eval_b3_on_the_cpu_launches_no_kernel():
    net = EfficientNet("efficientnet-b3").eval()
    before = dwc.DW_KERNEL.launches
    with torch.no_grad(), profiling.tracing():
        net(torch.rand(1, 6, 64, 96))
    records = profiling.collect()
    assert dwc.DW_KERNEL.launches == before
    assert not any("dw_bn_silu_squeeze" in c for c in records["counters"].values())
