"""JAX PoseNet variables → the port's PoseNet state_dict (the reverse of
cosypose_tpu/utils/torch_compat.py), with no jax import.

The input is the flax `{"params", "batch_stats"}` tree with numpy (or
array-like) leaves. Layouts: conv kernels HWIO → OIHW (a depthwise kernel
(kh,kw,1,C) becomes (C,1,kh,kw) by the same transpose), Dense (in,out) →
(out,in), BatchNorm scale/bias/mean/var → weight/bias/running_mean/running_var,
and the JAX block `block{stage}_{i}` → `_blocks.N` in stage-major order.
`load_jax_train_state` puts a JAX TrainState's params and batch_stats into
the port's train state (the pretrain path): any head_init_scale, since the
pose kernel is carried as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.efficientnet import block_names


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def jax_pose_variables_to_state_dict(variables: dict,
                                     variant: str = "efficientnet-b3") -> dict:
    params = variables["params"]
    stats = variables["batch_stats"]
    bb_p, bb_s = params["EfficientNet_0"], stats["EfficientNet_0"]
    sd = {}

    def bn(prefix, p, s):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    sd["backbone._conv_stem.weight"] = _conv(bb_p["stem_conv"]["kernel"])
    bn("backbone._bn0", bb_p["stem_bn"], bb_s["stem_bn"])
    for idx, name in enumerate(block_names(variant)):
        p, s, tp = bb_p[name], bb_s[name], f"backbone._blocks.{idx}"
        if "expand_conv" in p:
            sd[f"{tp}._expand_conv.weight"] = _conv(p["expand_conv"]["kernel"])
            bn(f"{tp}._bn0", p["bn0"], s["bn0"])
        sd[f"{tp}._depthwise_conv.weight"] = _conv(p["dw_conv"]["kernel"])
        bn(f"{tp}._bn1", p["bn1"], s["bn1"])
        for jax_name, port_name in (("reduce", "_se_reduce"), ("expand", "_se_expand")):
            sd[f"{tp}.{port_name}.weight"] = _conv(p["se"][jax_name]["kernel"])
            sd[f"{tp}.{port_name}.bias"] = _t(p["se"][jax_name]["bias"])
        sd[f"{tp}._project_conv.weight"] = _conv(p["project_conv"]["kernel"])
        bn(f"{tp}._bn2", p["bn2"], s["bn2"])
    sd["backbone._conv_head.weight"] = _conv(bb_p["head_conv"]["kernel"])
    bn("backbone._bn1", bb_p["head_bn"], bb_s["head_bn"])
    sd["pose_fc.weight"] = _t(np.asarray(params["pose_fc"]["kernel"]).T)
    sd["pose_fc.bias"] = _t(params["pose_fc"]["bias"])
    return sd


def load_jax_train_state(state, params: dict, batch_stats: dict) -> None:
    """Load a JAX TrainState's `params` and `batch_stats` (trees with numpy
    leaves) into the port's TrainState's net, in place. The optimizer state
    and the step are left as they are, as the JAX package's pretrain does."""
    sd = jax_pose_variables_to_state_dict({"params": params, "batch_stats": batch_stats},
                                          state.pp.cfg.backbone)
    state.pp.net.load_state_dict(sd)
