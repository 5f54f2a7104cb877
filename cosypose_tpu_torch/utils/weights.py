"""JAX PoseNet and detector variables → the port's state_dicts (the reverse
of cosypose_tpu/utils/torch_compat.py), with no jax import.

The input is the flax `{"params", "batch_stats"}` tree with numpy (or
array-like) leaves. Layouts: conv kernels HWIO → OIHW (a depthwise kernel
(kh,kw,1,C) becomes (C,1,kh,kw) by the same transpose), flax ConvTranspose
kernels (kh,kw,in,out), which flax applies unflipped, → torch's
ConvTranspose2d (in,out,kh,kw) flipped in both spatial axes, Dense (in,out) →
(out,in), BatchNorm scale/bias/mean/var → weight/bias/running_mean/running_var,
LayerNorm scale/bias → weight/bias. EfficientNet's block `block{stage}_{i}`
→ `_blocks.N` in stage-major order; the other backbones and the detector
head keep the JAX module names, so their trees map by name.
`load_jax_train_state` puts a JAX TrainState's params and batch_stats into
the port's train state (the pretrain path): any head_init_scale, since the
pose kernel is carried as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.efficientnet import block_names, split_dw_impl


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _is_leaf_module(tree: dict) -> bool:
    return not any(isinstance(v, dict) for v in tree.values())


def _by_name(params: dict, stats: dict, prefix: str, sd: dict,
             transposed: tuple = ()) -> None:
    """Map a flax subtree whose module names are the port's, into sd under
    `prefix`; modules named in `transposed` are ConvTranspose."""
    for name, p in params.items():
        path, s = f"{prefix}.{name}", (stats or {}).get(name, {})
        if not _is_leaf_module(p):
            _by_name(p, s, path, sd, transposed)
        elif "kernel" in p:
            k = np.asarray(p["kernel"])
            if k.ndim == 2:
                sd[f"{path}.weight"] = _t(k.T)
            elif name in transposed:
                sd[f"{path}.weight"] = _t(k[::-1, ::-1].transpose(2, 3, 0, 1))
            else:
                sd[f"{path}.weight"] = _conv(k)
            if "bias" in p:
                sd[f"{path}.bias"] = _t(p["bias"])
        else:  # BatchNorm (with running statistics) or LayerNorm
            sd[f"{path}.weight"] = _t(p["scale"])
            sd[f"{path}.bias"] = _t(p["bias"])
            if "mean" in s:
                sd[f"{path}.running_mean"] = _t(s["mean"])
                sd[f"{path}.running_var"] = _t(s["var"])
                sd[f"{path}.num_batches_tracked"] = torch.tensor(0)


def _efficientnet(bb_p: dict, bb_s: dict, variant: str, sd: dict) -> None:
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


BACKBONE_TREES = ("WideResNet_0", "FlowNetSEncoder_0", "CorrNet_0")


def jax_pose_variables_to_state_dict(variables: dict,
                                     variant: str = "efficientnet-b3") -> dict:
    """A JAX PoseNet's variables (any backbone and pooling) → the port's
    PoseNet state_dict. `variant` names the EfficientNet, when it is one
    (a depthwise lowering's suffix changes no parameter)."""
    variant = split_dw_impl(variant)[0]
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for name, p in params.items():
        if name == "EfficientNet_0":
            _efficientnet(p, stats[name], variant, sd)
        elif name in BACKBONE_TREES:
            _by_name(p, stats.get(name, {}), "backbone", sd)
        else:  # pose_fc, flatten_reduce, flatten_ln, lk_ln
            _by_name({name: p}, {}, "", sd)
    return {k.removeprefix("."): v for k, v in sd.items()}


def jax_detector_variables_to_state_dict(variables: dict) -> dict:
    """A JAX CenterNetDetector's variables → the port's CenterNetDetector
    state_dict (WideResNet backbone, head with its three deconvs)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for name, p in params.items():
        prefix = "backbone" if name.startswith("WideResNet") else name
        _by_name(p, stats.get(name, {}), prefix, sd,
                 transposed=("deconv0", "deconv1", "deconv2"))
    return sd


def load_jax_train_state(state, params: dict, batch_stats: dict) -> None:
    """Load a JAX TrainState's `params` and `batch_stats` (trees with numpy
    leaves) into the port's TrainState's net, in place. The optimizer state
    and the step are left as they are, as the JAX package's pretrain does."""
    sd = jax_pose_variables_to_state_dict({"params": params, "batch_stats": batch_stats},
                                          state.pp.cfg.backbone)
    state.pp.net.load_state_dict(sd)
