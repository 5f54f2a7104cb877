"""Data parallelism under torch.distributed (port of
cosypose_tpu/parallel/mesh.py).

The JAX package shards the batch over a 1-D 'data' mesh and lets XLA compute
the single-device step on the global batch. Here each rank is a process that
holds its contiguous rows of every global batch (`shard_batch`, the layout of
P('data')), and the pieces of the global step are written out:

- `DataParallel` wraps a root module whose forward is the step's whole loss,
  so the step makes one forward and one backward however often the loss
  calls the net: DistributedDataParallel averages the gradients
  ('replicated', the reference's DDP), or FSDP2's `fully_shard` shards the
  parameters, gradients and optimizer state over the ranks ('fsdp', the
  counterpart of fsdp_shardings; FSDP2 shards dim 0 where the JAX package
  shards a leaf's largest divisible dim, and the step is the same);
- every BatchNorm2d normalises with the global batch's statistics
  (models/efficientnet.global_batch_stats);
- `mean_over_ranks` makes the step's metrics the global batch's.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

from ..models.efficientnet import global_batch_stats
from ..utils.distributed import get_rank, get_world_size

PARAM_MODES = ("replicated", "fsdp")


def rank_rows(n: int, rank: int, world: int) -> slice:
    """The rows [r·n/w, (r+1)·n/w) that rank r of w holds of n, as P('data')
    lays a leading dim out over a mesh axis."""
    if n % world:
        raise ValueError(f"{n} rows do not split evenly over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch, rank: int | None = None, world: int | None = None):
    """This rank's rows of a batch: a tensor, an array, a list or a dict of
    them (rank and world default to the process group's)."""
    rank = get_rank() if rank is None else rank
    world = get_world_size() if world is None else world
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    return batch[rank_rows(len(batch), rank, world)]


def replicate(tree, src: int = 0):
    """Every rank's copy made equal to rank `src`'s, by broadcast, in place:
    a module's parameters and buffers, or a tensor, list or dict of tensors.
    Returns `tree`."""
    if get_world_size() == 1:
        return tree
    if isinstance(tree, nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        tensors = list(tree)
    else:
        tensors = [tree]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src)
    return tree


def gather_to_host(tree):
    """Every rank's rows, concatenated in rank order, as numpy arrays: a
    tensor or a dict of tensors of the same shape on every rank."""
    if isinstance(tree, dict):
        return {k: gather_to_host(v) for k, v in tree.items()}
    if get_world_size() == 1:
        return tree.detach().cpu().numpy()
    t = tree.detach().contiguous()
    out = torch.empty((get_world_size() * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t)
    return out.cpu().numpy()


def mean_over_ranks(metrics: dict) -> dict:
    """The ranks' mean of each metric (0-dim tensors on one device), in one
    all_reduce of their float64 vector, without a host read-back; float32
    values."""
    if get_world_size() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].double() for k in keys])
    dist.all_reduce(vec)
    vec = (vec / get_world_size()).float()
    return {k: vec[i] for i, k in enumerate(keys)}


def mean_count(count: torch.Tensor, group=None) -> torch.Tensor:
    """The normaliser of a sum over the global batch, in one rank's share:
    max(the count over all ranks, 1) / world. A rank's sum over its rows
    divided by it gives a loss whose mean over the ranks is the global sum
    over max(global count, 1), as the JAX package's step computes it; one
    process gets max(count, 1)."""
    count = count.detach()
    if group is None or dist.get_world_size(group) == 1:
        return count.clamp(min=1.0)
    total = count.clone()
    dist.all_reduce(total, group=group)
    return total.clamp(min=1.0) / dist.get_world_size(group)


class _Loss(nn.Module):
    """The root DDP and FSDP wrap: forward(fn, *args) is fn(*args), the
    step's loss, which may call `net` any number of times."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, fn, *args):
        return fn(*args)


class DataParallel:
    """A net trained data-parallel over the initialised process group.

    On construction every rank's net becomes rank 0's (`replicate`), its
    BatchNorm layers take the global batch's statistics, and the root
    (`_Loss` around the net) is wrapped: DistributedDataParallel without
    buffer broadcasts ('replicated': the running statistics move alike on
    every rank), or FSDP2 ('fsdp'). Build the optimizer over `parameters()`
    after this. `dp(fn, *args)` computes the step's loss fn(*args) through
    the wrapper.
    """

    def __init__(self, net: nn.Module, param_mode: str = "replicated"):
        if param_mode not in PARAM_MODES:
            raise ValueError(f"unknown param_mode {param_mode!r}, want one of {PARAM_MODES}")
        if not dist.is_initialized():
            raise RuntimeError("data parallelism needs the process group: call "
                               "utils.distributed.init_distributed_mode first")
        self.net, self.param_mode = net, param_mode
        root = replicate(_Loss(net))
        global_batch_stats(net, dist.group.WORLD)
        if param_mode == "replicated":
            self.module = nn.parallel.DistributedDataParallel(root, broadcast_buffers=False,
                                                              init_sync=False)
        else:
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.fsdp import fully_shard

            mesh = init_device_mesh(next(net.parameters()).device.type, (dist.get_world_size(),))
            self.module = fully_shard(root, mesh=mesh)

    def __call__(self, fn, *args):
        return self.module(fn, *args)

    def parameters(self):
        return self.module.parameters()

    @contextlib.contextmanager
    def full_params(self):
        """Inside the block the net holds its whole parameters, for a forward
        outside the step (an evaluation). Every rank enters it."""
        if self.param_mode == "fsdp":
            self.module.unshard()
        try:
            yield self.net
        finally:
            if self.param_mode == "fsdp":
                self.module.reshard()

    # -- checkpoints: the single-process format (the net's own keys, the
    # optimizer's state by parameter index) -------------------------------

    def state_dict(self) -> dict:
        """The net's whole state dict, on every rank (every rank calls it)."""
        return {k: whole(v) for k, v in self.net.state_dict().items()}

    def load_state_dict(self, sd: dict, strict: bool = True) -> None:
        """Load whole tensors of a state dict (the same on every rank); `strict`
        False loads the entries it has and leaves the rest. Under fsdp each
        rank copies its own shard of them, with no collective."""
        if self.param_mode == "replicated":
            self.net.load_state_dict(sd, strict=strict)
            return
        own = self.net.state_dict()
        if strict and set(sd) != set(own):
            raise KeyError(f"state dict keys differ: missing {sorted(set(own) - set(sd))}, "
                           f"unexpected {sorted(set(sd) - set(own))}")
        with torch.no_grad():
            for k, v in sd.items():
                local_part(own[k]).copy_(local_part(_shard_like(own[k], v)))

    def optimizer_state_dict(self, optimizer: torch.optim.Optimizer) -> dict:
        """The optimizer's whole state dict, as torch's keys it, on every rank
        (every rank calls it)."""
        osd = optimizer.state_dict()
        return {"state": {i: {k: whole(v) for k, v in st.items()}
                          for i, st in osd["state"].items()},
                "param_groups": osd["param_groups"]}

    def load_optimizer_state_dict(self, optimizer: torch.optim.Optimizer, osd: dict) -> None:
        """Load the optimizer's whole state dict (the same on every rank);
        under fsdp each rank keeps its own shard of each moment."""
        if self.param_mode == "replicated":
            optimizer.load_state_dict(osd)
            return
        params = list(self.net.parameters())
        state = {i: {k: _shard_like(params[i], v) if v.dim() else v for k, v in st.items()}
                 for i, st in osd["state"].items()}
        optimizer.load_state_dict({"state": state, "param_groups": osd["param_groups"]})


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor that FSDP2 shards on dim 0 gathered whole (every rank
    calls), else t. The shards are padded to one row count and gathered by
    c10d's all_gather_into_tensor, which gloo takes on CUDA tensors, where
    DTensor.full_tensor's functional collectives crash (gloo, an H100)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    if [(p.is_shard(), getattr(p, "dim", None)) for p in t.placements] != [(True, 0)]:
        raise ValueError(f"not a dim-0 shard: {t.placements}")
    group = t.device_mesh.get_group()
    world, n = dist.get_world_size(group), t.shape[0]
    per = -(-n // world)
    local = t.to_local().detach()
    padded = local.new_zeros((per, *local.shape[1:]))
    padded[:len(local)] = local
    out = local.new_empty((world * per, *local.shape[1:]))
    dist.all_gather_into_tensor(out, padded, group=group)
    return out[:n]


def _shard_like(t: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """`full` laid out as `t` is: this rank's shard of it where `t` is a
    DTensor (from the local copy, no collective), else `full` itself."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(t, DTensor):
        return full
    return distribute_tensor(full.to(t.device, t.dtype), t.device_mesh, t.placements,
                             src_data_rank=None)


def loss_through(dp: DataParallel | None, fn, *args):
    """fn(*args), through the data-parallel wrapper where there is one."""
    return fn(*args) if dp is None else dp(fn, *args)


def global_grad_norm(grads: list) -> torch.Tensor:
    """The norm of the whole gradient. Under FSDP the gradients are DTensor
    shards: the squares of the local shards are summed over the ranks."""
    from torch.distributed.tensor import DTensor

    sharded = [isinstance(g, DTensor) for g in grads]
    if not any(sharded):
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    if not all(sharded):
        raise ValueError("some gradients are sharded and some are not")
    sq = torch.stack([(g.to_local().double() ** 2).sum() for g in grads]).sum()
    dist.all_reduce(sq, group=grads[0].device_mesh.get_group())
    return sq.sqrt().float()


def local_part(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (an alias, to update in place), else t."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t
