"""Process groups, the (data, model) mesh and the tensor-parallel policy
(port of tensorflow_yolo2_tpu/parallel/mesh.py).

The JAX package runs one controller over N local devices and lets
``jit`` over a ``Mesh`` insert the collectives. Here one process runs
per rank, started by ``torchrun`` (``python -m torch.distributed.run``),
and the collectives are explicit:

- the ``data`` axis: each rank steps on its rows of the global batch;
  ``train.trainer.Trainer`` all-reduces (mean) the gradients over it and
  ``models.layers.BatchNorm`` takes its statistics over it;
- the ``model`` axis: a weight of rank ≥ 2 whose output dimension is at
  least 512 and divides by the axis is sharded on that dimension
  (``param_spec``, the JAX package's policy on the torch layout). Its
  conv or dense layer computes its slice of the output channels and
  all-gathers them (``apply_tensor_parallel``: Megatron's column-parallel
  pair of autograd functions, ``copy_to_group`` and
  ``gather_from_group``).

Without a launcher's environment no process group is made
(``maybe_initialize_distributed`` returns False), ``make_mesh_for_batch``
returns None, and every caller runs as a single process.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

TIMEOUT_ENV = "TFY2_DIST_TIMEOUT"  # seconds a collective may wait
DEFAULT_TIMEOUT_S = 1800
_LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")
_IDLE_TIMEOUT = datetime.timedelta(days=7)  # surplus ranks wait this long


def timeout() -> datetime.timedelta:
    """The process group's timeout: ``$TFY2_DIST_TIMEOUT`` seconds, else
    30 minutes. Finite, so that a rank whose peer died fails instead of
    hanging."""
    return datetime.timedelta(
        seconds=float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S)))


def maybe_initialize_distributed(device: str | torch.device | None = None
                                 ) -> bool:
    """Start the default process group from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``): NCCL on ``cuda`` (the default device, as the
    entries'), with this process on ``cuda:LOCAL_RANK``; gloo on the CPU.
    Returns whether it started a group: False without the launcher's
    variables, or when a group exists already (the caller's)."""
    if dist.is_initialized() or \
            not all(k in os.environ for k in _LAUNCHER_ENV):
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=timeout())
    return True


def world_size() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


@dataclass(frozen=True)
class MeshConfig:
    """Mesh shape: data × model. ``data=None`` → all remaining ranks."""

    data: int | None = None
    model: int = 1


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(cfg: MeshConfig = MeshConfig()) -> DeviceMesh | None:
    """A ('data', 'model') ``DeviceMesh`` over the first data·model ranks,
    data the outer axis, so that a rank's model group holds adjacent
    ranks. Every rank calls it (making the groups is collective); the
    ranks beyond the mesh get no coordinate (``in_mesh``) and wait in
    ``idle`` until the mesh's ranks call ``release_idle``. Without a
    process group a 1×1 mesh is None (one process) and any other shape
    raises, as the JAX package's mesh on one device does."""
    world = world_size()
    model = cfg.model
    data = cfg.data if cfg.data is not None else world // model
    n = data * model
    if n > world or n < 1:
        raise ValueError(
            f"mesh {data}x{model} needs {n} devices, have {world}" +
            ("" if dist.is_initialized() else
             f" (start one process a device: torchrun --nproc-per-node "
             f"{n} -m <entry> ...)"))
    if not dist.is_initialized():
        return None
    mesh = DeviceMesh(_device_type(), torch.arange(n).reshape(data, model),
                      mesh_dim_names=("data", "model"))
    # the surplus ranks' wait and its release run on a group of their own
    # with a long timeout: they idle for the whole run
    mesh.idle_group = (dist.new_group(timeout=_IDLE_TIMEOUT)
                       if n < world else None)
    return mesh


def mesh_shape_for_batch(batch_size: int, model: int = 1,
                         world: int = 1) -> tuple[int, int]:
    """The rule of ``make_mesh_for_batch``: data is the largest rank
    count that divides the batch, at most world/model."""
    limit = max(1, world // model)
    data = max(d for d in range(1, limit + 1) if batch_size % d == 0)
    if data < limit and batch_size > limit:
        # batch coprime with the device count: this is a silent slowdown,
        # not a small-batch run — say so instead of idling chips quietly
        print(f"make_mesh_for_batch: batch {batch_size} only shards over "
              f"{data}/{limit} devices; pick a batch divisible by {limit} "
              "to use the full mesh")
    return data, model


def make_mesh_for_batch(batch_size: int, model: int = 1
                        ) -> DeviceMesh | None:
    """The mesh whose data axis is the largest rank count dividing the
    batch (``mesh_shape_for_batch``): small-batch runs leave surplus
    ranks idle instead of failing to shard. None without a process group
    (``make_mesh``)."""
    data, model = mesh_shape_for_batch(batch_size, model, world_size())
    return make_mesh(MeshConfig(data=data, model=model))


def in_mesh(mesh: DeviceMesh | None) -> bool:
    """Whether this process takes steps: True without a mesh."""
    return mesh is None or mesh.get_coordinate() is not None


def idle(mesh: DeviceMesh) -> int:
    """A surplus rank's run: no step, a wait until the mesh is done
    (``release_idle``), exit status 0."""
    print(f"rank {dist.get_rank()}: outside the {mesh.size(0)}x"
          f"{mesh.size(1)} mesh, idle until the run ends")
    dist.barrier(group=mesh.idle_group)
    return 0


def release_idle(mesh: DeviceMesh | None) -> None:
    """The mesh's side of ``idle``: every rank of the mesh calls it when
    the run is done."""
    if mesh is not None and mesh.idle_group is not None:
        dist.barrier(group=mesh.idle_group)


def group_barrier(*groups) -> None:
    """A barrier over every rank of the groups' union where the groups
    are a mesh's axes (a barrier over each in turn: after the second,
    every rank knows that every rank reached the first)."""
    for g in groups:
        dist.barrier(group=g)


# -- autograd collectives ------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; its gradient is the sum of the ranks' gradients
    (every rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce (sum) of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; all-reduce (sum) of the gradient backward: the
    input of a column-parallel layer, whose ranks each give the input
    gradient of their output slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


class _GatherFromGroup(torch.autograd.Function):
    """All-gather of equal slices along ``dim``, in rank order; backward
    keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        size = grad.shape[ctx.dim] // n
        return grad.narrow(ctx.dim, r * size, size).contiguous(), None, None


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFromGroup.apply(x, group, dim)


def all_reduce_tensors(tensors: Mapping[str, torch.Tensor], group,
                       divisor: int = 1) -> dict[str, torch.Tensor]:
    """The tensors summed over ``group`` and divided by ``divisor`` (no
    gradient): one all-reduce a dtype over them flattened; each result
    keeps its tensor's memory layout."""
    out = dict(tensors)
    by_dtype: dict[torch.dtype, list[str]] = {}
    for k, t in tensors.items():
        by_dtype.setdefault(t.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([tensors[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat /= divisor
        for k, part in zip(keys, flat.split([tensors[k].numel()
                                             for k in keys])):
            out[k] = torch.empty_like(tensors[k]).copy_(
                part.view(tensors[k].shape))
    return out


def all_gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` (no gradient)."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


# -- parameter sharding policy -------------------------------------------------

# Shard a weight over 'model' when its output dim is at least this big;
# smaller tensors are cheaper to replicate than to gather.
_MIN_SHARD_DIM = 512


def param_spec(shape: tuple[int, ...], model_axis_size: int) -> int | None:
    """Tensor-parallel spec of one parameter: the dimension sharded over
    'model', or None (replicated).

    A weight of rank ≥ 2 is sharded on its output dimension, dim 0 of a
    conv's (O, I, kh, kw) and of a ``Linear``'s (out, in) (the JAX
    package's last dim of HWIO / (in, out)), when that dimension is
    ≥ 512 and divisible by the axis; 1-D parameters are replicated."""
    if model_axis_size <= 1 or len(shape) < 2:
        return None
    out_dim = shape[0]
    if out_dim >= _MIN_SHARD_DIM and out_dim % model_axis_size == 0:
        return 0
    return None


def shard_params(params: Mapping[str, torch.Tensor],
                 mesh: DeviceMesh) -> dict[str, int | None]:
    """``param_spec`` of every parameter by name, for ``mesh``'s model
    axis."""
    model_size = mesh.size(1)
    return {k: param_spec(tuple(v.shape), model_size)
            for k, v in params.items()}


def _column_parallel_forward(module: nn.Module, x: torch.Tensor
                             ) -> torch.Tensor:
    """A conv or dense layer whose weight holds this rank's slice of the
    output channels: the slice's outputs (without the bias), all-gathered
    along the channels, then the full (replicated) bias."""
    group, n = module.tp_group, module.tp_size
    x = copy_to_group(x, group)
    w = module.weight
    if isinstance(module, nn.Linear):
        y = gather_from_group(torch.nn.functional.linear(x, w), group, -1)
        return y if module.bias is None else y + module.bias
    if hasattr(module, "pad_input"):  # layers.SameConv2d
        x = module.pad_input(x)
    groups = module.groups
    if groups > 1:  # the slice of the groups whose outputs it computes
        per = x.shape[1] // n
        x = x.narrow(1, dist.get_rank(group) * per, per)
        groups //= n
    y = torch.nn.functional.conv2d(x, w, None, module.stride, module.padding,
                                   module.dilation, groups)
    y = gather_from_group(y, group, 1)
    return y if module.bias is None else y + module.bias.view(1, -1, 1, 1)


def apply_tensor_parallel(model: nn.Module, mesh: DeviceMesh
                          ) -> dict[str, int]:
    """Shard ``model``'s parameters over ``mesh``'s model axis in place
    (``shard_params``): each sharded weight is replaced by this rank's
    slice of dim 0 (a new parameter with the old one's
    ``requires_grad``) and its layer computes column-parallel. Returns
    {name: full size of dim 0} of the sharded parameters. Only ``Conv2d``
    (a grouped one when its groups divide by the axis) and ``Linear``
    weights are sharded; another sharded parameter raises."""
    group = mesh.get_group("model")
    n, r = mesh.size(1), dist.get_rank(group)
    specs = shard_params(dict(model.named_parameters()), mesh)
    sharded: dict[str, int] = {}
    for name, spec in specs.items():
        if spec is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        conv = isinstance(owner, nn.Conv2d)
        if leaf != "weight" or not (conv or isinstance(owner, nn.Linear)) \
                or (conv and owner.groups > 1 and owner.groups % n):
            raise NotImplementedError(
                f"tensor parallelism shards conv and dense weights; "
                f"{name} ({type(owner).__name__}) is not one")
        full = owner.weight
        size = full.shape[0] // n
        with torch.no_grad():
            part = full.narrow(0, r * size, size).clone()
        owner.weight = nn.Parameter(part, requires_grad=full.requires_grad)
        owner.tp_group, owner.tp_size = group, n
        owner.forward = _column_parallel_forward.__get__(owner)
        sharded[name] = full.shape[0]
    return sharded
