"""Spatial (height) sharding of the Darknet19 detector with halo exchange
(port of tensorflow_yolo2_tpu/parallel/spatial.py).

For inputs whose activations outgrow one card, each of N ranks (one
process a rank, ``torchrun --nproc-per-node N``) holds 1/N of the rows
of every feature map:

- a 3×3/1 conv needs one boundary row from each neighbour:
  ``halo_exchange`` fetches them with ``dist.batch_isend_irecv``; the end
  ranks receive zeros, which is SAME's zero padding;
- a 3×3/2 conv (``downsample="stride"``) needs only the next neighbour's
  first row (SAME at stride 2 pads low 0, high 1);
- a 2×2/2 max pool never crosses a shard boundary while shard heights
  stay even (H = 32·rows), and a 1×1 conv is local.

The structure comes from the model's own schedule
(``models.darknet._DARKNET19_SCHEDULE`` through ``backbone_plan``), so
every trunk (pool or stride) and head (the v1 grid, the plain v2 anchor
head, the v2 passthrough/reorg head) runs sharded. Rank 0 of the group
holds the batch; its rows go to the ranks by ``dist.scatter``.
``spatial_detector_fn`` serves BN-folded weights
(``models.fold.fold_params``) and all-gathers the grid;
``spatial_yolo_loss_fn`` trains with frozen BN; ``spatial_yolo_train_fn``
and ``spatial_yolo_v2_train_fn`` train with live BatchNorm whose
statistics are summed over the group (``models.layers.
synced_batch_stats``), padding the rows up to a multiple of 32·N where
H is not one and masking the padding rows in every layer. Their steps
backpropagate each rank's own loss term and all-reduce (sum) the
gradients: the autograd collectives' backward already sums the other
ranks' terms through the shared statistics and halos, so a loss
all-reduced before the backward would give N times the gradient.

Pools go through ``models.layers.max_pool``: a recorded gradient takes
the CUDA kernel B5 on the card. Parameters are the port's state-dict
names (``backbone.conv1.conv.weight``, ...).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tensorflow_yolo2_torch.config import yolo_grid_offset
from tensorflow_yolo2_torch.models.darknet import _DARKNET19_SCHEDULE
from tensorflow_yolo2_torch.models.layers import (
    BN_EPSILON,
    leaky_relu,
    max_pool,
    space_to_depth,
    synced_batch_stats,
)
from tensorflow_yolo2_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_tensors,
    world_size,
)
from tensorflow_yolo2_torch.utils.device import device_normalize

Params = Mapping[str, torch.Tensor]


def backbone_plan(downsample: str = "pool") -> tuple:
    """The trunk as spatial ops, from the model's own schedule:
    ``("conv", name, k, stride)``, ``("pool",)``, and ``("mid",)`` marking
    the (H/16, 512) passthrough source (the map that feeds the last
    downsample)."""
    if downsample not in ("pool", "stride"):
        raise ValueError(f"downsample must be 'pool' or 'stride', got "
                         f"{downsample!r}")
    ops = []
    conv_i = 0
    pool_i = 0
    n_pools = sum(1 for item in _DARKNET19_SCHEDULE if item == "M")
    pending_stride = False
    for item in _DARKNET19_SCHEDULE:
        if item == "M":
            pool_i += 1
            if pool_i == n_pools:
                ops.append(("mid",))
            if downsample == "pool":
                ops.append(("pool",))
            else:
                pending_stride = True  # every "M" precedes a 3×3 conv
        else:
            k, _ = item
            conv_i += 1
            ops.append(("conv", f"conv{conv_i}", k,
                        2 if pending_stride else 1))
            pending_stride = False
    return tuple(ops)


def spatial_mesh(n: int, axis: str = "spatial") -> DeviceMesh:
    """The 1-D mesh of the ``n`` ranks of a spatial run. The process group
    must hold exactly ``n`` ranks (``ValueError`` naming the launch
    otherwise): a spatial run never runs unsharded in silence."""
    world = world_size()
    if not dist.is_initialized() or world != n:
        raise ValueError(
            f"--spatial {n} runs one process a shard: start it with "
            f"torchrun --nproc-per-node {n} (this run has {world} "
            f"process{'es' if world != 1 else ''}"
            f"{'' if dist.is_initialized() else ' and no process group'})")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.arange(n), mesh_dim_names=(axis,))


def _fmt(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last
            if x.dim() == 4 and not x.is_contiguous() and
            x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def _exchange(up: torch.Tensor, down: torch.Tensor, group
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Send ``up`` to the previous rank and ``down`` to the next (both
    contiguous); return (what the previous rank sent down, what the next
    rank sent up), zeros at the ends."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    from_prev = torch.zeros_like(down, memory_format=torch.contiguous_format)
    from_next = torch.zeros_like(up, memory_format=torch.contiguous_format)
    ops = []
    if r > 0:
        prev = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, up, prev, group),
                dist.P2POp(dist.irecv, from_prev, prev, group)]
    if r < n - 1:
        nxt = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, down, nxt, group),
                dist.P2POp(dist.irecv, from_next, nxt, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """x (B, C, h, W) → (B, C, halo + h + halo, W): the previous rank's
    last ``halo`` rows above, the next rank's first below. Backward sends
    the halo rows' gradients back to their owners, who add them to the
    rows they sent."""

    @staticmethod
    def forward(ctx, x, group, halo):
        ctx.group, ctx.halo = group, halo
        from_prev, from_next = _exchange(x[:, :, :halo].contiguous(),
                                         x[:, :, -halo:].contiguous(), group)
        return torch.cat([from_prev, x, from_next], dim=2).contiguous(
            memory_format=_fmt(x))

    @staticmethod
    def backward(ctx, grad):
        h = ctx.halo
        dx = grad[:, :, h:-h].contiguous(memory_format=_fmt(grad))
        # our first rows' gradient comes from the previous rank's lower
        # halo, our last rows' from the next rank's upper halo
        from_prev, from_next = _exchange(grad[:, :, :h].contiguous(),
                                         grad[:, :, -h:].contiguous(),
                                         ctx.group)
        dx[:, :, :h] += from_prev
        dx[:, :, -h:] += from_next
        return dx, None, None


def halo_exchange(x: torch.Tensor, group, halo: int = 1) -> torch.Tensor:
    """Concatenate ``halo`` boundary rows from the up/down neighbours to an
    NCHW H-shard; the end ranks receive zeros (SAME's zero padding).
    Differentiable."""
    return _HaloExchange.apply(x, group, halo)


def _conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          h_valid: bool, stride: int = 1) -> torch.Tensor:
    """NCHW conv, SAME on W, VALID (``h_valid``) or SAME on H, stride 1
    or 2; at stride 2 W pads (0, 1), XLA's SAME for an even W."""
    kh, kw = weight.shape[-2:]
    pad_h = 0 if h_valid else (kh - 1) // 2
    if stride == 1:
        return F.conv2d(x, weight, bias, padding=(pad_h, (kw - 1) // 2))
    return F.conv2d(F.pad(x, (0, 1, pad_h, pad_h)), weight, bias, stride=2)


def _spatial_conv(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None, group,
                  stride: int = 1) -> torch.Tensor:
    """One conv on an H-shard with the exchange it needs: 3×3/1 → the
    symmetric 1-row halo, then VALID; 3×3/2 → the next rank's first row
    only (the global SAME stride-2 pads low 0 / high 1, so output row t
    reads global rows 2t..2t+2 from the shard's start), VALID over the
    h + 1 rows; 1×1 → local."""
    if weight.shape[-2] == 1:
        return _conv(x, weight, bias, h_valid=False)
    xh = halo_exchange(x, group)
    if stride == 1:
        return _conv(xh, weight, bias, h_valid=True)
    return _conv(xh[:, :, 1:], weight, bias, h_valid=True, stride=2)


def _folded(params: Params, name: str, x: torch.Tensor, group,
            stride: int = 1) -> torch.Tensor:
    return _spatial_conv(x, params[f"{name}.conv.weight"],
                         params[f"{name}.conv.bias"], group, stride)


def _sharded_trunk(params: Params, x: torch.Tensor, group,
                   downsample: str = "pool", want_mid: bool = False):
    """The folded Darknet19 trunk on one NCHW H-shard; ``want_mid`` also
    returns the (H/16, 512) passthrough map."""
    mid = None
    for op in backbone_plan(downsample):
        if op[0] == "mid":
            mid = x
            continue
        if op[0] == "pool":
            x = max_pool(x)
            continue
        _, name, _, stride = op
        x = leaky_relu(_folded(params, f"backbone.{name}", x, group, stride))
    return (x, mid) if want_mid else x


def _reorg(p: torch.Tensor) -> torch.Tensor:
    """The passthrough's 2×2 space-to-depth on an NCHW map, in the JAX
    package's channel order; local, since shard heights and starts at
    H/16 are even."""
    return space_to_depth(p.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _sharded_detector(params: Params, x: torch.Tensor, group,
                      bn_on_output: bool, downsample: str = "pool",
                      head: str = "v1") -> torch.Tensor:
    """The folded detector (trunk + head) on one NCHW H-shard → its rows
    of the NHWC float32 grid. ``head="v1"``: 3×(3×3 conv) + 1×1 output,
    leaky on the output with the reference's BN-on-output quirk (without
    it, the plain --v2 anchor head); ``head="v2p"``: the passthrough
    head."""
    if head == "v2p":
        x, mid = _sharded_trunk(params, x, group, downsample, want_mid=True)
        for i in (1, 2):
            x = leaky_relu(_folded(params, f"detection.conv{i}", x, group))
        pt = _reorg(leaky_relu(_folded(params, "detection.passthrough",
                                       mid, group)))
        x = torch.cat([x, pt.to(x.dtype)], dim=1)
        x = leaky_relu(_folded(params, "detection.conv3", x, group))
        x = _folded(params, "detection.output", x, group)
        return x.float().permute(0, 2, 3, 1)
    x = _sharded_trunk(params, x, group, downsample)
    for i in range(1, 4):
        x = leaky_relu(_folded(params, f"detection.conv{i}", x, group))
    x = _folded(params, "detection.output", x, group)
    if bn_on_output:
        x = leaky_relu(x)
    return x.float().permute(0, 2, 3, 1)


_DTYPES = (torch.uint8, torch.float32, torch.float64, torch.bfloat16,
           torch.float16, torch.int32, torch.int64)


def scatter_rows(x: torch.Tensor | None, group, dim: int,
                 device: torch.device) -> torch.Tensor:
    """This rank's block of ``dim`` of the group's rank 0's ``x`` (the
    other ranks pass None): shape and type are broadcast, then the
    equal blocks scattered. With one rank, ``x`` itself."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x.to(device)
    src = dist.get_global_rank(group, 0)
    header = torch.zeros(10, dtype=torch.int64, device=device)
    if r == 0:
        header[0], header[1] = x.dim(), _DTYPES.index(x.dtype)
        header[2:2 + x.dim()] = torch.tensor(x.shape)
    dist.broadcast(header, src, group=group)
    ndim, code, *shape = header.tolist()
    shape = shape[:ndim]
    shape[dim] //= n
    out = torch.empty(shape, dtype=_DTYPES[code], device=device)
    parts = ([p.contiguous() for p in x.to(device).chunk(n, dim)]
             if r == 0 else None)
    dist.scatter(out, parts, src=src, group=group)
    return out


def _check_h(h: int, n: int) -> None:
    if h % (32 * n) != 0:
        raise ValueError(
            f"H={h} must be divisible by 32·{n} for {n}-way spatial "
            "sharding (5 pools of stride 2)")


def _shard_images(images: torch.Tensor | None, group,
                  device: torch.device, dtype: torch.dtype | None = None,
                  pad_to: int | None = None) -> torch.Tensor:
    """Rank 0's NHWC batch → this rank's NCHW rows (``channels_last``),
    uint8 normalized, cast to ``dtype``, zero rows appended up to
    ``pad_to`` first."""
    if dist.get_rank(group) == 0:
        images = device_normalize(torch.as_tensor(images).to(device))
        if dtype is not None:
            images = images.to(dtype)
        if pad_to is not None and pad_to != images.shape[1]:
            images = F.pad(images, (0, 0, 0, 0, 0, pad_to - images.shape[1]))
        else:
            _check_h(images.shape[1], dist.get_world_size(group))
    x = scatter_rows(images, group, 1, device)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _device_of(params: Params) -> torch.device:
    return next(iter(params.values())).device


def _dtype_of(params: Params) -> torch.dtype:
    return next(iter(params.values())).dtype


def spatial_detector_fn(mesh: DeviceMesh, axis: str = "spatial",
                        bn_on_output: bool = True,
                        downsample: str = "pool", head: str = "v1"):
    """The H-sharded detector forward of folded weights: ``forward(folded,
    images)`` → the (B, S, S, cc) float32 grid, all-gathered on every
    rank. ``images`` (NHWC, float in [-1, 1] or uint8; H % 32·N == 0) is
    rank 0's, the other ranks pass None; they compute in ``folded``'s
    type. Covers ``head="v1"`` (``bn_on_output`` True: the reference
    quirk head; False: the plain --v2 anchor head) and ``head="v2p"``,
    each with the pool or the stride trunk."""
    if head not in ("v1", "v2p"):
        raise ValueError(f"unknown spatial head {head!r}")
    group = mesh.get_group(axis)

    def forward(folded: Params, images: torch.Tensor | None
                ) -> torch.Tensor:
        w = next(iter(folded.values()))
        x = _shard_images(images, group, w.device, w.dtype)
        grid = _sharded_detector(folded, x, group, bn_on_output,
                                 downsample, head)
        return all_gather_rows(grid, group, dim=1)  # (B, S, S, cc)

    return forward


def spatial_backbone_fn(mesh: DeviceMesh, axis: str = "spatial",
                        downsample: str = "pool"):
    """The H-sharded folded trunk: ``forward(folded, images)`` → the NHWC
    (B, H/32, W/32, 1024) map, all-gathered; images as in
    ``spatial_detector_fn``."""
    group = mesh.get_group(axis)

    def forward(folded: Params, images: torch.Tensor | None
                ) -> torch.Tensor:
        w = next(iter(folded.values()))
        x = _shard_images(images, group, w.device, w.dtype)
        y = _sharded_trunk(folded, x, group, downsample)
        return all_gather_rows(y.permute(0, 2, 3, 1), group, dim=1)

    return forward


def _offsets(cfg, rows_padded: int, r: int, rows: int,
             device: torch.device):
    """This shard's (column, row) index grids, (rows, S, B), with global
    row indices; rows past S (padding) are 0."""
    off = torch.zeros((rows_padded, cfg.S, cfg.B), dtype=torch.float32)
    off_t = torch.zeros_like(off)
    grid = torch.from_numpy(yolo_grid_offset(cfg.S, cfg.B)).float()
    off[:cfg.S] = grid
    off_t[:cfg.S] = grid.permute(1, 0, 2)
    sl = slice(r * rows, (r + 1) * rows)
    return off[sl].to(device), off_t[sl].to(device)


def _sum_grads(local: torch.Tensor, params: Params, group
               ) -> dict[str, torch.Tensor]:
    """The gradients of the sum of every rank's ``local`` term: this
    rank's backward, then their all-reduce (sum)."""
    names = [k for k, p in params.items() if p.requires_grad]
    return all_reduce_tensors(dict(zip(names, torch.autograd.grad(
        local, [params[k] for k in names]))), group)


def _sum_scalar(local: torch.Tensor, group) -> torch.Tensor:
    total = local.detach().clone()
    dist.all_reduce(total, group=group)
    return total


def _check_grid(images: torch.Tensor, labels: torch.Tensor, cfg,
                per_slot: bool) -> None:
    """The images must map to cfg's S×S grid and the labels be that grid:
    a mismatch would broadcast label rows across grid rows."""
    if images.shape[1] != 32 * cfg.S or images.shape[2] != 32 * cfg.S:
        raise ValueError(
            f"images {images.shape[1]}×{images.shape[2]} do not map to "
            f"cfg's S={cfg.S} grid — expected {32 * cfg.S}×{32 * cfg.S}")
    if per_slot:
        if labels.dim() != 5 or tuple(labels.shape[1:4]) != \
                (cfg.S, cfg.S, cfg.B):
            raise ValueError(
                f"labels must be the per-slot (b, {cfg.S}, {cfg.S}, "
                f"{cfg.B}, 5+C) grid, got {tuple(labels.shape)}")
    elif tuple(labels.shape[1:3]) != (cfg.S, cfg.S):
        raise ValueError(f"labels grid {tuple(labels.shape[1:3])} != "
                         f"(S, S) = ({cfg.S}, {cfg.S})")


def spatial_yolo_loss_fn(mesh: DeviceMesh, cfg, axis: str = "spatial",
                         bn_on_output: bool = True,
                         downsample: str = "pool"):
    """The H-sharded YOLOv1 loss of folded weights (frozen BN):
    ``loss_fn(folded, images, labels)`` → (loss, gradients by name of the
    parameters that require one), both the unsharded loss's, on every
    rank. Each rank owns S/N grid rows and their label rows and sums its
    terms with global row offsets (``losses.yolo.yolo_loss_term_sums``).
    ``images`` / ``labels`` are rank 0's (others pass None); H % 32·N
    == 0 and S % N == 0."""
    from tensorflow_yolo2_torch.losses.yolo import yolo_loss_term_sums

    group = mesh.get_group(axis)
    n, r = mesh.size(), dist.get_rank(group)
    if cfg.S % n:
        raise ValueError(f"S={cfg.S} must be divisible by the {n}-way "
                         "spatial axis")
    rows = cfg.S // n

    def loss_fn(folded: Params, images, labels):
        device = _device_of(folded)
        if r == 0:
            images, labels = torch.as_tensor(images), torch.as_tensor(labels)
            _check_grid(images, labels, cfg, per_slot=False)
            labels = labels.to(device, torch.float32)
        x = _shard_images(images, group, device, _dtype_of(folded))
        lab = scatter_rows(labels, group, 1, device)
        grid = _sharded_detector(folded, x, group, bn_on_output, downsample)
        offsets = _offsets(cfg, cfg.S, r, rows, device)
        class_s, object_s, noobject_s, coord_s, _, _ = yolo_loss_term_sums(
            grid, lab, cfg, offsets=offsets)
        local = torch.mean(class_s + object_s + noobject_s + coord_s)
        return _sum_scalar(local, group), _sum_grads(local, folded, group)

    return loss_fn


def _row_mask(h_local: int, group, valid_h: int,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """(h_local,) mask of this shard's globally valid rows: row t of rank
    i is global row i·h_local + t; rows ≥ ``valid_h`` are padding."""
    rows = dist.get_rank(group) * h_local + torch.arange(h_local,
                                                         device=device)
    return (rows < valid_h).to(dtype)


def _live_conv_bn(x, params: Params, name: str, group, eps: float,
                  valid_h: int, stats_out: dict, activate: bool = True,
                  stride: int = 1) -> torch.Tensor:
    """One ConvBN (conv + bias → BatchNorm on the group's statistics →
    leaky → padding rows re-zeroed) on an H-shard. ``valid_h`` is the
    valid height after the conv. Records the layer's batch mean and
    (biased) variance in ``stats_out`` under its running-statistic names.
    Zeroing the padding rows after the activation makes the next halo
    deliver what SAME's padding gives the unsharded net."""
    x = _folded(params, name, x, group, stride)
    n, h_local = dist.get_world_size(group), x.shape[2]
    mask = (_row_mask(h_local, group, valid_h, x.device, x.dtype)
            .view(1, 1, -1, 1) if valid_h != h_local * n else None)
    count = float(x.shape[0] * valid_h * x.shape[3])
    mean, var = synced_batch_stats(x, group, count=count, mask=mask)
    c = x.shape[1]
    x = ((x - mean.view(1, c, 1, 1)) *
         (params[f"{name}.bn.weight"] * torch.rsqrt(var + eps))
         .view(1, c, 1, 1) + params[f"{name}.bn.bias"].view(1, c, 1, 1))
    stats_out[f"{name}.bn.running_mean"] = mean
    stats_out[f"{name}.bn.running_var"] = var
    if activate:
        x = leaky_relu(x)
    return x if mask is None else x * mask


def _mask_rows(x: torch.Tensor, group, valid_h: int) -> torch.Tensor:
    n, h_local = dist.get_world_size(group), x.shape[2]
    if valid_h == h_local * n:
        return x
    return x * _row_mask(h_local, group, valid_h, x.device,
                         x.dtype).view(1, 1, -1, 1)


def _sharded_detector_live(params: Params, x: torch.Tensor, group,
                           valid_h: int, eps: float, bn_on_output: bool,
                           stats_out: dict, downsample: str = "pool",
                           head: str = "v1") -> torch.Tensor:
    """The UNFOLDED detector with live BatchNorm on one NCHW H-shard →
    its rows of the NHWC float32 grid; ``valid_h`` is the un-padded input
    height, ``stats_out`` collects every BatchNorm's batch statistics.
    ``head="v1"`` is the 3-conv grid/anchor head (``bn_on_output``: the
    reference quirk vs the plain --v2 linear output); ``head="v2p"`` the
    passthrough head, whose H/16 shard height 2·Sp/N is even, so the
    reorg stays local."""
    vh = valid_h
    mid = vh_mid = None
    for op in backbone_plan(downsample):
        if op[0] == "mid":
            if head == "v2p":
                mid, vh_mid = x, vh
            continue
        if op[0] == "pool":
            x = max_pool(x)
            vh = (vh + 1) // 2
            # a pool window inside the padding maxes zeros to zero
            # already; keep it exact
            x = _mask_rows(x, group, vh)
            continue
        _, name, _, stride = op
        if stride == 2:
            vh = (vh + 1) // 2  # SAME stride-2 valid height (pad-low 0)
        x = _live_conv_bn(x, params, f"backbone.{name}", group, eps, vh,
                          stats_out, stride=stride)
    if head == "v2p":
        for i in (1, 2):
            x = _live_conv_bn(x, params, f"detection.conv{i}", group, eps,
                              vh, stats_out)
        pt = _live_conv_bn(mid, params, "detection.passthrough", group, eps,
                           vh_mid, stats_out)
        # padding mid rows (zeroed above) land on padding grid rows
        x = torch.cat([x, _reorg(pt).to(x.dtype)], dim=1)
        x = _live_conv_bn(x, params, "detection.conv3", group, eps, vh,
                          stats_out)
        x = _mask_rows(_folded(params, "detection.output", x, group),
                       group, vh)
        return x.float().permute(0, 2, 3, 1)
    for i in range(1, 4):
        x = _live_conv_bn(x, params, f"detection.conv{i}", group, eps, vh,
                          stats_out)
    if bn_on_output:
        x = _live_conv_bn(x, params, "detection.output", group, eps, vh,
                          stats_out)
    else:
        x = _mask_rows(_folded(params, "detection.output", x, group),
                       group, vh)
    return x.float().permute(0, 2, 3, 1)


def _moving_average(batch_stats: Params, new: dict, momentum: float
                    ) -> dict[str, torch.Tensor]:
    return {k: momentum * batch_stats[k] + (1 - momentum) * v.detach()
            for k, v in new.items()}


def _live_setup(mesh: DeviceMesh, cfg, axis: str):
    group = mesh.get_group(axis)
    n = mesh.size()
    sp = -(-cfg.S // n) * n  # grid rows padded to a multiple of N
    return group, n, dist.get_rank(group), sp, sp // n


def _shard_labels(labels, group, sp: int, cfg, device: torch.device
                  ) -> torch.Tensor:
    """Rank 0's label grid, zero rows appended up to ``sp``, → this
    rank's rows (float32)."""
    if dist.get_rank(group) == 0:
        labels = torch.as_tensor(labels).to(device, torch.float32)
        if sp != cfg.S:
            pad = [0, 0] * (labels.dim() - 2) + [0, sp - cfg.S]
            labels = F.pad(labels, pad)
    return scatter_rows(labels, group, 1, device)


def spatial_yolo_train_fn(mesh: DeviceMesh, cfg, axis: str = "spatial",
                          bn_on_output: bool = True,
                          bn_momentum: float = 0.99,
                          bn_epsilon: float = BN_EPSILON,
                          downsample: str = "pool"):
    """H-sharded YOLOv1 training with LIVE BatchNorm: train-mode
    statistics summed over the group (the unsharded batch's) and the
    moving-average update. Any H = 32·S: the input is padded with zero
    rows up to 32·Sp (Sp the next multiple of N) and every layer
    re-masks the padding, so S % N need not be 0.

    Returns ``step_fn(params, batch_stats, images, labels) → (loss,
    gradients, new_batch_stats)`` on the unfolded detector's parameters
    and running statistics by state-dict name (``dict(model.
    named_parameters())``); the gradients are of the parameters that
    require one. All three are the same on every rank. ``images`` /
    ``labels`` are rank 0's; the other ranks pass None."""
    from tensorflow_yolo2_torch.losses.yolo import yolo_loss_term_sums

    group, n, r, sp, rows = _live_setup(mesh, cfg, axis)

    def step_fn(params: Params, batch_stats: Params, images, labels):
        device = _device_of(params)
        if r == 0:
            images, labels = torch.as_tensor(images), torch.as_tensor(labels)
            _check_grid(images, labels, cfg, per_slot=False)
        x = _shard_images(images, group, device, _dtype_of(params),
                          pad_to=32 * sp)
        lab = _shard_labels(labels, group, sp, cfg, device)
        new_stats: dict = {}
        grid = _sharded_detector_live(params, x, group, 32 * cfg.S,
                                      bn_epsilon, bn_on_output, new_stats,
                                      downsample)
        class_s, object_s, noobject_s, coord_s, _, _ = yolo_loss_term_sums(
            grid, lab, cfg, offsets=_offsets(cfg, sp, r, rows, device))
        local = torch.mean(class_s + object_s + noobject_s + coord_s)
        return (_sum_scalar(local, group), _sum_grads(local, params, group),
                _moving_average(batch_stats, new_stats, bn_momentum))

    return step_fn


def spatial_yolo_v2_train_fn(mesh: DeviceMesh, cfg, axis: str = "spatial",
                             bn_momentum: float = 0.99,
                             bn_epsilon: float = BN_EPSILON,
                             downsample: str = "pool", head: str = "v2"):
    """H-sharded YOLOv2 anchor-loss training with live BatchNorm, as
    ``spatial_yolo_train_fn``. The ignore test needs every ground-truth
    box of the image: one all-gather of the (small) label boxes over the
    group gives it (``losses.yolo_v2.yolo_v2_loss``'s ``ignore_gt``), and
    ``noobj_valid`` takes the padding rows out of the no-object term.
    ``head`` is ``"v2"`` (the linear anchor head) or ``"v2p"`` (the
    passthrough head). Returns ``step_fn(params, batch_stats, images,
    labels, step) → (loss, gradients, new_batch_stats)``; labels are the
    per-slot (b, S, S, B, 5+C) grid, ``step`` the optimizer's step count
    (the burn-in)."""
    from tensorflow_yolo2_torch.losses.yolo_v2 import yolo_v2_loss

    if not (cfg.per_slot_classes and cfg.anchors):
        raise ValueError("spatial v2 training needs the per-slot anchor "
                         "config")
    if head not in ("v2", "v2p"):
        raise ValueError(f"unknown spatial v2 head {head!r}")
    group, n, r, sp, rows = _live_setup(mesh, cfg, axis)

    def step_fn(params: Params, batch_stats: Params, images, labels,
                step):
        device = _device_of(params)
        if r == 0:
            images, labels = torch.as_tensor(images), torch.as_tensor(labels)
            _check_grid(images, labels, cfg, per_slot=True)
        x = _shard_images(images, group, device, _dtype_of(params),
                          pad_to=32 * sp)
        lab = _shard_labels(labels, group, sp, cfg, device)
        new_stats: dict = {}
        grid = _sharded_detector_live(params, x, group, 32 * cfg.S,
                                      bn_epsilon, False, new_stats,
                                      downsample, head=head)
        b = lab.shape[0]
        # the whole image's boxes (padding rows have owner 0)
        gather = lambda v: all_gather_rows(v[None], group, 0).movedim(0, 1)
        gt_all = gather(lab[..., 1:5] / float(cfg.image_size)).reshape(
            b, -1, 4)
        gt_valid = gather(lab[..., 0]).reshape(b, -1)
        noobj_valid = (None if sp == cfg.S else _row_mask(
            rows, group, cfg.S, device, grid.dtype).view(1, -1, 1, 1))
        local, _ = yolo_v2_loss(grid, lab, cfg, step=step,
                                offsets=_offsets(cfg, sp, r, rows, device),
                                ignore_gt=(gt_all, gt_valid),
                                noobj_valid=noobj_valid)
        return (_sum_scalar(local, group), _sum_grads(local, params, group),
                _moving_average(batch_stats, new_stats, bn_momentum))

    return step_fn
