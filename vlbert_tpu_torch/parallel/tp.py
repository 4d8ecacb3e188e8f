"""Tensor parallelism: TPU.PARTITION_MODE ``tp`` over a [data, model] mesh
of ranks, one card a rank (port of vlbert_tpu/parallel/mesh.py:123
``param_sharding_rules`` and the tp branch of
vlbert_tpu/training/loop.py:266-281).

    torchrun --nproc_per_node N -m vlbert_tpu_torch.engine.train --dist \\
        --task vqa --cfg cfgs/vqa/base_v5e_bf16.yaml \\
        TPU.PARTITION_MODE tp TPU.MESH_SHAPE '[d,m]' \\
        TPU.MESH_AXES '[data,model]'

The JAX package places its train state by ``param_sharding_rules`` and
lets XLA insert the collectives; its step computes what the one-process
step on the global batch computes. The port writes the collectives by
hand, as Megatron-LM does (column- and row-parallel linears):

- rank r sits at data index r // m and model index r % m (``Mesh``, the
  row-major layout of mesh.py:24-31); the m ranks of a data index are a
  model group, and read the same rows; the d ranks of a model index are a
  data group;
- each ``BertLayer`` keeps its rank's rows of the query, key, value and
  intermediate weights and biases (the JAX rule's output-dim split) and
  its columns of the two output dense weights (the input-dim split); its
  self-attention runs H/m heads, heads model_index·H/m .. of H, and K3/K4
  draw those heads' dropout masks as one process does (``head_offset``,
  ``heads_total``); everything else is replicated;
- ``copy_to_model`` before a column-parallel linear (identity forward,
  the input gradient summed over the model group backward) and
  ``reduce_from_model`` after a row-parallel one (the partial products
  summed over the model group forward, in fp32, before the bias; identity
  backward) keep every activation outside a layer's split region, and its
  gradient, whole on the m ranks;
- ``shard_module`` attaches the ``TensorParallel`` partition
  (``dist.partition_of``): the split gradients are averaged over the data
  group and the replicated ones over every rank, so that the replicated
  parameters stay equal on the m ranks whatever a kernel's order of
  additions (``reduce_gradients_``); the losses' data-dependent counts
  and the metrics are summed over the data group (``data_axis``); the
  global norm counts a split gradient's square sum once over the model
  group (``norm``); a checkpoint gathers the split tensors over the model
  group into the file a ``dp`` run writes (``full_state``,
  ``load_full_state_``).

The collectives are plain c10d calls, over NCCL or gloo, so two ranks can
share one card over gloo. Nothing falls back: a collective that fails
raises. Serving runs on one card. PARTITION_MODE fsdp on a mesh with a
model axis runs this split first and then FSDP2 over each data group
(``parallel/fsdp.py``), on the groups of the same ``make_mesh``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from vlbert_tpu_torch.parallel import dist as dist_lib

# the weights split on their output dim (rows of a torch [out, in]
# weight, and the bias) and on their input dim (columns; the bias is
# replicated and added once), the JAX rule's COL and ROW names
_COLUMN = ("attention.self.query", "attention.self.key",
           "attention.self.value", "intermediate.dense")
_ROW = ("attention.output.dense", "output.dense")


class Mesh(NamedTuple):
    """The [data, model] mesh seen from one rank: the axes' sizes, the
    rank's indices, its two process groups and the ``DeviceMesh`` they
    come from (over which fsdp's FSDP2 shards)."""
    d: int
    m: int
    data_index: int
    model_index: int
    model_group: object
    data_group: object
    device_mesh: object = None


def make_mesh(config, device="cpu"):
    """The mesh of TPU.MESH_SHAPE over the default process group's ranks,
    a ``DeviceMesh`` of ``device``'s type with dims ("data", "model"),
    row-major: rank r at (r // m, r % m). Collective: every rank creates
    every group, in one order; tp and fsdp then share these groups."""
    from torch.distributed.device_mesh import init_device_mesh

    rank, world = dist_lib.rank_world()
    d, m = dist_lib.mesh_dims(config, world)
    mesh = init_device_mesh(torch.device(device).type, (d, m),
                            mesh_dim_names=("data", "model"))
    return Mesh(d, m, rank // m, rank % m, mesh.get_group("model"),
                mesh.get_group("data"), mesh)


def _all_reduce(t, group):
    """``t`` summed over ``group``, in place (the model group's one
    collective; chip_smoke times it here)."""
    dist.all_reduce(t, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, group):
    """``x`` (whole on every rank of the model group) as the input of a
    column-parallel linear: the identity forward; backward, the input's
    gradient summed over ``group`` (each rank's holds its heads' share)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """The partial products of a row-parallel linear summed over
    ``group``; backward, the identity (the sum's gradient is each
    rank's)."""
    return _ReduceFromModel.apply(x, group)


def _keep(linear, dim, m, j):
    """Keep part j of m of ``linear``'s weight along ``dim`` (0: rows, and
    the bias's; 1: columns), as new Parameters."""
    w = linear.weight
    n = w.shape[dim] // m
    linear.weight = nn.Parameter(w.detach().narrow(dim, j * n, n).clone(),
                                 requires_grad=w.requires_grad)
    if dim == 0:
        linear.out_features = n
        if linear.bias is not None:
            b = linear.bias
            linear.bias = nn.Parameter(b.detach()[j * n:(j + 1) * n].clone(),
                                       requires_grad=b.requires_grad)
    else:
        linear.in_features = n


def shard_module(model, mesh):
    """Split each ``BertLayer`` of ``model`` over ``mesh``'s model axis, in
    place: the rank's rows of the column-parallel weights and biases, its
    columns of the row-parallel weights, its heads; attaches the
    ``TensorParallel`` partition. Returns ``model``. Build the optimizer
    and the train step after it (the split layers hold new Parameters);
    call it after the warm starts, which load whole tensors."""
    from vlbert_tpu_torch.models.bert import BertLayer

    m, j = mesh.m, mesh.model_index
    dims = {}
    for prefix, layer in model.named_modules():
        if not isinstance(layer, BertLayer):
            continue
        for dim, names in ((0, _COLUMN), (1, _ROW)):
            for name in names:
                linear = layer.get_submodule(name)
                if getattr(linear, "quantized", False):
                    raise ValueError(f"{prefix}.{name}: tensor parallelism "
                                     f"trains fp32 weights, not int8 ones")
                _keep(linear, dim, m, j)
                dims[f"{prefix}.{name}.weight"] = dim
                if dim == 0 and linear.bias is not None:
                    dims[f"{prefix}.{name}.bias"] = 0
        att = layer.attention.self
        heads = att.num_heads // m
        att.head_offset, att.heads_total = j * heads, att.num_heads
        att.num_heads = heads
        for module in (att, layer.attention.output, layer.intermediate,
                       layer.output):
            module.model_group = mesh.model_group
    if not dims:
        raise ValueError("tensor parallelism found no BertLayer to split")
    model.partition = TensorParallel(mesh, dims)
    return model


class TensorParallel(dist_lib.Replicated):
    """The partition of a module that ``shard_module`` split over ``mesh``:
    ``dims`` maps each split parameter's name (a moment's too) to its
    split dim; every other tensor is replicated. The step reduces over
    the data group; a snapshot or load is collective."""
    collective = True

    def __init__(self, mesh, dims):
        self.mesh, self.dims = mesh, dims

    def split_dim(self, name):
        """The dim along which ``name`` is split, else None."""
        return self.dims.get(name)

    def data_axis(self):
        mesh = self.mesh
        return dist_lib.DataAxis(mesh.data_group, mesh.d, mesh.data_index)

    def full_shape(self, name, t):
        shape, dim = tuple(t.shape), self.split_dim(name)
        if dim is None:
            return shape
        return shape[:dim] + (shape[dim] * self.mesh.m,) + shape[dim + 1:]

    def reduce_gradients_(self, names, grads):
        """A split gradient's mean over the data group; a replicated one's
        over every rank. The m ranks of a model group compute a
        replicated gradient from the same rows, but a kernel that adds
        atomically (a cuDNN convolution's weight gradient, ROIAlign's
        backward) need not give them the same bits: the mean over the
        world is the data group's mean and the same on every rank, so the
        replicated parameters stay equal by construction."""
        split = [g for n, g in zip(names, grads)
                 if self.split_dim(n) is not None]
        whole = [g for n, g in zip(names, grads)
                 if self.split_dim(n) is None]
        dist_lib.all_reduce_mean_(whole)
        if self.mesh.d > 1:
            dist_lib.all_reduce_mean_(split, group=self.mesh.data_group)

    def norm(self, names, tensors):
        """The global norm, fp32: each tensor's square sum, the split
        ones' summed over the model group, the replicated ones counted
        once."""
        sq = torch.stack([torch.linalg.vector_norm(t.to(torch.float32))
                          for t in tensors]).square()
        mask = torch.tensor([self.split_dim(n) is not None for n in names],
                            dtype=torch.bool, device=sq.device)
        part = torch.where(mask, sq, torch.zeros_like(sq)).sum()
        _all_reduce(part, self.mesh.model_group)
        return torch.sqrt(part + torch.where(mask, torch.zeros_like(sq),
                                             sq).sum())

    def _gather(self, t, dim):
        """``t``'s shards over the model group, concatenated along ``dim``
        (collective on the group). Over gloo the shards travel on the
        CPU."""
        mesh = self.mesh
        src = t.detach()
        if dist.get_backend(mesh.model_group) == "gloo":
            src = src.cpu()
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.m)]
        dist.all_gather(parts, src, group=mesh.model_group)
        return torch.cat(parts, dim)

    def full_state(self, names, tensors):
        """Collective on every rank: each tensor of ``tensors`` (named by
        ``names``; the same list, in the same order, on every rank) whole
        and on the CPU, on rank 0; None on the other ranks. The split ones
        are gathered over rank 0's model group, the other data indices
        taking no part; a tensor listed twice (a tied weight) comes back
        as one CPU tensor."""
        rank = dist_lib.rank_world()[0]
        seen, out = {}, []
        for name, t in zip(names, tensors):
            key = (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
            if key not in seen:
                full, dim = t, self.split_dim(name)
                if dim is not None and self.mesh.data_index == 0:
                    full = self._gather(t, dim)
                seen[key] = (full.detach().to("cpu", copy=True)
                             if rank == 0 else None)
            out.append(seen[key])
        return out if rank == 0 else None

    @torch.no_grad()
    def load_full_state_(self, names, targets, full, src=0):
        """Each tensor of ``targets`` (named by ``names``; the same list on
        every rank) becomes its part of the whole tensor at the same place
        in ``full``, rank ``src``'s list (None on the others): collective,
        each whole tensor broadcast from ``src`` and each rank keeping its
        part. A shape that does not match raises ValueError on every
        rank, before any tensor is written."""
        rank = dist_lib.rank_world()[0]
        shapes = [self.full_shape(n, t) for n, t in zip(names, targets)]
        error = None
        if rank == src:
            if len(full) != len(targets):
                error = f"{len(full)} tensors for {len(targets)} targets"
            else:
                for i, (f, shape) in enumerate(zip(full, shapes)):
                    if tuple(f.shape) != shape:
                        error = (f"tensor {i}: shape {tuple(f.shape)}, the "
                                 f"split target's whole shape {shape}")
                        break
        error = dist_lib.broadcast_object(error, src)
        if error is not None:
            raise ValueError(f"load_full_state_: {error}")
        for i, (name, t, shape) in enumerate(zip(names, targets, shapes)):
            if rank == src:
                value = full[i].to(device=t.device,
                                   dtype=t.dtype).contiguous()
            else:
                value = torch.empty(shape, dtype=t.dtype, device=t.device)
            dist.broadcast(value, src)
            dim = self.split_dim(name)
            if dim is not None:
                n = t.shape[dim]
                value = value.narrow(dim, self.mesh.model_index * n, n)
            self._store(t, value)
        return targets

    def _store(self, t, value):
        """``t`` takes ``value``, the rank's part of a loaded tensor."""
        t.copy_(value)
