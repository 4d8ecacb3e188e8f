"""Sharded training state: TPU.PARTITION_MODE ``fsdp`` as FSDP2 (port of
vlbert_tpu/parallel/mesh.py:77 ``fsdp_sharding_rules``), on a mesh of the
data axis alone or on a [data, model] mesh with tensor parallelism.

    torchrun --nproc_per_node N -m vlbert_tpu_torch.engine.train --dist \\
        --task vqa --cfg <yaml> TPU.PARTITION_MODE fsdp \\
        [TPU.MESH_SHAPE '[d,m]' TPU.MESH_AXES '[data,model]']

``shard_module`` calls ``torch.distributed.fsdp.fully_shard`` on each
encoder layer (``BertLayer``), then on the root, over the data axis of
the ranks. Each parameter, and each optimizer moment that
``training/optim.py`` makes with ``zeros_like`` after it, is then a DTensor
sharded on dim 0: a rank keeps its ``torch.chunk`` of the rows (FSDP2 pads
the last). A unit's parameters are all-gathered before its forward (and
its backward, and a TPU.REMAT recompute), and its gradients are
reduce-scattered to their mean over the data group after its backward, so
each rank's ``p.grad`` is its shard of the global batch's mean gradient.
The word embedding and the pretraining model's tied MLM decoder (one
tensor under two names), the other embeddings, the heads and the ResNet
stay in the root unit.

On a MESH_SHAPE [d, m] with m > 1 (MESH_AXES [data, model]) the JAX rule
first gives each encoder kernel tp's ``model`` placement, then shards a
free dim over ``data``, as the port does: ``parallel/tp.py`` splits each
layer over the model group first (its rows, columns and heads, its
model-group all-reduces), and FSDP2 then shards each rank's part, and
every replicated tensor, over the rank's data group of the same
``tp.make_mesh``. [1, m] is tp's placement and runs as tp alone; [d, 1],
[d] and [] shard over the d = world ranks of the data axis.

Where the state lives changes, not what is computed. The JAX rule leaves
leaves under 8192 elements replicated and shards a leaf's largest free
divisible dimension; FSDP2 shards dim 0 of every (tp-local) parameter.
No ``MixedPrecisionPolicy`` is passed: the parameters stay fp32, are
gathered in fp32, and the port's layers cast them to the compute dtype in
their forward as in ``dp`` and in one process, so bf16, fp16 and fp32
compute are unchanged, and so is every kernel launch.

Every rank must run the same collectives in the same order:
- the same number of forwards (the samplers of ``data/`` pad every rank to
  one batch count);
- the same parameters in each reduce-scatter: a parameter that one rank's
  forward does not reach would leave that rank's reduce-scatter short.
  ``zero_touch`` adds 0 × each trainable root parameter to a micro-step's
  loss, so that each has a gradient (zero where the forward did not reach
  it) on every rank, as the JAX package's dense gradient does. The layers'
  parameters are reached by every forward;
- checkpoints: ``Fsdp.full_state`` gathers on every rank (rank 0 writes),
  ``Fsdp.load_full_state_`` broadcasts rank 0's tensors.

The norm, the snapshot and the load are plain c10d calls on each
DTensor's ``to_local()`` shard, as tp's collectives are: no DTensor
collective (its gather, scatter or redistribution) runs on this path, so
that gloo ranks sharing one card run it too.
``shard_module`` attaches ``Fsdp``, the partition (``dist.partition_of``)
through which the step, the optimizer and the checkpoint reach these.
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from vlbert_tpu_torch.parallel import dist as dist_lib
from vlbert_tpu_torch.parallel import tp as tp_lib


def is_dtensor(t):
    """True for a DTensor. No tensor is one until ``shard_module`` has
    imported torch.distributed.tensor (a second's import, which a run
    without fsdp never pays)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def is_sharded(module):
    """True when ``module``'s parameters are FSDP2's DTensors: a
    checkpoint snapshot of it is collective (JAX's
    ``snapshot_needs_all_ranks``)."""
    return any(is_dtensor(p) for p in module.parameters())


def shard_module(model, device, mesh=None):
    """Shard ``model`` over the ranks, in place; returns it. ``mesh``: a
    ``tp.make_mesh`` [d, m] mesh, or None for the data axis of every rank
    (a 1-D mesh of ``device``'s type). At m > 1 each ``BertLayer`` is
    first split over the model group (``tp.shard_module``); at d = 1 that
    is all (tp's placement). Then ``fully_shard`` runs on each
    ``BertLayer`` and on ``model`` over the data axis. Build the optimizer
    and the train step after it (FSDP2 replaces the module's Parameters);
    call it after the warm starts, which load whole tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    from vlbert_tpu_torch.models.bert import BertLayer

    dims = {}
    if mesh is None:
        rank, world = dist_lib.rank_world()
        mesh = tp_lib.Mesh(world, 1, rank, 0, None, None, init_device_mesh(
            torch.device(device).type, (world,), mesh_dim_names=("data",)))
    elif mesh.m > 1:
        tp_lib.shard_module(model, mesh)
        if mesh.d == 1:
            return model
        dims = model.partition.dims
    data_mesh = mesh.device_mesh["data"]
    for layer in [m for m in model.modules() if isinstance(m, BertLayer)]:
        fully_shard(layer, mesh=data_mesh)
    fully_shard(model, mesh=data_mesh)
    model.partition = Fsdp(mesh, dims)
    return model


class Fsdp(tp_lib.TensorParallel):
    """The partition of a module that ``shard_module`` sharded over
    ``mesh``'s data axis, after splitting the tensors of ``dims`` over its
    model axis (``dims`` empty at m = 1). A DTensor's shape is its tp
    part's; FSDP2 reduce-scatters the gradients over the data group in
    the backward; the norm, snapshot and load run c10d on the local
    shards."""

    def reduce_gradients_(self, names, grads):
        """FSDP2 has made each gradient its mean over the data group. The
        m ranks of a model group share a data index, so they hold the same
        chunk of a replicated gradient: those chunks are averaged over the
        model group, which keeps the replicated parameters equal on the m
        ranks whatever a kernel's order of additions. A split gradient
        needs nothing more."""
        if self.mesh.m > 1:
            dist_lib.all_reduce_mean_(
                [local(g) for n, g in zip(names, grads)
                 if self.split_dim(n) is None],
                group=self.mesh.model_group)

    def norm(self, names, tensors):
        """The global norm, fp32, the same on every rank: each tensor's
        norm from its local shards' square sums, a split tensor's summed
        over the world (each element is held once), a replicated one's over
        a data group (the model-index-0 ranks' alone count), in one
        all-reduce over the world; then the norm of those norms, as
        ``dp``'s. A group of one rank reduces nothing."""
        norms = torch.stack([torch.linalg.vector_norm(
            local(t).to(torch.float32)) for t in tensors])
        if dist_lib.rank_world()[1] > 1:
            sq = norms.square()
            if self.mesh.model_index:
                split = torch.tensor(
                    [self.split_dim(n) is not None for n in names],
                    dtype=torch.bool, device=sq.device)
                sq = torch.where(split, sq, 0.0)
            norms = tp_lib._all_reduce(sq, None).sqrt()
        return torch.linalg.vector_norm(norms)

    def full_state(self, names, tensors):
        """Collective on every rank: each tensor of ``tensors`` (named by
        ``names``; the same list, in the same order, on every rank) whole
        and on the CPU, on rank 0; None on the other ranks. A DTensor's
        chunks are gathered over its data group, then a split tensor's
        parts over rank 0's model group; a tensor listed twice (a tied
        weight) comes back as one CPU tensor."""
        rank = dist_lib.rank_world()[0]
        seen, out = {}, []
        for name, t in zip(names, tensors):
            if id(t) not in seen:
                full, dim = _gather_data(t), self.split_dim(name)
                if dim is not None and self.mesh.data_index == 0:
                    full = self._gather(full, dim)
                seen[id(t)] = (full.detach().to("cpu", copy=True)
                               if rank == 0 else None)
            out.append(seen[id(t)])
        return out if rank == 0 else None

    def _store(self, t, value):
        copy_shard_(t, value)


def local(t):
    """The part of ``t`` that this rank holds: a DTensor's local shard
    (writes to it write the DTensor), another tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _gather_data(t):
    """DTensor ``t`` whole (its tp part) on every rank of its data group,
    by a c10d all-gather of the chunks padded to ceil(n / d) rows, then
    trimmed; over gloo the chunks travel on the CPU, where the result
    stays. Another tensor as it is."""
    if not is_dtensor(t):
        return t
    mesh, shard = t.device_mesh, t.to_local().detach()
    group = mesh.get_group()
    if dist.get_backend(group) == "gloo":
        shard = shard.cpu()
    per = -(-t.shape[0] // mesh.size())
    padded = shard.new_zeros((per, *shard.shape[1:]))
    padded[:shard.shape[0]] = shard
    parts = [torch.empty_like(padded) for _ in range(mesh.size())]
    dist.all_gather(parts, padded, group=group)
    return torch.cat(parts)[:t.shape[0]]


def plain(t):
    """A DTensor whole on every rank of its data group, on its device
    (collective: ``_gather_data``); other tensors as they are. At m > 1
    a split parameter's whole is its rank's tp part."""
    return _gather_data(t).to(t.device) if is_dtensor(t) else t


@torch.no_grad()
def copy_shard_(t, value):
    """``t`` takes its part of ``value``: a DTensor the rows of its local
    shard (FSDP2's ``torch.chunk`` over its mesh: ceil(n / d) rows a rank,
    the last ranks' fewer or none), another tensor all of it. No rank
    communicates."""
    if not is_dtensor(t):
        return t.copy_(value)
    mesh, shard = t.device_mesh, t.to_local()
    per = -(-t.shape[0] // mesh.size())
    start = min(mesh.get_local_rank() * per, t.shape[0])
    shard.copy_(value.narrow(0, start, shard.shape[0]))
    return t


def zero_touch(model):
    """0 × the sum of each trainable parameter of ``model``'s root unit,
    as the root holds them after its forward (unsharded): a scalar zero
    whose backward gives each of them a zero gradient, to be added to the
    micro-step's loss. Sharded parameters (the layers', which every
    forward reaches) are left out."""
    touched = [p for p in model.parameters()
               if p.requires_grad and not is_dtensor(p)]
    if not touched:
        return 0.0
    return torch.stack([p.sum() for p in touched]).sum() * 0.0


def local_numel(tensors):
    """Elements that this rank holds of ``tensors``: a DTensor's local
    shard, a plain tensor whole."""
    return sum(local(t).numel() for t in tensors)
