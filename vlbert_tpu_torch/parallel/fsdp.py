"""Sharded training state: TPU.PARTITION_MODE ``fsdp`` as FSDP2 (port of
vlbert_tpu/parallel/mesh.py:77 ``fsdp_sharding_rules``).

    torchrun --nproc_per_node N -m vlbert_tpu_torch.engine.train --dist \\
        --task vqa --cfg <yaml with TPU.PARTITION_MODE: fsdp>

``shard_module`` calls ``torch.distributed.fsdp.fully_shard`` on each
encoder layer (``BertLayer``), then on the root, over a 1-D mesh of the
process group's ranks. Each parameter, and each optimizer moment that
``training/optim.py`` makes with ``zeros_like`` after it, is then a DTensor
sharded on dim 0: a rank keeps its ``torch.chunk`` of the rows (FSDP2 pads
the last). A unit's parameters are all-gathered before its forward (and
its backward, and a TPU.REMAT recompute), and its gradients are
reduce-scattered to their mean over the ranks after its backward, so each
rank's ``p.grad`` is its shard of the global batch's mean gradient. The
word embedding and the pretraining model's tied MLM decoder (one tensor
under two names), the other embeddings, the heads and the ResNet stay in
the root unit.

Where the state lives changes, not what is computed. The JAX rule leaves
leaves under 8192 elements replicated and shards a leaf's largest
divisible dimension; FSDP2 shards dim 0 of every parameter. No
``MixedPrecisionPolicy`` is passed: the parameters stay fp32, are gathered
in fp32, and the port's layers cast them to the compute dtype in their
forward as in ``dp`` and in one process, so bf16, fp16 and fp32 compute
are unchanged, and so is every kernel launch.

Every rank must run the same collectives in the same order:
- the same number of forwards (the samplers of ``data/`` pad every rank to
  one batch count);
- the same parameters in each reduce-scatter: a parameter that one rank's
  forward does not reach would leave that rank's reduce-scatter short.
  ``zero_touch`` adds 0 × each trainable root parameter to a micro-step's
  loss, so that each has a gradient (zero where the forward did not reach
  it) on every rank, as the JAX package's dense gradient does. The layers'
  parameters are reached by every forward;
- checkpoints: ``full_state`` gathers on every rank (rank 0 writes),
  ``load_full_state_`` scatters rank 0's tensors.

``shard_module`` attaches ``Fsdp``, the partition (``dist.partition_of``)
through which the step, the optimizer and the checkpoint reach these.
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from vlbert_tpu_torch.parallel import dist as dist_lib


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


def shard_module(model, device):
    """``fully_shard`` each ``BertLayer`` of ``model``, then ``model``
    itself, over a mesh of the default process group's ranks on
    ``device``'s type. In place; returns ``model``. Build the optimizer and
    the train step after it: FSDP2 replaces the module's Parameters."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    from vlbert_tpu_torch.models.bert import BertLayer

    mesh = init_device_mesh(torch.device(device).type,
                            (dist.get_world_size(),))
    layers = [m for m in model.modules() if isinstance(m, BertLayer)]
    for layer in layers:
        fully_shard(layer, mesh=mesh)
    fully_shard(model, mesh=mesh)
    model.partition = Fsdp()
    return model


class Fsdp(dist_lib.Replicated):
    """The partition of a module that ``shard_module`` sharded: DTensors
    have their whole shape, the gradients are reduce-scattered in the
    backward, a shard's norm is reduced over the ranks (``plain``), and a
    snapshot or load is collective."""
    collective = True

    def reduce_gradients_(self, names, grads):
        pass

    def norm(self, names, tensors):
        return plain(super().norm(names, tensors))

    def full_state(self, names, tensors):
        return full_state(tensors)

    def load_full_state_(self, names, targets, full):
        return load_full_state_(targets, full)


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


def plain(t):
    """A DTensor whole on every rank, as a plain tensor (collective: its
    shards gathered, its partial values reduced); other tensors as they
    are."""
    return t.full_tensor() if is_dtensor(t) else t


def full_state(tensors):
    """Collective on every rank: each tensor of ``tensors`` (the same list,
    in the same order, on every rank) whole and on the CPU, on rank 0; None
    on the other ranks. A DTensor is gathered (``full_tensor``), a plain
    tensor copied. A tensor listed twice (a tied weight) is gathered once
    and comes back as one CPU tensor."""
    rank = dist_lib.rank_world()[0]
    seen, out = {}, []
    for t in tensors:
        if id(t) not in seen:
            full = t.full_tensor() if is_dtensor(t) else t
            seen[id(t)] = (full.detach().to("cpu", copy=True)
                           if rank == 0 else None)
        out.append(seen[id(t)])
    return out if rank == 0 else None


@torch.no_grad()
def load_full_state_(targets, full, src=0):
    """Each tensor of ``targets`` (the same list on every rank) becomes the
    value of the full tensor at the same place in ``full``: with ``src`` a
    rank, ``full`` is that rank's (None on the others) and the call is
    collective, each rank keeping its own shard; with ``src`` None every
    rank passes the same ``full`` and no rank communicates. A shape that
    does not match raises ValueError on every rank, before any tensor is
    written."""
    from torch.distributed.tensor import distribute_tensor

    rank = dist_lib.rank_world()[0]
    have = src is None or rank == src
    error = None
    if have:
        if len(full) != len(targets):
            error = f"{len(full)} tensors for {len(targets)} targets"
        else:
            for i, (t, f) in enumerate(zip(targets, full)):
                if tuple(f.shape) != tuple(t.shape):
                    error = (f"tensor {i}: shape {tuple(f.shape)}, target "
                             f"{tuple(t.shape)}")
                    break
    if src is not None:
        error = dist_lib.broadcast_object(error, src)
    if error is not None:
        raise ValueError(f"load_full_state_: {error}")
    for i, t in enumerate(targets):
        if have:
            value = full[i].to(device=t.device, dtype=t.dtype)
        else:
            value = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        if is_dtensor(t):
            # rank src's value, scattered: each rank gets its chunk
            t.copy_(distribute_tensor(value, t.device_mesh, t.placements,
                                      src_data_rank=src))
        else:
            if src is not None:
                dist.broadcast(value, src)
            t.copy_(value)
    return targets


def local_numel(tensors):
    """Elements that this rank holds of ``tensors``: a DTensor's local
    shard, a plain tensor whole."""
    return sum((t.to_local() if is_dtensor(t) else t).numel()
               for t in tensors)
