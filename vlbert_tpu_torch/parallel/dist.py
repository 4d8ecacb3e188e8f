"""Data parallelism over ``torch.distributed``: TPU.PARTITION_MODE ``dp``
(port of vlbert_tpu/parallel/mesh.py, where one jit over a mesh's 'data'
axis averages the gradients and sums the metrics).

One process a card, N ranks, started by ``torchrun`` (which sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT):

    torchrun --nproc_per_node N -m vlbert_tpu_torch.engine.train --dist \\
        --task vqa --cfg cfgs/vqa/base_4x16G_fp32.yaml

Each rank loads its own shard of every batch (``data/build.py``). Its step
equals the JAX package's step over the global batch, the ranks' shards
concatenated, so a run's result does not depend on the number of ranks:

- ``all_reduce_mean_``: the gradients, summed across ranks in flat
  buckets and divided by the world size, once an optimizer step;
- ``all_reduce_sum``: a loss whose denominator counts something in the
  data (masked tokens, live boxes) divides by the count over every
  rank's batch, over the world size (``utils/losses.py::global_counts``),
  so that the ranks' mean gradient is the global batch's;
- ``all_reduce_step_stats`` / ``all_reduce_accumulator``: the loss and
  the metrics' (sum, count) pairs, so every rank logs, validates and
  steps the plateau detector on the global numbers;
- ``broadcast_tensors_`` / ``broadcast_object``: rank 0's resumed state.

The gradients are reduced explicitly before the optimizer step, not by
``DistributedDataParallel``: the step already lists every trained
parameter's gradient (zeros for one the forward did not reach), the
module keeps its reference names (no ``module.`` prefix in checkpoints),
validation, test and serving use the same module, and the same code runs
over gloo, which the one-card machine's two-rank check uses. What it
gives up is DDP's overlap of the all-reduce with the backward.

Nothing falls back: a collective that fails raises. PARTITION_MODE
``fsdp`` and ``tp``, which shard the state over the mesh, are refused at
more than one rank (``check_partition``).
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

# flat buckets of at most this many bytes a collective
BUCKET_BYTES = 64 << 20

MODES = ("dp", "fsdp", "tp")
_LATER = {"fsdp": "FSDP2 sharding of the parameters and optimizer state",
          "tp": "the tensor-parallel rules of vlbert_tpu/parallel/mesh.py"}


def is_distributed():
    return dist.is_available() and dist.is_initialized()


def rank_world():
    """(rank, world size) of the default process group, else (0, 1)."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def check_partition(config, world):
    """Raise on a TPU.PARTITION_MODE or TPU.MESH_SHAPE the port cannot run
    at ``world`` ranks, before anything is built. One rank runs every mode
    on its one card (the mesh knobs then only warn, ``build_module``); at
    more than one only ``dp`` over a mesh of ``world`` devices on the data
    axis."""
    tpu = config.TPU if "TPU" in config else {}
    mode = str(tpu.get("PARTITION_MODE", "dp")).lower()
    if mode not in MODES:
        raise ValueError(f"unknown TPU.PARTITION_MODE {mode!r} (one of "
                         f"{', '.join(MODES)})")
    if world <= 1:
        return
    if mode != "dp":
        raise NotImplementedError(
            f"TPU.PARTITION_MODE={mode} at {world} ranks needs {_LATER[mode]}"
            f", which the port does not have yet (ROADMAP.md queue 1, "
            f"multi-GPU); PARTITION_MODE dp trains at {world} ranks")
    shape = list(tpu.get("MESH_SHAPE") or [])
    if shape and math.prod(int(s) for s in shape) != world:
        raise ValueError(
            f"TPU.MESH_SHAPE {shape} lays out {math.prod(shape)} devices; "
            f"the process group has {world} ranks, one card each (set "
            f"MESH_SHAPE to [{world}] or [])")
    if len(shape) > 1 and any(int(s) > 1 for s in shape[1:]):
        raise NotImplementedError(
            f"TPU.MESH_SHAPE {shape} has a model axis: tensor parallelism "
            f"needs {_LATER['tp']}, which the port does not have yet "
            f"(ROADMAP.md queue 1, multi-GPU)")


def resolve_device(device=None, local_rank=0):
    """``device`` when given, else ``cuda:LOCAL_RANK``. Raises when that
    card does not exist: two ranks are never put on one card unasked."""
    if device:
        return torch.device(device)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_rank >= n:
        raise RuntimeError(
            f"LOCAL_RANK {local_rank} has no card of its own ({n} CUDA "
            f"device(s)); start at most {n} ranks on this host, or pass "
            f"--device")
    return torch.device("cuda", local_rank)


def default_backend(device):
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_from_env(backend=None, device=None, env=None):
    """Initialise the default process group from torchrun's environment.
    Returns the rank's device. ``backend``: nccl or gloo, by default nccl
    on a card and gloo on the CPU; nccl on the CPU raises."""
    env = os.environ if env is None else env
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(
            f"--dist needs torchrun's environment ({', '.join(missing)} "
            f"unset): torchrun --nproc_per_node N -m "
            f"vlbert_tpu_torch.engine.train --dist ...")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    device = resolve_device(device, int(env.get("LOCAL_RANK", rank)))
    backend = backend or default_backend(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got "
                         f"{device} (use --dist-backend gloo)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return device


@contextlib.contextmanager
def process_group(backend=None, device=None):
    """``init_from_env`` for the block; the group is destroyed on every
    exit. Yields the rank's device."""
    device = init_from_env(backend, device)
    try:
        yield device
    finally:
        if is_distributed():
            dist.destroy_process_group()


def barrier():
    if is_distributed():
        dist.barrier()


def _buckets(tensors, cap=BUCKET_BYTES):
    """``tensors`` in order, in runs of one dtype and device of at most
    ``cap`` bytes (a larger tensor is a run of its own)."""
    runs, run, size, key = [], [], 0, None
    for t in tensors:
        k, n = (t.dtype, t.device), t.numel() * t.element_size()
        if run and (k != key or size + n > cap):
            runs.append(run)
            run, size = [], 0
        run.append(t)
        size, key = size + n, k
    if run:
        runs.append(run)
    return runs


@torch.no_grad()
def _bucketed(tensors, collective):
    """Apply ``collective(flat)`` to each bucket of ``tensors`` flattened,
    and copy the result back into them."""
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        collective(flat)
        offset = 0
        for t in run:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def all_reduce_mean_(tensors):
    """Each tensor, in place, becomes its mean over the ranks (the sum
    divided by the world size). A no-op without a process group."""
    if not is_distributed():
        return tensors
    world = dist.get_world_size()

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(world)

    return _bucketed(tensors, mean)


def broadcast_tensors_(tensors, src=0):
    """Each tensor, in place, becomes rank ``src``'s."""
    if not is_distributed():
        return tensors
    return _bucketed(tensors, lambda flat: dist.broadcast(flat, src))


def broadcast_object(obj, src=0):
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


@torch.no_grad()
def all_reduce_sum(t):
    """A detached copy of ``t`` summed over the ranks."""
    out = t.detach().clone()
    if is_distributed():
        dist.all_reduce(out)
    return out


@torch.no_grad()
def all_reduce_step_stats(loss, metrics):
    """(loss, metrics) of the global batch in one collective: the ranks'
    mean loss (each rank's loss is its share of the global mean, see
    ``utils/losses.py``) and every (sum, count) pair summed over the
    ranks, in float64. Unchanged without a process group."""
    if not is_distributed():
        return loss, metrics
    keys = sorted(metrics)
    flat = torch.stack(
        [loss.to(torch.float64)]
        + [torch.as_tensor(v, dtype=torch.float64, device=loss.device)
           for k in keys for v in metrics[k]])
    dist.all_reduce(flat)
    out = {k: (flat[1 + 2 * i], flat[2 + 2 * i]) for i, k in enumerate(keys)}
    return (flat[0] / dist.get_world_size()).to(loss.dtype), out


@torch.no_grad()
def all_reduce_accumulator(acc, device):
    """A ``metrics.HostAccumulator``'s sums and counts, in place, summed
    over the ranks (the validation metrics of a rank-sharded loader)."""
    if not is_distributed():
        return acc
    keys = sorted(acc.sums)
    flat = torch.tensor([x for k in keys for x in (acc.sums[k], acc.nums[k])],
                        dtype=torch.float64, device=device)
    dist.all_reduce(flat)
    for i, k in enumerate(keys):
        acc.sums[k], acc.nums[k] = flat[2 * i].item(), flat[2 * i + 1].item()
    return acc
