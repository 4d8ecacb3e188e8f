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

PARTITION_MODE ``fsdp`` shards the parameters and moments over the data
axis (``parallel/fsdp.py``); ``tp`` splits the encoder's heads and FFN
over the model axis of a [data, model] mesh (``parallel/tp.py``), and the
collectives above then run over the data axis's group (their ``group``);
``fsdp`` on a [data, model] mesh does both, tp's split first.
How a model's state is held is one object, ``partition_of(model)``:
``Replicated`` here for dp (and one process), the ones that fsdp's and
tp's ``shard_module`` attach; the train step, the optimizer, validation
and the checkpoint call its methods and do not ask which it is.
``check_partition`` refuses a layout the port cannot run, by name, before
anything is built. Nothing falls back: a collective that fails raises.

Under SLURM, ``srun`` starts one task a card and ``--dist`` reads its
environment when torchrun's is absent (``slurm_env``):

    srun --ntasks-per-node <cards> python -m vlbert_tpu_torch.engine.train \
        --dist --task vqa --cfg ...        (scripts/run_slurm_torch.sh)
"""

from __future__ import annotations

import contextlib
import math
import os
import re
from typing import NamedTuple

import torch
import torch.distributed as dist

# flat buckets of at most this many bytes a collective
BUCKET_BYTES = 64 << 20

MODES = ("dp", "fsdp", "tp")
# the widths that tensor parallelism splits over the model axis
_TP_SPLIT = ("num_attention_heads", "hidden_size", "intermediate_size")


def is_distributed():
    return dist.is_available() and dist.is_initialized()


def rank_world():
    """(rank, world size) of the default process group, else (0, 1)."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def partition_mode(config):
    tpu = config.TPU if "TPU" in config else {}
    return str(tpu.get("PARTITION_MODE", "dp")).lower()


def mesh_dims(config, world):
    """(d, m): the data and model axes' sizes of TPU.MESH_SHAPE over
    ``world`` ranks (MESH_SHAPE [] is [world]). Rank r sits at data index
    r // m and model index r % m, the row-major layout of
    vlbert_tpu/parallel/mesh.py:24-31."""
    tpu = config.TPU if "TPU" in config else {}
    shape = [int(s) for s in (tpu.get("MESH_SHAPE") or [world])]
    return shape[0], math.prod(shape[1:])


def check_partition(config, world):
    """Raise on a TPU.PARTITION_MODE or TPU.MESH_SHAPE the port cannot run
    at ``world`` ranks, before anything is built. ``tp`` runs over a
    MESH_SHAPE [d, m] of d·m = ``world`` ranks with MESH_AXES [data, model]
    and m > 1; a model axis of 1 raises the JAX package's ValueError
    (vlbert_tpu/training/loop.py:273-279), at one rank too, and so do
    heads or widths that m does not divide (the port splits heads).
    ``fsdp`` with a model axis > 1 is held to the same rules. One rank
    runs ``dp`` and ``fsdp`` without a model axis on its one card (the
    mesh knobs then only warn, ``build_module``); at more than one, over a
    mesh of ``world`` devices on the data axis (MESH_SHAPE [], [world] or
    [world, 1])."""
    tpu = config.TPU if "TPU" in config else {}
    mode = partition_mode(config)
    if mode not in MODES:
        raise ValueError(f"unknown TPU.PARTITION_MODE {mode!r} (one of "
                         f"{', '.join(MODES)})")
    shape = list(tpu.get("MESH_SHAPE") or [])
    model_axis = len(shape) > 1 and math.prod(int(s) for s in shape[1:]) > 1
    if mode == "tp" or (mode == "fsdp" and model_axis):
        _check_tp(config, world, mode)
        return
    if world <= 1:
        return
    if shape and math.prod(int(s) for s in shape) != world:
        raise ValueError(
            f"TPU.MESH_SHAPE {shape} lays out {math.prod(shape)} devices; "
            f"the process group has {world} ranks, one card each (set "
            f"MESH_SHAPE to [{world}] or [])")
    if model_axis:
        raise ValueError(
            f"TPU.MESH_SHAPE {shape} has a model axis, which "
            f"TPU.PARTITION_MODE dp does not use: set PARTITION_MODE tp "
            f"or fsdp (with MESH_AXES [data, model]) or MESH_SHAPE [{world}]")


def _check_tp(config, world, mode="tp"):
    tpu = config.TPU if "TPU" in config else {}
    shape = [int(s) for s in (tpu.get("MESH_SHAPE") or [])]
    axes = list(tpu.get("MESH_AXES") or ["data"])[:len(shape) or 1]
    names = dict(zip(axes, shape or [world]))
    if len(shape) < 2 or math.prod(shape[1:]) <= 1:
        raise ValueError(
            "TPU.PARTITION_MODE=tp needs a 'model' mesh axis > 1 "
            f"(mesh is {names}); set TPU.MESH_SHAPE, e.g. "
            "[4, 2], and TPU.MESH_AXES: [data, model] — otherwise "
            "training would silently run pure DP")
    if len(shape) != 2 or axes != ["data", "model"]:
        raise ValueError(
            f"TPU.PARTITION_MODE={mode} on a model axis runs on a mesh of "
            f"two axes, TPU.MESH_SHAPE [d, m] with TPU.MESH_AXES [data, "
            f"model]; got MESH_SHAPE {shape}, MESH_AXES {axes}")
    if math.prod(shape) != world:
        raise ValueError(
            f"TPU.MESH_SHAPE {shape} lays out {math.prod(shape)} devices; "
            f"the process group has {world} ranks, one card each (start "
            f"{math.prod(shape)} ranks with --dist, or set MESH_SHAPE to "
            f"[{world} // m, m])")
    m = shape[1]
    vl = config.NETWORK.VLBERT
    bad = {k: vl[k] for k in _TP_SPLIT if int(vl[k]) % m}
    if bad:
        raise ValueError(
            f"TPU.PARTITION_MODE={mode} over a model axis of {m}: "
            + ", ".join(f"NETWORK.VLBERT.{k} {v}" for k, v in bad.items())
            + f" not divisible by {m}. The port splits the attention by "
            f"heads and cannot split a head (the JAX package would "
            f"replicate such a kernel); choose a model axis that divides "
            f"them")


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


_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_SLURM = ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID")


def expand_hostlist(spec):
    """SLURM's compressed host list as the list of its host names, in
    order: ``gpu[01-03,07],login2`` is gpu01, gpu02, gpu03, gpu07, login2.
    A range keeps the zero padding of its first bound; several bracket
    groups in one name expand as their product. Raises ValueError on a
    list it cannot read."""
    items, depth, cur = [], 0, ""
    for ch in spec:
        depth += (ch == "[") - (ch == "]")
        if depth < 0 or depth > 1:
            raise ValueError(f"host list {spec!r}: unbalanced brackets")
        if ch == "," and depth == 0:
            items.append(cur)
            cur = ""
        else:
            cur += ch
    items.append(cur)
    if depth or any(not item for item in items):
        raise ValueError(f"host list {spec!r}: unbalanced brackets or an "
                         f"empty name")
    return [host for item in items for host in _expand_name(item, spec)]


def _expand_name(name, spec):
    m = re.fullmatch(r"([^\[\]]*)\[([^\[\]]*)\](.*)", name)
    if m is None:
        if "[" in name or "]" in name:
            raise ValueError(f"host list {spec!r}: cannot read {name!r}")
        return [name]
    head, body, tail = m.groups()
    numbers = []
    for part in body.split(","):
        lo, sep, hi = part.partition("-")
        if not lo.isdigit() or (sep and not hi.isdigit()):
            raise ValueError(f"host list {spec!r}: range {part!r} is not "
                             f"a number or lo-hi")
        if not sep:
            numbers.append(lo)
            continue
        if int(hi) < int(lo):
            raise ValueError(f"host list {spec!r}: range {part!r} runs "
                             f"backwards")
        numbers += [str(i).zfill(len(lo)) for i in range(int(lo),
                                                         int(hi) + 1)]
    rests = _expand_name(tail, spec)
    return [head + n + rest for n in numbers for rest in rests]


def slurm_port(job_id):
    """MASTER_PORT of a SLURM job without one: 10000 + SLURM_JOB_ID mod
    20000, below Linux's ephemeral ports (32768 and up), the same on every
    task of the job."""
    return 10000 + int(job_id) % 20000


def slurm_env(env):
    """torchrun's variables from ``srun``'s environment (one task a card):
    RANK = SLURM_PROCID, WORLD_SIZE = SLURM_NTASKS, LOCAL_RANK =
    SLURM_LOCALID, MASTER_ADDR = the first host of SLURM_STEP_NODELIST
    (SLURM_JOB_NODELIST when the step has none), MASTER_PORT from the
    environment, else ``slurm_port(SLURM_JOB_ID)``. A variable it needs and
    does not find raises by name; nothing is guessed."""
    missing = [k for k in _SLURM if k not in env]
    nodelist = env.get("SLURM_STEP_NODELIST") or env.get(
        "SLURM_JOB_NODELIST")
    if nodelist is None:
        missing.append("SLURM_STEP_NODELIST (or SLURM_JOB_NODELIST)")
    if "MASTER_PORT" not in env and "SLURM_JOB_ID" not in env:
        missing.append("MASTER_PORT (or SLURM_JOB_ID)")
    if missing:
        raise RuntimeError(f"--dist under SLURM: {', '.join(missing)} "
                           f"unset (start the ranks with srun, one task a "
                           f"card: scripts/run_slurm_torch.sh)")
    return {"RANK": env["SLURM_PROCID"], "WORLD_SIZE": env["SLURM_NTASKS"],
            "LOCAL_RANK": env["SLURM_LOCALID"],
            "MASTER_ADDR": expand_hostlist(nodelist)[0],
            "MASTER_PORT": env.get("MASTER_PORT")
            or str(slurm_port(env["SLURM_JOB_ID"]))}


def rendezvous_env(env):
    """(torchrun's variables, init method) of this process: torchrun's own
    when RANK is set (they win over SLURM's), else ``slurm_env``'s when
    SLURM_PROCID is set. torchrun's are read by ``env://`` (its agent may
    host the store), SLURM's by ``tcp://MASTER_ADDR:MASTER_PORT``."""
    if "RANK" in env or "SLURM_PROCID" not in env:
        missing = [k for k in _TORCHRUN if k not in env]
        if missing:
            raise RuntimeError(
                f"--dist needs torchrun's environment ({', '.join(missing)}"
                f" unset): torchrun --nproc_per_node N -m "
                f"vlbert_tpu_torch.engine.train --dist ..., or srun's "
                f"(SLURM_PROCID unset)")
        return {k: env[k] for k in _TORCHRUN + ("LOCAL_RANK",)
                if k in env}, "env://"
    out = slurm_env(env)
    return out, f"tcp://{out['MASTER_ADDR']}:{out['MASTER_PORT']}"


def init_from_env(backend=None, device=None, env=None):
    """Initialise the default process group from torchrun's environment,
    or srun's (``rendezvous_env``). Returns the rank's device.
    ``backend``: nccl or gloo, by default nccl on a card and gloo on the
    CPU; nccl on the CPU raises."""
    env = os.environ if env is None else env
    found, init_method = rendezvous_env(env)
    rank, world = int(found["RANK"]), int(found["WORLD_SIZE"])
    device = resolve_device(device, int(found.get("LOCAL_RANK", rank)))
    backend = backend or default_backend(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got "
                         f"{device} (use --dist-backend gloo)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
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


def all_reduce_mean_(tensors, group=None):
    """Each tensor, in place, becomes its mean over the ranks of ``group``
    (the sum divided by its size; every rank by default). A no-op without
    a process group."""
    if not is_distributed():
        return tensors
    world = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, group=group)
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


def from_rank0(fn):
    """``fn()`` run on rank 0, its (picklable) value on every rank. An
    exception that ``fn`` raises on rank 0 is raised on every rank, after
    the broadcast, so that no rank waits in a collective for it. Without a
    process group, ``fn()``."""
    if not is_distributed():
        return fn()
    value, error = None, None
    if dist.get_rank() == 0:
        try:
            value = fn()
        except Exception as e:      # raised below, after the broadcast
            error = e
    box = broadcast_object(("ok", value) if error is None
                           else ("error", f"{type(error).__name__}: {error}"))
    if error is not None:
        raise error
    if box[0] == "error":
        raise RuntimeError(f"rank 0 failed: {box[1]}")
    return box[1]


@torch.no_grad()
def all_reduce_sum(t, group=None):
    """A detached copy of ``t`` summed over the ranks of ``group`` (every
    rank by default)."""
    out = t.detach().clone()
    if is_distributed():
        dist.all_reduce(out, group=group)
    return out


@torch.no_grad()
def all_reduce_step_stats(loss, metrics, group=None):
    """(loss, metrics) of the global batch in one collective over the ranks
    of ``group`` (every rank by default): the ranks' mean loss (each rank's
    loss is its share of the global mean, see ``utils/losses.py``) and
    every (sum, count) pair summed over the ranks, in float64. Unchanged
    without a process group."""
    if not is_distributed():
        return loss, metrics
    keys = sorted(metrics)
    flat = torch.stack(
        [loss.to(torch.float64)]
        + [torch.as_tensor(v, dtype=torch.float64, device=loss.device)
           for k in keys for v in metrics[k]])
    dist.all_reduce(flat, group=group)
    out = {k: (flat[1 + 2 * i], flat[2 + 2 * i]) for i, k in enumerate(keys)}
    return (flat[0] / dist.get_world_size(group)).to(loss.dtype), out


@torch.no_grad()
def all_reduce_accumulator(acc, device, group=None):
    """A ``metrics.HostAccumulator``'s sums and counts, in place, summed
    over the ranks of ``group``, every rank by default (the validation
    metrics of a rank-sharded loader)."""
    if not is_distributed():
        return acc
    keys = sorted(acc.sums)
    flat = torch.tensor([x for k in keys for x in (acc.sums[k], acc.nums[k])],
                        dtype=torch.float64, device=device)
    dist.all_reduce(flat, group=group)
    for i, k in enumerate(keys):
        acc.sums[k], acc.nums[k] = flat[2 * i].item(), flat[2 * i + 1].item()
    return acc


class DataAxis(NamedTuple):
    """What a training step's means and sums run over: a process group
    (None: every rank), its size and this rank's index in it."""
    group: object
    size: int
    index: int


class Replicated:
    """The training state whole on every rank (TPU.PARTITION_MODE dp, and
    one process). ``partition_of`` gives a model's partition; fsdp's and
    tp's ``shard_module`` attach their own, with these methods:

    - ``collective``: a checkpoint snapshot or load needs every rank;
    - ``data_axis()``: the ``DataAxis`` of the step and of validation;
    - ``full_shape(name, t)``: the whole shape of parameter (or moment)
      ``name``, held as ``t``;
    - ``reduce_gradients_(names, grads)``: each rank's gradients, in
      place, become the global batch's mean gradient;
    - ``norm(names, tensors)``: the whole gradients' global norm, fp32, the
      same on every rank;
    - ``full_state(names, tensors)`` and ``load_full_state_(names,
      targets, full)``: the collective snapshot and load (collective
      partitions only)."""
    collective = False

    def data_axis(self):
        rank, world = rank_world()
        return DataAxis(None, world, rank)

    def full_shape(self, name, t):
        return tuple(t.shape)

    def reduce_gradients_(self, names, grads):
        all_reduce_mean_(grads)

    def norm(self, names, tensors):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t.to(torch.float32)) for t in tensors]))


def partition_of(model):
    """How ``model``'s training state is held across ranks: what
    ``shard_module`` attached, else ``Replicated``."""
    return getattr(model, "partition", None) or Replicated()
