"""Host data loader: per-host sharding, epoch-seeded shuffling, worker pool,
prefetch, and the multitask zip.

ref:
  * DistributedSampler (pretrain/data/samplers/distributed.py:10-66):
    rank-sharded, epoch-seeded shuffle, pad-to-divisible — here per-host
    sharding uses jax.process_index()/process_count();
  * dataloader factory (pretrain/data/build.py:43-105);
  * MultiTaskDataLoader (common/utils/multi_task_dataloader.py:17-54):
    master loader defines epoch length; aux loaders auto-restart.

Port copy of ``vlbert_tpu/data/loader.py``, unchanged but for its imports:
the port imports nothing of the JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

# --- process-worker plumbing (fork start method: the dataset + collate are
# shipped ONCE per worker via the pool initializer, not per task) -----------

_WORKER_DS = None
_WORKER_COLLATE = None
_WORKER_SEED = 0
_WORKER_LOADER_ID = 0


def _reseed(obj, seed):
    """Re-create augmentation RNG streams (any ``rng`` attribute on the
    dataset or its transform chain: flip RNG, masking RNG) from ``seed``
    (int or np.random.SeedSequence); each consumer gets an independent
    spawned stream."""
    ss = seed if isinstance(seed, np.random.SeedSequence) \
        else np.random.SeedSequence(int(seed))
    transforms = [t for t in getattr(getattr(obj, "transform", None),
                                     "transforms", []) if hasattr(t, "rng")]
    children = ss.spawn(1 + len(transforms))
    if hasattr(obj, "rng"):
        obj.rng = np.random.default_rng(children[0])
    for child, t in zip(children[1:], transforms):
        t.rng = np.random.default_rng(child)


def _worker_init(ds, collate, base_seed, loader_id=0):
    global _WORKER_DS, _WORKER_COLLATE, _WORKER_SEED, _WORKER_LOADER_ID
    _WORKER_DS = ds
    _WORKER_COLLATE = collate
    _WORKER_SEED = base_seed
    _WORKER_LOADER_ID = loader_id


def _batch_seed(base_seed, epoch, batch_idx, loader_id=0):
    """SeedSequence-mixed (seed, loader-id, epoch, first-index) —
    collision-resistant for any dataset size (a linear epoch*K + index
    scheme collides once the dataset exceeds K samples). loader_id
    decorrelates multitask sub-loaders that share cfg.RNG_SEED and epoch:
    without it, two sub-datasets whose batches start at the same index
    would replay identical masking/augmentation RNG streams."""
    first = int(batch_idx[0]) if len(batch_idx) else 0
    return np.random.SeedSequence(
        (int(base_seed), int(loader_id), int(epoch), first))


def _worker_batch(batch_idx, epoch=0):
    # propagate the loader epoch into the worker's dataset copy (pool
    # workers received the dataset once at pool creation; epoch-dependent
    # state like VCR's person-name rotation needs the current value)
    if getattr(_WORKER_DS, "epoch", None) != epoch:
        try:
            _WORKER_DS.epoch = epoch
        except AttributeError:
            pass
    # augmentation RNG seeded per (run seed, epoch, batch) — a run with the
    # same RNG_SEED replays identical augmentations no matter which worker
    # the pool scheduler hands each batch to (PID-derived seeds made runs
    # irreproducible despite the seed plumbing)
    _reseed(_WORKER_DS, _batch_seed(_WORKER_SEED, epoch, batch_idx,
                                    _WORKER_LOADER_ID))
    samples = [_WORKER_DS[int(i)] for i in batch_idx]
    return _WORKER_COLLATE(samples)


class ShardedSampler:
    """Epoch-seeded shuffle, sharded across hosts, padded to divisibility
    (ref distributed.py:10-66)."""

    def __init__(self, n, shuffle=True, num_replicas=1, rank=0, seed=0):
        self.n = n
        self.shuffle = shuffle
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-n // num_replicas)
        self.total = self.num_samples * num_replicas

    def set_epoch(self, epoch):
        self.epoch = epoch

    def indices(self):
        return self.indices_with_valid()[0]

    def indices_with_valid(self):
        """(indices, valid): valid[i] is False for wrap-padding duplicates
        (positions past the true dataset length after pad-to-divisible)."""
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            idx = g.permutation(self.n)
        else:
            idx = np.arange(self.n)
        valid = np.ones(self.n, bool)
        # pad to divisible (wrap around, ref :47-49); np.resize tiles, so
        # datasets smaller than a shard still pad fully
        if self.total > self.n:
            idx = np.resize(idx, self.total)
            valid = np.concatenate(
                [valid, np.zeros(self.total - self.n, bool)])
        return idx[self.rank::self.num_replicas], \
            valid[self.rank::self.num_replicas]


class DataLoader:
    """Batched loader with a background prefetch thread.

    dataset: object with __len__ and __getitem__(i) -> dict of fixed-shape
    numpy arrays. collate: dict-list -> batch tuple (task-specific).

    Parallelism: ``num_workers > 0`` forks a persistent process pool (one
    whole batch per task, collated in the worker — the master only
    deserializes the finished batch). The GIL makes threads scale poorly on
    this decode/tokenize-heavy path (measured ~1.5x at 8 threads vs ~linear
    for processes, bench_host.py); the reference gets the same effect from
    torch DataLoader worker processes (NUM_WORKERS_PER_GPU). ``num_workers
    = 0`` falls back to the thread pool (deterministic augmentation order,
    used by tests).
    """

    def __init__(self, dataset, batch_size, collate_fn, shuffle=True,
                 num_replicas=1, rank=0, seed=0, drop_last=True,
                 prefetch=2, num_threads=4, num_workers=0,
                 aspect_grouping=False, loader_id=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = ShardedSampler(len(dataset), shuffle, num_replicas,
                                      rank, seed)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.num_workers = num_workers
        self.seed = seed
        self.loader_id = loader_id
        self._pool = None
        # TRAIN.ASPECT_GROUPING (ref build.py + grouped_batch_sampler.py):
        # batch within aspect groups; needs dataset-provided group ids (the
        # reference's datasets assert False on grouping — dormant there too)
        self.group_ids = None
        if aspect_grouping:
            if not hasattr(dataset, "group_ids"):
                raise NotImplementedError(
                    "TRAIN.ASPECT_GROUPING requires the dataset to expose "
                    "group_ids (reference datasets assert on it too, e.g. "
                    "vcr/data/datasets/vcr.py:114-116)")
            self.group_ids = np.asarray(dataset.group_ids)

    def set_epoch(self, epoch):
        self.sampler.set_epoch(epoch)
        # datasets with epoch-dependent state (e.g. VCR person-name
        # rotation) read .epoch; worker copies get it via _worker_batch
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = epoch

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ProcessPoolExecutor
            import multiprocessing as mp
            import pickle

            # forkserver when possible: the server process is exec'd fresh,
            # so workers never fork a JAX-threaded parent (fork after XLA
            # threads start can deadlock; CPython warns on it). forkserver
            # ships dataset/collate pickled; fall back to fork inheritance
            # for unpicklable datasets (e.g. closures over local fixtures).
            # NOTE: like torch DataLoader with the spawn method, forkserver
            # re-imports the caller's __main__ — user scripts driving this
            # loader need an `if __name__ == "__main__":` guard (all shipped
            # entry scripts have one).
            method = "forkserver"
            try:
                # probe picklability WITHOUT materializing the (potentially
                # hundreds-of-MB) byte blob: serialize into a null sink
                class _Null:
                    def write(self, b):
                        return len(b)

                pickle.Pickler(_Null()).dump((self.dataset, self.collate_fn))
            except Exception:
                method = "fork"
            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=mp.get_context(method),
                initializer=_worker_init,
                initargs=(self.dataset, self.collate_fn, self.seed,
                          self.loader_id))
        return self._pool

    def shutdown(self):
        """Terminate the worker pool (kept alive across epochs otherwise)."""
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def __len__(self):
        if self.group_ids is not None:
            return len(GroupedBatchSampler(
                self.sampler.indices(), self.group_ids, self.batch_size,
                drop_uneven=self.drop_last))
        n = self.sampler.num_samples
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _batches(self):
        for batch_idx, _valid in self._batches_with_valid():
            yield batch_idx

    def _batches_with_valid(self):
        """Yield (batch_idx, valid) where valid[i] is False for every
        wrap-padding duplicate (sampler pad-to-divisible across hosts and
        the final-batch pad). Metrics mask by this so padded duplicates
        never bias validation."""
        idx, valid = self.sampler.indices_with_valid()
        if self.group_ids is not None:
            for chunk in GroupedBatchSampler(
                    idx, self.group_ids, self.batch_size,
                    drop_uneven=self.drop_last):
                # grouped wrap-pads reuse real samples; count only the
                # first occurrence of each index within the batch
                seen, v = set(), []
                for i in chunk:
                    v.append(int(i) not in seen)
                    seen.add(int(i))
                yield chunk, np.asarray(v, bool)
            return
        B = self.batch_size
        if not self.drop_last and len(idx) % B:
            # pad by wrapping so every batch is full (static shapes); the
            # reference's DistributedSampler pads to divisibility the same
            # way (ref distributed.py:47-49). np.resize tiles, covering
            # datasets smaller than one batch.
            n_full = -(-len(idx) // B) * B
            pad = n_full - len(idx)
            idx = np.resize(idx, n_full)
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        nb = len(self)
        for b in range(nb):
            yield idx[b * B:(b + 1) * B], valid[b * B:(b + 1) * B]

    def __iter__(self):
        for batch, _valid in self._iter_pairs():
            yield batch

    def iter_with_valid(self):
        """Iterate (batch, valid) pairs; valid marks wrap-padding duplicates
        (validation masks metrics by it)."""
        return self._iter_pairs()

    def _iter_pairs(self):
        if self.num_workers > 0:
            yield from self._iter_processes()
            return
        q = queue.Queue(maxsize=self.prefetch)
        stop = object()
        closed = threading.Event()   # set when the consumer abandons us

        def put(item):
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                from concurrent.futures import ThreadPoolExecutor

                epoch = int(getattr(self.sampler, "epoch", 0))
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for batch_idx, valid in self._batches_with_valid():
                        # per-batch deterministic augmentation seed (same
                        # scheme as the process workers). NOTE: with
                        # num_threads > 1 the within-batch draw ORDER is
                        # scheduler-dependent; build.py uses threads only
                        # as the single-thread fallback
                        _reseed(self.dataset,
                                _batch_seed(self.seed, epoch, batch_idx,
                                            self.loader_id))
                        samples = list(pool.map(
                            self.dataset.__getitem__, batch_idx))
                        if not put((self.collate_fn(samples), valid)):
                            return
            except BaseException as e:  # surface worker errors
                put(e)
            finally:
                put(stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # consumer done or abandoned (e.g. a next(iter(loader)) shape
            # probe): unblock the producer so it exits instead of pinning
            # `prefetch` collated batches in memory for the process's life
            closed.set()

    def _iter_processes(self):
        """Ordered sliding window of in-flight batch futures over the
        persistent fork pool; each worker builds + collates a whole batch."""
        pool = self._ensure_pool()
        window = max(self.prefetch, self.num_workers)
        pending = []
        epoch = int(getattr(self.sampler, "epoch", 0))
        try:
            for batch_idx, valid in self._batches_with_valid():
                pending.append((pool.submit(_worker_batch, list(batch_idx),
                                            epoch), valid))
                if len(pending) >= window:
                    f, v = pending.pop(0)
                    yield f.result(), v
            while pending:
                f, v = pending.pop(0)
                yield f.result(), v
        except BaseException:
            for f, _v in pending:
                f.cancel()
            raise


class MultiTaskLoader:
    """Zip of a master loader (defines epoch length) with aux loaders that
    restart on exhaustion (ref multi_task_dataloader.py:17-54). Batches are
    concatenated tuple-wise: (master..., aux0..., aux1...)."""

    def __init__(self, loaders):
        assert len(loaders) >= 1
        self.loaders = loaders
        self.cycles = [0] * len(loaders)

    def set_epoch(self, epoch):
        self.loaders[0].set_epoch(epoch)
        # aux loaders advance by their own cycle count

    def __len__(self):
        return len(self.loaders[0])

    def shutdown(self):
        """Terminate every sub-loader's worker pool."""
        for loader in self.loaders:
            loader.shutdown()

    def __iter__(self):
        iters = [iter(l) for l in self.loaders]
        for master in iters[0]:
            out = list(master)
            for i in range(1, len(self.loaders)):
                try:
                    aux = next(iters[i])
                except StopIteration:
                    self.cycles[i] += 1
                    if hasattr(self.loaders[i], "set_epoch"):
                        self.loaders[i].set_epoch(self.cycles[i])
                    iters[i] = iter(self.loaders[i])
                    try:
                        aux = next(iters[i])
                    except StopIteration:
                        # PEP 479 would surface this as an opaque
                        # "generator raised StopIteration"
                        raise ValueError(
                            f"aux loader {i} is empty (dataset smaller "
                            f"than its per-host batch under drop_last?) — "
                            f"cannot zip with the master loader") from None
                out.extend(aux)
            yield tuple(out)


class GroupedBatchSampler:
    """Batches within aspect-ratio groups, preserving sampler order, with a
    DETERMINISTIC batch count.

    ref: pretrain/data/samplers/grouped_batch_sampler.py:9-113 (from
    maskrcnn-benchmark), wired to TRAIN.ASPECT_GROUPING. Groups here are any
    integer labels (the reference uses horizontal/vertical = 0/1).

    Unlike the reference's sampler — whose per-rank batch count depends on
    each rank's group composition, which is exactly the distributed-RefCOCO
    deadlock its README warns about (README.md:137-139: ranks desync at the
    epoch barrier) — every epoch here yields EXACTLY
    ``len(indices) // batch_size`` (drop_uneven) or ``ceil`` full-size
    batches on every rank: per-group full batches first, then leftovers of
    all groups merged (mixed-group, at most #groups-1 such batches) and
    wrap-padded to the static batch size.
    """

    def __init__(self, indices, group_ids, batch_size, drop_uneven=False):
        self.indices = np.asarray(indices)
        self.group_ids = np.asarray(group_ids)
        self.batch_size = batch_size
        self.drop_uneven = drop_uneven

    def __iter__(self):
        B = self.batch_size
        target = len(self)
        order = {int(idx): pos for pos, idx in enumerate(self.indices)}
        clusters = {}
        for idx in self.indices:
            g = int(self.group_ids[int(idx)])
            clusters.setdefault(g, []).append(int(idx))
        batches, leftovers = [], []
        for g, idxs in clusters.items():
            n_full = len(idxs) // B
            for i in range(n_full):
                batches.append(idxs[i * B:(i + 1) * B])
            leftovers.extend(idxs[n_full * B:])
        while len(batches) < target and leftovers:
            chunk = leftovers[:B]
            leftovers = leftovers[B:]
            if len(chunk) < B:   # wrap-pad to the static batch size
                chunk = list(np.resize(np.asarray(chunk), B))
            batches.append(chunk)
        batches = batches[:target]
        # preserve sampler order: sort batches by first element's position
        batches.sort(key=lambda b: order[int(b[0])])
        return iter(batches)

    def __len__(self):
        n, B = len(self.indices), self.batch_size
        return n // B if self.drop_uneven else -(-n // B)
