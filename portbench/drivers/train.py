"""The training driver: one run of a fine-tuning cell.

Set-up writes the traffic mix's data under TMPDIR, builds the model with
the program's ``build_module`` and ``apply_trainable_mask``, loads the
weights the benchmark made from the seed, and builds the program's loader
(``make_dataloader``), optimizer and ``make_train_step``, as the
program's ``train_net`` does. Its first steps go through the window's own
feed (the loader, ``to_device``, a step seed from a seeded generator,
``train_step``, ``float(loss)``, as ``fit``'s inner loop): the first
``check_steps`` are recorded for the comparison with the reference, the
next ``warmup_steps`` warm up. Then the window takes steps for
``seconds``. With ``trace`` a profiler window covers ``profile_steps``
steps from the window's ``profile_from``-th, and the run reports the
per-layer metrics instead of the end-to-end ones.

Once the window has closed and the peak memory has been read, the
program's state is freed and the reference takes the recorded steps; the
comparison (``check.py``) decides ``correct``. No checkpoint is written
and no validation runs.
"""

from __future__ import annotations

import copy
import gc
import statistics
import tempfile
import time

import torch
import yaml

from portbench import check, harness, trace as trace_lib, weights
from portbench.reference import model as ref_model, step as ref_step


def _set(d, key, value):
    *parents, leaf = key.split(".")
    for p in parents:
        d = d.setdefault(p, {})
    d[leaf] = value


def batch_stats(task, batch):
    """What a step's batch asks of the model: the live length of each
    sequence (text, live boxes and END), the live boxes of each image,
    and each image's resized (h, w)."""
    if task != "vcr":
        raise ValueError(f"no batch layout for task {task!r}")
    boxes = batch[4].sum(1)
    text = batch[8].sum(-1)                      # [B, C]
    lengths = (text + boxes[:, None] + 1).reshape(-1)
    hw = [(int(round(h)), int(round(w))) for w, h in batch[9][:, :2]]
    canvas = tuple(int(x) for x in batch[0].shape[1:3])
    return {"seq_lengths": [int(x) for x in lengths],
            "boxes": [int(x) for x in boxes], "image_hw": hw,
            "canvas": canvas}


class Feed:
    """The loader's batches, epoch after epoch (``fit``'s set_epoch)."""

    def __init__(self, loader):
        self.loader, self.epoch = loader, 0
        self.it = iter(loader)

    def next(self):
        try:
            return next(self.it)
        except StopIteration:
            self.epoch += 1
            self.loader.set_epoch(self.epoch)
            self.it = iter(self.loader)
            return next(self.it)


def program_config(cell, root, seed, data_keys):
    """(the program's config, the same as a plain dict for the
    reference): the cell's configuration with the run's data paths."""
    from vlbert_tpu_torch.utils.config import load_config

    spec = cell["config_spec"]
    raw = copy.deepcopy(spec["config"])
    for k, v in {**data_keys, "OUTPUT_PATH": f"{root}/out",
                 "RNG_SEED": int(seed)}.items():
        _set(raw, k, v)
    path = f"{root}/config.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return load_config(spec["task"], path), raw


def faulty(train_step, fault, model):
    """``train_step`` broken as a check must catch: "unchanged" returns
    the state it was given; "half_batch" drops the second half of every
    batch (the losses are means, so the mean is over the rest);
    "answer" changes each answer label where the loader made it."""
    if fault is None:
        return train_step

    def step(batch, seed):
        if fault == "half_batch":
            batch = tuple(None if x is None else x[:x.shape[0] // 2]
                          for x in batch)
        elif fault == "answer":
            batch = batch[:-1] + ((batch[-1] + 1) % 4,)
        elif fault != "unchanged":
            raise ValueError(f"fault {fault!r}")
        if fault != "unchanged":
            return train_step(batch, seed)
        saved = [p.detach().clone() for p in model.parameters()]
        out = train_step(batch, seed)
        with torch.no_grad():
            for p, s in zip(model.parameters(), saved):
                p.copy_(s)
        return out

    return step


def leaf_norms(tensors):
    return [float(torch.linalg.vector_norm(t.float())) for t in tensors]


def run(cell, seed, seconds, trace, *, t_start, device="cuda", fault=None,
        control=False, window=True, keep_leaves=False):
    """One run; returns the result line's object. ``fault`` and
    ``control`` serve the checks that the comparison fails what it must:
    the program broken underneath, or the reference in float8 put in the
    program's place; ``window=False`` stops after set-up's steps;
    ``keep_leaves`` adds every leaf's norms to the result's detail."""
    from vlbert_tpu_torch.data.build import make_dataloader
    from vlbert_tpu_torch.data.tokenization import BertTokenizer
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.loop import make_train_step, to_device
    from vlbert_tpu_torch.training.optim import (Optimizer,
                                                 apply_trainable_mask)

    mix = cell["traffic_spec"]
    task = cell["config_spec"]["task"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="portbench-") as root:
        gen = harness.load(mix["generator"], cell["bench_dir"])
        data_keys, facts = gen.write(root, mix["data"], seed)
        cfg, raw = program_config(cell, root, seed, data_keys)
        shapes = ref_model.leaf_shapes(raw, task)

        model = build_module(cfg, task, device=dev)
        apply_trainable_mask(model, cfg)
        weights.load_into(model, weights.make(shapes, raw, seed, dev))
        tokenizer = BertTokenizer.from_pretrained(
            cfg.NETWORK.BERT_MODEL_NAME)
        loader = make_dataloader(cfg, task, "train", tokenizer)
        try:
            optimizer = Optimizer(cfg, model, len(loader), 1)
            accum = max(int(cfg.TRAIN.GRAD_ACCUMULATE_STEPS), 1)
            train_step = faulty(make_train_step(model, optimizer, task, cfg,
                                                accum),
                                fault, model)
            seeds = torch.Generator().manual_seed(int(seed))
            feed = Feed(loader)

            def take(host, on=False):
                with trace_lib.span("to_device", on):
                    batch = to_device(host, dev)
                s = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=seeds))
                with trace_lib.span("train_step", on):
                    loss, dm = train_step(batch, s)
                with trace_lib.span("loss", on):
                    return float(loss), s, dm

            # set-up's steps: the first ones recorded for the comparison
            checked = {"batches": [], "seeds": [], "loss": []}
            names = optimizer.names
            for i in range(mix["check_steps"]):
                host = feed.next()
                checked["batches"].append(host)
                if control:
                    s = int(torch.randint(0, 2 ** 63 - 1, (1,),
                                          generator=seeds))
                    checked["seeds"].append(s)
                    continue
                loss, s, dm = take(host)
                checked["loss"].append(loss)
                checked["seeds"].append(s)
                if i == 0:
                    checked["grad"] = dict(zip(names, leaf_norms(
                        first_gradient(optimizer, float(
                            dm["grad_total_norm"][0]), shapes, raw, seed,
                            dev))))
            if not control:
                start = weights.make(shapes, raw, seed, dev)
                checked["change"] = dict(zip(names, leaf_norms(
                    [p.detach() - start[n] for n, p in
                     zip(names, optimizer.params)])))
                del start
            for _ in range(mix["warmup_steps"] if window else 0):
                take(feed.next())
            if cuda:
                torch.cuda.synchronize()
            setup_s = time.perf_counter() - t_start

            timing = {"loader_s": [], "step_s": [], "stats": [],
                      "profiled": []}
            traced = None
            t0 = time.perf_counter()
            profile_at = mix["profile_from"] if trace else -1
            n = 0
            while window and time.perf_counter() - t0 < seconds:
                if n == profile_at:
                    traced, t_prof = profiled_steps(
                        feed, take, mix["profile_steps"], task, timing)
                    n += mix["profile_steps"]
                    continue
                a = time.perf_counter()
                host = feed.next()
                b = time.perf_counter()
                take(host)
                c = time.perf_counter()
                timing["loader_s"].append(b - a)
                timing["step_s"].append(c - b)
                timing["stats"].append(batch_stats(task, host))
                n += 1
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() if cuda else 0
        finally:
            loader.shutdown()
        del model, optimizer, train_step, loader, feed
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        numbers, worst, leaves = reference_check(cell, raw, task, checked,
                                                 seed, dev, facts, control)
    correct, table = check.verdict(numbers, cell["limits"])
    batch = cfg.TRAIN.BATCH_IMAGES
    steps = n
    result = {"correct": bool(correct), "attempted": steps, "failed": 0,
              "metrics": {}, "device": device_info(dev, peak)}
    if not trace:
        result["metrics"] = {
            "train_samples_per_s": {"value": steps * batch / wall
                                    if wall > 0 else None,
                                    "unit": "samples/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    elif traced is not None:
        ctx = {"task": task, "config": raw, "timing": timing,
               "traced": traced, "profiled_s": t_prof, "window_s": wall}
        for m in cell["per_layer"]:
            reader = harness.load(f"metrics/{m['name']}.py", cell["bench_dir"])
            value = reader.read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = trace_lib.busy_s(traced)
        result["device"]["window_s"] = trace_lib.window_s(traced)
        result["breakdown"] = {"device_ops": trace_lib.top_device_ops(traced),
                               "idle_gaps": trace_lib.idle_gaps(traced)}
    # the checked numbers come last
    result["detail"] = {"worst": worst, "program_loss": checked["loss"],
                        "window_s": wall, "steps": steps,
                        "step_ms": _quartiles(timing["step_s"]),
                        "loader_ms": _quartiles(timing["loader_s"])}
    if keep_leaves:
        result["detail"]["leaves"] = leaves
    result["check"] = table
    return result


def profiled_steps(feed, take, k, task, timing):
    """``k`` steps inside a profiler window; their stats go to
    ``timing["profiled"]``. Returns (the window's trace, its seconds)."""
    a = time.perf_counter()
    with trace_lib.profiled() as traced:
        for _ in range(k):
            with trace_lib.span("loader", True):
                host = feed.next()
            take(host, on=True)
            timing["profiled"].append(batch_stats(task, host))
    return traced, time.perf_counter() - a


@torch.no_grad()
def first_gradient(optimizer, norm, shapes, raw, seed, dev):
    """The first step's gradient as the optimizer got it, worked out from
    its state after that step: the clipped gradient is SGD's momentum less
    the coupled weight decay of the starting weights; the clip's factor is
    undone with the global norm the step reported."""
    if optimizer.kind != "SGD":
        raise ValueError(f"no first gradient from {optimizer.kind!r}")
    unclip = max(1.0, norm / optimizer.clip) if optimizer.clip > 0 else 1.0
    start = weights.make(shapes, raw, seed, dev)
    out = [(m - optimizer.wd * start[n]) * unclip
           for n, m in zip(optimizer.names, optimizer.mu)]
    del start
    return out


def reference_check(cell, raw, task, checked, seed, dev, facts, control):
    """The reference's steps over the recorded batches and seeds, and the
    numbers that compare the program's (or, as the control, the float8
    reference's) with them."""
    steps_per_epoch = facts["samples"] // int(raw["TRAIN"]["BATCH_IMAGES"])
    shapes = ref_model.leaf_shapes(raw, task)
    batches = [tuple(None if x is None else torch.as_tensor(x).to(dev)
                     for x in b) for b in checked["batches"]]
    start = weights.make(shapes, raw, seed, dev)
    ref = ref_step.run_steps(start, raw, task, batches, checked["seeds"],
                             steps_per_epoch)
    prog = checked
    if control:
        prog = ref_step.run_steps(start, raw, task, batches,
                                  checked["seeds"], steps_per_epoch,
                                  lower=True)
        checked["loss"] = prog["loss"]
    del start, batches
    numbers, worst = check.compare(prog, ref)
    worst["reference_loss"] = ref["loss"]
    leaves = {side: {k: r[k] for k in ("grad", "change")}
              for side, r in (("program", prog), ("reference", ref))}
    return numbers, worst, leaves


def device_info(dev, peak):
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": harness.device_kind(), "count": 1,
            "memory_peak_bytes": int(peak)}


def _quartiles(seconds):
    """(min, quartiles, max) of the window's step or loader times in ms."""
    if len(seconds) < 2:
        return None
    ms = sorted(x * 1e3 for x in seconds)
    return [ms[0], *statistics.quantiles(ms, n=4), ms[-1]]
