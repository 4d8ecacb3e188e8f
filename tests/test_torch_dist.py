"""Data parallelism of the port (TPU.PARTITION_MODE dp over
torch.distributed) on the CPU: two gloo ranks, each a process started with
torchrun's environment, at tiny width in fp32 with dropout off.

The bar is the JAX package's semantics: a step over N ranks equals the
one-process step over the global batch, the ranks' shards concatenated.
Two ranks are held to the JAX package's ``make_train_step`` on the
concatenated batch (VQA; RefCOCO+ from precomputed features with unequal
live boxes per rank, whose masked BCE divides by the global count), and
to one port process with GRAD_ACCUMULATE_STEPS 2; then ``train_net``:
rank 0 alone writes, a rank without the checkpoint resumes to rank 0's
epoch and moments, and validation over the rank-sharded loader equals
one process's over the whole split.

Each spawned group has a time limit of RANK_TIMEOUT seconds and fails on
a hang. The rank processes import this module: jax and the JAX package's
models are imported inside the parent's functions only.
"""

import hashlib
import os
import pickle
import socket
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120
WORLD = 2
# the bar of tests/test_torch_models.py (fp32, dropout off)
TOL = dict(rtol=1e-3, atol=1e-4)
# two ranks against one port process: fp32 sums in another order
PORT_TOL = dict(rtol=1e-5, atol=1e-5)
T, O, F, A = 8, 5, 16, 6
# live boxes of each RefCOCO+ row: the two ranks' shards differ
LIVE = (5, 5, 2, 3, 5, 1, 4, 2)


# ---------------------------------------------------------------- configs

def _cfg(task, batch_images, accum=1, dropout=0.0):
    """The tiny fp32 config of ``task`` (vqa, refcoco): 2 layers, hidden
    32, precomputed features, AdamW with clipping, weight decay and
    LR_MULT; BATCH_IMAGES ``batch_images``. The JAX package's config
    class, which the port reads too."""
    from vlbert_tpu.utils.config import default_config

    cfg = default_config(task)
    cfg.MODULE = "ResNetVLBERT"
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64
    v.vocab_size = 1050; v.max_position_embeddings = 32
    v.visual_ln = True
    v.visual_scale_text_init = 1.0; v.visual_scale_object_init = 1.0
    v.hidden_dropout_prob = dropout; v.attention_probs_dropout_prob = dropout
    cfg.NETWORK.IMAGE_FINAL_DIM = 32
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = True
    cfg.NETWORK.CLASSIFIER_DROPOUT = dropout
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = F
    if task == "vqa":
        cfg.NETWORK.CLASSIFIER_TYPE = "2fc"
        cfg.NETWORK.CLASSIFIER_HIDDEN_SIZE = 24
        cfg.DATASET.ANSWER_VOCAB_SIZE = A
    t = cfg.TRAIN
    t.BATCH_IMAGES = batch_images
    t.GRAD_ACCUMULATE_STEPS = accum
    t.LR = 1e-3 / 4
    t.LR_SCHEDULE = "triangle"
    t.WARMUP = False
    t.END_EPOCH = 2
    t.WD = 1e-4
    t.CLIP_GRAD_NORM = 1.0
    t.OPTIMIZER = "AdamW"
    t.LR_MULT = [("final_mlp", 10.0), ("embedding_LayerNorm", 0.5)]
    cfg._world_size = 1
    return cfg


def _global_batch(task, B, seed=0):
    """(inputs, label) of a global batch of B rows, numpy."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 40, (B, O, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (B, O, 2)),
                            rng.normal(size=(B, O, F))], -1).astype(np.float32)
    box_mask = np.ones((B, O), bool)
    im_info = np.tile(np.asarray([[64, 48, 1.0, 1.0]], np.float32), (B, 1))
    ids = rng.integers(1000, 1050, (B, T)).astype(np.int32)
    text_mask = np.ones((B, T), bool)
    text_mask[1::3, 6:] = False
    if task == "vqa":
        box_mask[1::4, 3:] = False
        ans_pos = np.full((B,), 4, np.int32)
        label = (rng.uniform(0, 1, (B, A))
                 * (rng.uniform(size=(B, A)) < 0.4)).astype(np.float32)
        return (None, boxes, box_mask, im_info, ids,
                np.zeros((B, T), np.int32), text_mask, ans_pos), label
    for b in range(B):
        box_mask[b, LIVE[b]:] = False
    label = np.where(box_mask, rng.uniform(size=(B, O)) < 0.4, -1.0) \
        .astype(np.float32)
    label[:, 0] = 1.0
    return (None, boxes, box_mask, im_info, ids, text_mask), label


def _shard(x, rank, world, accum):
    """Rank ``rank``'s rows of a global batch laid out as the JAX package
    lays out accumulation: micro-step i is rows [i M, (i + 1) M) of the
    global batch (M = its micro batch), and its rank shards are M / world
    rows each in rank order."""
    if x is None:
        return None
    M = x.shape[0] // accum
    m = M // world
    return np.concatenate([x[i * M + rank * m:i * M + (rank + 1) * m]
                           for i in range(accum)])


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------ the rank processes

def _port_model(cfg, task):
    from vlbert_tpu_torch.models.task_modules import build_module

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the ignored TPU.* knobs
        tm = build_module(cfg, task, dtype=torch.float32)
    tm.image_feature_extractor.obj_downsample[0].rate = 0.0
    return tm


def _steps(cfg, task, state_dict, batch, n, world, seed=7):
    """``n`` port train steps of ``batch`` from ``state_dict``; returns
    (losses, grad norms, final state dict)."""
    from vlbert_tpu_torch.training.loop import make_train_step
    from vlbert_tpu_torch.training.optim import Optimizer

    tm = _port_model(cfg, task)
    tm.load_state_dict(state_dict)
    accum = cfg.TRAIN.GRAD_ACCUMULATE_STEPS
    step = make_train_step(tm, Optimizer(cfg, tm, 4, world), task, cfg,
                           accum)
    batch = tuple(None if x is None else torch.from_numpy(np.asarray(x))
                  for x in batch)
    losses, norms = [], []
    for i in range(n):
        loss, dm = step(batch, seed + i)
        losses.append(loss.item())
        norms.append(float(dm["grad_total_norm"][0]))
    return losses, norms, {k: v.clone() for k, v in tm.state_dict().items()}


def _rank_steps(rank, world, d):
    """The step scenarios of one rank under the process group."""
    import vlbert_tpu_torch.training.loop as loop

    out = {}
    for name, case in d["cases"].items():
        cfg = _cfg(case["task"], case["batch_images"] // world,
                   case["accum"])
        shard = tuple(_shard(x, rank, world, case["accum"])
                      for x in case["batch"])
        out[name] = _steps(cfg, case["task"], case["init"], shard,
                           case["n"], world)
    # dropout on, the same rows and weights on both ranks: the loss
    # before the all-reduce is each rank's own draw
    local, saved = [], loop.dist_lib.all_reduce_step_stats

    def keep_local(loss, metrics, **kw):
        local.append(loss.item())
        return saved(loss, metrics, **kw)

    loop.dist_lib.all_reduce_step_stats = keep_local
    try:
        case = d["cases"]["vqa"]
        cfg = _cfg("vqa", case["batch_images"] // world, dropout=0.5)
        same = tuple(_shard(x, 0, world, 1) for x in case["batch"])
        out["dropout"] = (local, _steps(cfg, "vqa", case["init"], same, 1,
                                        world)[0])
    finally:
        loop.dist_lib.all_reduce_step_stats = saved
    # a non-finite loss on rank 1 alone
    case = d["cases"]["vqa"]
    bad = [_shard(x, rank, world, 1) for x in case["batch"]]
    if rank == 1:
        bad[-1] = np.full_like(bad[-1], np.nan)
    try:
        _steps(_cfg("vqa", case["batch_images"] // world), "vqa",
               case["init"], bad, 1, world)
        out["nan"] = None
    except FloatingPointError as e:
        out["nan"] = str(e)
    return out


def _rank_train_net(rank, world, d):
    """train_net twice on the tiny VQA fixture: epoch 0, then AUTO_RESUME
    to END_EPOCH 2. Rank 1 has an output directory of its own, so it
    finds no checkpoint to resume from."""
    import vlbert_tpu_torch.engine.train as t_train
    from vlbert_tpu_torch.parallel import dist as dist_lib

    kept, saved = {"val_sums": []}, t_train.resume
    saved_acc = dist_lib.all_reduce_accumulator

    def summed(acc, device, **kw):
        saved_acc(acc, device, **kw)
        kept["val_sums"].append({k: (acc.sums[k], acc.nums[k])
                                 for k in acc.sums})
        return acc

    def resume(prefix, model, optimizer, config):
        begin_epoch, extra = saved(prefix, model, optimizer, config)
        kept.setdefault("resumed", []).append({
            "begin_epoch": begin_epoch, "count": optimizer.count,
            "best_val": extra.get("best_val"),
            "mu": _digest(optimizer.mu), "nu": _digest(optimizer.nu),
            "mu_abs": float(sum(m.abs().sum() for m in optimizer.mu)),
            "params": _digest(model.parameters()),
            "base_lr": optimizer.base_lr})
        return begin_epoch, extra

    t_train.resume = resume
    dist_lib.all_reduce_accumulator = summed
    runs = []
    try:
        for end_epoch in (1, 2):
            cfg = _train_net_cfg(d, end_epoch)
            cfg.OUTPUT_PATH = os.path.join(d["tmp"], f"out{rank}")
            # the second run scores the best checkpoint: rank 0 alone
            args = types.SimpleNamespace(
                model_dir="", device="cpu", do_test=end_epoch == 2, ckpt="",
                result_path=os.path.join(d["tmp"], f"res{rank}"),
                result_name="tiny")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                model, history = t_train.train_net(args, cfg, "vqa")
            runs.append({"history": history,
                         "params": _digest(model.parameters()),
                         "results": sorted(os.listdir(args.result_path))
                         if os.path.isdir(args.result_path) else []})
    finally:
        t_train.resume = saved
        dist_lib.all_reduce_accumulator = saved_acc
    files = {r: sorted(os.listdir(os.path.join(d["tmp"], f"out{r}",
                                               "vqa_train")))
             for r in range(world)}
    return {"runs": runs, "resumed": kept["resumed"], "files": files,
            "val_sums": kept["val_sums"]}


def _train_net_cfg(d, end_epoch):
    import pathlib

    from tests.test_entrypoints import _tiny_vqa_cfg

    cfg = _tiny_vqa_cfg(pathlib.Path(d["tmp"]), d["data_dir"],
                        d["vocab_dir"])
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = 32
    cfg.TPU.PROCESS_WORKERS = False
    cfg.TRAIN.LR, cfg.TRAIN.WARMUP = 1e-3, False
    cfg.TRAIN.END_EPOCH = end_epoch
    cfg.RNG_SEED = 0
    return cfg


def _rank_main(scenario, tmp):
    """One rank (RANK, WORLD_SIZE, MASTER_* from the environment): runs
    ``scenario`` under a gloo process group on the CPU and pickles what it
    returns to ``{tmp}/{scenario}_rank{rank}.pkl``."""
    from vlbert_tpu_torch.parallel import dist as dist_lib

    torch.set_num_threads(2)
    with open(os.path.join(tmp, f"{scenario}.pkl"), "rb") as f:
        d = pickle.load(f)
    with dist_lib.process_group("gloo", "cpu"):
        rank, world = dist_lib.rank_world()
        out = {"steps": _rank_steps,
               "train_net": _rank_train_net}[scenario](rank, world, d)
    out["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(tmp, f"{scenario}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(rank, port, world=WORLD):
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def start_ranks(scenario, tmp, payload, module="tests.test_torch_dist",
                env_of=torchrun_env, world=WORLD):
    """Start ``module._rank_main(scenario, tmp)`` on ``world`` rank
    processes, rank r with ``env_of(r, port)`` (torchrun's variables of
    ``world`` ranks by default; the inherited ones dropped) and a free
    port; returns what ``finish_ranks`` takes."""
    if env_of is torchrun_env:
        def env_of(rank, port):
            return torchrun_env(rank, port, world)
    with open(os.path.join(tmp, f"{scenario}.pkl"), "wb") as f:
        pickle.dump(payload, f)
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT") and not k.startswith("SLURM_")}
    procs = []
    for rank in range(world):
        env = {**base, **env_of(rank, port), "OMP_NUM_THREADS": "2"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             f"import {module} as t; "
             f"t._rank_main({scenario!r}, {str(tmp)!r})"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return scenario, tmp, procs


def finish_ranks(started, timeout=RANK_TIMEOUT):
    """Each rank's result of ``start_ranks``' group. Fails on a rank's
    error or when the group outlives ``timeout`` seconds."""
    scenario, tmp, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{scenario}: the ranks did not finish within "
                    f"{timeout} s (a hang)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} of {scenario}:\n{log[-4000:]}"
    out = []
    for rank in range(len(procs)):
        with open(os.path.join(tmp, f"{scenario}_rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    assert not any(o["jax_imported"] for o in out)
    return out


def _spawn(scenario, tmp, payload):
    """Run ``scenario`` on WORLD ranks; returns each rank's result. Fails
    on a rank's error or when the group outlives RANK_TIMEOUT."""
    return finish_ranks(start_ranks(scenario, tmp, payload))


# ------------------------------------------------------------ the parent

def _jax_init(task, cfg, batch):
    """The JAX model of ``cfg`` and its variables (seed 0), dropout 0."""
    import jax
    import jax.numpy as jnp
    from vlbert_tpu.models.task_modules import build_module as j_build

    jm = j_build(cfg, task, dtype=jnp.float32)
    inputs, _ = batch
    v = jm.init(jax.random.PRNGKey(0),
                *[None if x is None else jnp.asarray(x) for x in inputs],
                train=False)
    return jm, v


def _jax_flat(tree):
    import jax
    from vlbert_tpu.training.checkpoint import flatten_params

    return {k: np.asarray(a) for k, a in
            flatten_params(jax.device_get(tree)).items()}


def _jax_steps(task, cfg, jm, v, batch, n):
    """``n`` steps of the JAX package's make_train_step on ``batch`` (one
    process, the global batch); (losses, grad norms, final flat params)."""
    import jax
    import jax.numpy as jnp
    from vlbert_tpu.training.loop import create_train_state
    from vlbert_tpu.training.loop import make_train_step as j_step

    state, tx, _, _ = create_train_state(jm, None, cfg, 4, params=v)
    step = jax.jit(j_step(jm, tx, task, cfg))
    batch = tuple(None if x is None else jnp.asarray(x) for x in batch)
    losses, norms = [], []
    for i in range(n):
        state, loss, dm = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(loss))
        norms.append(float(dm["grad_total_norm"][0]))
    return losses, norms, _jax_flat(state.params["params"])


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    """The JAX package's one-process steps, one port process's and the
    two ranks' on the same global batches."""
    import vlbert_tpu.models.fast_rcnn as j_fast_rcnn
    from vlbert_tpu.ops.dropout import Dropout as JDropout
    from vlbert_tpu_torch.training.convert import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("dist_steps")
    saved = j_fast_rcnn.Dropout
    # the fixed Dropout(0.1) before obj_downsample, off in both packages
    j_fast_rcnn.Dropout = lambda rate: JDropout(rate=0.0)
    try:
        cases, jax_out = {}, {}
        for task in ("vqa", "refcoco"):
            B = 4
            inputs, label = _global_batch(task, B)
            cfg = _cfg(task, B)
            jm, v = _jax_init(task, cfg, (inputs, label))
            tm = _port_model(cfg, task)
            init = state_dict_from_jax(_jax_flat(v["params"]), tm)
            batch = (*inputs, label)
            cases[task] = {"task": task, "batch_images": B, "accum": 1,
                           "batch": batch, "init": init, "n": 2}
            losses, norms, flat = _jax_steps(task, cfg, jm, v, batch, 2)
            jax_out[task] = (losses, norms, state_dict_from_jax(flat, tm))
            # accumulation: 8 rows, 2 micro-steps of 4 (2 a rank)
            inputs8, label8 = _global_batch(task, 8, seed=1)
            cases[f"{task}_accum"] = {"task": task, "batch_images": 4,
                                      "accum": 2,
                                      "batch": (*inputs8, label8),
                                      "init": init, "n": 2}
    finally:
        j_fast_rcnn.Dropout = saved
    one = {}
    for name, case in cases.items():
        if name.endswith("_accum"):
            cfg = _cfg(case["task"], case["batch_images"], case["accum"])
            one[name] = _steps(cfg, case["task"], case["init"],
                               case["batch"], case["n"], 1)
    ranks = _spawn("steps", str(tmp), {"cases": cases})
    return {"jax": jax_out, "one": one, "ranks": ranks}


def _assert_state_close(got, want, **tol):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("task", ["vqa", "refcoco"])
def test_two_ranks_equal_the_jax_one_process_step(steps_run, task):
    """Two ranks of 2 rows each take the JAX package's step over the 4
    rows: losses, gradient norms and the parameters after 2 AdamW steps.
    RefCOCO+'s ranks hold 10 and 5 live boxes: its masked BCE divides by
    the 15 of the global batch."""
    want_loss, want_norm, want_sd = steps_run["jax"][task]
    for rank_out in steps_run["ranks"]:
        losses, norms, sd = rank_out[task]
        np.testing.assert_allclose(losses, want_loss, rtol=1e-5)
        np.testing.assert_allclose(norms, want_norm, rtol=1e-4)
        _assert_state_close(sd, want_sd, **TOL)


@pytest.mark.parametrize("task", ["vqa", "refcoco"])
def test_two_ranks_equal_one_process_under_accumulation(steps_run, task):
    """GRAD_ACCUMULATE_STEPS 2: two ranks of 2 micro-steps of 2 rows equal
    one port process of 2 micro-steps of 4 rows, micro-step i being the
    ranks' micro-steps i side by side (the JAX package's layout)."""
    want_loss, want_norm, want_sd = steps_run["one"][f"{task}_accum"]
    for rank_out in steps_run["ranks"]:
        losses, norms, sd = rank_out[f"{task}_accum"]
        np.testing.assert_allclose(losses, want_loss, rtol=1e-5)
        np.testing.assert_allclose(norms, want_norm, rtol=1e-5)
        _assert_state_close(sd, want_sd, **PORT_TOL)


def test_parameters_are_identical_across_ranks(steps_run):
    """After 2 steps every parameter is the same on both ranks, bit for
    bit: the averaged gradient and the update are computed alike."""
    r0, r1 = steps_run["ranks"]
    for case in ("vqa", "refcoco", "vqa_accum", "refcoco_accum"):
        sd0, sd1 = r0[case][2], r1[case][2]
        assert all(torch.equal(sd0[k], sd1[k]) for k in sd0), case
        assert r0[case][0] == r1[case][0], case


def test_dropout_masks_differ_across_ranks(steps_run):
    """The same rows, weights and step seed on both ranks, dropout 0.5:
    each rank's seed folds in its rank, so the losses before the
    all-reduce differ; after it both ranks hold their mean."""
    (local0, loss0), (local1, loss1) = (r["dropout"]
                                        for r in steps_run["ranks"])
    assert local0[0] != local1[0]
    assert loss0 == loss1
    np.testing.assert_allclose(loss0[0], (local0[0] + local1[0]) / 2,
                               rtol=1e-6)


def test_a_non_finite_loss_on_one_rank_raises_on_both(steps_run):
    """Rank 1's labels are NaN: the loss is all-reduced before the guard,
    so both ranks raise (and neither waits in a collective)."""
    for rank_out in steps_run["ranks"]:
        assert rank_out["nan"] and "non-finite loss nan" in rank_out["nan"]


@pytest.fixture(scope="module")
def train_net_run(tmp_path_factory):
    from tests.test_entrypoints import _write_vqa_fixture

    tmp = tmp_path_factory.mktemp("dist_train_net")
    data_dir, vocab_dir = _write_vqa_fixture(tmp)
    d = {"tmp": str(tmp), "data_dir": data_dir, "vocab_dir": vocab_dir}
    return d, _spawn("train_net", str(tmp), d)


def test_rank0_alone_writes_and_a_rank_without_the_file_resumes(
        train_net_run):
    """train_net on 2 ranks: rank 0 alone writes the checkpoints and the
    best; the second run AUTO_RESUMEs on rank 0, and rank 1, whose output
    directory holds no checkpoint, takes rank 0's epoch, count, best
    validation metric, weights and AdamW moments; both end identical.
    Rank 0 alone runs --do-test, over the unsharded test split."""
    _, (r0, r1) = train_net_run
    assert r0["files"][0] == ["tiny-0000.model", "tiny-0001.model",
                              "tiny-best.model", "train_rank0.log"]
    assert r0["files"][1] == ["train_rank1.log"]
    first, second = r0["resumed"][1], r1["resumed"][1]
    assert first["begin_epoch"] == second["begin_epoch"] == 1
    assert first["count"] == second["count"] == 4
    assert first["best_val"] == second["best_val"] is not None
    for key in ("mu", "nu", "params"):
        assert first[key] == second[key], key
    assert second["mu_abs"] > 0
    for run0, run1 in zip(r0["runs"], r1["runs"]):
        assert run0["params"] == run1["params"]
        assert run0["history"]["loss"] == run1["history"]["loss"]
    h0 = r0["runs"][1]["history"]
    assert (h0["begin_epoch"], h0["resumed_count"], len(h0["loss"])) \
        == (1, 4, 4)
    # --do-test: rank 0 scores the 4 questions of the unsharded split
    assert len(h0["test"]) == 4 and r0["runs"][1]["results"] \
        == ["tiny_vqa2_test.json"]
    assert r1["runs"][1]["history"]["test"] is None
    assert r1["runs"][1]["results"] == []


def test_sharded_validation_equals_one_process(train_net_run):
    """Each rank validates 2 of the 4 val questions; the all-reduced
    (sum, count) counts each question once, and SoftAcc is the same on
    both ranks and equals one process's over the whole split, from the
    same checkpoint."""
    from vlbert_tpu_torch.data.build import make_dataloader
    from vlbert_tpu_torch.engine.val import make_validation_fn
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib

    d, (r0, r1) = train_net_run
    for run in range(2):
        v0 = r0["runs"][run]["history"]["val"]
        assert v0 == r1["runs"][run]["history"]["val"] and len(v0) == 1
    cfg = _train_net_cfg(d, 2)
    tm = _port_model(cfg, "vqa")
    ckpt_lib.load_checkpoint(os.path.join(d["tmp"], "out0", "vqa_train",
                                          "tiny-0001.model"), tm)
    loader = make_dataloader(cfg, "vqa", "val")
    assert len(loader) == 4
    want = make_validation_fn(tm, cfg, "vqa", "cpu")(loader)
    got = r0["runs"][1]["history"]["val"][0]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    assert r0["val_sums"] == r1["val_sums"] and len(r0["val_sums"]) == 2
    for k, (total, count) in r0["val_sums"][-1].items():
        assert count == len(loader)
        assert total == pytest.approx(want[k] * count, rel=1e-6)


def test_the_lr_scales_by_world(train_net_run):
    """Base LR = TRAIN.LR x world x BATCH_IMAGES x accumulation, on every
    rank, as the JAX package's schedule gives it at 2 devices."""
    from vlbert_tpu.training.optim import make_lr_schedule as j_schedule

    d, ranks = train_net_run
    cfg = _train_net_cfg(d, 2)
    cfg._world_size = WORLD
    want = j_schedule(cfg, 4)[1]
    assert want == pytest.approx(WORLD * cfg.TRAIN.LR
                                 * cfg.TRAIN.BATCH_IMAGES, rel=1e-12)
    for r in ranks:
        assert [x["base_lr"] for x in r["resumed"]] \
            == pytest.approx([want, want], rel=1e-12)


# --------------------------------------------------- in-process checks

@pytest.mark.parametrize("tpu", [{"PARTITION_MODE": "fsdp"},
                                 {"PARTITION_MODE": "tp"},
                                 {"MESH_SHAPE": [4]},
                                 {"MESH_SHAPE": [1, 2]}])
def test_fsdp_tp_and_a_mismatched_mesh_are_refused_before_a_model_is_built(
        tmp_path, monkeypatch, tpu):
    """At 2 ranks train_net refuses PARTITION_MODE tp without a model axis
    (the JAX package's ValueError, at one rank too), a MESH_SHAPE that
    does not lay out 2 devices and one with a model axis under dp, naming
    what is missing, before it builds a model or a loader; tp passes the
    check at [1, 2] with MESH_AXES [data, model] (tests/test_torch_tp.py)
    and is refused when the model axis does not divide the heads; fsdp
    passes over a MESH_SHAPE of [] or [2] (FSDP2,
    tests/test_torch_fsdp.py) and over [1, 2] and [2, 2] with MESH_AXES
    [data, model] (tests/test_torch_fsdp_tp.py), and is refused on other
    axes. At one rank every other config passes (the knobs warn)."""
    import vlbert_tpu_torch.engine.train as t_train
    from tests.test_entrypoints import _tiny_vqa_cfg, _write_vqa_fixture
    from vlbert_tpu_torch.parallel.dist import check_partition

    data_dir, vocab_dir = _write_vqa_fixture(tmp_path)
    cfg = _tiny_vqa_cfg(tmp_path, data_dir, vocab_dir)
    for k, v in tpu.items():
        cfg.TPU[k] = v
    jax_tp = "TPU.PARTITION_MODE=tp needs a 'model' mesh axis > 1"
    if tpu.get("PARTITION_MODE") == "tp":
        with pytest.raises(ValueError, match=jax_tp):
            check_partition(cfg, 1)
        cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES = [1, 2], ["data", "model"]
        check_partition(cfg, 2)
        cfg.TPU.MESH_SHAPE = [1, 4]
        with pytest.raises(ValueError, match="num_attention_heads 2 not "
                                             "divisible by 4"):
            check_partition(cfg, 4)
        cfg.TPU.MESH_SHAPE = [2, 1]
    else:
        check_partition(cfg, 1)
    if tpu.get("PARTITION_MODE") == "fsdp":
        for shape in ([], [2]):
            cfg.TPU.MESH_SHAPE = shape
            check_partition(cfg, 2)
        cfg.TPU.MESH_AXES = ["data", "model"]
        for shape, world in (([1, 2], 2), ([2, 2], 4)):
            cfg.TPU.MESH_SHAPE = shape
            check_partition(cfg, world)
        cfg.TPU.MESH_AXES = ["data", "foo"]
        with pytest.raises(ValueError, match="MESH_AXES"):
            check_partition(cfg, 4)
        return
    built = []
    monkeypatch.setattr(t_train, "dist_rank_world", lambda: (0, 2))
    monkeypatch.setattr(t_train, "build_module",
                        lambda *a, **kw: built.append(a))
    monkeypatch.setattr(t_train, "make_dataloader",
                        lambda *a, **kw: built.append(a))
    args = types.SimpleNamespace(model_dir="", device="cpu")
    want = {"tp": jax_tp}.get(
        tpu.get("PARTITION_MODE"),
        "lays out 4 devices" if tpu.get("MESH_SHAPE") == [4]
        else "model axis")
    with pytest.raises((NotImplementedError, ValueError), match=want):
        t_train.train_net(args, cfg, "vqa")
    assert built == []
    cfg.TPU.PARTITION_MODE = "dp"
    cfg.TPU.MESH_SHAPE = [2]
    check_partition(cfg, 2)


_MASKED = {
    "bce_with_logits_masked": lambda L, rng: (
        rng.normal(size=(2, 5)), (rng.uniform(size=(2, 5)) < 0.5) * 1.0,
        rng.uniform(size=(2, 5)) < [[0.9], [0.4]][L % 2]),
    "masked_cross_entropy": lambda L, rng: (
        rng.normal(size=(2, 5, 7)), rng.integers(0, 7, (2, 5)),
        rng.uniform(size=(2, 5)) < [[0.9], [0.3]][L % 2]),
    "cross_entropy_ignore_index": lambda L, rng: (
        rng.normal(size=(2, 6, 9)),
        np.where(rng.uniform(size=(2, 6)) < [0.7, 0.2][L % 2],
                 rng.integers(0, 9, (2, 6)), -1)),
    "soft_cross_entropy": lambda L, rng: (
        rng.normal(size=(2, 4, 5)), _soft(rng, (2, 4, 5), [0.8, 0.3][L % 2])),
    # batch first: the count is of the examples with any valid entry
    "cross_entropy_ignore_index_batch_first": lambda L, rng: (
        rng.normal(size=(3, 6, 9)),
        np.where((rng.uniform(size=(3, 6)) < 0.6) & (np.arange(3) <= 2 - 2 * L)
                 [:, None], rng.integers(0, 9, (3, 6)), -1)),
    "soft_cross_entropy_batch_first": lambda L, rng: (
        rng.normal(size=(3, 4, 5)),
        _soft(rng, (3, 4, 5), 0.7) * (np.arange(3) <= 2 - 2 * L)[:, None,
                                                                  None]),
}


def _soft(rng, shape, p):
    """Soft labels that sum to 1 on a fraction ``p`` of the rows, 0
    elsewhere."""
    s = rng.uniform(size=shape)
    s /= s.sum(-1, keepdims=True)
    return s * (rng.uniform(size=shape[:-1]) < p)[..., None]


@pytest.mark.parametrize("name", sorted(_MASKED))
def test_masked_losses_divide_by_the_global_count(name):
    """Each loss with a data-dependent denominator, computed on two
    shards with unequal counts within ``global_counts`` (the all-reduce
    here a sum over the two shards' counts): the mean of the two losses
    equals the loss of the concatenated batch, and so do the mean of
    their gradients. Outside the block each shard divides by its own
    count, as before."""
    from vlbert_tpu_torch.utils import losses

    fn = getattr(losses, name)
    rng = np.random.default_rng(3)
    shards = [[torch.tensor(x) for x in _MASKED[name](r, rng)]
              for r in range(2)]
    for s in shards:
        s[0] = s[0].float().requires_grad_()
    whole = [torch.cat([s[i].detach() for s in shards])
             for i in range(len(shards[0]))]
    whole[0].requires_grad_()
    want = fn(*whole)
    want.backward()
    # the shards' own counts (one rank), then the global count they sum to
    probe = []
    with losses.global_counts(lambda c: probe.append(c) or c, 1):
        for s in shards:
            fn(*[x.detach() for x in s])
    assert len(probe) == 2 and float(probe[0]) != float(probe[1])
    total = probe[0] + probe[1]
    got = []
    for s in shards:
        with losses.global_counts(lambda c: total, 2):
            got.append(fn(*s))
    (got[0] + got[1]).div(2).backward()
    np.testing.assert_allclose(float((got[0] + got[1]).detach() / 2),
                               float(want.detach()), rtol=1e-6)
    grads = torch.cat([s[0].grad for s in shards])
    np.testing.assert_allclose(grads.numpy(), whole[0].grad.numpy(),
                               rtol=1e-5, atol=1e-8)
    # outside the block: the shard's own count, the code path of one process
    local = fn(*[x.detach() for x in shards[1]])
    assert float(local) != pytest.approx(float(got[1].detach()))


def test_device_and_backend_are_never_chosen_silently(monkeypatch):
    """--device wins; else cuda:LOCAL_RANK, and a LOCAL_RANK without a
    card of its own raises; nccl by default on a card, gloo on the CPU,
    nccl on the CPU refused; --dist without torchrun's environment
    raises."""
    from vlbert_tpu_torch.engine.cli import parse_args, parse_test_args
    from vlbert_tpu_torch.parallel import dist as dist_lib

    assert dist_lib.resolve_device("cpu", 5) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist_lib.resolve_device(None, 0) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card"):
        dist_lib.resolve_device(None, 1)
    assert dist_lib.default_backend("cuda:0") == "nccl"
    assert dist_lib.default_backend("cpu") == "gloo"
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": "1"}
    with pytest.raises(ValueError, match="nccl backend needs a CUDA"):
        dist_lib.init_from_env("nccl", "cpu", env=env)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        dist_lib.init_from_env("gloo", "cpu", env={"RANK": "0"})
    assert not dist_lib.is_distributed()
    args = parse_args(argv=["--task", "vqa", "--cfg", "x.yaml", "--dist",
                            "--dist-backend", "gloo"])
    assert (args.dist, args.dist_backend, args.device) == (True, "gloo",
                                                           None)
    args = parse_args(argv=["--task", "vqa", "--cfg", "x.yaml"])
    assert (args.dist, args.dist_backend) == (False, None)
    assert parse_test_args(["--task", "vqa", "--cfg", "x.yaml", "--ckpt",
                            "c.model"]).device == "cuda"
