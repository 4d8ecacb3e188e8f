"""Sharded training state on the port (TPU.PARTITION_MODE fsdp as FSDP2)
and the SLURM rendezvous, on the CPU: two gloo ranks, each a process, at
tiny width in fp32.

The bar is the JAX package's semantics, as tests/test_torch_dist.py holds
``dp`` to it: a step of two fsdp ranks equals the JAX one-process step on
the concatenated batch (VQA, and multitask pretraining with unequal
masked counts on the ranks), with and without accumulation, and equals
the port's two ``dp`` ranks within 1e-6 of each tensor's largest element.
Each rank holds half the parameters and moments, up to dim 0's padding;
REMAT, validation between steps and a parameter that one rank's forward
does not reach keep fsdp equal to dp. ``train_net`` under fsdp writes
one file on rank 0 that a ``dp`` run's matches key for key, that one
process and the JAX package read, and that resumes on a rank without it.

Two spawned groups, started together while the parent runs the JAX
steps: "steps" rendezvouses from a faked SLURM environment (no RANK),
"train_net" from torchrun's; each takes one ``dp`` step of the same
batch, which must agree bit for bit. The rank processes import this
module and tests/test_torch_dist.py: jax and the JAX package's models are
imported inside the parent's functions only.
"""

import os
import pickle
import socket
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import tests.test_torch_dist as td

# a tensor's gap to the reference, over its largest element
REL = 1e-6
# the multitask pretraining model's tiny shapes: text, corpus text, box
# slots, feature width, region classes, vocabulary
PT, PT2, PO, PF, PC, PV = 10, 12, 5, 16, 11, 120


# ---------------------------------------------------------------- configs

def _pretrain_cfg(batch_images, accum=1):
    """The multitask MLM + MVRC + relationship config from precomputed
    features (tests/test_torch_pretrain.py's prec_aux) with the training
    settings of tests/test_torch_dist.py; BATCH_IMAGES [b, b]."""
    from vlbert_tpu.utils.config import default_config

    cfg = default_config("pretrain")
    cfg.MODULE = "ResNetVLBERTForPretrainingMultitask"
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64; v.vocab_size = PV
    v.max_position_embeddings = 64; v.visual_ln = True
    v.visual_scale_text_init = 1.0; v.visual_scale_object_init = 1.0
    v.hidden_dropout_prob = 0.0; v.attention_probs_dropout_prob = 0.0
    v.with_pooler = True; v.visual_region_classes = PC
    n = cfg.NETWORK
    n.IMAGE_FINAL_DIM = 32
    n.IMAGE_FEAT_PRECOMPUTED = True
    n.IMAGE_SEMANTIC = False
    n.ENABLE_CNN_REG_LOSS = False
    n.WITH_MLM_LOSS = n.WITH_MVRC_LOSS = n.WITH_REL_LOSS = True
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = PF
    t = cfg.TRAIN
    t.BATCH_IMAGES = [batch_images, batch_images]
    t.GRAD_ACCUMULATE_STEPS = accum
    t.LR = 1e-4
    t.LR_SCHEDULE = "triangle"
    t.WARMUP = False
    t.END_EPOCH = 2
    t.WD = 1e-4
    t.CLIP_GRAD_NORM = 1.0
    t.OPTIMIZER = "AdamW"
    t.LR_MULT = [("mlm_head", 2.0)]
    cfg._world_size = 1
    return cfg


def _pretrain_batch(B, seed=0):
    """The multitask loader's 10-tuple of B caption and B corpus rows:
    the whole-image box first, padded slots at -2 on odd rows, MLM and
    masked-region labels whose counts differ from row to row."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 40, (B, PO, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, (B, PO, 2)),
                            rng.normal(size=(B, PO, PF))],
                           -1).astype(np.float32)
    boxes[:, 0, :4] = (0, 0, 63, 47)
    boxes[1::2, 3:] = -2.0
    im_info = np.tile(np.asarray([[64, 48, 1.0, 1.0]], np.float32), (B, 1))
    text = rng.integers(5, PV, (B, PT)).astype(np.int32)
    text[::2, 7:] = 0
    mlm = np.full((B, PT), -1, np.int32)
    aux = rng.integers(5, PV, (B, PT2)).astype(np.int32)
    aux[1::2, 9:] = 0
    aux_mlm = np.full((B, PT2), -1, np.int32)
    ops = np.zeros((B, PO), np.int32)
    for b in range(B):
        for j in range(b % 3 + 1):
            mlm[b, 1 + 2 * j] = rng.integers(5, PV)
        aux_mlm[b, 2 + (b % 2) * 3] = rng.integers(5, PV)
        ops[b, 1 + (b % 2)] = 1
    mvrc = np.zeros((B, PO, PC), np.float32)
    for b, o in zip(*np.nonzero(ops)):
        p = rng.uniform(size=PC).astype(np.float32)
        mvrc[b, o] = p / p.sum()
    rel = (np.arange(B) % 2).astype(np.int32)
    return (None, boxes, im_info, text, rel, mlm, ops, mvrc, aux, aux_mlm)


def _case_cfg(case, world, **tpu):
    bi = case["batch_images"] // world
    cfg = (td._cfg("vqa", bi, case["accum"], dropout=case.get("dropout", 0.0))
           if case["task"] == "vqa" else _pretrain_cfg(bi, case["accum"]))
    for k, v in tpu.items():
        cfg.TPU[k] = v
    return cfg


# ------------------------------------------------------ the rank processes

def _full(module_state):
    """Each tensor of a state dict whole and on the CPU, on every rank
    (collective for FSDP2's DTensors: the same keys in the same order on
    every rank)."""
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib

    return {k: fsdp_lib.plain(v).detach().clone()
            for k, v in module_state.items()}


def _bound(tensors, world):
    """Elements of ``tensors`` a rank holds at most under dim-0 sharding:
    its chunk of dim 0, the last padded."""
    return sum(-(-t.shape[0] // world) * (t.numel() // t.shape[0])
               if t.dim() else t.numel() for t in tensors)


def _model(cfg, task):
    """The port model of ``cfg``, fp32 or (TRAIN.FP16) fp16, FastRCNN's
    fixed Dropout(0.1) off as in the JAX package's model here."""
    from vlbert_tpu_torch.models.task_modules import build_module

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the ignored TPU.* knobs
        tm = build_module(cfg, task, dtype=torch.float16 if cfg.TRAIN.FP16
                          else torch.float32)
    tm.image_feature_extractor.obj_downsample[0].rate = 0.0
    return tm


def _run(mode, case, rank, world, hook=None, save=None, train=None,
         **tpu):
    """``case["n"]`` port steps of the rank's shard of ``case["batch"]``
    under ``mode`` (dp, fsdp), for VQA an eval forward under
    inference_mode after the first. Returns losses, grad norms, the eval's
    metrics, the whole final state dict, the first moments and, under
    fsdp, (local elements, bound, total). ``hook(model, rank)`` edits the
    model before sharding; ``save`` a checkpoint prefix to write after the
    steps; ``train`` and ``tpu`` override TRAIN and TPU keys."""
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.loop import (make_eval_step,
                                                make_train_step)
    from vlbert_tpu_torch.training.optim import Optimizer

    task, accum = case["task"], case["accum"]
    cfg = _case_cfg(case, world, **tpu)
    for k, v in (train or {}).items():
        cfg.TRAIN[k] = v
    tm = _model(cfg, task)
    tm.load_state_dict(case["init"])
    if hook is not None:
        hook(tm, rank)
    if mode == "fsdp":
        fsdp_lib.shard_module(tm, "cpu")
    opt = Optimizer(cfg, tm, 4, world)
    step = make_train_step(tm, opt, task, cfg, accum)
    batch = tuple(None if x is None else torch.from_numpy(
        td._shard(x, rank, world, accum)) for x in case["batch"])
    eval_step = make_eval_step(tm, task, cfg)
    losses, norms, evals = [], [], []
    for i in range(case["n"]):
        loss, dm = step(batch, 7 + i)
        losses.append(loss.item())
        norms.append(float(dm["grad_total_norm"][0]))
        if i == 0 and task == "vqa":
            evals.append({k: [float(x) for x in v] for k, v in eval_step(
                batch[:-1], {"label": batch[-1]}).items()})
    if save is not None:
        ckpt_lib.save_checkpoint(save, 0, tm, opt, write=rank == 0)
    moments = opt.mu + opt.nu
    elements = None
    if mode == "fsdp":
        elements = (fsdp_lib.local_numel(opt.params + moments),
                    _bound(opt.params + moments, world),
                    sum(t.numel() for t in opt.params + moments))
    return {"losses": losses, "norms": norms, "evals": evals,
            "state": _full(tm.state_dict()),
            "mu": [fsdp_lib.plain(m).clone() for m in opt.mu],
            "elements": elements}


def _detach_end_embedding_on_rank1(tm, rank):
    """Rank 1's forward leaves ``vlbert.end_embedding`` unreached (its
    output detached: the same values, no gradient); rank 0's reaches it."""
    if rank != 1:
        return
    emb = tm.vlbert.end_embedding
    forward = emb.forward
    emb.forward = lambda ids: forward(ids).detach()


def _rank_steps(rank, world, d):
    """Group "steps", started from srun's environment: every case under
    dp and fsdp, then REMAT with dropout, a parameter reached on rank 1
    only, and the pretraining model's checkpoint under both modes."""
    from vlbert_tpu_torch.parallel import dist as dist_lib

    out = {"rendezvous": (os.environ.get("RANK"),
                          dist_lib.rank_world())}
    for name, case in d["cases"].items():
        for mode in ("dp", "fsdp"):
            save = (os.path.join(d["tmp"], f"pretrain_{mode}", "p")
                    if name == "pretrain" else None)
            out[name, mode] = _run(mode, case, rank, world, save=save)
    vqa = d["cases"]["vqa"]
    for mode in ("dp", "fsdp"):
        out["remat", mode] = _run(mode, {**vqa, "dropout": 0.1}, rank,
                                  world, REMAT=True)
        out["unreached", mode] = _run(mode, vqa, rank, world,
                                      hook=_detach_end_embedding_on_rank1)
        out["fp16", mode] = _run(mode, vqa, rank, world, train={
            "FP16": True, "FP16_LOSS_SCALE": 128.0}, FP16_PARITY_MODE=True)
    out["partial_load"] = _partial_load_sharded(vqa)
    out["reload"] = _reload_sharded(
        d["cases"]["pretrain"],
        os.path.join(d["tmp"], "pretrain_fsdp", "p-0000.model"))
    return out


def _reload_sharded(case, path):
    """The pretraining model's fsdp file loaded into a fresh fsdp model
    and optimizer (collective: rank 0 reads, each keeps its shard): the
    state, the first moments, both whole, and the count."""
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.optim import Optimizer

    cfg = _case_cfg(case, td.WORLD)
    tm = _model(cfg, case["task"])
    fsdp_lib.shard_module(tm, "cpu")
    opt = Optimizer(cfg, tm, 4, td.WORLD)
    ckpt_lib.load_checkpoint(path, tm, opt)
    return (_full(tm.state_dict()),
            [fsdp_lib.plain(m).clone() for m in opt.mu], opt.count)


def _partial_load_sharded(case):
    """``partial_load`` of a whole state dict into an fsdp model: (loaded,
    missing, mismatched) and the model's state after it, whole."""
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib

    tm = _model(_case_cfg(case, td.WORLD), case["task"])
    fsdp_lib.shard_module(tm, "cpu")
    report = ckpt_lib.partial_load(tm, case["init"])
    return report, _full(tm.state_dict())


def _rank_train_net(rank, world, d):
    """Group "train_net", torchrun's environment: train_net under fsdp,
    epoch 0 then AUTO_RESUME to END_EPOCH 2 with --do-test (rank 1's
    output directory has no checkpoint); one dp epoch into another
    directory; the dp step of "steps"' vqa case."""
    import vlbert_tpu_torch.engine.train as t_train
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib

    kept, saved = {"resumed": []}, t_train.resume

    def resume(prefix, model, optimizer, config):
        begin_epoch, extra = saved(prefix, model, optimizer, config)
        kept["resumed"].append({
            "begin_epoch": begin_epoch, "count": optimizer.count,
            "best_val": extra.get("best_val"),
            "mu": td._digest(fsdp_lib.plain(m) for m in optimizer.mu),
            "nu": td._digest(fsdp_lib.plain(m) for m in optimizer.nu),
            "params": td._digest(fsdp_lib.plain(p)
                                 for p in optimizer.params),
            "sharded": fsdp_lib.is_sharded(model)})
        return begin_epoch, extra

    t_train.resume = resume
    runs = []
    try:
        for mode, out_dir, end_epoch in (("fsdp", "out", 1),
                                         ("fsdp", "out", 2),
                                         ("dp", "dp", 1)):
            cfg = td._train_net_cfg(d, end_epoch)
            cfg.TPU.PARTITION_MODE = mode
            cfg.OUTPUT_PATH = os.path.join(d["tmp"], f"{out_dir}{rank}")
            args = types.SimpleNamespace(
                model_dir="", device="cpu", ckpt="",
                do_test=mode == "fsdp" and end_epoch == 2,
                result_path=os.path.join(d["tmp"], f"res{rank}"),
                result_name="tiny")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                model, history = t_train.train_net(args, cfg, "vqa")
            runs.append({"history": history,
                         "state": _full(model.state_dict()),
                         "results": sorted(os.listdir(args.result_path))
                         if os.path.isdir(args.result_path) else []})
    finally:
        t_train.resume = saved
    files = {r: sorted(os.listdir(os.path.join(d["tmp"], f"out{r}",
                                               "vqa_train")))
             for r in range(world)}
    return {"runs": runs, "resumed": kept["resumed"], "files": files,
            "dp_step": _run("dp", d["vqa"], rank, world),
            "rendezvous": (os.environ.get("RANK"), (rank, world))}


def _rank_main(scenario, tmp):
    """One rank: runs ``scenario`` under a gloo process group on the CPU
    (from torchrun's or srun's environment) and pickles what it returns
    to ``{tmp}/{scenario}_rank{rank}.pkl``."""
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


def _slurm_job_id():
    """A SLURM_JOB_ID whose port (``dist.slurm_port``) is free here."""
    from vlbert_tpu_torch.parallel.dist import slurm_port

    for job in range(4242, 4242 + 20000, 97):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", slurm_port(job)))
            except OSError:
                continue
            return job
    pytest.fail("no free port in 10000-29999")


def _slurm_env(job):
    """srun's variables of one task a card on one node, no torchrun
    variable; the node list compressed, its first host this machine."""
    def env_of(rank, _port):
        return {"SLURM_PROCID": str(rank), "SLURM_NTASKS": str(td.WORLD),
                "SLURM_LOCALID": str(rank), "SLURM_JOB_ID": str(job),
                "SLURM_STEP_NODELIST": "localhost,gpu[01-03,07]"}
    return env_of


# ------------------------------------------------------------ the parent

def _jax_init(task, cfg, batch):
    import jax
    import jax.numpy as jnp
    from vlbert_tpu.models.task_modules import build_module as j_build

    if task == "vqa":
        return td._jax_init(task, cfg, batch)
    jm = j_build(cfg, task, dtype=jnp.float32)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)},
                *[None if x is None else jnp.asarray(x) for x in batch],
                train=True)
    return jm, v


def _jax_steps(case, cfg, jm, v):
    """``case["n"]`` steps of the JAX package's make_train_step with
    ``case["accum"]`` micro-steps on the global batch, laid out
    [accum, micro, ...] as its loader lays it out; (losses, grad norms,
    final flat params)."""
    import jax
    import jax.numpy as jnp
    from vlbert_tpu.training.loop import create_train_state
    from vlbert_tpu.training.loop import make_train_step as j_step

    accum = case["accum"]
    state, tx, _, _ = create_train_state(jm, None, cfg, 4, params=v)
    step = jax.jit(j_step(jm, tx, case["task"], cfg, accum))
    batch = tuple(None if x is None else jnp.asarray(
        x.reshape(accum, -1, *x.shape[1:]) if accum > 1 else x)
        for x in case["batch"])
    losses, norms = [], []
    for i in range(case["n"]):
        state, loss, dm = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(loss))
        norms.append(float(dm["grad_total_norm"][0]))
    return losses, norms, td._jax_flat(state.params["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups, started together; meanwhile the JAX package's
    one-process steps on the same global batches."""
    import vlbert_tpu.models.fast_rcnn as j_fast_rcnn
    from tests.test_entrypoints import _write_vqa_fixture
    from vlbert_tpu.ops.dropout import Dropout as JDropout
    from vlbert_tpu_torch.training.convert import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("fsdp")
    saved = j_fast_rcnn.Dropout
    # the fixed Dropout(0.1) before obj_downsample, off in both packages
    j_fast_rcnn.Dropout = lambda rate: JDropout(rate=0.0)
    try:
        cases, models = {}, {}
        for task in ("vqa", "pretrain"):
            for accum, B, seed in ((1, 4, 0), (2, 8, 1)):
                if task == "vqa":
                    inputs, label = td._global_batch(task, B, seed=seed)
                    batch = (*inputs, label)
                    cfg = td._cfg(task, B // accum, accum)
                else:
                    batch = _pretrain_batch(B, seed=seed)
                    cfg = _pretrain_cfg(B // accum, accum)
                if task not in models:
                    jm, v = _jax_init(task, cfg, (batch[:-1], batch[-1])
                                      if task == "vqa" else batch)
                    tm = td._port_model(cfg, task)
                    init = state_dict_from_jax(td._jax_flat(v["params"]), tm)
                    models[task] = (jm, v, tm, init)
                name = task if accum == 1 else f"{task}_accum"
                cases[name] = {"task": task, "batch_images": B // accum,
                               "accum": accum, "batch": batch,
                               "init": models[task][3], "n": 2}
        data_dir, vocab_dir = _write_vqa_fixture(tmp)
        d_net = {"tmp": str(tmp), "data_dir": data_dir,
                 "vocab_dir": vocab_dir, "vqa": cases["vqa"]}
        steps = td.start_ranks("steps", str(tmp),
                               {"cases": cases, "tmp": str(tmp)},
                               module="tests.test_torch_fsdp",
                               env_of=_slurm_env(_slurm_job_id()))
        net = td.start_ranks("train_net", str(tmp), d_net,
                             module="tests.test_torch_fsdp")
        jax_out = {}
        for name, case in cases.items():
            jm, v, tm, _ = models[case["task"]]
            cfg = (td._cfg("vqa", case["batch_images"], case["accum"])
                   if case["task"] == "vqa"
                   else _pretrain_cfg(case["batch_images"], case["accum"]))
            losses, norms, flat = _jax_steps(case, cfg, jm, v)
            jax_out[name] = (losses, norms, state_dict_from_jax(flat, tm))
    finally:
        j_fast_rcnn.Dropout = saved
    return {"jax": jax_out, "steps": td.finish_ranks(steps),
            "net": td.finish_ranks(net), "tmp": str(tmp), "d": d_net}


def _assert_rel(got, want, floor=1e-2):
    """Each tensor within REL of its reference's largest element, or of
    ``floor`` when that is smaller (a tensor of round-off, such as the key
    bias, whose gradient is 0 but for rounding)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = torch.as_tensor(np.asarray(w))
        gap = float((got[k] - w).abs().max()) if w.numel() else 0.0
        assert gap <= REL * max(float(w.abs().max()), floor), (k, gap)


def _assert_moments_rel(got, want):
    """Moments within REL of the largest moment of any parameter."""
    want = [torch.as_tensor(np.asarray(w)) for w in want]
    floor = max(float(w.abs().max()) for w in want)
    _assert_rel(dict(enumerate(got)), dict(enumerate(want)), floor)


CASES = ["vqa", "vqa_accum", "pretrain", "pretrain_accum"]


@pytest.mark.parametrize("case", CASES)
def test_two_fsdp_ranks_equal_the_jax_one_process_step(runs, case):
    """Two fsdp ranks take the JAX package's step over the concatenated
    batch (accumulation: micro-step i is the ranks' micro-steps i side by
    side): losses, gradient norms, parameters after 2 AdamW steps, at the
    bar of test_two_ranks_equal_the_jax_one_process_step. The pretraining
    ranks' MLM and masked-region counts differ."""
    want_loss, want_norm, want_sd = runs["jax"][case]
    for rank_out in runs["steps"]:
        got = rank_out[case, "fsdp"]
        np.testing.assert_allclose(got["losses"], want_loss, rtol=1e-5)
        np.testing.assert_allclose(got["norms"], want_norm, rtol=1e-4)
        sd = {k: v for k, v in got["state"].items() if k in want_sd}
        td._assert_state_close(sd, want_sd, **td.TOL)


@pytest.mark.parametrize("case", CASES + ["remat", "unreached", "fp16"])
def test_two_fsdp_ranks_equal_two_dp_ranks(runs, case):
    """fsdp against dp on the same ranks and shards: losses, norms, the
    eval forward between the steps (train -> validate -> train) and every
    tensor of the state within 1e-6 of its largest element (of 0.01 at
    least), the first moments within 1e-6 of the largest; the same on
    both ranks. ``remat``: TPU.REMAT with dropout 0.1 in both modes.
    ``unreached``: rank 1's forward does not reach
    vlbert.end_embedding, whose mean gradient is then rank 0's over 2,
    as under dp (``fsdp.zero_touch``). ``fp16``: TRAIN.FP16 with
    TPU.FP16_PARITY_MODE, the static loss scale 128 undone on the
    sharded gradients."""
    for rank_out in runs["steps"]:
        dp, fs = rank_out[case, "dp"], rank_out[case, "fsdp"]
        np.testing.assert_allclose(fs["losses"], dp["losses"], rtol=REL)
        np.testing.assert_allclose(fs["norms"], dp["norms"], rtol=REL)
        assert fs["evals"] == dp["evals"]
        _assert_rel(fs["state"], dp["state"])
        _assert_moments_rel(fs["mu"], dp["mu"])
    r0, r1 = runs["steps"]
    assert r0[case, "fsdp"]["losses"] == r1[case, "fsdp"]["losses"]
    assert all(torch.equal(v, r1[case, "fsdp"]["state"][k])
               for k, v in r0[case, "fsdp"]["state"].items())


def test_the_unreached_parameter_moves_by_half_a_gradient(runs):
    """Without rank 1's share, vlbert.end_embedding still moves, under
    both modes alike, and differently from the run where both ranks
    reach it."""
    k = "vlbert.end_embedding.weight"
    r0 = runs["steps"][0]
    reached, unreached = r0["vqa", "fsdp"], r0["unreached", "fsdp"]
    init = runs["d"]["vqa"]["init"][k]
    assert not torch.equal(unreached["state"][k], init)
    assert not torch.equal(unreached["state"][k], reached["state"][k])


def test_partial_load_keeps_each_rank_its_shard(runs):
    """partial_load of a whole state dict into an fsdp model (each rank
    reads the file itself): every tensor loaded, none missing or
    misshaped, and the model then holds the file's values."""
    init = runs["d"]["vqa"]["init"]
    for rank_out in runs["steps"]:
        (loaded, missing, mismatched), state = rank_out["partial_load"]
        assert sorted(loaded) == sorted(init) and not missing \
            and not mismatched
        assert all(torch.equal(state[k], v) for k, v in init.items())


def test_each_rank_holds_half_the_parameters_and_moments(runs):
    """Each fsdp rank's local elements of the trained parameters and
    their AdamW moments: at most its chunk of dim 0 (half, plus the
    padding of an odd dim 0), and the two ranks' together the whole."""
    for case in CASES:
        local = [r[case, "fsdp"]["elements"] for r in runs["steps"]]
        total = local[0][2]
        for held, bound, _ in local:
            assert held <= bound <= total / 2 + total / 100, (case, held)
        assert local[0][0] + local[1][0] == total


def test_the_gathered_checkpoint_is_a_dp_checkpoint(runs):
    """The pretraining model's file saved under fsdp (every rank gathers,
    rank 0 writes) against the one saved under dp: the same keys, shapes
    and dtypes, the tied MLM decoder one tensor with the word embedding,
    the values and moments within 1e-6, no prefix added."""
    from vlbert_tpu_torch.models.vlbert import TIED_DECODER
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib

    tmp = runs["tmp"]
    assert os.listdir(os.path.join(tmp, "pretrain_fsdp")) == ["p-0000.model"]
    fs = ckpt_lib.load_checkpoint(
        os.path.join(tmp, "pretrain_fsdp", "p-0000.model"))
    dp = ckpt_lib.load_checkpoint(
        os.path.join(tmp, "pretrain_dp", "p-0000.model"))
    for part in ("state_dict",):
        assert list(fs[part]) == list(dp[part])
        for k in dp[part]:
            assert (fs[part][k].shape, fs[part][k].dtype) \
                == (dp[part][k].shape, dp[part][k].dtype), k
        _assert_rel(fs[part], dp[part])
    sd = fs["state_dict"]
    decoder = [k for k in sd if k.endswith(TIED_DECODER)]
    words = [k for k in sd if k.endswith("word_embeddings.weight")
             and "special" not in k]
    assert len(decoder) == len(words) == 1
    assert sd[decoder[0]].data_ptr() == sd[words[0]].data_ptr()
    assert not any(k.startswith(("module.", "_fsdp")) for k in sd)
    for key in ("mu", "nu"):
        assert list(fs["optimizer"][key]) == list(dp["optimizer"][key])
        _assert_moments_rel(list(fs["optimizer"][key].values()),
                            list(dp["optimizer"][key].values()))
    assert (fs["step"], fs["optimizer"]["count"]) == (2, 2)


def test_the_gathered_checkpoint_loads_back_into_shards(runs):
    """The pretraining model's fsdp file loaded into a fresh fsdp model
    and optimizer on both ranks (rank 0 reads it, each keeps its shard;
    the tied decoder loaded once, as the word embedding): every tensor
    and moment equal to the file's, the count restored."""
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib

    f = ckpt_lib.load_checkpoint(
        os.path.join(runs["tmp"], "pretrain_fsdp", "p-0000.model"))
    for rank_out in runs["steps"]:
        state, mu, count = rank_out["reload"]
        assert state.keys() == f["state_dict"].keys() and count == 2
        assert all(torch.equal(state[k], v)
                   for k, v in f["state_dict"].items())
        assert all(torch.equal(m, v) for m, v in
                   zip(mu, f["optimizer"]["mu"].values()))
        assert len(mu) == len(f["optimizer"]["mu"])


def test_train_net_under_fsdp_writes_one_file_and_resumes(runs):
    """train_net at 2 fsdp ranks: rank 0 alone writes; the AUTO_RESUME
    run scatters rank 0's file to rank 1, whose directory holds none: both
    take epoch 1, count 4, the best validation metric, the weights and
    moments of the file; both end identical. --do-test runs on rank 0
    alone, from the written file."""
    r0, r1 = runs["net"]
    assert r0["files"][0] == ["tiny-0000.model", "tiny-0001.model",
                              "tiny-best.model", "train_rank0.log"]
    assert r0["files"][1] == ["train_rank1.log"]
    first, second = r0["resumed"][1], r1["resumed"][1]
    assert first["sharded"] and second["sharded"]
    assert first["begin_epoch"] == second["begin_epoch"] == 1
    assert first["count"] == second["count"] == 4
    assert first["best_val"] == second["best_val"] is not None
    for key in ("mu", "nu", "params"):
        assert first[key] == second[key], key
    for run0, run1 in zip(r0["runs"], r1["runs"]):
        assert run0["history"]["loss"] == run1["history"]["loss"]
        assert all(torch.equal(v, run1["state"][k])
                   for k, v in run0["state"].items())
    h0 = r0["runs"][1]["history"]
    assert (h0["begin_epoch"], h0["resumed_count"], len(h0["loss"])) \
        == (1, 4, 4)
    assert len(h0["test"]) == 4 and r0["runs"][1]["results"] \
        == ["tiny_vqa2_test.json"]
    assert r1["runs"][1]["history"]["test"] is None
    held, total = h0["state_elements"]
    assert held < 0.51 * total and held + r1["runs"][1]["history"][
        "state_elements"][0] == total


def test_the_fsdp_file_matches_dp_and_loads_in_one_process_and_in_jax(
        runs):
    """tiny-0000.model of the fsdp run against the dp run's: keys, shapes
    and dtypes, values within 1e-6; it loads into a one-process port model
    and optimizer (dp's resume path: rank 0's smart_resume) with the
    moments the fsdp ranks resumed, and through the JAX package's
    load_torch_or_native_checkpoint."""
    from vlbert_tpu.training.convert import load_torch_or_native_checkpoint
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.optim import Optimizer

    d, tmp = runs["d"], runs["tmp"]
    path = os.path.join(tmp, "out0", "vqa_train", "tiny-0000.model")
    fs = ckpt_lib.load_checkpoint(path)
    dp = ckpt_lib.load_checkpoint(os.path.join(tmp, "dp0", "vqa_train",
                                               "tiny-0000.model"))
    assert list(fs["state_dict"]) == list(dp["state_dict"])
    for k, v in dp["state_dict"].items():
        assert (fs["state_dict"][k].shape, fs["state_dict"][k].dtype) \
            == (v.shape, v.dtype), k
    _assert_rel(fs["state_dict"], dp["state_dict"])
    assert fs["step"] == dp["step"] == 4
    cfg = td._train_net_cfg(d, 2)
    cfg.TRAIN.AUTO_RESUME = True
    tm = td._port_model(cfg, "vqa")
    opt = Optimizer(cfg, tm, 4)
    prefix = os.path.join(tmp, "out0", "vqa_train", "tiny")
    begin, extra = ckpt_lib.smart_resume(prefix, tm, opt, cfg)
    assert (begin, opt.count) == (2, 8)
    ckpt_lib.load_checkpoint(path, tm, opt)
    resumed = runs["net"][0]["resumed"][1]
    assert td._digest(opt.mu) == resumed["mu"]
    assert td._digest(opt.params) == resumed["params"]
    flat = load_torch_or_native_checkpoint(path)
    assert len(flat) > 0 and all(np.isfinite(np.asarray(a)).all()
                                 for a in flat.values())


def test_the_slurm_rendezvous_equals_torchrun(runs):
    """The "steps" ranks rendezvoused from srun's variables alone (no
    RANK; MASTER_ADDR the first host of a compressed node list, the port
    from SLURM_JOB_ID), the "train_net" ranks from torchrun's; the dp
    step of the same shards is bit for bit the same in both groups."""
    for rank, (s, n) in enumerate(zip(runs["steps"], runs["net"])):
        assert s["rendezvous"] == (None, (rank, td.WORLD))
        assert n["rendezvous"] == (str(rank), (rank, td.WORLD))
        a, b = s["vqa", "dp"], n["dp_step"]
        assert a["losses"] == b["losses"] and a["norms"] == b["norms"]
        assert all(torch.equal(v, b["state"][k])
                   for k, v in a["state"].items())


# --------------------------------------------------- in-process checks

@pytest.mark.parametrize("spec, want", [
    ("a", ["a"]),
    ("gpu[01-03,07]", ["gpu01", "gpu02", "gpu03", "gpu07"]),
    ("x[1-2],y", ["x1", "x2", "y"]),
    ("gpu[01-03,07],login2", ["gpu01", "gpu02", "gpu03", "gpu07",
                              "login2"]),
    ("n[009-011]", ["n009", "n010", "n011"]),
    ("r[1-2]-n[8-9]", ["r1-n8", "r1-n9", "r2-n8", "r2-n9"]),
])
def test_slurm_host_lists_expand(spec, want):
    """SLURM's compressed host lists, zero padding kept; a list it cannot
    read raises."""
    from vlbert_tpu_torch.parallel.dist import expand_hostlist

    assert expand_hostlist(spec) == want
    for bad in (spec + "[", spec + ",", "a[3-1]", "a[x]"):
        with pytest.raises(ValueError, match="host list"):
            expand_hostlist(bad)


def test_torchrun_wins_and_a_missing_slurm_variable_raises_by_name():
    """torchrun's variables win over srun's; srun's alone give rank,
    world, local rank, the first host and the job's port; each missing
    variable is named."""
    from vlbert_tpu_torch.parallel.dist import rendezvous_env, slurm_port

    slurm = {"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
             "SLURM_JOB_NODELIST": "gpu[07-08]", "SLURM_JOB_ID": "123456"}
    torchrun = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500"}
    found, method = rendezvous_env({**slurm, **torchrun})
    assert (found, method) == (torchrun, "env://")
    found, method = rendezvous_env(slurm)
    assert found == {"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
                     "MASTER_ADDR": "gpu07",
                     "MASTER_PORT": str(slurm_port(123456))}
    assert method == f"tcp://gpu07:{slurm_port(123456)}"
    assert 10000 <= slurm_port(123456) < 30000 and slurm_port(0) == 10000
    step = {**slurm, "SLURM_STEP_NODELIST": "b[2-3]", "MASTER_PORT": "7"}
    assert rendezvous_env(step)[0]["MASTER_ADDR"] == "b2"
    assert rendezvous_env(step)[0]["MASTER_PORT"] == "7"
    for key in ("SLURM_NTASKS", "SLURM_LOCALID", "SLURM_JOB_NODELIST",
                "SLURM_JOB_ID"):
        env = {k: v for k, v in slurm.items() if k != key}
        with pytest.raises(RuntimeError, match=key):
            rendezvous_env(env)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        rendezvous_env({"RANK": "0"})
    with pytest.raises(RuntimeError, match="SLURM_PROCID unset"):
        rendezvous_env({})


class _Grouped:
    """A dataset stub of n items in two aspect groups, 1 in 5 portrait."""

    def __init__(self, n):
        self.n = n
        self.group_ids = [int(i % 5 == 0) for i in range(n)]

    def __len__(self):
        return self.n


@pytest.mark.parametrize("grouping", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_every_rank_takes_the_same_number_of_batches(grouping, drop_last):
    """FSDP2 gathers in every forward, so the ranks of a process group
    must run the same number of them: the sharded loader, with and without
    aspect grouping (its deterministic count), gives every rank of 2 and
    3 the same number of batches in every epoch, for a set that does not
    divide."""
    from vlbert_tpu_torch.data.loader import DataLoader

    for world in (2, 3):
        counts = set()
        for rank in range(world):
            loader = DataLoader(_Grouped(53), 4, collate_fn=None,
                                num_replicas=world, rank=rank,
                                drop_last=drop_last, aspect_grouping=grouping)
            for epoch in range(3):
                loader.set_epoch(epoch)
                counts.add((len(loader), sum(1 for _ in loader._batches())))
        assert len(counts) == 1 and counts.pop()[0] > 0, (world, counts)
