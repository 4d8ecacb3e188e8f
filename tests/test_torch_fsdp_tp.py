"""fsdp on a [data, model] mesh on the port (TPU.PARTITION_MODE fsdp with
TPU.MESH_SHAPE [d, m] and MESH_AXES [data, model]: tensor parallelism's
split, then FSDP2 over each data group, ``vlbert_tpu_torch/parallel/
fsdp.py``) on the CPU: gloo ranks, each a process, at tiny width in fp32.

The bar is the JAX package's semantics: its fsdp rules place the tp
layout's shards over the data axis too (vlbert_tpu/parallel/mesh.py:
77-120) and leave the compute alone, so a step equals the one-process
step on the global batch. Four ranks at MESH_SHAPE [2, 2] are held to the
JAX package's ``make_train_step`` on the global batch (VQA, and multitask
pretraining with unequal masked counts on the replicas), with and without
accumulation, at tests/test_torch_dist.py's bar, and to four tp ranks at
[2, 2] within 1e-6 of each tensor's largest element, parameters and first
moments; so is a run with dropout 0.1, TPU.REMAT and TPU.FUSED_QKV. Each
rank holds its data chunk of its model part, the replicated parameters
are bit for bit alike on the four ranks, the gathered file is a
one-process file key for key that loads in one port process and in the
JAX package and resumes into shards; ``train_net`` under fsdp [2, 2]
writes one file on rank 0 and AUTO_RESUMEs on all four. Two ranks at
[1, 2] run tp's placement: fsdp there equals tp bit for bit.

Three groups start together (four ranks at [2, 2], four for train_net,
two at [1, 2]) while the parent runs the JAX steps and one port process.
The rank processes import this module and tests/test_torch_{dist,fsdp,
tp}.py: jax and the JAX package's models are imported inside the
parent's functions only.
"""

import os
import pickle
import re
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import tests.test_torch_dist as td
import tests.test_torch_fsdp as tf
import tests.test_torch_tp as tt

# a gap to tp's: losses, norms and first moments (over the largest
# moment) within REL; each parameter within REL_PARAMS of its largest
# element. fsdp averages a replicated gradient over the data group, then
# the model group, where tp averages it over the world at once, and the
# two norms add other partial sums: last-bit differences, which the
# second AdamW step's moment grows where it nearly cancels (measured:
# image_feature_extractor.obj_downsample.1.weight at 1.9e-6 of its largest
# element, every other tensor under 7e-7), so parameters are held at
# tests/test_torch_tp.py's bar for another order of additions
REL, REL_PARAMS = 1e-6, 1e-5
MESH22, MESH12 = [2, 2], [1, 2]
# the encoder layer whose local shards the ranks report
LAYER0 = ".encoder.layer.0."


def _mesh(cfg, mode, shape):
    cfg.TPU.PARTITION_MODE = mode
    cfg.TPU.MESH_SHAPE = list(shape)
    cfg.TPU.MESH_AXES = ["data", "model"]
    return cfg


# ------------------------------------------------------ the rank processes

def _shard_model(mode, case, shape):
    """(cfg, model, mesh) of ``case`` under ``mode`` (fsdp, tp) over
    ``shape``, from the case's whole weights."""
    from vlbert_tpu_torch.parallel import dist as dist_lib
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib
    from vlbert_tpu_torch.parallel import tp as tp_lib

    world = dist_lib.rank_world()[1]
    cfg = _mesh(tt._case_cfg(case, world), mode, shape)
    dist_lib.check_partition(cfg, world)
    tm = tf._model(cfg, tt._task(case))
    if "init" in case:
        tm.load_state_dict(case["init"])
    mesh = tp_lib.make_mesh(cfg, "cpu")
    if mode == "fsdp":
        fsdp_lib.shard_module(tm, "cpu", mesh)
    else:
        tp_lib.shard_module(tm, mesh)
    return cfg, tm, mesh


def _whole(t):
    """``t``'s rank part whole over the data axis (collective)."""
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib

    return fsdp_lib.plain(t).detach().clone()


def _run(mode, case, shape, save=None):
    """``case["n"]`` steps of the replica's rows of ``case["batch"]``
    under ``mode`` over ``shape``, for VQA an eval forward after the
    first. Returns the losses, norms, eval metrics, the rank's mesh place,
    its tp part of every tensor and first moment whole over the data axis,
    the split dims, layer 0's heads, the partition's class, the digest of
    the replicated parameters, layer 0's local shards, and the trained
    parameters' and moments' local elements beside their bound and their
    split and replicated totals."""
    from vlbert_tpu_torch.parallel import dist as dist_lib
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.loop import (make_eval_step,
                                                make_train_step)
    from vlbert_tpu_torch.training.optim import Optimizer

    rank, world = dist_lib.rank_world()
    task, accum = tt._task(case), case["accum"]
    cfg, tm, mesh = _shard_model(mode, case, shape)
    opt = Optimizer(cfg, tm, 4, world)
    step = make_train_step(tm, opt, task, cfg, accum)
    batch = tuple(None if x is None else torch.from_numpy(
        td._shard(x, mesh.data_index, mesh.d, accum))
        for x in case["batch"])
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
    part = dist_lib.partition_of(tm)
    dims = dict(getattr(part, "dims", {}))
    state = {k: _whole(v) for k, v in tm.state_dict().items()}
    trained = opt.params + opt.mu + opt.nu
    names = opt.names * 3
    split = sum(t.numel() for n, t in zip(names, trained) if n in dims)
    att = tm.vlbert.encoder.layer[0].attention.self
    return {"losses": losses, "norms": norms, "evals": evals,
            "place": (mesh.data_index, mesh.model_index), "state": state,
            "mu": dict(zip(opt.names, (_whole(m) for m in opt.mu))),
            "dims": dims, "partition": type(part).__name__,
            "heads": (att.num_heads, att.head_offset, att.heads_total),
            "replicated": td._digest(state[n] for n, _ in
                                     tm.named_parameters() if n not in dims),
            "local": {n: fsdp_lib.local(p).detach().clone()
                      for n, p in tm.named_parameters() if LAYER0 in n},
            "elements": (fsdp_lib.local_numel(trained),
                         tf._bound(trained, mesh.d), split,
                         sum(t.numel() for t in trained) - split)}


def _reload(case, path):
    """``path`` loaded into a fresh fsdp model and optimizer at [2, 2]
    (collective: rank 0 reads, each rank keeps its data chunk of its
    part): the local shards of the state and first moments, the count,
    the names of the sharded tensors (FSDP2 keeps buffers whole)."""
    from vlbert_tpu_torch.parallel import dist as dist_lib
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.optim import Optimizer

    case = {k: v for k, v in case.items() if k != "init"}
    cfg, tm, _ = _shard_model("fsdp", case, MESH22)
    opt = Optimizer(cfg, tm, 4, dist_lib.rank_world()[1])
    ckpt_lib.load_checkpoint(path, tm, opt)
    sd = tm.state_dict()
    return ({k: fsdp_lib.local(v).detach().clone() for k, v in sd.items()},
            {n: fsdp_lib.local(m).detach().clone()
             for n, m in zip(opt.names, opt.mu)}, opt.count,
            {k for k, v in sd.items() if fsdp_lib.is_dtensor(v)})


def _rank_mesh22(rank, world, d):
    """Four ranks at [2, 2]: every case under fsdp and under tp, the
    pretraining model's fsdp file written after its steps, then read back
    into shards."""
    out = {}
    for name, case in d["cases"].items():
        for mode in ("fsdp", "tp"):
            save = (os.path.join(d["tmp"], "pretrain_fsdp_tp", "p")
                    if name == "pretrain" and mode == "fsdp" else None)
            out[name, mode] = _run(mode, case, MESH22, save=save)
    out["reload"] = _reload(d["cases"]["pretrain"], os.path.join(
        d["tmp"], "pretrain_fsdp_tp", "p-0000.model"))
    return out


def _rank_mesh12(rank, world, d):
    """Two ranks at [1, 2]: the six-head case with dropout under fsdp and
    under tp."""
    return {mode: _run(mode, d["case"], MESH12) for mode in ("fsdp", "tp")}


def _rank_net22(rank, world, d):
    """Four ranks: ``train_net`` under fsdp [2, 2] on the tiny VQA
    fixture, epoch 0, then AUTO_RESUME to END_EPOCH 2 (the output
    directories of ranks 1-3 hold no checkpoint)."""
    import vlbert_tpu_torch.engine.train as t_train
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib

    kept, saved = [], t_train.resume

    def digest(tensors):
        return td._digest(fsdp_lib.plain(t) for t in tensors)

    def resume(prefix, model, optimizer, config):
        begin_epoch, extra = saved(prefix, model, optimizer, config)
        kept.append({"begin_epoch": begin_epoch, "count": optimizer.count,
                     "best_val": extra.get("best_val"),
                     "mu": digest(optimizer.mu),
                     "params": digest(optimizer.params),
                     "partition": type(model.partition).__name__})
        return begin_epoch, extra

    t_train.resume = resume
    runs = []
    try:
        for end_epoch in (1, 2):
            cfg = _mesh(td._train_net_cfg(d, end_epoch), "fsdp", MESH22)
            cfg.OUTPUT_PATH = os.path.join(d["tmp"], f"net{rank}")
            args = types.SimpleNamespace(model_dir="", device="cpu", ckpt="",
                                         do_test=False)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                model, history = t_train.train_net(args, cfg, "vqa")
            runs.append({"history": history,
                         "params": digest(p for _, p in
                                          model.named_parameters())})
    finally:
        t_train.resume = saved
    return {"runs": runs, "resumed": kept,
            "files": {r: sorted(os.listdir(os.path.join(
                d["tmp"], f"net{r}", "vqa_train"))) for r in range(world)}}


def _rank_main(scenario, tmp):
    """One rank (torchrun's variables): runs ``scenario`` under a gloo
    process group on the CPU and pickles what it returns to
    ``{tmp}/{scenario}_rank{rank}.pkl``."""
    from vlbert_tpu_torch.parallel import dist as dist_lib

    torch.set_num_threads(2)
    with open(os.path.join(tmp, f"{scenario}.pkl"), "rb") as f:
        d = pickle.load(f)
    with dist_lib.process_group("gloo", "cpu"):
        rank, world = dist_lib.rank_world()
        out = {"mesh22": _rank_mesh22, "mesh12": _rank_mesh12,
               "net22": _rank_net22}[scenario](rank, world, d)
    out["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(tmp, f"{scenario}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------------ the parent

def _jax_cases():
    """tests/test_torch_tp.py's four JAX cases (VQA and multitask
    pretraining, with and without accumulation) and their models."""
    from vlbert_tpu_torch.training.convert import state_dict_from_jax

    cases, models = {}, {}
    for task in ("vqa", "pretrain"):
        for accum, B, seed in ((1, 4, 0), (2, 8, 1)):
            if task == "vqa":
                inputs, label = td._global_batch(task, B, seed=seed)
                batch = (*inputs, label)
                cfg = td._cfg(task, B // accum, accum)
            else:
                batch = tf._pretrain_batch(B, seed=seed)
                cfg = tf._pretrain_cfg(B // accum, accum)
            if task not in models:
                jm, v = tf._jax_init(task, cfg, (batch[:-1], batch[-1])
                                     if task == "vqa" else batch)
                tm = td._port_model(cfg, task)
                init = state_dict_from_jax(td._jax_flat(v["params"]), tm)
                models[task] = (jm, v, tm, init)
            name = task if accum == 1 else f"{task}_accum"
            cases[name] = {"task": task, "batch_images": B // accum,
                           "accum": accum, "batch": batch,
                           "init": models[task][3], "n": 2}
    return cases, models


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three rank groups, started together; meanwhile the JAX
    package's one-process steps and the port's one-process pretraining
    file."""
    import vlbert_tpu.models.fast_rcnn as j_fast_rcnn
    from tests.test_entrypoints import _write_vqa_fixture
    from vlbert_tpu.ops.dropout import Dropout as JDropout
    from vlbert_tpu_torch.training.convert import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("fsdp_tp")
    saved = j_fast_rcnn.Dropout
    # the fixed Dropout(0.1) before obj_downsample, off in both packages
    j_fast_rcnn.Dropout = lambda rate: JDropout(rate=0.0)
    try:
        cases, models = _jax_cases()
        batch6, init6 = tt._six_heads_init(8)
        # dropout 0.1, REMAT and the fused QKV route, 8 rows at [2, 2]
        cases["flags"] = {"task": "vqa6", "batch_images": 8, "accum": 1,
                          "batch": batch6, "init": init6, "n": 2,
                          "flags": {"remat": True, "fused_qkv": True}}
        data_dir, vocab_dir = _write_vqa_fixture(tmp)
        mesh22 = td.start_ranks("mesh22", str(tmp),
                                {"cases": cases, "tmp": str(tmp)},
                                module="tests.test_torch_fsdp_tp", world=4)
        net22 = td.start_ranks("net22", str(tmp),
                               {"tmp": str(tmp), "data_dir": data_dir,
                                "vocab_dir": vocab_dir},
                               module="tests.test_torch_fsdp_tp", world=4)
        mesh12 = td.start_ranks(
            "mesh12", str(tmp),
            {"case": {**cases["flags"], "flags": {}}},
            module="tests.test_torch_fsdp_tp", world=2)
        jax_out = {}
        for name in tt.CASES:
            case = cases[name]
            jm, v, tm, _ = models[case["task"]]
            cfg = (td._cfg("vqa", case["batch_images"], case["accum"])
                   if case["task"] == "vqa"
                   else tf._pretrain_cfg(case["batch_images"], case["accum"]))
            losses, norms, flat = tf._jax_steps(case, cfg, jm, v)
            jax_out[name] = (losses, norms, state_dict_from_jax(flat, tm))
    finally:
        j_fast_rcnn.Dropout = saved
    tt._one_process(cases["pretrain"],
                    save=os.path.join(str(tmp), "pretrain_one", "p"))
    return {"jax": jax_out, "cases": cases, "tmp": str(tmp),
            "d_net": {"tmp": str(tmp), "data_dir": data_dir,
                      "vocab_dir": vocab_dir},
            "mesh22": td.finish_ranks(mesh22),
            "net22": td.finish_ranks(net22),
            "mesh12": td.finish_ranks(mesh12)}


def _chunk(v, place, dim, m, d):
    """Rank ``place``'s data chunk of its model part of the whole tensor
    ``v``: the part along the split ``dim`` (None: all of it), then
    FSDP2's ``torch.chunk`` of its rows over d."""
    i, j = place
    if dim is not None:
        n = v.shape[dim] // m
        v = v.narrow(dim, j * n, n)
    per = -(-v.shape[0] // d)
    start = min(i * per, v.shape[0])
    return v[start:start + per]


def _assert_params_rel(got, want, floor=1e-2):
    """Each tensor within REL_PARAMS of its reference's largest element
    (of ``floor`` at least)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        gap = float((got[k] - w).abs().max()) if w.numel() else 0.0
        assert gap <= REL_PARAMS * max(float(w.abs().max()), floor), (k, gap)


@pytest.mark.parametrize("case", tt.CASES)
def test_mesh22_fsdp_equals_the_jax_one_process_step(runs, case):
    """Four fsdp ranks at [2, 2] take the JAX package's step over the
    global batch: losses, gradient norms and the parameters after 2 AdamW
    steps at tests/test_torch_dist.py's bar, on both replicas; the two
    replicas bit for bit alike, and a replica's eval forward between the
    steps the same on its two ranks. The pretraining replicas' MLM and
    masked-region counts differ."""
    want_loss, want_norm, want_sd = runs["jax"][case]
    outs = [r[case, "fsdp"] for r in runs["mesh22"]]
    assert {o["partition"] for o in outs} == {"Fsdp"}
    for o in outs:
        np.testing.assert_allclose(o["losses"], want_loss, rtol=1e-5)
        np.testing.assert_allclose(o["norms"], want_norm, rtol=1e-4)
    whole = tt._whole(outs)
    assert sorted(whole) == [0, 1]
    for state in whole.values():
        sd = {k: v for k, v in state.items() if k in want_sd}
        td._assert_state_close(sd, want_sd, **td.TOL)
    assert all(torch.equal(v, whole[1][k]) for k, v in whole[0].items())
    evals = {o["place"]: o["evals"] for o in outs}
    assert evals[0, 0] == evals[0, 1] and evals[1, 0] == evals[1, 1]


@pytest.mark.parametrize("case", tt.CASES + ["flags"])
def test_mesh22_fsdp_equals_mesh22_tp(runs, case):
    """fsdp against tp on the same [2, 2] ranks and rows: losses and norms
    within 1e-6, the eval forward equal, every tensor of the state within
    1e-5 of its largest element (of 0.01 at least; REL_PARAMS) and the
    first moments within 1e-6 of the largest. ``flags``: dropout 0.1, TPU.REMAT and TPU.FUSED_QKV in
    both modes (the recompute replays the model-group all-reduces and the
    seeds, which fold in the data index)."""
    for r in runs["mesh22"]:
        fs, tp = r[case, "fsdp"], r[case, "tp"]
        assert fs["place"] == tp["place"] and fs["dims"] == tp["dims"]
        assert fs["heads"] == tp["heads"]
        np.testing.assert_allclose(fs["losses"], tp["losses"], rtol=REL)
        np.testing.assert_allclose(fs["norms"], tp["norms"], rtol=REL)
        assert fs["evals"] == tp["evals"]
        _assert_params_rel(fs["state"], tp["state"])
        tf._assert_moments_rel(list(fs["mu"].values()),
                               list(tp["mu"].values()))


def test_each_rank_holds_its_data_chunk_of_its_model_part(runs):
    """Each rank's local shards of layer 0 are its data chunk of its model
    part of the replica's tensors; a rank holds at most its chunk of the
    trained parameters and moments, about split / 4 + replicated / 2 of
    the whole model's; the four ranks' together are the split tensors once
    and the replicated ones twice."""
    for case in tt.CASES + ["flags"]:
        outs = [r[case, "fsdp"] for r in runs["mesh22"]]
        whole = tt._whole(outs)[0]
        for o in outs:
            assert o["local"] and all(
                torch.equal(v, _chunk(whole[k], o["place"],
                                      o["dims"].get(k), 2, 2))
                for k, v in o["local"].items()), case
        split, repl = outs[0]["elements"][2:]
        for held, bound, _, _ in (o["elements"] for o in outs):
            assert held <= bound <= (split + repl) / 2 * 1.02, case
        assert sum(o["elements"][0] for o in outs) == 2 * (split + repl)
        # the whole model's split elements are m = 2 parts of `split`
        assert abs(outs[0]["elements"][0]
                   - (2 * split / 4 + repl / 2)) <= 0.02 * (split + repl)


def test_replicated_parameters_are_bit_for_bit_alike_on_four_ranks(runs):
    """Every replicated parameter, gathered over the data axis, is the
    same on the four ranks after the steps (its chunks averaged over the
    model group by construction), under fsdp and under tp."""
    for case in tt.CASES + ["flags"]:
        for mode in ("fsdp", "tp"):
            digests = {r[case, mode]["replicated"] for r in runs["mesh22"]}
            assert len(digests) == 1, (case, mode)


def test_the_gathered_file_is_one_process_file_and_loads_everywhere(runs):
    """The pretraining model's file written under fsdp [2, 2] against one
    process's after the same steps: the same keys in the same order,
    shapes and dtypes, the tied MLM decoder one tensor with the word
    embedding, values within the JAX bar; it loads into one port process
    (strict) and through the JAX package's converter."""
    from vlbert_tpu.training.convert import load_torch_or_native_checkpoint
    from vlbert_tpu_torch.models.vlbert import TIED_DECODER
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.optim import Optimizer

    tmp = runs["tmp"]
    path = os.path.join(tmp, "pretrain_fsdp_tp", "p-0000.model")
    assert os.listdir(os.path.dirname(path)) == ["p-0000.model"]
    got = ckpt_lib.load_checkpoint(path)
    want = ckpt_lib.load_checkpoint(
        os.path.join(tmp, "pretrain_one", "p-0000.model"))
    assert list(got["state_dict"]) == list(want["state_dict"])
    for k, v in want["state_dict"].items():
        assert (got["state_dict"][k].shape, got["state_dict"][k].dtype) \
            == (v.shape, v.dtype), k
    td._assert_state_close(got["state_dict"], want["state_dict"], **td.TOL)
    sd = got["state_dict"]
    decoder = [k for k in sd if k.endswith(TIED_DECODER)]
    words = [k for k in sd if k.endswith("word_embeddings.weight")
             and "special" not in k]
    assert sd[decoder[0]].data_ptr() == sd[words[0]].data_ptr()
    for key in ("mu", "nu"):
        assert list(got["optimizer"][key]) == list(want["optimizer"][key])
        for k, v in want["optimizer"][key].items():
            assert got["optimizer"][key][k].shape == v.shape, k
    assert (got["step"], got["optimizer"]["count"]) == (2, 2)
    cfg = tf._pretrain_cfg(runs["cases"]["pretrain"]["batch_images"])
    tm = tf._model(cfg, "pretrain")
    opt = Optimizer(cfg, tm, 4)
    ckpt_lib.load_checkpoint(path, tm, opt)
    assert opt.count == 2
    flat = load_torch_or_native_checkpoint(path)
    assert len(flat) > 0 and all(np.isfinite(np.asarray(a)).all()
                                 for a in flat.values())


def test_the_gathered_file_resumes_into_shards(runs):
    """The [2, 2] file loaded into a fresh fsdp model and optimizer on four
    ranks: each rank's local parameters and first moments are its data
    chunk of its part of the file's, the count restored."""
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib

    f = ckpt_lib.load_checkpoint(os.path.join(
        runs["tmp"], "pretrain_fsdp_tp", "p-0000.model"))
    for r in runs["mesh22"]:
        state, mu, count, sharded = r["reload"]
        place, dims = (r["pretrain", "fsdp"][k] for k in ("place", "dims"))
        assert count == 2 and state.keys() == f["state_dict"].keys()
        assert sharded and set(mu) <= sharded
        for k, v in f["state_dict"].items():
            want = _chunk(v, place, dims.get(k), 2, 2) if k in sharded else v
            assert torch.equal(state[k], want), k
        for k, v in f["optimizer"]["mu"].items():
            assert torch.equal(mu[k], _chunk(v, place, dims.get(k), 2, 2)), k


def test_train_net_under_fsdp_mesh22_writes_one_file_and_resumes(runs):
    """train_net at fsdp [2, 2]: rank 0 alone writes; the AUTO_RESUME run
    broadcasts rank 0's file to the three ranks whose directories hold
    none: all four take epoch 1, count 2, the best validation metric, the
    weights and moments as written, the same losses; the file loads into
    one port process."""
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib

    outs = runs["net22"]
    assert outs[0]["files"][0] == ["tiny-0000.model", "tiny-0001.model",
                                   "tiny-best.model", "train_rank0.log"]
    assert all(outs[0]["files"][r] == [f"train_rank{r}.log"]
               for r in range(1, 4))
    for o in outs:
        first, second = o["resumed"]
        assert second["partition"] == "Fsdp"
        assert (second["begin_epoch"], second["count"]) == (1, 2)
        assert second["params"] == o["runs"][0]["params"]
        assert second["best_val"] == outs[0]["resumed"][1]["best_val"] \
            is not None
        h = o["runs"][1]["history"]
        assert (h["begin_epoch"], h["resumed_count"], len(h["loss"])) \
            == (1, 2, 2)
    for i in range(2):
        assert len({tuple(o["runs"][i]["history"]["loss"])
                    for o in outs}) == 1
        assert len({str(o["runs"][i]["history"]["val"]) for o in outs}) == 1
    # the model ranks of a data index hold the same replicated chunks; the
    # data indices of a model index hold the same gathered part
    for i in range(2):
        assert outs[0]["runs"][i]["params"] == outs[2]["runs"][i]["params"]
        assert outs[1]["runs"][i]["params"] == outs[3]["runs"][i]["params"]
    held, total = outs[0]["runs"][1]["history"]["state_elements"]
    assert held < 0.5 * total
    cfg = td._train_net_cfg(runs["d_net"], 2)
    ckpt_lib.load_checkpoint(os.path.join(
        runs["tmp"], "net0", "vqa_train", "tiny-0001.model"),
        td._port_model(cfg, "vqa"))


def test_mesh12_fsdp_is_tp_bit_for_bit(runs):
    """At [1, 2] fsdp is tp's placement (the JAX rule at data 1,
    vlbert_tpu/parallel/mesh.py:98-102): the same partition, heads,
    losses, norms, state and moments bit for bit, dropout 0.1 on."""
    for r in runs["mesh12"]:
        fs, tp = r["fsdp"], r["tp"]
        assert fs["partition"] == tp["partition"] == "TensorParallel"
        assert fs["heads"] == tp["heads"] and fs["dims"] == tp["dims"]
        assert fs["losses"] == tp["losses"] and fs["norms"] == tp["norms"]
        for part in ("state", "mu"):
            assert all(torch.equal(v, tp[part][k])
                       for k, v in fs[part].items())


def test_no_rank_imported_jax(runs):
    assert not any(r["jax_imported"] for r in
                   runs["mesh22"] + runs["net22"] + runs["mesh12"])


# --------------------------------------------------- in-process checks

PORT = os.path.join(td.REPO, "vlbert_tpu_torch")


def test_nothing_in_the_port_calls_a_dtensor_collective():
    """The port's sources and chip_smoke.py name no DTensor functional
    collective: ``full_tensor``, ``distribute_tensor``, ``redistribute``,
    the functional collectives module: gloo ranks sharing a card run c10d
    calls only (the norm, snapshot and load run on ``to_local()``)."""
    banned = re.compile(r"full_tensor|distribute_tensor|redistribute|"
                        r"_functional_collectives|funcol")
    hits = []
    paths = [os.path.join(td.REPO, "chip_smoke.py")] + [
        os.path.join(root, name) for root, _, files in os.walk(PORT)
        for name in files if name.endswith(".py")]
    for path in paths:
        with open(path) as f:
            hits += [f"{path}:{i}: {line.strip()}"
                     for i, line in enumerate(f, 1) if banned.search(line)]
    assert not hits, hits


@pytest.mark.parametrize("shape, axes, world, heads, want", [
    ([1, 2], ["data", "model"], 2, 2, None),
    ([2, 2], ["data", "model"], 4, 2, None),
    ([2, 1], ["data", "model"], 2, 2, None),
    ([2, 2], ["data", "foo"], 4, 2, "MESH_AXES \\[data, model\\]"),
    ([1, 2, 2], ["data", "model", "x"], 4, 2, "two axes"),
    ([2, 2], ["data", "model"], 2, 2, "lays out 4 devices"),
    ([1, 2], ["data", "model"], 1, 2, "lays out 2 devices"),
    ([1, 4], ["data", "model"], 4, 2, "num_attention_heads 2 not divisible"),
])
def test_fsdp_on_a_mesh_is_checked_as_tp(shape, axes, world, heads, want):
    """check_partition under fsdp: a model axis > 1 takes tp's rules
    (two axes [data, model], d·m = the world, heads and widths that m
    divides), at one rank too; [d, 1] is the data axis alone."""
    from vlbert_tpu_torch.parallel.dist import check_partition

    cfg = _mesh(td._cfg("vqa", 1), "fsdp", shape)
    cfg.TPU.MESH_AXES = axes
    cfg.NETWORK.VLBERT.num_attention_heads = heads
    if want is None:
        check_partition(cfg, world)
    else:
        with pytest.raises(ValueError, match=want):
            check_partition(cfg, world)


@pytest.mark.parametrize("mode, shape, want", [
    ("fsdp", [2, 2], [(0, 2, 2), (0, 2, 2), (1, 2, 2), (1, 2, 2)]),
    ("tp", [2, 2], [(0, 2, 2), (0, 2, 2), (1, 2, 2), (1, 2, 2)]),
    ("fsdp", [], [(r, 4, 1) for r in range(4)]),
    ("fsdp", [4, 1], [(r, 4, 1) for r in range(4)]),
    ("dp", [4], [(r, 4, 1) for r in range(4)]),
])
def test_the_loader_shards_by_data_index_on_a_model_axis(monkeypatch, mode,
                                                         shape, want):
    """``data_shard`` at 4 ranks: on a mesh with a model axis (tp, fsdp)
    each rank loads its data index's rows, m times BATCH_IMAGES; without
    one, its rank's."""
    import vlbert_tpu_torch.data.build as build

    cfg = _mesh(td._cfg("vqa", 1), mode, shape)
    got = []
    for r in range(4):
        monkeypatch.setattr(build, "dist_rank_world", lambda r=r: (r, 4))
        got.append(build.data_shard(cfg))
    assert got == want
