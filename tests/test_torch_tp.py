"""Tensor parallelism on the port (TPU.PARTITION_MODE tp over a [data,
model] mesh, ``vlbert_tpu_torch/parallel/tp.py``) on the CPU: gloo ranks,
each a process, at tiny width in fp32.

The bar is the JAX package's semantics: its tp step is one jit whose
compute equals the one-process step on the global batch
(vlbert_tpu/training/loop.py:266-270). Four ranks at MESH_SHAPE [2, 2]
(two replicas of two model ranks each) are held to the JAX package's
``make_train_step`` on the global batch (VQA, and multitask pretraining
with unequal masked counts on the replicas), with and without
accumulation, at tests/test_torch_dist.py's bar; each rank holds its rows
of the column-parallel weights and its columns of the row-parallel ones,
its moments alike; the pretraining model's gathered file is a one-process
file key for key, loads in one process and in the JAX package, and
resumes into shards. Two ranks at [1, 2] with dropout 0.1 (6 heads: rank
1's K3 mask at head offset 3 of 6), with REMAT and with the fused QKV
route equal one port process at BATCH_IMAGES x 2 within 1e-5 of each
tensor's largest element, and ``train_net`` under tp writes one file on
rank 0 and AUTO_RESUMEs on a rank without it.

The two groups start together while the parent runs the JAX steps and the
one-process port steps. The rank processes import this module,
tests/test_torch_dist.py and tests/test_torch_fsdp.py: jax and the JAX
package's models are imported inside the parent's functions only.
"""

import os
import pickle
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import tests.test_torch_dist as td
import tests.test_torch_fsdp as tf

# a tensor's gap to one port process, over its largest element
REL = 1e-5
MESH22, MESH12 = [2, 2], [1, 2]
# the [1, 2] cases' encoder: 6 heads of 8, so rank 1 holds heads 3..5
HEADS6 = dict(hidden_size=48, visual_size=48, num_attention_heads=6,
              intermediate_size=96)


def _tp(cfg, shape):
    cfg.TPU.PARTITION_MODE = "tp"
    cfg.TPU.MESH_SHAPE = list(shape)
    cfg.TPU.MESH_AXES = ["data", "model"]
    return cfg


def _six_heads_cfg(batch_images, remat=False, fused_qkv=False):
    """tests/test_torch_dist.py's VQA config with dropout 0.1 (hidden,
    attention probs, classifier) and the encoder of HEADS6."""
    cfg = td._cfg("vqa", batch_images, dropout=0.1)
    for k, v in HEADS6.items():
        cfg.NETWORK.VLBERT[k] = v
    cfg.NETWORK.IMAGE_FINAL_DIM = HEADS6["hidden_size"]
    cfg.TPU.REMAT = remat
    cfg.TPU.FUSED_QKV = fused_qkv
    return cfg


def _case_cfg(case, world):
    if case["task"] == "vqa6":
        return _six_heads_cfg(case["batch_images"] // world,
                              **case.get("flags", {}))
    return tf._case_cfg(case, world)


def _task(case):
    return "vqa" if case["task"] == "vqa6" else case["task"]


# ------------------------------------------------------ the rank processes

def _run_tp(case, shape, save=None):
    """``case["n"]`` steps of the replica's rows of ``case["batch"]`` on a
    tp model over ``shape``, for VQA an eval forward after the first.
    Returns the losses, norms, eval metrics, the rank's mesh place, its
    local state and first moments, the split dims and layer 0's heads."""
    from vlbert_tpu_torch.parallel import dist as dist_lib
    from vlbert_tpu_torch.parallel import tp as tp_lib
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.loop import (make_eval_step,
                                                make_train_step)
    from vlbert_tpu_torch.training.optim import Optimizer

    rank, world = dist_lib.rank_world()
    task, accum = _task(case), case["accum"]
    cfg = _tp(_case_cfg(case, world), shape)
    dist_lib.check_partition(cfg, world)
    tm = tf._model(cfg, task)
    tm.load_state_dict(case["init"])
    mesh = tp_lib.make_mesh(cfg)
    tp_lib.shard_module(tm, mesh)
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
    att = tm.vlbert.encoder.layer[0].attention.self
    return {"losses": losses, "norms": norms, "evals": evals,
            "place": (mesh.data_index, mesh.model_index),
            "state": {k: v.detach().clone()
                      for k, v in tm.state_dict().items()},
            "mu": dict(zip(opt.names, (m.clone() for m in opt.mu))),
            "dims": dict(tm.partition.dims),
            "heads": (att.num_heads, att.head_offset, att.heads_total)}


def _reload(case, path, shape):
    """``path`` loaded into a fresh tp model and optimizer (collective:
    rank 0 reads, each rank keeps its part): local state, first moments
    and the count."""
    from vlbert_tpu_torch.parallel import dist as dist_lib
    from vlbert_tpu_torch.parallel import tp as tp_lib
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.optim import Optimizer

    world = dist_lib.rank_world()[1]
    cfg = _tp(_case_cfg(case, world), shape)
    tm = tf._model(cfg, _task(case))
    tp_lib.shard_module(tm, tp_lib.make_mesh(cfg))
    opt = Optimizer(cfg, tm, 4, world)
    ckpt_lib.load_checkpoint(path, tm, opt)
    return ({k: v.detach().clone() for k, v in tm.state_dict().items()},
            dict(zip(opt.names, (m.clone() for m in opt.mu))), opt.count)


def _reduce_probe(rank):
    """``TensorParallel.reduce_gradients_`` at [2, 2] on gradients that
    differ on every rank: a split one ("w", rank + 0.25 x its index) and
    a replicated one ("b", the same)."""
    from vlbert_tpu_torch.parallel import tp as tp_lib

    cfg = _tp(td._cfg("vqa", 4), MESH22)
    part = tp_lib.TensorParallel(tp_lib.make_mesh(cfg), {"w": 0})
    grads = [rank + 0.25 * torch.arange(6.0).reshape(3, 2)
             for _ in range(2)]
    part.reduce_gradients_(["w", "b"], grads)
    return dict(zip(["w", "b"], grads))


def _rank_mesh22(rank, world, d):
    """Four ranks at [2, 2]: every JAX case, the pretraining model's file
    written after its steps, then read back into shards; the gradient
    reduction's probe."""
    out = {"reduce": _reduce_probe(rank)}
    for name, case in d["cases"].items():
        save = (os.path.join(d["tmp"], "pretrain_tp", "p")
                if name == "pretrain" else None)
        out[name] = _run_tp(case, MESH22, save=save)
    out["reload"] = _reload(d["cases"]["pretrain"],
                            os.path.join(d["tmp"], "pretrain_tp",
                                         "p-0000.model"), MESH22)
    return out


def _rank_mesh12(rank, world, d):
    """Two ranks at [1, 2]: the six-head cases with dropout, then
    ``train_net`` on the tiny VQA fixture, epoch 0 and AUTO_RESUME to
    END_EPOCH 2 (rank 1's output directory has no checkpoint)."""
    import vlbert_tpu_torch.engine.train as t_train

    out = {name: _run_tp(case, MESH12) for name, case in d["cases"].items()}
    kept, saved = [], t_train.resume

    def resume(prefix, model, optimizer, config):
        begin_epoch, extra = saved(prefix, model, optimizer, config)
        kept.append({"begin_epoch": begin_epoch, "count": optimizer.count,
                     "best_val": extra.get("best_val"),
                     "mu": td._digest(optimizer.mu),
                     "params": td._digest(optimizer.params)})
        return begin_epoch, extra

    t_train.resume = resume
    runs = []
    try:
        for end_epoch in (1, 2):
            cfg = _tp(td._train_net_cfg(d, end_epoch), MESH12)
            cfg.OUTPUT_PATH = os.path.join(d["tmp"], f"out{rank}")
            args = types.SimpleNamespace(model_dir="", device="cpu", ckpt="",
                                         do_test=False)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                model, history = t_train.train_net(args, cfg, "vqa")
            runs.append({"history": history,
                         "state": {k: v.detach().clone() for k, v
                                   in model.state_dict().items()}})
    finally:
        t_train.resume = saved
    out["train_net"] = {
        "runs": runs, "resumed": kept,
        "files": {r: sorted(os.listdir(os.path.join(d["tmp"], f"out{r}",
                                                    "vqa_train")))
                  for r in range(world)}}
    return out


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
        out = {"mesh22": _rank_mesh22,
               "mesh12": _rank_mesh12}[scenario](rank, world, d)
    out["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(tmp, f"{scenario}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------------ the parent

def _one_process(case, save=None):
    """``case["n"]`` port steps of the whole batch in one process (the
    same seeds): losses, norms and the final state."""
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.loop import make_train_step
    from vlbert_tpu_torch.training.optim import Optimizer

    cfg = _case_cfg(case, 1)
    tm = tf._model(cfg, _task(case))
    tm.load_state_dict(case["init"])
    opt = Optimizer(cfg, tm, 4, 1)
    step = make_train_step(tm, opt, _task(case), cfg, case["accum"])
    batch = tuple(None if x is None else torch.from_numpy(np.asarray(x))
                  for x in case["batch"])
    losses, norms = [], []
    for i in range(case["n"]):
        loss, dm = step(batch, 7 + i)
        losses.append(loss.item())
        norms.append(float(dm["grad_total_norm"][0]))
    if save is not None:
        ckpt_lib.save_checkpoint(save, 0, tm, opt)
    return {"losses": losses, "norms": norms,
            "state": {k: v.detach().clone()
                      for k, v in tm.state_dict().items()}}


def _six_heads_init(B):
    """(batch, init) of the [1, 2] cases: tests/test_torch_dist.py's VQA
    batch of B rows, seed-3 random weights of the six-head model."""
    from vlbert_tpu_torch.models.layers import init_weights

    inputs, label = td._global_batch("vqa", B, seed=2)
    tm = tf._model(_six_heads_cfg(B), "vqa")
    init_weights(tm, torch.Generator().manual_seed(3))
    return (*inputs, label), {k: v.clone()
                              for k, v in tm.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups, started together; meanwhile the JAX package's
    one-process steps and the port's."""
    import vlbert_tpu.models.fast_rcnn as j_fast_rcnn
    from tests.test_entrypoints import _write_vqa_fixture
    from vlbert_tpu.ops.dropout import Dropout as JDropout
    from vlbert_tpu_torch.training.convert import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("tp")
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
        batch6, init6 = _six_heads_init(4)
        six = {name: {"task": "vqa6", "batch_images": 4, "accum": 1,
                      "batch": batch6, "init": init6, "n": 2,
                      "flags": flags}
               for name, flags in (("dropout", {}),
                                   ("remat", {"remat": True}),
                                   ("fused", {"fused_qkv": True}))}
        data_dir, vocab_dir = _write_vqa_fixture(tmp)
        d12 = {"tmp": str(tmp), "data_dir": data_dir, "vocab_dir": vocab_dir,
               "cases": six}
        mesh22 = td.start_ranks("mesh22", str(tmp),
                                {"cases": cases, "tmp": str(tmp)},
                                module="tests.test_torch_tp", world=4)
        mesh12 = td.start_ranks("mesh12", str(tmp), d12,
                                module="tests.test_torch_tp", world=2)
        jax_out = {}
        for name, case in cases.items():
            jm, v, tm, _ = models[case["task"]]
            cfg = (td._cfg("vqa", case["batch_images"], case["accum"])
                   if case["task"] == "vqa"
                   else tf._pretrain_cfg(case["batch_images"], case["accum"]))
            losses, norms, flat = tf._jax_steps(case, cfg, jm, v)
            jax_out[name] = (losses, norms, state_dict_from_jax(flat, tm))
    finally:
        j_fast_rcnn.Dropout = saved
    one = {name: _one_process(case) for name, case in six.items()}
    one["pretrain"] = _one_process(
        cases["pretrain"], save=os.path.join(str(tmp), "pretrain_one", "p"))
    return {"jax": jax_out, "one": one, "cases": cases, "d12": d12,
            "tmp": str(tmp), "mesh22": td.finish_ranks(mesh22),
            "mesh12": td.finish_ranks(mesh12)}


def _whole(rank_outs, part="state"):
    """{data index: the replica's tensors whole}: each split tensor's
    parts concatenated along its split dim in model-index order; a
    replicated tensor as rank (data index, 0) holds it."""
    by_place = {o["place"]: o for o in rank_outs}
    out = {}
    for (i, j), o in sorted(by_place.items()):
        if j:
            continue
        ranks = [by_place[i, jj] for jj in range(len(
            [p for p in by_place if p[0] == i]))]
        out[i] = {k: torch.cat([r[part][k] for r in ranks], o["dims"][k])
                  if k in o["dims"] else v for k, v in o[part].items()}
    return out


def _assert_rel(got, want, floor=1e-2):
    """Each tensor within REL of its reference's largest element (of
    ``floor`` at least)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = torch.as_tensor(np.asarray(w))
        gap = float((got[k] - w).abs().max()) if w.numel() else 0.0
        assert gap <= REL * max(float(w.abs().max()), floor), (k, gap)


CASES = ["vqa", "vqa_accum", "pretrain", "pretrain_accum"]


@pytest.mark.parametrize("case", CASES)
def test_mesh22_tp_equals_the_jax_one_process_step(runs, case):
    """Four ranks at [2, 2] take the JAX package's step over the global
    batch: losses, gradient norms and the parameters after 2 AdamW steps
    at tests/test_torch_dist.py's bar, on both replicas; the two replicas
    bit for bit alike, and a replica's eval forward between the steps the
    same on its two ranks. The pretraining replicas' MLM and masked-region
    counts differ."""
    want_loss, want_norm, want_sd = runs["jax"][case]
    outs = [r[case] for r in runs["mesh22"]]
    for o in outs:
        np.testing.assert_allclose(o["losses"], want_loss, rtol=1e-5)
        np.testing.assert_allclose(o["norms"], want_norm, rtol=1e-4)
    whole = _whole(outs)
    assert sorted(whole) == [0, 1]
    for state in whole.values():
        sd = {k: v for k, v in state.items() if k in want_sd}
        td._assert_state_close(sd, want_sd, **td.TOL)
    assert all(torch.equal(v, whole[1][k]) for k, v in whole[0].items())
    # an eval forward of a replica's rows: the same on its two model ranks
    evals = {o["place"]: o["evals"] for o in outs}
    assert evals[0, 0] == evals[0, 1] and evals[1, 0] == evals[1, 1]


def test_replicated_gradients_are_one_mean_on_every_rank(runs):
    """At [2, 2], ranks that computed different gradients: a split
    gradient becomes its mean over the data group (ranks j and 2 + j), a
    replicated one its mean over the world, bit for bit the same on every
    rank, so that replicated parameters cannot drift apart between the
    ranks of a model group."""
    base = 0.25 * torch.arange(6.0).reshape(3, 2)
    outs = [r["reduce"] for r in runs["mesh22"]]
    for rank, o in enumerate(outs):
        j = rank % 2
        torch.testing.assert_close(o["w"], base + (j + 2 + j) / 2,
                                   rtol=0, atol=1e-6)
        assert torch.equal(o["b"], outs[0]["b"])
    torch.testing.assert_close(outs[0]["b"], base + 1.5, rtol=0, atol=1e-6)


def test_each_rank_holds_its_rows_columns_and_moments(runs):
    """q, k, v and intermediate weights are [out / 2, in] on each rank of
    [2, 2] (their biases [out / 2]), the two output denses' [out, in / 2],
    every other tensor whole; the moments have their parameters' shapes;
    the ranks of a model group hold different parts, the replicas the
    same ones."""
    full = td._port_model(td._cfg("vqa", 4), "vqa").state_dict()
    outs = [r["vqa"] for r in runs["mesh22"]]
    for o in outs:
        dims = o["dims"]
        # 2 layers of 8 column-parallel tensors and 2 row-parallel weights
        assert len(dims) == 2 * 10
        for k, v in o["state"].items():
            want = list(full[k].shape)
            if k.endswith(("query.weight", "key.weight", "value.weight",
                           "intermediate.dense.weight")) or k.endswith((
                               "query.bias", "key.bias", "value.bias",
                               "intermediate.dense.bias")):
                assert dims[k] == 0
                want[0] //= 2
            elif k.endswith("output.dense.weight"):
                assert dims[k] == 1
                want[1] //= 2
            else:
                assert k not in dims
            assert list(v.shape) == want, k
        for k, m in o["mu"].items():
            assert m.shape == o["state"][k].shape, k
    by_place = {o["place"]: o for o in outs}
    k = "vlbert.encoder.layer.0.attention.self.query.weight"
    assert not torch.equal(by_place[0, 0]["state"][k],
                           by_place[0, 1]["state"][k])
    assert torch.equal(by_place[0, 1]["state"][k], by_place[1, 1]["state"][k])


@pytest.mark.parametrize("case", ["dropout", "remat", "fused"])
def test_mesh12_tp_with_dropout_equals_one_process(runs, case):
    """Two ranks at [1, 2], dropout 0.1 everywhere, 6 heads (rank 1 runs
    heads 3..5: its attention masks are drawn at head offset 3 of 6):
    losses, norms and every tensor after 2 steps within 1e-5 of its
    largest element of one port process on the same rows with the same
    seeds. ``remat``: TPU.REMAT (the recompute replays the collectives
    and the seeds); ``fused``: TPU.FUSED_QKV on the local shards."""
    one = runs["one"][case]
    outs = [r[case] for r in runs["mesh12"]]
    assert [o["heads"] for o in outs] == [(3, 0, 6), (3, 3, 6)]
    for o in outs:
        np.testing.assert_allclose(o["losses"], one["losses"], rtol=REL)
        np.testing.assert_allclose(o["norms"], one["norms"], rtol=REL)
    _assert_rel(_whole(outs)[0], one["state"])


def test_the_gathered_file_is_one_process_file_and_loads_everywhere(runs):
    """The pretraining model's file written under tp at [2, 2] (rank 0
    writes what rank 0's model group gathers) against one process's after
    the same steps: the same keys in the same order, shapes and dtypes,
    the tied MLM decoder one tensor with the word embedding, values and
    moments within the JAX bar; it loads into one port process (strict)
    and through the JAX package's converter."""
    from vlbert_tpu.training.convert import load_torch_or_native_checkpoint
    from vlbert_tpu_torch.models.vlbert import TIED_DECODER
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.optim import Optimizer

    tmp = runs["tmp"]
    assert os.listdir(os.path.join(tmp, "pretrain_tp")) == ["p-0000.model"]
    path = os.path.join(tmp, "pretrain_tp", "p-0000.model")
    got = ckpt_lib.load_checkpoint(path)
    want = ckpt_lib.load_checkpoint(
        os.path.join(tmp, "pretrain_one", "p-0000.model"))
    for part in ("state_dict",):
        assert list(got[part]) == list(want[part])
        for k, v in want[part].items():
            assert (got[part][k].shape, got[part][k].dtype) \
                == (v.shape, v.dtype), k
        td._assert_state_close(got[part], want[part], **td.TOL)
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
    case = runs["cases"]["pretrain"]
    cfg = tf._pretrain_cfg(case["batch_images"])
    tm = tf._model(cfg, "pretrain")
    opt = Optimizer(cfg, tm, 4)
    ckpt_lib.load_checkpoint(path, tm, opt)
    assert opt.count == 2
    flat = load_torch_or_native_checkpoint(path)
    assert len(flat) > 0 and all(np.isfinite(np.asarray(a)).all()
                                 for a in flat.values())


def test_the_gathered_file_resumes_into_shards(runs):
    """The [2, 2] file loaded into a fresh tp model and optimizer on four
    ranks: each rank's parameters and first moments are its part of the
    file's, the count restored."""
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib

    f = ckpt_lib.load_checkpoint(
        os.path.join(runs["tmp"], "pretrain_tp", "p-0000.model"))
    for r in runs["mesh22"]:
        state, mu, count = r["reload"]
        place, dims = r["pretrain"]["place"], r["pretrain"]["dims"]
        assert count == 2 and state.keys() == f["state_dict"].keys()
        for k, v in f["state_dict"].items():
            want = v
            if k in dims:
                n = state[k].shape[dims[k]]
                want = v.narrow(dims[k], place[1] * n, n)
            assert torch.equal(state[k], want), k
        for k, v in f["optimizer"]["mu"].items():
            want = v if k not in dims else v.narrow(
                dims[k], place[1] * mu[k].shape[dims[k]], mu[k].shape[dims[k]])
            assert torch.equal(mu[k], want), k


def test_train_net_under_tp_writes_one_file_and_resumes(runs):
    """train_net at [1, 2]: rank 0 alone writes; the AUTO_RESUME run
    scatters rank 0's file to rank 1, whose directory holds none: both
    take epoch 1, count 4, the best validation metric, the weights and
    moments of their parts, and the same losses; the file loads into one
    port process."""
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib

    r0, r1 = (r["train_net"] for r in runs["mesh12"])
    assert r0["files"][0] == ["tiny-0000.model", "tiny-0001.model",
                              "tiny-best.model", "train_rank0.log"]
    assert r0["files"][1] == ["train_rank1.log"]
    first, second = r0["resumed"][1], r1["resumed"][1]
    assert first["begin_epoch"] == second["begin_epoch"] == 1
    assert first["count"] == second["count"] == 4
    assert first["best_val"] == second["best_val"] is not None
    for run0, run1 in zip(r0["runs"], r1["runs"]):
        assert run0["history"]["loss"] == run1["history"]["loss"]
        assert run0["history"]["val"] == run1["history"]["val"]
    h0 = r0["runs"][1]["history"]
    assert (h0["begin_epoch"], h0["resumed_count"], len(h0["loss"])) \
        == (1, 4, 4)
    held, total = h0["state_elements"]
    assert held < total
    cfg = td._train_net_cfg(runs["d12"], 2)
    tm = td._port_model(cfg, "vqa")
    ckpt_lib.load_checkpoint(os.path.join(
        runs["tmp"], "out0", "vqa_train", "tiny-0001.model"), tm)


def test_no_rank_imported_jax(runs):
    assert not any(r["jax_imported"] for r in runs["mesh22"] + runs["mesh12"])


# --------------------------------------------------- in-process checks

@pytest.mark.parametrize("offset, heads", [(0, 6), (3, 3), (2, 2), (5, 1)])
def test_attention_bits_of_a_head_slice_are_its_slice(offset, heads):
    """attention_bits of heads offset .. offset + heads - 1 of a layer of
    6 (head_offset, heads_total) is that slice of the layer's bits, and
    the plain K3 of the slice is that slice of the layer's output; at the
    defaults the bits are the layer's own."""
    from vlbert_tpu_torch.ops import attention as tattn

    B, H, L, seed = 2, 6, 9, 2 ** 63 + 11
    full = tattn.attention_bits(B, H, L, seed)
    part = tattn.attention_bits(B, heads, L, seed, head_offset=offset,
                                heads_total=H)
    assert torch.equal(part, full[:, offset:offset + heads])
    assert torch.equal(tattn.attention_bits(B, H, L, seed, head_offset=0,
                                            heads_total=H), full)
    g = torch.Generator().manual_seed(offset)
    q, k, v = (torch.randn(B, L, H, 8, generator=g) for _ in range(3))
    bias = torch.zeros(B, 1, 1, L)
    bias[1, ..., 6:] = -10000.0
    want = tattn.fused_attention_dropout(q, k, v, bias, 0.3, seed=seed)
    sl = slice(offset, offset + heads)
    got = tattn.fused_attention_dropout(q[:, :, sl], k[:, :, sl],
                                        v[:, :, sl], bias, 0.3, seed=seed,
                                        head_offset=offset, heads_total=H)
    assert torch.equal(got, want[:, :, sl])
    with pytest.raises(ValueError, match="not in a layer of 6"):
        tattn.attention_bits(B, heads, L, seed, head_offset=H - heads + 1,
                             heads_total=H)


def test_shard_module_keeps_each_rank_its_part():
    """``shard_module`` on a [1, 2] mesh (no collective: the groups are
    only held): each layer's heads, its split weights and the map of split
    dims; the parts of the two model indices are the whole tensor's."""
    from vlbert_tpu_torch.parallel import tp as tp_lib

    cfg = _six_heads_cfg(2)
    whole = tf._model(cfg, "vqa")
    parts = []
    for j in range(2):
        tm = tf._model(cfg, "vqa")
        tm.load_state_dict(whole.state_dict())
        tp_lib.shard_module(tm, tp_lib.Mesh(1, 2, 0, j, None, None))
        att = tm.vlbert.encoder.layer[1].attention.self
        assert (att.num_heads, att.head_offset, att.heads_total) \
            == (3, 3 * j, 6)
        parts.append(tm.state_dict())
    sd, dims = whole.state_dict(), tm.partition.dims
    assert set(dims) == {k for k in sd if k.startswith("vlbert.encoder") and
                         k.endswith(("query.weight", "query.bias",
                                     "key.weight", "key.bias",
                                     "value.weight", "value.bias",
                                     "intermediate.dense.weight",
                                     "intermediate.dense.bias",
                                     "output.dense.weight"))}
    for k, v in sd.items():
        got = torch.cat([p[k] for p in parts], dims[k]) if k in dims \
            else parts[1][k]
        assert torch.equal(got, v), k


@pytest.mark.parametrize("shape, axes, world, heads, want", [
    ([], ["data"], 1, 2, "needs a 'model' mesh axis > 1"),
    ([4], ["data"], 4, 2, "needs a 'model' mesh axis > 1"),
    ([4, 1], ["data", "model"], 4, 2, "needs a 'model' mesh axis > 1"),
    ([1, 2], ["data", "model"], 1, 2, "lays out 2 devices"),
    ([2, 2], ["data", "model"], 2, 2, "lays out 4 devices"),
    ([1, 4], ["data", "model"], 4, 2, "num_attention_heads 2 not divisible"),
    ([1, 2], ["model", "data"], 2, 2, "MESH_AXES \\[data, model\\]"),
    ([1, 2, 1], ["data", "model", "x"], 2, 2, "MESH_AXES \\[data, model\\]"),
])
def test_tp_is_refused_by_name(shape, axes, world, heads, want):
    """check_partition under tp: a model axis of at most 1 raises the JAX
    package's ValueError (vlbert_tpu/training/loop.py:273-279), at one
    rank too; so do a mesh whose size is not the world, heads that the
    model axis does not divide, and another layout than [data, model]."""
    from vlbert_tpu_torch.parallel.dist import check_partition

    cfg = td._cfg("vqa", 1)
    cfg.NETWORK.VLBERT.num_attention_heads = heads
    cfg.TPU.PARTITION_MODE = "tp"
    cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES = shape, axes
    with pytest.raises(ValueError, match=want):
        check_partition(cfg, world)


def test_tp_is_accepted_on_a_mesh_of_the_world():
    """[1, 2] at 2 ranks, [2, 2] at 4, [1, 4] at 4 with 4 heads."""
    from vlbert_tpu_torch.parallel.dist import check_partition, mesh_dims

    cfg = _tp(td._cfg("vqa", 1), [1, 2])
    check_partition(cfg, 2)
    assert mesh_dims(cfg, 2) == (1, 2)
    cfg.TPU.MESH_SHAPE = [2, 2]
    check_partition(cfg, 4)
    cfg.TPU.MESH_SHAPE = [1, 4]
    cfg.NETWORK.VLBERT.num_attention_heads = 4
    check_partition(cfg, 4)
    assert mesh_dims(cfg, 4) == (1, 4)


def test_command_line_overrides_follow_the_yaml(tmp_path):
    """``engine.train``'s KEY VALUE overrides: YAML values, strict keys,
    pairs only."""
    from vlbert_tpu_torch.engine.cli import apply_overrides, parse_args
    from vlbert_tpu_torch.utils.config import default_config

    args = parse_args(argv=["--task", "vqa", "--cfg", "x.yaml", "--dist",
                            "TPU.PARTITION_MODE", "tp", "TPU.MESH_SHAPE",
                            "[1,2]", "TPU.MESH_AXES", "[data,model]"])
    cfg = apply_overrides(default_config("vqa"), args.opts)
    assert (cfg.TPU.PARTITION_MODE, cfg.TPU.MESH_SHAPE,
            cfg.TPU.MESH_AXES) == ("tp", [1, 2], ["data", "model"])
    apply_overrides(cfg, ["NETWORK.VLBERT.num_attention_heads", "6"])
    assert cfg.NETWORK.VLBERT.num_attention_heads == 6
    with pytest.raises(ValueError, match="TPU.NO_SUCH_KNOB is not in"):
        apply_overrides(cfg, ["TPU.NO_SUCH_KNOB", "1"])
    with pytest.raises(SystemExit):
        parse_args(argv=["--task", "vqa", "--cfg", "x.yaml", "TPU.REMAT"])
