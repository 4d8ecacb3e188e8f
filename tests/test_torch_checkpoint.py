"""The port's checkpoints and warm starts (vlbert_tpu_torch.training.
checkpoint, training.convert's loaders, engine.train's warm starts and
resume) against the JAX package on the CPU, at tiny width in fp32.

Weights meet on reference names: a port checkpoint must load in the JAX
package through its torch path, a reference-layout file (``module.`` and
``vlbert._module.`` prefixes) must load into the port, and every warm
start must leave the port with the tensors the JAX package ends with.
Checkpoints and pretrained files are written by the tests themselves.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlbert_tpu.engine.train as j_train
import vlbert_tpu.training.convert as j_convert
import vlbert_tpu_torch.engine.train as t_train
from tests.test_entrypoints import VOCAB, _tiny_vqa_cfg, _write_vqa_fixture
from tests.test_torch_train import (TOL, _batch, _flat, _jax_vqa, _jnp,
                                    _port_model, _step_cfg, _torch)
from vlbert_tpu.training.checkpoint import flatten_params, partial_load
from vlbert_tpu.utils.config import default_config, load_config
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.ops.dropout import Dropout
from vlbert_tpu_torch.training import checkpoint as ckpt
from vlbert_tpu_torch.training.convert import state_dict_from_jax
from vlbert_tpu_torch.training.loop import make_train_step
from vlbert_tpu_torch.training.optim import Optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = {"vqa": os.path.join(REPO, "cfgs", "vqa", "base_v5e_bf16.yaml"),
           "refcoco": os.path.join(REPO, "cfgs", "refcoco",
                                   "base_gt_boxes_4x16G.yaml")}


def _trained(seed=0, steps=2):
    """A tiny VQA model and its AdamW after ``steps`` steps."""
    cfg = _step_cfg()
    torch.manual_seed(seed)
    tm = _port_model(cfg)
    init_weights(tm, torch.Generator().manual_seed(seed))
    tm.image_feature_extractor.obj_downsample[0].rate = 0.0
    opt = Optimizer(cfg, tm, 4)
    inputs, label = _batch(seed)
    step = make_train_step(tm, opt, "vqa", cfg)
    for i in range(steps):
        step(tuple(map(_torch, (*inputs, label))), i)
    opt.plateau_scale = 0.25
    return cfg, tm, opt


def _assert_same_state(m1, o1, m2, o2):
    for k, v in m1.state_dict().items():
        assert torch.equal(v, m2.state_dict()[k]), k
    s1, s2 = o1.state_dict(), o2.state_dict()
    assert (s1["count"], s1["plateau_scale"]) \
        == (s2["count"], s2["plateau_scale"])
    for key in ("mu", "nu"):
        assert s1[key].keys() == s2[key].keys()
        for n, t in s1[key].items():
            assert torch.equal(t, s2[key][n]), (key, n)


@pytest.mark.parametrize("async_write", [False, True])
def test_save_then_load_restores_everything(tmp_path, async_write):
    cfg, tm, opt = _trained()
    extra = {"best_val": 0.375, "plateau": {"best": 0.375,
                                            "num_bad_epochs": 1,
                                            "cooldown_counter": 2,
                                            "scale": 0.1}}
    prefix = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(prefix, 3, tm, opt, extra=extra,
                                async_write=async_write,
                                mirror_best_to=prefix)
    assert path == f"{prefix}-0003.model"
    _, tm2, opt2 = _trained(seed=1, steps=1)
    got = ckpt.load_checkpoint(path, tm2, opt2)    # joins the writer first
    assert got == extra
    _assert_same_state(tm, opt, tm2, opt2)
    assert opt2.count == 2 and opt2.lr() == opt.lr()
    assert os.path.exists(f"{prefix}-best.model")
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    payload = ckpt.load_checkpoint(f"{prefix}-best.model")
    assert set(payload) == {"state_dict", "optimizer", "step", "extra"}
    assert payload["step"] == 2


def test_mirror_best_joins_the_writer_and_copies_its_file(tmp_path):
    _, tm, opt = _trained(steps=1)
    prefix = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(prefix, 4, tm, opt, extra={"best_val": 0.5},
                                async_write=True)
    best = ckpt.mirror_best(str(tmp_path / "run"), path)
    assert best == str(tmp_path / "run-best.model")
    with open(path, "rb") as a, open(best, "rb") as b:
        assert a.read() == b.read()
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_async_write_failure_surfaces_at_the_next_join(tmp_path,
                                                       monkeypatch):
    _, tm, opt = _trained(steps=1)

    def full_disk(obj, f):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt.torch, "save", full_disk)
    ckpt.save_checkpoint(str(tmp_path / "ck"), 0, tm, opt, async_write=True)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ckpt.wait_for_pending_save()
    ckpt.wait_for_pending_save()           # the failure is reported once


def test_auto_resume_picks_the_newest_epoch(tmp_path):
    prefix = str(tmp_path / "ck")
    saved = {}
    for epoch, seed in ((0, 0), (2, 1)):
        _, tm, opt = _trained(seed=seed, steps=epoch + 1)
        ckpt.save_checkpoint(prefix, epoch, tm, opt, extra={"epoch": epoch})
        saved[epoch] = (tm, opt)
    _, tm, opt = _trained(seed=5, steps=1)
    assert ckpt.auto_resume(prefix, tm, opt, end_epoch=6) \
        == (3, {"epoch": 2})
    _assert_same_state(*saved[2], tm, opt)
    assert ckpt.auto_resume(prefix, tm, opt, end_epoch=2) \
        == (1, {"epoch": 0})
    _assert_same_state(*saved[0], tm, opt)
    assert ckpt.auto_resume(str(tmp_path / "none"), tm, opt, 6) == (0, {})


def test_smart_resume_rules(tmp_path):
    cfg, tm, opt = _trained(steps=1)
    prefix = str(tmp_path / "ck")
    cfg.TRAIN.RESUME, cfg.TRAIN.BEGIN_EPOCH = True, 0
    with pytest.raises(ValueError, match="BEGIN_EPOCH >= 1"):
        ckpt.smart_resume(prefix, tm, opt, cfg)
    assert not ckpt.has_resumable_checkpoint(prefix, cfg)
    ckpt.save_checkpoint(prefix, 1, tm, opt, extra={"best_val": 0.5})
    cfg.TRAIN.BEGIN_EPOCH = 2
    assert ckpt.has_resumable_checkpoint(prefix, cfg)
    assert ckpt.smart_resume(prefix, tm, opt, cfg) == (2, {"best_val": 0.5})
    cfg.TRAIN.RESUME, cfg.TRAIN.AUTO_RESUME = False, False
    cfg.TRAIN.BEGIN_EPOCH = 0
    assert not ckpt.has_resumable_checkpoint(prefix, cfg)
    assert ckpt.smart_resume(prefix, tm, opt, cfg) == (0, {})


def test_optimizer_state_refuses_a_missing_or_misshaped_moment():
    _, tm, opt = _trained(steps=1)
    sd = opt.state_dict()
    name = opt.names[3]
    mu = dict(sd["mu"])
    del mu[name]
    with pytest.raises(KeyError, match=name):
        opt.load_state_dict({**sd, "mu": mu})
    nu = dict(sd["nu"])
    nu[name] = torch.zeros(7)
    with pytest.raises(ValueError, match="shape"):
        opt.load_state_dict({**sd, "nu": nu})


def _train_args(tmp_path):
    return types.SimpleNamespace(model_dir=str(tmp_path), device="cpu")


def _fixture_cfg(tmp_path, name, end_epoch):
    data_dir, vocab_dir = _write_vqa_fixture(tmp_path)
    cfg = _tiny_vqa_cfg(tmp_path, data_dir, vocab_dir)
    cfg.OUTPUT_PATH = str(tmp_path / name)
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = 32
    cfg.TPU.PROCESS_WORKERS = False
    cfg.TRAIN.LR, cfg.TRAIN.WARMUP = 1e-3, False
    cfg.TRAIN.BATCH_IMAGES = 2
    cfg.TRAIN.END_EPOCH = end_epoch
    cfg.TRAIN.LR_SCHEDULE = "step"
    cfg.TRAIN.LR_STEP = (1.5,)
    cfg.RNG_SEED = 0
    v = cfg.NETWORK.VLBERT
    v.hidden_dropout_prob = v.attention_probs_dropout_prob = 0.0
    cfg.NETWORK.CLASSIFIER_DROPOUT = 0.0
    return cfg


def test_resume_equals_an_unbroken_run(tmp_path, monkeypatch):
    """VQA with every dropout rate 0: two epochs straight give the same
    weights exactly as one epoch, a stop and an AUTO_RESUME of the
    second."""
    import vlbert_tpu_torch.models.fast_rcnn as fast_rcnn

    monkeypatch.setattr(fast_rcnn, "Dropout", lambda rate: Dropout(0.0))
    straight = _fixture_cfg(tmp_path, "straight", 2)
    m_straight, h_straight = t_train.train_net(
        _train_args(tmp_path), straight, "vqa")
    assert h_straight["begin_epoch"] == 0 and len(h_straight["loss"]) == 8

    broken = _fixture_cfg(tmp_path, "broken", 1)
    _, h1 = t_train.train_net(_train_args(tmp_path), broken, "vqa")
    broken.TRAIN.END_EPOCH = 2
    m_resumed, h2 = t_train.train_net(_train_args(tmp_path), broken,
                                      "vqa")
    assert (h2["begin_epoch"], h2["resumed_count"]) == (1, 4)
    assert h1["loss"] + h2["loss"] == h_straight["loss"]
    for k, v in m_straight.state_dict().items():
        assert torch.equal(v, m_resumed.state_dict()[k]), k
    out = os.path.join(broken.OUTPUT_PATH, "vqa_train")
    assert {"tiny-0000.model", "tiny-0001.model", "tiny-best.model"} \
        <= set(os.listdir(out))


def _state(params):
    """The piece of a JAX TrainState the warm-start functions touch."""
    return types.SimpleNamespace(
        params=params,
        replace=lambda params: _state(params))


def _assert_port_equals_jax(tm, jparams):
    """Every tensor of the port module equals the JAX tree's leaf, through
    the JAX converter's names (the VQA mlm head renamed as the port's
    converter renames it)."""
    want = {k: np.asarray(a) for k, a in flatten_params(
        jax.device_get(jparams["params"])).items()}
    got, skipped = j_convert.convert_state_dict(tm.state_dict())
    assert skipped == []
    if any(".qkv." in k for k in want):
        got = j_convert.fuse_qkv_params(got)
    if "final_mlp.transform_dense.kernel" in want:
        got = _to_jax_names_flat(got)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _refcoco_inputs(seed):
    """One RefCOCO+ query for the tiny model: a random 48x48 image, four
    candidate boxes (the last padded) and eight tokens."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, 48, 48, 3)).astype(np.float32),
            np.asarray([[[0, 0, 20, 20], [8, 4, 40, 30], [20, 18, 47, 47],
                         [0, 0, 0, 0]]], np.float32),
            np.asarray([[True, True, True, False]]),
            np.asarray([[48, 48, 1, 1]], np.float32),
            rng.integers(1, 100, (1, 8)).astype(np.int32),
            np.asarray([[True] * 6 + [False] * 2]))


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("kind", ["2fc", "mlm", "refcoco"])
def test_port_checkpoint_loads_in_jax_with_equal_logits(tmp_path, kind):
    if kind == "refcoco":
        from vlbert_tpu_torch.models.task_modules import build_module

        cfg = _tiny_refcoco_cfg()
        jm, v = _jax_refcoco(cfg)
        tm = build_module(cfg, "refcoco", dtype=torch.float32)
        init_weights(tm, torch.Generator().manual_seed(4))
        opt = Optimizer(cfg, tm, 4)
        inputs = _refcoco_inputs(1)
    else:
        cfg, jm, v = _jax_vqa(kind)
        _, tm, opt = _trained()
        if kind == "mlm":
            tm = _port_model(cfg)
            init_weights(tm, torch.Generator().manual_seed(4))
            opt = Optimizer(cfg, tm, 4)
        inputs, _ = _batch(1)
    path = ckpt.save_checkpoint(str(tmp_path / "port"), 0, tm, opt)
    assert j_convert.checkpoint_format(path) == "torch"
    flat = j_convert.load_torch_or_native_checkpoint(path)
    if kind == "mlm":
        # the JAX converter maps the reference's VQA mlm head to RefCOCO's
        # leaves (ROADMAP.md queue 3, JAX-side); renamed as the port does
        flat = _to_jax_names_flat(flat)
    if cfg.TPU.FUSED_QKV:
        flat = j_convert.fuse_qkv_params(flat)
    params, loaded = partial_load(jax.device_get(v["params"]), flat)
    assert sorted(loaded) == sorted(flatten_params(v["params"]))
    want = jm.apply({**v, "params": params}, *map(_jnp, inputs),
                    train=False)["label_logits"]
    with torch.no_grad():
        got = tm.eval()(*map(_torch, inputs))["label_logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


_MLM_FLAT = {"final_mlp_transform.dense.": "final_mlp.transform_dense.",
             "final_mlp_fc.": "final_mlp.dense_0."}


def _to_jax_names_flat(flat):
    out = {}
    for k, a in flat.items():
        for old, new in _MLM_FLAT.items():
            if k.startswith(old):
                k = new + k[len(old):]
        out[k] = a
    return out


def _reference_layout(sd):
    """Port names -> a reference task checkpoint's: the DDP ``module.``
    prefix, VL-BERT under ``vlbert._module.`` (TimeDistributed) and TF-era
    LayerNorm names in the encoder."""
    out = {}
    for k, t in sd.items():
        if k.startswith("vlbert."):
            k = "vlbert._module." + k[len("vlbert."):]
            if ".encoder." in k and "LayerNorm" in k:
                k = k.replace(".weight", ".gamma").replace(".bias", ".beta")
        out["module." + k] = t
    return out


def test_reference_layout_file_loads_into_the_port(tmp_path):
    from vlbert_tpu_torch.engine import test as t_test

    cfg, jm, v = _jax_vqa("2fc")
    flat = _flat(v["params"])
    ref = _port_model(cfg)
    ref.load_state_dict(state_dict_from_jax(flat, ref))
    path = str(tmp_path / "ref.model")
    torch.save({"state_dict": _reference_layout(ref.state_dict()),
                "epoch": 3}, path)
    tm = _port_model(cfg)
    loaded = t_test._load_params(tm, path)
    assert sorted(loaded) == sorted(tm.state_dict())
    inputs, _ = _batch(2)
    want = jm.apply(v, *map(_jnp, inputs), train=False)["label_logits"]
    with torch.no_grad():
        got = tm.eval()(*map(_torch, inputs))["label_logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ warm starts

def _bert_file(tm, path, type_rows, seed):
    """A language-pretrained BERT ``pytorch_model.bin``: ``bert.*`` names,
    TF-era LayerNorm names, a ``cls.*`` head and ``type_rows`` token
    types, with weights of the tiny model's shapes."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, t in tm.state_dict().items():
        if not k.startswith("vlbert.") or "visual" in k \
                or "end_embedding" in k:
            continue
        k = k[len("vlbert."):]
        for a, b in (("word_embeddings", "embeddings.word_embeddings"),
                     ("position_embeddings", "embeddings.position_embeddings"),
                     ("token_type_embeddings",
                      "embeddings.token_type_embeddings"),
                     ("embedding_LayerNorm", "embeddings.LayerNorm")):
            k = k.replace(a, b) if k.startswith(a) else k
        if "LayerNorm" in k:
            k = k.replace(".weight", ".gamma").replace(".bias", ".beta")
        shape = t.shape
        if "token_type_embeddings" in k:
            shape = (type_rows,) + tuple(t.shape[1:])
        sd["bert." + k] = torch.randn(shape, generator=g)
    H = tm.vl_config.hidden_size
    sd["cls.predictions.transform.dense.weight"] = torch.randn(H, H,
                                                               generator=g)
    sd["cls.predictions.bias"] = torch.randn(len(VOCAB), generator=g)
    sd["cls.seq_relationship.weight"] = torch.randn(2, H, generator=g)
    torch.save(sd, path)


def _resnet_file(tm, path, seed):
    """A raw torchvision-style ResNet state dict (conv1, bn1, layer1-4,
    fc, num_batches_tracked) of the tiny backbone's shapes."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, t in tm.state_dict().items():
        for src, dst in (("image_feature_extractor.backbone.", ""),
                         ("image_feature_extractor.roi_head_feature_"
                          "extractor.", "layer4.")):
            if k.startswith(src):
                sd[dst + k[len(src):]] = torch.rand(t.shape, generator=g) \
                    + (0.5 if "running_var" in k else 0.0)
                if k.endswith("bn1.running_var"):
                    sd[(dst + k[len(src):]).replace(
                        "running_var", "num_batches_tracked")] = \
                        torch.tensor(7)
    sd["fc.weight"] = torch.randn(10, 8, generator=g)
    sd["fc.bias"] = torch.randn(10, generator=g)
    torch.save(sd, path)


def _tiny_refcoco_cfg():
    from tests.test_torch_serve import _tiny_cfg

    cfg = _tiny_cfg()
    cfg.TPU.FUSED_QKV = False
    return cfg


def _jax_refcoco(cfg):
    from vlbert_tpu.models.task_modules import build_module as j_build

    jm = j_build(cfg, "refcoco", dtype=jnp.float32)
    B, O, T, IMG = 1, 4, 8, 48
    batch = (jnp.zeros((B, IMG, IMG, 3)),
             jnp.asarray([[[0, 0, 20, 20]] * O], jnp.float32),
             jnp.ones((B, O), bool),
             jnp.asarray([[IMG, IMG, 1, 1]], jnp.float32),
             jnp.ones((B, T), jnp.int32), jnp.ones((B, T), bool))
    return jm, jm.init(jax.random.PRNGKey(0), *batch, train=False)


def _port_from_jax(cfg, task, jparams):
    from vlbert_tpu_torch.models.task_modules import build_module

    tm = build_module(cfg, task, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_jax(_flat(jparams["params"]), tm))
    return tm


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("type_rows", [1, 2])
def test_bert_and_resnet_warm_starts_equal_jax(tmp_path, type_rows):
    cfg = _tiny_refcoco_cfg()
    cfg.NETWORK.VLBERT.vocab_size = len(VOCAB)
    jm, jp = _jax_refcoco(cfg)
    tm = _port_from_jax(cfg, "refcoco", jp)
    bert_dir = tmp_path / "bert"
    bert_dir.mkdir()
    _bert_file(tm, str(bert_dir / "pytorch_model.bin"), type_rows, seed=1)
    _resnet_file(tm, str(tmp_path / "resnet.pth"), seed=2)
    cfg.NETWORK.BERT_MODEL_NAME = str(bert_dir)
    cfg.NETWORK.IMAGE_PRETRAINED = str(tmp_path / "resnet.pth")
    assert t_train.warm_start_paths(cfg) == (
        str(bert_dir / "pytorch_model.bin"), str(tmp_path / "resnet.pth"))

    before = {k: t.clone() for k, t in tm.state_dict().items()}
    t_train.apply_warm_starts(tm, cfg)
    jstate = j_train.apply_warm_starts(_state(jax.device_get(jp)), cfg)
    _assert_port_equals_jax(tm, jstate.params)
    changed = {k for k, t in tm.state_dict().items()
               if not torch.equal(t, before[k])}
    # every backbone / RoI-head tensor and every BERT tensor came from a file
    assert all(k in changed for k in before
               if ".backbone." in k or "roi_head" in k
               or "encoder.layer" in k or "word_embeddings" in k)
    tt = tm.state_dict()["vlbert.token_type_embeddings.weight"]
    assert torch.equal(tt[2], tt[1]) and torch.equal(tt[1], tt[0]) \
        == (type_rows == 1)


def _pretrain_file(tm, task, path, seed):
    """A reference-layout VL-BERT pretrain checkpoint of ``tm``'s shapes:
    ``module.`` prefix, the task head's transform under the pretrain head
    it comes from (``vlbert.mlm_head.predictions.transform`` for VQA's
    mlm classifier, ``vlbert.mvrc_head.transform`` for RefCOCO+), no
    answer / grounding head, and the MLM head's own extra tensors."""
    g = torch.Generator().manual_seed(seed)
    head = ("vlbert.mlm_head.predictions.transform." if task == "vqa"
            else "vlbert.mvrc_head.transform.")
    sd = {}
    for k, t in tm.state_dict().items():
        if k.startswith("final_mlp.0."):
            k = head + k[len("final_mlp.0."):]
        elif k.startswith("final_mlp."):
            continue
        sd["module." + k] = torch.randn(t.shape, generator=g) * 0.1 \
            + (1.0 if "running_var" in k else 0.0)
    H = tm.vl_config.hidden_size
    sd["module.vlbert.mlm_head.predictions.bias"] = torch.randn(50,
                                                                generator=g)
    sd["module.vlbert.mlm_head.predictions.decoder.weight"] = torch.randn(
        50, H, generator=g)
    torch.save({"state_dict": sd}, path)
    return sd


def _jax_with_vqa_head_rename(monkeypatch):
    """The JAX converter with its VQA mlm-head leaves renamed, as the
    port's converter renames them (ROADMAP.md queue 3, JAX-side)."""
    orig = j_convert.convert_state_dict

    def renamed(sd):
        flat, skipped = orig(sd)
        return _to_jax_names_flat(flat), skipped

    monkeypatch.setattr(j_convert, "convert_state_dict", renamed)


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("case", ["vqa_shipped", "vqa_no_prefix_changes",
                                  "vqa_module_rules_only", "refcoco_shipped"])
def test_partial_pretrain_equals_jax(tmp_path, monkeypatch, case):
    task = case.split("_")[0]
    shipped = load_config(task, SHIPPED[task])
    if task == "vqa":
        cfg, _, v = _jax_vqa("mlm")
        cfg = cfg.clone()
        cfg.TPU.FUSED_QKV = True
        jp = jax.device_get(v)
    else:
        cfg = _tiny_refcoco_cfg()
        _, jp = _jax_refcoco(cfg)
        jp = jax.device_get(jp)
    tm = _port_from_jax(cfg, task, jp)
    path = str(tmp_path / "pretrain.model")
    sd = _pretrain_file(tm, task, path, seed=3)
    cfg.NETWORK.PARTIAL_PRETRAIN = path
    # the rules apply to the file's raw names, before 'module.' is
    # stripped: the module.-prefixed rules alone must still match
    rules = list(shipped.NETWORK.PARTIAL_PRETRAIN_PREFIX_CHANGES)
    cfg.NETWORK.PARTIAL_PRETRAIN_PREFIX_CHANGES = {
        "vqa_no_prefix_changes": [],
        "vqa_module_rules_only": [r for r in rules
                                  if r.startswith("module.")],
    }.get(case, rules)
    cfg.NETWORK.CLASSIFIER_PRETRAINED = task == "vqa"

    # the JAX package unchanged: under the shipped rules it drops the mlm
    # transform's dense layer (mapped to RefCOCO's leaf), nothing else
    plain = j_train.apply_partial_pretrain(_state(jp), cfg)
    if task == "vqa":
        _jax_with_vqa_head_rename(monkeypatch)
    jstate = j_train.apply_partial_pretrain(_state(jp), cfg)
    loaded, missing, mismatched = t_train.apply_partial_pretrain(tm, cfg)
    _assert_port_equals_jax(tm, jstate.params)
    dropped = {k for k, a in flatten_params(plain.params["params"]).items()
               if not np.array_equal(a, flatten_params(
                   jstate.params["params"])[k])}
    assert dropped == (set() if case in ("refcoco_shipped",
                                         "vqa_no_prefix_changes")
                       else {"final_mlp.transform_dense.kernel",
                             "final_mlp.transform_dense.bias"})
    # every tensor but the task head's last layer came from the file
    head = {k for k in tm.state_dict() if k.startswith("final_mlp.")
            and not k.startswith("final_mlp.0.")}
    assert set(loaded) == set(tm.state_dict()) - head
    assert not mismatched
    # the decoder has no counterpart and is skipped, as the JAX converter
    # skips it; the MLM bias has one but no place in a task model
    want_missing = {"vlbert.mlm_head.predictions.bias"}
    if case == "vqa_no_prefix_changes":
        want_missing |= {k[len("module."):] for k in sd
                         if "mlm_head.predictions.transform" in k}
    assert set(missing) == want_missing
    head_src = ("module.vlbert.mlm_head.predictions.transform."
                if task == "vqa" else "module.vlbert.mvrc_head.transform.")
    for k in loaded:
        src = head_src + k[len("final_mlp.0."):] \
            if k.startswith("final_mlp.0.") else "module." + k
        assert torch.equal(tm.state_dict()[k], sd[src]), k


def test_nsp_and_segmb_surgeries_equal_jax():
    """On plain dicts of reference names, compared through the JAX
    converter's names."""
    rng = np.random.default_rng(0)
    H = 6
    sd = {"vlbert.relationship_head.caption_image_relationship.weight":
          torch.from_numpy(rng.normal(size=(2, H)).astype(np.float32)),
          "vlbert.relationship_head.caption_image_relationship.bias":
          torch.from_numpy(rng.normal(size=2).astype(np.float32)),
          "vlbert.token_type_embeddings.weight":
          torch.from_numpy(rng.normal(size=(3, H)).astype(np.float32))}
    for rel, segmb in ((True, True), (False, False), (True, False)):
        cfg = default_config("vcr")
        cfg.NETWORK.LOAD_REL_HEAD = rel
        cfg.NETWORK.PARTIAL_PRETRAIN_SEGMB_INIT = segmb
        got = t_train.segmb_init_surgery(
            t_train.nsp_to_binary_classifier_surgery(dict(sd), cfg), cfg)
        flat, _ = j_convert.convert_state_dict(sd)
        want = j_train.segmb_init_surgery(
            j_train.nsp_to_binary_classifier_surgery(flat, cfg), cfg)
        got_flat, skipped = j_convert.convert_state_dict(got)
        assert not skipped and got_flat.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got_flat[k], w, err_msg=k)
        assert ("final_mlp.4.weight" in got) == rel
    assert not torch.equal(sd["vlbert.token_type_embeddings.weight"][1],
                           sd["vlbert.token_type_embeddings.weight"][0])
