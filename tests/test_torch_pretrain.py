"""Pretraining on the port (vlbert_tpu_torch): the multitask MLM + MVRC
model with its heads, losses, metrics and converter paths, against the
JAX package on the CPU (``train_net(..., "pretrain")`` is
tests/test_torch_pretrain_train.py).

Tiny width, as tests/test_torch_vcr.py: 2 layers, hidden 32, 2 heads, a
vocabulary of 120, 11 region classes, fp32, every dropout rate 0 and the
fixed Dropout(0.1) before FastRCNN's ``obj_downsample`` off on both sides;
from pixels a ResNet-50 with a dilated conv5. Inputs come from numpy with
a seed; the JAX module is initialised by JAX (in training mode) and its
params reach the port through ``state_dict_from_jax``. Losses and logits
are held to rtol 1e-3 / atol 1e-4, the bar of
tests/test_fullsize_parity.py; gradients leaf by leaf to the same rtol
against the leaf's largest element plus the same atol
(tests/test_torch_train_e2e.py); an AdamW or SGD step's parameters to
atol 1e-5 (1% of the base LR, tests/test_torch_train.py).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlbert_tpu.models.fast_rcnn as j_fast_rcnn
from tests.test_torch_train_e2e import _assert_grads_match
from vlbert_tpu.models.task_modules import build_module as j_build_module
from vlbert_tpu.ops.dropout import Dropout as JDropout
from vlbert_tpu.training import metrics as j_metrics
from vlbert_tpu.training.checkpoint import flatten_params
from vlbert_tpu.training.convert import (align_vlbert_nesting,
                                         fuse_qkv_params,
                                         load_torch_or_native_checkpoint)
from vlbert_tpu.training.loop import create_train_state
from vlbert_tpu.training.loop import make_train_step as j_make_train_step
from vlbert_tpu.utils import losses as j_losses
from vlbert_tpu.utils.config import default_config
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.models.vlbert import TIED_DECODER
from vlbert_tpu_torch.training import checkpoint as t_ckpt
from vlbert_tpu_torch.training import metrics as t_metrics
from vlbert_tpu_torch.training.convert import state_dict_from_jax
from vlbert_tpu_torch.training.loop import make_train_step
from vlbert_tpu_torch.training.optim import Optimizer, apply_trainable_mask
from vlbert_tpu_torch.utils import losses as t_losses

TOL = dict(rtol=1e-3, atol=1e-4)
B, B2, O, T, T2, F, C, V = 2, 3, 5, 10, 12, 16, 11, 120
H, W = 48, 64

# (name, module name, NETWORK overrides, from pixels, PRECOMPUTED_FEAT_DIM)
VARIANTS = {
    # the shipped base_prec config's shape: precomputed features, corpus
    # rows, the relationship task on
    "prec_aux": ("ResNetVLBERTForPretrainingMultitask",
                 {"WITH_REL_LOSS": True}, False, F),
    # the e2e config's: pixels, masked RoIs zeroed on the host
    "pixels_mask_raw": ("ResNetVLBERTForPretrainingMultitask",
                        {"MASK_RAW_PIXELS": True}, True, F),
    # pixels with the learned masked-region feature, before the class
    # embedding (IMAGE_SEMANTIC on, which pretraining gives no classes)
    "pixels_embed": ("ResNetVLBERTForPretrainingMultitask",
                     {"MASK_RAW_PIXELS": False}, True, 2048),
    # base_prec_withouttextonly: no corpus rows
    "prec_no_aux": ("ResNetVLBERTForPretraining", {"WITH_REL_LOSS": True},
                    False, F),
    "prec_batch_first": ("ResNetVLBERTForPretrainingMultitask",
                         {"MLM_LOSS_NORM_IN_BATCH_FIRST": True,
                          "MVRC_LOSS_NORM_IN_BATCH_FIRST": True}, False, F),
}
LOSSES = ("relationship_loss", "mlm_loss_wvc", "mlm_loss_aux", "mvrc_loss")
LOGITS = ("relationship_logits", "mlm_logits_wvc", "mlm_logits_aux",
          "mvrc_logits")


def _cfg(name):
    module, net, e2e, feat_dim = VARIANTS[name]
    cfg = default_config("pretrain")
    cfg.MODULE = module
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64; v.vocab_size = V
    v.max_position_embeddings = 64; v.visual_ln = True
    v.visual_scale_text_init = 1.0; v.visual_scale_object_init = 1.0
    v.hidden_dropout_prob = 0.0; v.attention_probs_dropout_prob = 0.0
    v.with_pooler = True; v.visual_region_classes = C
    n = cfg.NETWORK
    n.IMAGE_FINAL_DIM = 32
    n.IMAGE_FEAT_PRECOMPUTED = not e2e
    n.IMAGE_NUM_LAYERS = 50
    n.IMAGE_STRIDE_IN_1x1 = True
    n.IMAGE_C5_DILATED = True
    n.IMAGE_SEMANTIC = False
    n.ENABLE_CNN_REG_LOSS = False
    n.WITH_MLM_LOSS = n.WITH_MVRC_LOSS = True
    n.WITH_REL_LOSS = False
    for k, val in net.items():
        n[k] = val
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = feat_dim
    cfg._world_size = 1
    return cfg


def _batch(name, seed=0):
    """The loader's 10-tuple (8 without the corpus rows) of a tiny batch:
    the whole-image box first, padded box rows at -2, masked regions with
    soft labels, text and corpus rows with [PAD] tails and MLM labels."""
    _, _, e2e, _ = VARIANTS[name]
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 40, (B, O, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, (B, O, 2))],
                           -1).astype(np.float32)
    boxes[:, 0] = (0, 0, W - 1, H - 1)
    if not e2e:
        boxes = np.concatenate(
            [boxes, rng.normal(size=(B, O, F)).astype(np.float32)], -1)
    boxes[1, 3:] = -2.0
    im_info = np.tile(np.asarray([[W, H, 1.0, 1.0]], np.float32), (B, 1))
    image = None
    if e2e:
        # host-normalized pixels under MASK_RAW_PIXELS, uint8 otherwise
        image = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
        if VARIANTS[name][1]["MASK_RAW_PIXELS"]:
            image = image.astype(np.float32) - 110.0
    text = rng.integers(5, V, (B, T)).astype(np.int32)
    text[0, 7:] = 0
    mlm = np.full((B, T), -1, np.int32)
    mlm[0, 2], mlm[1, 5], mlm[1, 8] = 7, 30, 99
    rel = np.asarray([0, 1], np.int32)
    ops = np.zeros((B, O), np.int32)
    ops[0, 1] = ops[0, 3] = ops[1, 2] = 1
    mvrc = np.zeros((B, O, C), np.float32)
    for b, o in zip(*np.nonzero(ops)):
        p = rng.uniform(size=C).astype(np.float32)
        mvrc[b, o] = p / p.sum()
    batch = (image, boxes, im_info, text, rel, mlm, ops, mvrc)
    if VARIANTS[name][0].endswith("Multitask"):
        aux = rng.integers(5, V, (B2, T2)).astype(np.int32)
        aux[1, 9:] = 0
        aux_mlm = np.full((B2, T2), -1, np.int32)
        aux_mlm[0, 1], aux_mlm[2, 11], aux_mlm[1, 4] = 8, 50, 60
        batch += (aux, aux_mlm)
    return batch


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _flat(tree):
    return {k: np.asarray(a) for k, a in
            flatten_params(jax.device_get(tree)).items()}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    cfg = _cfg(name)
    jm = j_build_module(cfg, "pretrain", dtype=jnp.float32)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)},
                *map(_jnp, _batch(name)), train=True)
    return cfg, jm, v


def _port(cfg, v):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the ignored TPU.* knobs
        tm = build_module(cfg, "pretrain", dtype=torch.float32)
    tm.load_state_dict(state_dict_from_jax(_flat(v["params"]), tm))
    return tm


def _no_obj_dropout(tm, monkeypatch):
    monkeypatch.setattr(j_fast_rcnn, "Dropout",
                        lambda rate: JDropout(rate=0.0))
    tm.image_feature_extractor.obj_downsample[0].rate = 0.0


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("name", list(VARIANTS))
def test_pretrain_module_matches_jax(name, monkeypatch):
    """The four losses, their sum and the four heads' logits (train and
    eval mode), then every gradient leaf against JAX's value_and_grad."""
    cfg, jm, v = _jax_model(name)
    tm = _port(cfg, v)
    apply_trainable_mask(tm, cfg)
    _no_obj_dropout(tm, monkeypatch)
    batch = _batch(name, seed=1)

    def lf(p):
        out, loss = jm.apply({**v, "params": p}, *map(_jnp, batch),
                             train=True,
                             rngs={"dropout": jax.random.PRNGKey(2)})
        return loss, out

    (jloss, jout), jgrads = jax.value_and_grad(lf, has_aux=True)(
        v["params"])
    outputs, loss = tm.train()(*map(_torch, batch))
    assert outputs.keys() == jout.keys()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for k in LOSSES:
        np.testing.assert_allclose(outputs[k].item(), float(jout[k]),
                                   **TOL, err_msg=k)
    assert float(outputs["mlm_loss_wvc"]) > 0
    assert float(outputs["mvrc_loss"]) > 0
    for k in LOGITS:
        if k in jout:
            np.testing.assert_allclose(outputs[k].detach().numpy(),
                                       np.asarray(jout[k]), **TOL,
                                       err_msg=k)
    for k in ("mlm_label_wvc", "mlm_label_aux", "mvrc_label"):
        if k in jout:
            np.testing.assert_array_equal(outputs[k].numpy(),
                                          np.asarray(jout[k]), err_msg=k)
    aux = VARIANTS[name][0].endswith("Multitask")
    assert ("mlm_logits_aux" in outputs) == aux
    assert ("relationship_logits" in outputs) \
        == cfg.NETWORK.WITH_REL_LOSS

    loss.backward()
    size = _assert_grads_match(tm, jgrads, cfg)
    assert sum(s > 0 for s in size.values()) > 0.8 * len(size)

    j_eval = jm.apply(v, *map(_jnp, batch), train=False)
    with torch.no_grad():
        t_eval = tm.eval()(*map(_torch, batch))
    assert t_eval.keys() == j_eval.keys()
    for k in LOGITS:
        if k in j_eval:
            np.testing.assert_allclose(t_eval[k].numpy(),
                                       np.asarray(j_eval[k]), **TOL,
                                       err_msg=k)


def test_masked_regions_take_the_learned_feature():
    """From pixels without MASK_RAW_PIXELS, a masked region's 2048-d
    feature is replaced before obj_downsample: changing the learned
    embedding moves the masked slots' object reps only."""
    from vlbert_tpu_torch.models.layers import init_weights

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the ignored TPU.* knobs
        tm = build_module(_cfg("pixels_embed"), "pretrain",
                          dtype=torch.float32).eval()
    init_weights(tm, torch.Generator().manual_seed(0))
    image, boxes, im_info, _, _, _, ops, _ = _batch("pixels_embed")[:8]
    fe = tm.image_feature_extractor
    args = (_torch(image), _torch(boxes), _torch(boxes[..., 0] > -1.5),
            _torch(im_info))
    emb = torch.linspace(-1, 1, 2048)
    with torch.no_grad():
        a = fe(*args, mvrc_ops=_torch(ops), mask_visual_embed=emb)
        b = fe(*args, mvrc_ops=_torch(ops), mask_visual_embed=emb + 3)
        plain = fe(*args)
    moved = (a["obj_reps"] - b["obj_reps"]).abs().amax(-1) > 0
    assert torch.equal(moved, _torch(ops == 1))
    keep = _torch(ops == 0)
    assert torch.equal(a["obj_reps"][keep], plain["obj_reps"][keep])


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("optimizer", ["AdamW", "SGD"])
def test_pretrain_optimizer_step_matches_jax(optimizer, monkeypatch):
    """One optimizer step on a multitask batch: the loss, the gradient
    norm and then every parameter leaf against JAX's train step."""
    cfg, jm, v = _jax_model("prec_aux")
    cfg = cfg.clone()
    t = cfg.TRAIN
    t.BATCH_IMAGES = [B, B2]
    t.LR = 1e-4
    t.LR_SCHEDULE = "triangle"
    t.WARMUP = False
    t.END_EPOCH = 2
    t.WD = 1e-4
    t.CLIP_GRAD_NORM = 1.0
    t.OPTIMIZER = optimizer
    tm = _port(cfg, v)
    _no_obj_dropout(tm, monkeypatch)
    batch = _batch("prec_aux", seed=3)
    state, tx, _, _ = create_train_state(jm, None, cfg, 4, params=v)
    state, jloss, jdm = jax.jit(j_make_train_step(jm, tx, "pretrain", cfg))(
        state, tuple(map(_jnp, batch)), jax.random.PRNGKey(0))
    opt = Optimizer(cfg, tm, 4)
    loss, dm = make_train_step(tm, opt, "pretrain", cfg)(
        tuple(map(_torch, batch)), 0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(dm["grad_total_norm"][0]),
                               float(jdm["grad_total_norm"][0]), rtol=1e-4)
    assert set(dm) - {"grad_total_norm"} \
        == set(jdm) - {"grad_total_norm"}
    for k in set(dm) - {"grad_total_norm"}:
        np.testing.assert_allclose([float(x) for x in dm[k]],
                                   [float(x) for x in jdm[k]], **TOL,
                                   err_msg=k)
    want = state_dict_from_jax(_flat(state.params["params"]), tm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("fn", ["cross_entropy_ignore_index_batch_first",
                                "soft_cross_entropy_batch_first"])
def test_batch_first_losses_match_jax(fn):
    """The NORM_IN_BATCH_FIRST losses, with an example that has no valid
    entry (the +1e-4 smoothing of both denominators)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 6, 9)).astype(np.float32) * 3
    if fn.startswith("cross"):
        labels = np.where(rng.uniform(size=(3, 6)) < 0.4,
                          rng.integers(0, 9, (3, 6)), -1).astype(np.int32)
        labels[1] = -1
    else:
        labels = rng.uniform(size=(3, 6, 9)).astype(np.float32)
        labels /= labels.sum(-1, keepdims=True)
        labels[:, ::2] = 0.0
        labels[2] = 0.0
    want = float(getattr(j_losses, fn)(jnp.asarray(logits),
                                       jnp.asarray(labels)))
    got = float(getattr(t_losses, fn)(torch.from_numpy(logits),
                                      torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("net", [{}, {"WITH_MLM_LOSS": False},
                                 {"WITH_MLM_LOSS": False,
                                  "WITH_MVRC_LOSS": False}])
def test_pretrain_metrics_match_jax(net):
    """MLMAcc, MLMAccAUX, MVRCAcc and RelAcc of device_metrics as the same
    (sum, count) pairs as JAX's on the same outputs, with a wrap-padded
    sample marked invalid; the host metric falls back as JAX's does."""
    cfg = _cfg("prec_aux")
    for k, val in net.items():
        cfg.NETWORK[k] = val
    rng = np.random.default_rng(5)
    n = 3
    out = {"relationship_logits": rng.normal(size=(n, 2)),
           "relationship_label": np.asarray([0, 1, 1]),
           "valid": np.asarray([True, True, False]),
           "mlm_loss": np.float32(1.5)}
    if cfg.NETWORK.WITH_MLM_LOSS:
        out.update(
            mlm_logits_wvc=rng.normal(size=(n, T, 7)),
            mlm_label_wvc=np.where(rng.uniform(size=(n, T)) < 0.5,
                                   rng.integers(0, 7, (n, T)), -1),
            mlm_logits_aux=rng.normal(size=(B2, T2, 7)),
            mlm_label_aux=np.where(rng.uniform(size=(B2, T2)) < 0.5,
                                   rng.integers(0, 7, (B2, T2)), -1))
    if cfg.NETWORK.WITH_MVRC_LOSS:
        lab = rng.uniform(size=(n, O, C))
        lab /= lab.sum(-1, keepdims=True)
        lab[:, 1] = 0.0
        out.update(mvrc_logits=rng.normal(size=(n, O, C)), mvrc_label=lab)
    out = {k: np.asarray(x, np.float32 if np.asarray(x).dtype.kind == "f"
                         else np.asarray(x).dtype) for k, x in out.items()}
    want = j_metrics.device_metrics("pretrain", cfg, {
        k: jnp.asarray(x) for k, x in out.items()})
    got = t_metrics.device_metrics("pretrain", cfg, {
        k: torch.from_numpy(x) for k, x in out.items()})
    assert set(got) == set(want)
    assert {"RelAcc", "MLMLoss"} <= set(got)
    for k in want:
        assert [float(x) for x in got[k]] \
            == pytest.approx([float(x) for x in want[k]], rel=1e-6), k
    assert t_metrics.host_metric_name("pretrain", cfg) \
        == j_metrics.host_metric_name("pretrain", cfg)


def test_state_dict_round_trip_in_the_reference_layout(tmp_path):
    """The JAX pretraining tree (encoder at ``vlbert.bert.``) carried into
    the port uses every leaf; the port's state dict holds the tied MLM
    decoder as the reference's does, saved once, and loads back from a
    file with it; the JAX package reads the saved file back to its own
    tree leaf for leaf (its default fuses q, k and v)."""
    cfg, _, v = _jax_model("prec_aux")
    flat = _flat(v["params"])
    assert any(k.startswith("vlbert.bert.") for k in flat)
    tm = _port(cfg, v)
    sd = tm.state_dict()
    dec = "vlbert." + TIED_DECODER
    assert torch.equal(sd[dec], sd["vlbert.word_embeddings.weight"])
    assert dec not in dict(tm.named_parameters())
    opt = Optimizer(cfg, tm, 4)
    path = t_ckpt.save_checkpoint(str(tmp_path / "pt"), 0, tm, opt)
    blob = torch.load(path, weights_only=True)["state_dict"]
    assert blob[dec].untyped_storage().data_ptr() \
        == blob["vlbert.word_embeddings.weight"].untyped_storage().data_ptr()
    # a reference .model (``module.`` names, the decoder beside the table)
    ref = {"module." + k: t for k, t in blob.items()}
    fresh = _port(cfg, v)
    for p in fresh.parameters():
        torch.nn.init.zeros_(p)
    loaded, missing, mismatched = t_ckpt.partial_load(fresh, ref)
    assert not missing and not mismatched
    assert len(loaded) == len(fresh.state_dict())
    fresh2 = _port(cfg, v)
    t_ckpt.load_checkpoint(path, fresh2)
    for k, t in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
        assert torch.equal(fresh2.state_dict()[k], t), k
    back = fuse_qkv_params(align_vlbert_nesting(
        load_torch_or_native_checkpoint(path), v["params"]))
    assert back.keys() == flat.keys()
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


@pytest.mark.parametrize("task_module", ["ResNetVLBERTForPretraining",
                                         "ResNetVLBERTForPretrainingMultitask"])
def test_build_module_checks_like_jax(task_module):
    """IMAGE_FINAL_DIM must equal the hidden size with the corpus rows
    (the aux embedding stands in for visual features), in both packages;
    without them it is free."""
    cfg = _cfg("prec_aux")
    cfg.MODULE = task_module
    cfg.NETWORK.IMAGE_FINAL_DIM = cfg.NETWORK.VLBERT.visual_size = 24
    aux = task_module.endswith("Multitask")
    jm = j_build_module(cfg, "pretrain", dtype=jnp.float32)
    batch = _batch("prec_aux")[:10 if aux else 8]
    if aux:
        with pytest.raises(ValueError, match="IMAGE_FINAL_DIM"):
            jm.init(jax.random.PRNGKey(0), *map(_jnp, batch), train=False)
        with pytest.raises(ValueError, match="IMAGE_FINAL_DIM"):
            build_module(cfg, "pretrain", dtype=torch.float32)
    else:
        tm = build_module(cfg, "pretrain", dtype=torch.float32)
        assert not tm.with_aux
        with torch.no_grad():
            out = tm.eval()(*map(_torch, batch))
        assert out["mlm_logits_wvc"].shape == (B, T, V)
