"""Training from pixels on the port: the ResNet's stages 3-4 and the conv5
RoI head take gradients through ROIAlign (K1b on the card), VCR and
RefCOCO+ fine-tuning, against the JAX package on the CPU.

Tiny width, as tests/test_torch_vcr.py: ResNet-50 with a dilated conv5,
2 layers, hidden 32, 2 heads, fp32, visual LN scales 1.0 (at the configs'
0.0 no gradient would reach the image path), every dropout rate 0 and the
fixed Dropout(0.1) before FastRCNN's ``obj_downsample`` off on both sides.
Inputs come from numpy with a seed; the JAX module's params reach the port
through ``state_dict_from_jax``, and so do its gradients (the converter's
transposes and splits are linear). The loss is held to rtol 1e-3 / atol
1e-4, the bar of tests/test_fullsize_parity.py, and every gradient leaf
to the same rtol against that leaf's largest element, plus the same atol:
the random ResNet's activations are large (FastRCNN's CNN loss starts in
the thousands), and the conv weight gradients sum thousands of such
products in fp32 in another order than XLA's (the worst leaf read 8.5e-4
of its largest element, with JAX at "highest" matmul precision too).
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_vcr as tv
import vlbert_tpu.models.fast_rcnn as j_fast_rcnn
from tests.test_torch_infer import _refcoco_driver_cfg
from tests.test_torch_serve import _tiny_cfg as _tiny_refcoco_cfg
from vlbert_tpu.models.task_modules import build_module as j_build_module
from vlbert_tpu.ops.dropout import Dropout as JDropout
from vlbert_tpu.training import metrics as j_metrics
from vlbert_tpu.training.checkpoint import flatten_params
from vlbert_tpu.training.optim import make_optimizer as j_make_optimizer
from vlbert_tpu.training.optim import trainable_mask as j_trainable_mask
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.training import metrics as t_metrics
from vlbert_tpu_torch.training.convert import state_dict_from_jax
from vlbert_tpu_torch.training.loop import make_train_step
from vlbert_tpu_torch.training.optim import Optimizer, apply_trainable_mask
from vlbert_tpu_torch.utils.config import load_config

TOL = dict(rtol=1e-3, atol=1e-4)
VCR_CFG = "cfgs/vcr/base_q2a_4x16G_fp32.yaml"
REFCOCO_CFG = "cfgs/refcoco/base_gt_boxes_4x16G.yaml"


def _flat(tree):
    return {k: np.asarray(a) for k, a in
            flatten_params(jax.device_get(tree)).items()}


def _on_port_names(jax_tree, tm):
    """A JAX params-shaped tree (params or their gradients) on the port's
    parameter names, as numpy."""
    sd = state_dict_from_jax(_flat(jax_tree), tm)
    return {n: np.asarray(sd[n], np.float32) for n, _ in
            tm.named_parameters()}


def _no_obj_dropout(tm, monkeypatch):
    monkeypatch.setattr(j_fast_rcnn, "Dropout",
                        lambda rate: JDropout(rate=0.0))
    tm.image_feature_extractor.obj_downsample[0].rate = 0.0


def _assert_grads_match(tm, jgrads, cfg):
    """Every trainable leaf's gradient equals JAX's (frozen leaves zeroed
    by JAX's trainable mask, as its train step does); the port's frozen
    leaves have no gradient at all. Returns {name: |grad|_max}."""
    mask = j_trainable_mask(jgrads, cfg)
    masked = jax.tree_util.tree_map(
        lambda g, m: g if m else jnp.zeros_like(g), jgrads, mask)
    want = _on_port_names(masked, tm)
    size = {}
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            assert not want[name].any(), f"JAX trains the frozen {name}"
            continue
        got = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        size[name] = float(np.abs(want[name]).max())
        err = float(np.abs(got - want[name]).max())
        assert err <= TOL["rtol"] * size[name] + TOL["atol"], \
            (name, err, size[name])
    return size


# (CNN-reg variant of tests/test_torch_vcr.py, frozen backbone stages):
# the shipped [1, 2]; the RoI head frozen too, which still passes the
# gradient to stages 3-4; everything frozen, where nothing flows into the
# backbone (JAX's stop_gradient, the port's detach)
VCR_CASES = [("cnn_top_e2e", (1, 2)), ("cnn_frcnn_e2e", (1, 2)),
             ("cnn_top_e2e", (1, 2, 5)), ("cnn_top_e2e", (1, 2, 3, 4, 5))]


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("variant,frozen", VCR_CASES)
def test_vcr_train_step_matches_jax(variant, frozen, monkeypatch):
    """A VCR Q2A training step with the CNN regularization loss (on the
    object hidden states, or FastRCNN's on the pooled RoI features): the
    loss and every gradient leaf against JAX's value_and_grad, stages 3-4
    and the RoI head included."""
    cfg, _, v = tv._jax_model(variant)
    cfg = cfg.clone()
    cfg.NETWORK.IMAGE_FROZEN_BACKBONE_STAGES = list(frozen)
    jm = j_build_module(cfg, "vcr", dtype=jnp.float32)
    tm = tv._port(cfg, v)
    apply_trainable_mask(tm, cfg)
    _no_obj_dropout(tm, monkeypatch)
    inputs, label, _ = tv._batch(seed=3)

    def lf(p):
        _, loss = jm.apply({**v, "params": p}, *map(tv._jnp, inputs),
                           jnp.asarray(label), train=True,
                           rngs={"dropout": jax.random.PRNGKey(2)})
        return loss

    jloss, jgrads = jax.value_and_grad(lf)(v["params"])
    outputs, loss = tm.train()(*map(tv._torch, inputs), tv._torch(label))
    assert "cnn_regularization_loss" in outputs
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    size = _assert_grads_match(tm, jgrads, cfg)

    def reached(prefix):
        return max((s for n, s in size.items() if n.startswith(prefix)),
                   default=0.0)

    stage3 = "image_feature_extractor.backbone.layer3."
    head = "image_feature_extractor.roi_head_feature_extractor."
    if 3 in frozen:
        assert reached("image_feature_extractor.backbone.") == 0.0
        assert reached(head) == 0.0
    else:
        assert reached(stage3) > 1e-6      # through the head and ROIAlign
        assert (reached(head) > 1e-6) == (5 not in frozen)
    for n, p in tm.named_parameters():
        if n.startswith(("image_feature_extractor.backbone.layer1.",
                         "image_feature_extractor.backbone.conv1.")):
            assert p.grad is None, n


def _refcoco_batch(seed=0):
    """A tiny RefCOCO+ batch: uint8 images, 5 slots (the whole-image box
    first, image 1 with two padded), labels 1 / 0 on live slots and -1 on
    padded ones, as the collate writes them."""
    rng = np.random.default_rng(seed)
    B, O, T, H, W = 2, 5, 8, 48, 64
    image = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    xy = rng.uniform(0, 40, (B, O, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (B, O, 2))],
                           -1).astype(np.float32)
    boxes[:, 0] = (0, 0, W - 1, H - 1)
    box_mask = np.ones((B, O), bool)
    box_mask[1, 3:] = False
    im_info = np.tile(np.asarray([[W, H, 1.0, 1.0]], np.float32), (B, 1))
    ids = rng.integers(10, 100, (B, T)).astype(np.int32)
    ids[:, 0], ids[:, -1] = 2, 3
    text_mask = np.ones((B, T), bool)
    text_mask[1, 5:] = False
    label = np.where(box_mask, (rng.uniform(size=(B, O)) < 0.4), -1.0) \
        .astype(np.float32)
    label[0, 2] = 1.0
    return (image, boxes, box_mask, im_info, ids, text_mask), label


def _refcoco_cfg():
    cfg = _tiny_refcoco_cfg()
    v = cfg.NETWORK.VLBERT
    v.hidden_dropout_prob = v.attention_probs_dropout_prob = 0.0
    cfg.NETWORK.CLASSIFIER_DROPOUT = 0.0
    return cfg


def _jax_refcoco(cfg):
    jm = j_build_module(cfg, "refcoco", dtype=jnp.float32)
    inputs, _ = _refcoco_batch()
    return jm, jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs),
                       train=False)


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
def test_refcoco_train_step_and_metrics_match_jax(monkeypatch):
    """RefCOCO+ training mode: the masked BCE over the [B, O] logits, every
    gradient leaf, the label with -1 on padded slots; then RefAcc, ClsAcc,
    ClsPosAcc and ClsPosFrac of device_metrics against JAX's on the same
    outputs, a wrap-padded sample marked invalid."""
    cfg = _refcoco_cfg()
    jm, v = _jax_refcoco(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = build_module(cfg, "refcoco", dtype=torch.float32)
    tm.load_state_dict(state_dict_from_jax(_flat(v["params"]), tm))
    apply_trainable_mask(tm, cfg)
    _no_obj_dropout(tm, monkeypatch)
    inputs, label = _refcoco_batch(seed=1)

    def lf(p):
        out, loss = jm.apply({**v, "params": p}, *map(jnp.asarray, inputs),
                             jnp.asarray(label), train=True,
                             rngs={"dropout": jax.random.PRNGKey(2)})
        return loss, out

    (jloss, jout), jgrads = jax.value_and_grad(lf, has_aux=True)(
        v["params"])
    outputs, loss = tm.train()(*map(torch.from_numpy, inputs),
                               torch.from_numpy(label))
    assert set(outputs) == {"label_logits", "label", "cls_loss"}
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(outputs["label_logits"].detach().numpy(),
                               np.asarray(jout["label_logits"]), **TOL)
    np.testing.assert_array_equal(outputs["label"].numpy(),
                                  np.asarray(jout["label"]))
    size = _assert_grads_match(tm, jgrads, cfg)
    assert max(s for n, s in size.items() if ".backbone.layer3." in n) > 1e-6

    # the metrics on the same outputs: JAX's train outputs, with a third
    # (wrap-padded) sample that must not count
    logits = np.concatenate([np.asarray(jout["label_logits"]),
                             np.asarray([[3.0, -1.0, 2.0, 0.5, -2.0]])])
    lab = np.concatenate([np.asarray(jout["label"]),
                          np.asarray([[1.0, 0.0, 1.0, -1.0, -1.0]])])
    out = {"label_logits": logits.astype(np.float32),
           "label": lab.astype(np.float32),
           "valid": np.asarray([True, True, False])}
    want = j_metrics.device_metrics("refcoco", cfg, {
        k: jnp.asarray(x) for k, x in out.items()})
    got = t_metrics.device_metrics("refcoco", cfg, {
        k: torch.from_numpy(x) for k, x in out.items()})
    assert set(got) == set(want) == {"RefAcc", "ClsAcc", "ClsPosAcc",
                                     "ClsPosFrac"}
    for k in want:
        assert [float(x) for x in got[k]] == [float(x) for x in want[k]], k
    assert t_metrics.HOST_METRIC_NAME["refcoco"] \
        == j_metrics.HOST_METRIC_NAME["refcoco"] == "RefAcc"


@pytest.mark.parametrize("live", ["some", "none"])
def test_bce_with_logits_masked_matches_jax(live):
    """RefCOCO+'s loss: BCE averaged over the live slots only (0 when none
    is live), with the padded slots' -10000 logits and -1 labels."""
    from vlbert_tpu.utils.losses import bce_with_logits_masked as j_bce
    from vlbert_tpu_torch.utils.losses import bce_with_logits_masked

    rng = np.random.default_rng(5)
    logits = rng.normal(scale=4.0, size=(3, 7)).astype(np.float32)
    mask = rng.uniform(size=(3, 7)) < 0.6
    if live == "none":
        mask[:] = False
    label = np.where(mask, rng.uniform(size=(3, 7)) < 0.3, -1.0)
    logits = np.where(mask, logits, -10000.0).astype(np.float32)
    want = float(j_bce(jnp.asarray(logits), jnp.asarray(label),
                       jnp.asarray(mask)))
    got = bce_with_logits_masked(torch.from_numpy(logits),
                                 torch.from_numpy(label),
                                 torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)
    assert (want == 0.0) == (live == "none")


def _shipped_train(cfg, path, **overrides):
    """cfg with the TRAIN section of a shipped config, then overrides."""
    cfg.TRAIN = load_config("vcr" if path == VCR_CFG else "refcoco",
                            path).TRAIN
    for k, val in overrides.items():
        cfg.TRAIN[k] = val
    cfg._world_size = 1
    return cfg


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("task", ["vcr", "refcoco"])
def test_optimizer_steps_under_the_shipped_groups_match_jax(task):
    """Three optimizer steps from the same weights and gradients, port vs
    JAX, with the shipped TRAIN sections: VCR's SGD (momentum 0.9, coupled
    WD, clip 10, linear warm-up from factor 0, LR_STEP) and RefCOCO+'s
    AdamW with the triangle schedule (clip 1), over the trainable mask of
    the shipped freezing (frozen BN, stages 1-2). Warm-up and the step are
    shortened so that the three steps cross them, and the LRs raised so
    that a step stands well above the tolerance."""
    if task == "vcr":
        cfg, _, v = tv._jax_model("cnn_top_e2e")
        cfg = _shipped_train(cfg.clone(), VCR_CFG, WARMUP_STEPS=2,
                             LR_STEP=[1.0], LR=1e-2)
        params = v["params"]
        atol = 1e-6
    else:
        cfg = _shipped_train(_refcoco_cfg(), REFCOCO_CFG, WARMUP_STEPS=2,
                             END_EPOCH=2, LR=1e-4)
        params = _jax_refcoco(cfg)[1]["params"]
        atol = 1e-5
    assert cfg.TRAIN.OPTIMIZER == ("SGD" if task == "vcr" else "AdamW")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = build_module(cfg, task, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_jax(_flat(params), tm))
    apply_trainable_mask(tm, cfg)
    steps_per_epoch = 2
    tx, _, _ = j_make_optimizer(cfg, params, steps_per_epoch)
    opt_state = tx.init(params)
    opt = Optimizer(cfg, tm, steps_per_epoch)
    mask = j_trainable_mask(params, cfg)
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    rng = np.random.default_rng(11)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p, m: jnp.asarray(rng.normal(size=p.shape) * m,
                                     jnp.float32), params, mask)
        jnorm = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                            for g in jax.tree_util.tree_leaves(grads)))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        on_port = _on_port_names(grads, tm)
        norm = opt.step([torch.from_numpy(on_port[n]) for n in opt.names])
        # fp32 sums over 23M elements against float64 (as
        # tests/test_torch_train.py holds the norm)
        np.testing.assert_allclose(float(norm), jnorm, rtol=1e-4)
    want = _on_port_names(params, tm)
    moved = 0.0
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=atol, err_msg=n)
        d = (p.detach() - start[n]).abs().max().item()
        if not p.requires_grad:
            assert d == 0.0, n
        moved = max(moved, d)
    assert moved > 20 * atol


def test_vcr_grad_accumulation_equals_the_full_batch():
    """One SGD step over a VCR batch of 4 images (4 choices each, uint8
    images, instance masks, classes, [B, C, T] text) taken as 4
    micro-steps of 1 equals the step over the whole batch: the loss and
    every updated weight. Each image has the same number of live boxes,
    so the per-micro-step means of the CNN regularization loss average to
    the whole batch's."""
    cfg, _, _ = tv._jax_model("cnn_top_e2e")
    rng = np.random.default_rng(21)
    parts = [tv._batch(seed=s) for s in (1, 2)]
    inputs = tuple(None if a is None else np.concatenate([a, b])
                   for a, b in zip(parts[0][0], parts[1][0]))
    box_mask = np.ones_like(inputs[4])
    box_mask[:, 4:] = False
    inputs = inputs[:4] + (box_mask,) + inputs[5:]
    label = rng.integers(0, 4, 4).astype(np.int32)
    batch = tuple(map(tv._torch, inputs + (label,)))
    assert batch[0].shape[0] == 4 and batch[5].dim() == 3
    states = []
    for accum in (1, 4):
        c = _shipped_train(cfg.clone(), VCR_CFG, WARMUP=False,
                           GRAD_ACCUMULATE_STEPS=accum,
                           BATCH_IMAGES=4 // accum)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tm = build_module(c, "vcr", dtype=torch.float32)
        init_weights(tm, torch.Generator().manual_seed(0))
        apply_trainable_mask(tm, c)
        tm.image_feature_extractor.obj_downsample[0].rate = 0.0
        opt = Optimizer(c, tm, 4)
        loss, dm = make_train_step(tm, opt, "vcr", c, accum)(batch, 7)
        states.append((loss.item(), tm.state_dict()))
    (l1, p1), (l4, p4) = states
    np.testing.assert_allclose(l4, l1, rtol=1e-6)
    for k in p1:
        torch.testing.assert_close(p4[k], p1[k], rtol=0, atol=1e-6)


# ------------------------------------------------------------ train_net

def _trained_vs_init(model, cfg, task):
    """max |weight - its initial value| of the stem, of stage 3 and of the
    RoI head, against a fresh model initialised from the same seed."""
    fresh = build_module(cfg, task, dtype=torch.float32)
    init_weights(fresh, torch.Generator().manual_seed(int(cfg.RNG_SEED)))
    ref = dict(fresh.named_parameters())
    out = {}
    for key, prefix in (("stem", "image_feature_extractor.backbone.conv1."),
                        ("stage3", "image_feature_extractor.backbone."
                                   "layer3.0.conv1."),
                        ("head", "image_feature_extractor."
                                 "roi_head_feature_extractor.0.conv1.")):
        out[key] = max((p.detach() - ref[n]).abs().max().item()
                       for n, p in model.named_parameters()
                       if n.startswith(prefix))
    return out


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("task", ["vcr", "refcoco"])
def test_train_net_from_pixels(tmp_path, task):
    """train_net on the CPU from pixels with the shipped TRAIN section
    (VCR: SGD, 2-step accumulation here; RefCOCO+: AdamW, aspect grouping,
    horizontal flips with the left/right token swap): two epochs, finite
    losses, each epoch validated with the task's host metric, its
    checkpoint written, the stem frozen, stage 3 and the RoI head moved;
    a second train_net finds the checkpoint through AUTO_RESUME."""
    from vlbert_tpu_torch.engine.train import train_net

    if task == "vcr":
        cfg, _, _ = tv._driver_cfg(tmp_path, "Q2A")
        cfg = _shipped_train(cfg, VCR_CFG, BATCH_IMAGES=1,
                             GRAD_ACCUMULATE_STEPS=2, WARMUP=False,
                             END_EPOCH=2, LR=1e-3)
        cfg.DATASET.TRAIN_ANNOTATION_FILE = "ann.jsonl"
        metric = "Acc"
    else:
        cfg = _refcoco_driver_cfg(tmp_path)
        cfg = _shipped_train(cfg, REFCOCO_CFG, BATCH_IMAGES=2,
                             WARMUP=False, END_EPOCH=2, LR=1e-3)
        cfg.DATASET.TRAIN_ANNOTATION_FILE = "ann.jsonl"
        metric = "RefAcc"
    cfg.RNG_SEED = 0
    cfg.OUTPUT_PATH = str(tmp_path / "out")
    cfg.NETWORK.PARTIAL_PRETRAIN = ""
    cfg.NETWORK.IMAGE_PRETRAINED = ""
    cfg.NETWORK.VLBERT.visual_scale_text_init = 1.0
    cfg.NETWORK.VLBERT.visual_scale_object_init = 1.0
    cfg.MODEL_PREFIX = "tiny"
    assert cfg.TRAIN.FLIP_PROB == 0.5
    args = types.SimpleNamespace(model_dir=str(tmp_path / "out"),
                                 device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model, history = train_net(args, cfg, task)
    assert len(history["loss"]) >= 2 and np.isfinite(history["loss"]).all()
    assert len(history["val"]) == 2
    assert all(0.0 <= v[metric] <= 1.0 for v in history["val"])
    out = tmp_path / "out" / f"{task}_train"
    assert {"tiny-0000.model", "tiny-0001.model", "tiny-best.model"} \
        <= {p.name for p in out.iterdir()}
    moved = _trained_vs_init(model, cfg, task)
    assert moved["stem"] == 0.0 and moved["stage3"] > 0.0 \
        and moved["head"] > 0.0, moved
    # AUTO_RESUME: the run is complete, so it resumes past its last epoch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, again = train_net(args, cfg, task)
    assert (again["begin_epoch"], again["loss"]) == (2, [])
    assert again["resumed_count"] == len(history["loss"])
