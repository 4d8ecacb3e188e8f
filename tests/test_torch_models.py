"""Port models (vlbert_tpu_torch.models) against the JAX package on the CPU.

Each JAX module is initialised by JAX; its params reach the port through
``state_dict_from_jax``. Inputs are made with numpy from a seed. Both run
in fp32; the bar is the one tests/test_fullsize_parity.py sets (rtol 1e-3,
atol 1e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from vlbert_tpu.models import fast_rcnn as j_fast_rcnn
from vlbert_tpu.models import resnet as j_resnet
from vlbert_tpu.models import vlbert as j_vlbert
from vlbert_tpu.training.checkpoint import flatten_params
from vlbert_tpu_torch.models.fast_rcnn import FastRCNN
from vlbert_tpu_torch.models.resnet import ResNetC4Backbone, ResNetRoIHead
from vlbert_tpu_torch.models.vlbert import VisualLinguisticBert, VLBertConfig
from vlbert_tpu_torch.training.convert import state_dict_from_jax

TOL = dict(rtol=1e-3, atol=1e-4)


def _flat(variables, prefix=""):
    flat = flatten_params(jax.device_get(variables)["params"])
    return {prefix + k: np.asarray(v) for k, v in flat.items()}


def _load(module, flat):
    module.load_state_dict(state_dict_from_jax(flat, module))
    return module.eval()


def test_resnet50_backbone_and_roi_head(rng):
    images = rng.normal(size=(1, 64, 96, 3)).astype(np.float32)
    rois = rng.normal(size=(2, 14, 14, 1024)).astype(np.float32)
    jb = j_resnet.ResNetC4Backbone(num_layers=50, stride_in_1x1=True)
    vb = jb.init(jax.random.PRNGKey(0), jnp.asarray(images))
    want_body4 = np.asarray(jb.apply(vb, jnp.asarray(images)))

    holder = nn.Module()
    holder.backbone = ResNetC4Backbone(50, stride_in_1x1=True)
    for dilated in (True, False):
        jh = j_resnet.ResNetRoIHead(num_layers=50, c5_dilated=dilated,
                                    stride_in_1x1=True, average_pool=False)
        vh = jh.init(jax.random.PRNGKey(1), jnp.asarray(rois))
        want_head = np.asarray(jh.apply(vh, jnp.asarray(rois)))
        holder.roi_head_feature_extractor = ResNetRoIHead(
            50, c5_dilated=dilated, stride_in_1x1=True)
        _load(holder, {**_flat(vb, "backbone."), **_flat(vh, "roi_head.")})
        with torch.no_grad():
            body4 = holder.backbone(torch.from_numpy(images))
            head = holder.roi_head_feature_extractor(torch.from_numpy(rois))
        assert body4.shape == (1, 4, 6, 1024) and body4.is_contiguous()
        np.testing.assert_allclose(body4.numpy(), want_body4, **TOL)
        assert head.shape == ((2, 14, 14, 2048) if dilated
                              else (2, 7, 7, 2048))
        np.testing.assert_allclose(head.numpy(), want_head, **TOL)


@pytest.mark.parametrize("precomputed", [False, True])
def test_fast_rcnn_matches_jax(rng, precomputed):
    B, O, F = 1, 4, 16
    im_info = np.asarray([[90, 60, 1.0, 1.0]], np.float32)
    boxes = np.asarray([[[0, 0, 89, 59], [5, 10, 40, 50], [60, 30, 95, 63],
                         [0, 0, 0, 0]]], np.float32)
    mask = np.asarray([[True, True, True, False]])
    if precomputed:
        images = None
        boxes = np.concatenate(
            [boxes, rng.normal(size=(B, O, F)).astype(np.float32)], -1)
    else:
        images = rng.integers(0, 256, (B, 64, 96, 3)).astype(np.uint8)
    kw = dict(image_feat_precomputed=precomputed, num_layers=50,
              stride_in_1x1=True, c5_dilated=True, final_dim=32)
    jm = j_fast_rcnn.FastRCNN(**kw)
    jargs = (None if images is None else jnp.asarray(images),
             jnp.asarray(boxes), jnp.asarray(mask), jnp.asarray(im_info))
    v = jm.init(jax.random.PRNGKey(0), *jargs)
    want = jm.apply(v, *jargs)

    tm = _load(FastRCNN(**kw, visual_feat_dim=F if precomputed else 2048),
               _flat(v))
    targs = [None if a is None else torch.from_numpy(np.asarray(a))
             for a in (images, boxes, mask, im_info)]
    with torch.no_grad():
        got = tm(*targs)
    for key in ("obj_reps", "obj_reps_raw"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL)
    assert np.all(got["obj_reps"].numpy()[~mask] == 0)


@pytest.mark.parametrize("fused_qkv,visual_ln", [(False, True), (True, True),
                                                 (True, False)])
def test_visual_linguistic_bert_matches_jax(rng, fused_qkv, visual_ln):
    B, T, O, H = 2, 7, 5, 64
    cfg = dict(vocab_size=1050, hidden_size=H,
               visual_size=H if visual_ln else 48, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=32, visual_ln=visual_ln,
               visual_scale_text_init=0.7, visual_scale_object_init=1.3,
               with_pooler=True, word_embedding_frozen=not visual_ln)
    Vs = cfg["visual_size"]
    ids = rng.integers(0, 1050, (B, T)).astype(np.int32)
    types = np.zeros((B, T), np.int32)
    tve = rng.normal(size=(B, T, Vs)).astype(np.float32)
    tmask = np.ones((B, T), bool)
    tmask[1, 4:] = False
    obj = rng.normal(size=(B, O, Vs + H)).astype(np.float32)
    omask = np.ones((B, O), bool)
    omask[0, 3:] = False
    args = (ids, types, tve, tmask, obj, omask)

    jm = j_vlbert.VisualLinguisticBert(
        j_vlbert.VLBertConfig(**cfg, fused_qkv=fused_qkv))
    jargs = tuple(map(jnp.asarray, args))
    v = jm.init(jax.random.PRNGKey(0), *jargs)
    probs_too = not fused_qkv
    want = jm.apply(v, *jargs, output_text_and_object_separately=True,
                    output_attention_probs=probs_too)

    tm = _load(VisualLinguisticBert(VLBertConfig(**cfg, fused_qkv=fused_qkv)),
               _flat(v))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args),
                 output_text_and_object_separately=True,
                 output_attention_probs=probs_too)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if probs_too:
        for g, w in zip(got[3], want[3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("dilated", [True, False])
def test_resnet18_fast_rcnn_matches_jax_in_eval_and_a_gradient_step(
        rng, dilated):
    """ResNet-18 (BasicBlock; C4 256 and the RoI head 512 wide) through
    FastRCNN from pixels with the CNN-reg head: eval outputs, then one
    SGD step on sum(obj_reps^2) + the reg loss, gradient leaf by leaf and
    the updated weights; the converter's rules both ways."""
    from vlbert_tpu.training.convert import convert_state_dict

    B, O = 1, 3
    images = rng.normal(size=(B, 64, 64, 3)).astype(np.float32)
    boxes = np.asarray([[[4, 4, 40, 40], [10, 8, 60, 50], [0, 0, 63, 63]]],
                       np.float32)
    mask = np.ones((B, O), bool)
    im_info = np.asarray([[64, 64, 1, 1]], np.float32)
    classes = np.asarray([[3, 7, 0]], np.int32)
    kw = dict(image_feat_precomputed=False, num_layers=18, c5_dilated=dilated,
              final_dim=16, enable_cnn_reg_loss=True)
    jm = j_fast_rcnn.FastRCNN(**kw, frozen_stages=())
    jargs = tuple(map(jnp.asarray, (images, boxes, mask, im_info, classes)))
    v = jm.init(jax.random.PRNGKey(0), *jargs)
    want = jm.apply(v, *jargs)

    def loss_fn(p):
        o = jm.apply({"params": p}, *jargs)
        return jnp.sum(o["obj_reps"] ** 2) + o["cnn_regularization_loss"]

    jgrads = {k: np.asarray(g) for k, g in flatten_params(
        jax.device_get(jax.grad(loss_fn)(v["params"]))).items()}

    flat = _flat(v)
    tm = _load(FastRCNN(**kw), flat)
    assert tm.backbone.layer3[0].conv1.weight.shape == (256, 128, 3, 3)
    assert tm.roi_head_feature_extractor[2].conv2.weight.shape \
        == (512, 512, 3, 3)
    assert not hasattr(tm.backbone.layer1[0], "conv3")
    # port names -> JAX paths: the JAX tree back, leaf for leaf
    back, skipped = convert_state_dict(tm.state_dict())
    assert not skipped and back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)

    targs = [torch.from_numpy(a) for a in (images, boxes, mask, im_info,
                                           classes)]
    got = tm(*targs)
    for key in ("obj_reps", "obj_reps_raw", "obj_logits",
                "cnn_regularization_loss"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), **TOL, err_msg=key)
    assert got["obj_reps_raw"].shape == (B, O, 512)
    loss = got["obj_reps"].square().sum() + got["cnn_regularization_loss"]
    loss.backward()
    lr = 1e-2
    sd_grads = state_dict_from_jax(jgrads, tm)
    for name, p in tm.named_parameters():
        # each leaf to rtol 1e-3 of its largest element plus atol 1e-4
        # (tests/test_torch_train_e2e.py), the step to lr times that
        g, jg = p.grad.numpy(), sd_grads[name].numpy()
        atol = 1e-3 * np.abs(jg).max() + 1e-4
        np.testing.assert_allclose(g, jg, rtol=0, atol=atol, err_msg=name)
        with torch.no_grad():
            p.sub_(lr * p.grad)
        want_p = state_dict_from_jax(
            {k: flat[k] - lr * jgrads[k] for k in flat}, tm)[name]
        np.testing.assert_allclose(p.detach().numpy(), want_p.numpy(),
                                   rtol=0, atol=lr * atol + 1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("depth", [18, 34])
def test_basic_block_resnet_shapes_match_jax_on_meta(depth):
    """ResNet-18 / 34's backbone and RoI head on the meta device against
    JAX's under jax.eval_shape: every converted name, shape and count."""
    jb = j_resnet.ResNetC4Backbone(num_layers=depth)
    jh = j_resnet.ResNetRoIHead(num_layers=depth, average_pool=False)
    vb = jax.eval_shape(jb.init, jax.random.PRNGKey(0),
                        jnp.zeros((1, 64, 64, 3)))
    vh = jax.eval_shape(jh.init, jax.random.PRNGKey(0),
                        jnp.zeros((2, 14, 14, 256)))
    flat = {}
    for prefix, v in (("backbone.", vb), ("roi_head.", vh)):
        flat.update({prefix + k: np.broadcast_to(np.zeros((), np.float32),
                                                 s.shape)
                     for k, s in flatten_params(v["params"]).items()})
    holder = nn.Module()
    holder.backbone = ResNetC4Backbone(depth, device="meta")
    holder.roi_head_feature_extractor = ResNetRoIHead(depth, device="meta")
    sd = state_dict_from_jax(flat, holder)        # strict: names and shapes
    want = holder.state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].shape == want[k].shape for k in sd)
    assert sum(t.numel() for t in want.values()) \
        == sum(a.size for a in flat.values())
    blocks = {18: (2, 2, 2), 34: (3, 4, 6)}[depth]
    assert tuple(len(getattr(holder.backbone, f"layer{i}"))
                 for i in (1, 2, 3)) == blocks
