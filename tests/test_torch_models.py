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
