"""FastRCNN visual-feature extractor (port of vlbert_tpu/models/fast_rcnn.py).

Two modes, selected by ``image_feat_precomputed``:
  (a) precomputed: each box row is [x1, y1, x2, y2, feat_0..feat_{F-1}];
      the feature is sliced off.
  (b) end-to-end: ResNet stem + stages 1-3 -> stride-16 body4 map, ROIAlign
      to 14x14 (fp32 sums, stored in the compute dtype), conv5 RoI head in
      the compute dtype, the optional per-box instance-mask multiply (VCR
      ``segms``, in the compute dtype), then the mean over the map in fp32
      -> 2048-d; and, under ``enable_cnn_reg_loss``, the 81-way
      ``regularizing_predictor`` on the pooled features with its masked
      NLL (``cnn_regularization_loss``).
Then for both: the optional 128-d class embedding (``image_semantic``,
``object_embed`` over 81 classes) after the features, 2x4x256 sin/cos
coordinate embeddings before them, and ``obj_downsample`` (Dropout(0.1) +
Linear) + ReLU. Masked box slots are zeroed at the end.

Training from pixels: ROIAlign's map gradient is kernel K1b on CUDA, and
frozen stages are parameters without ``requires_grad``, so no gradient
reaches stages 1-2 or the image. As in the JAX package, a frozen conv5
head (stage 5) still passes the gradient through to stages 3-4; only when
stages 1-5 are all frozen is the pooled feature detached, and nothing
flows into the backbone.

Everything stays in the padded [B, O, ...] layout with a box validity
mask. Pretraining's MVRC masking: given ``mvrc_ops`` and
``mask_visual_embed``, the masked regions' features are replaced by the
embedding before the class embedding is concatenated (with
MASK_RAW_PIXELS the host zeroed their pixels instead, and no embedding
is given).
"""

from __future__ import annotations

import torch
from torch import nn

from vlbert_tpu_torch.models.layers import Embedding, Linear
from vlbert_tpu_torch.models.resnet import (ResNetC4Backbone, ResNetRoIHead,
                                            c4_channels)
from vlbert_tpu_torch.ops.coord_embed import coordinate_embeddings
from vlbert_tpu_torch.ops.dropout import Dropout
from vlbert_tpu_torch.ops.image_norm import normalize_uint8_image
from vlbert_tpu_torch.ops.roi_align import roi_align
from vlbert_tpu_torch.utils import losses

NUM_CLASSES = 81          # COCO's 80 and the background
CLASS_EMBED_DIM = 128


class FastRCNN(nn.Module):
    def __init__(self, image_feat_precomputed=False, num_layers=101,
                 stride_in_1x1=False, c5_dilated=False, final_dim=768,
                 enable_cnn_reg_loss=False, image_semantic=False,
                 roi_sampling_ratio=1,
                 pixel_means=(102.9801, 115.9465, 122.7717),
                 pixel_stds=(1.0, 1.0, 1.0), visual_feat_dim=2048,
                 frozen_stages=(), *, dtype=torch.float32, device=None):
        super().__init__()
        self.image_feat_precomputed = image_feat_precomputed
        # stages 1-5 all frozen: no gradient into the backbone
        self.frozen_backbone = {1, 2, 3, 4, 5} <= set(frozen_stages)
        # the regularizing classifier reads the pooled RoI features, which
        # the precomputed mode does not compute
        self.enable_cnn_reg_loss = enable_cnn_reg_loss \
            and not image_feat_precomputed
        self.image_semantic = image_semantic
        # 1 = one bilinear sample per bin, the reference's effective value
        self.roi_sampling_ratio = roi_sampling_ratio
        self.pixel_means = tuple(pixel_means)
        self.pixel_stds = tuple(pixel_stds)
        self.compute_dtype = dtype
        kw = dict(dtype=dtype, device=device)
        if not image_feat_precomputed:
            # the RoI head's channels: 2048, or 512 for ResNet-18 / 34
            visual_feat_dim = 2 * c4_channels(num_layers)
            self.backbone = ResNetC4Backbone(num_layers, stride_in_1x1, **kw)
            # the head hands back its map: the mask multiply and the fp32
            # mean pool happen here, as in the JAX package
            self.roi_head_feature_extractor = ResNetRoIHead(
                num_layers, c5_dilated, stride_in_1x1, **kw)
        if self.enable_cnn_reg_loss:
            self.regularizing_predictor = Linear(visual_feat_dim,
                                                 NUM_CLASSES, **kw)
        if image_semantic:
            self.object_embed = Embedding(NUM_CLASSES, CLASS_EMBED_DIM, **kw)
            visual_feat_dim += CLASS_EMBED_DIM
        self.obj_downsample = nn.Sequential(
            Dropout(0.1),
            Linear(4 * 2 * 256 + visual_feat_dim, final_dim, **kw))

    def forward(self, images, boxes, box_mask, im_info, classes=None,
                segms=None, mvrc_ops=None, mask_visual_embed=None):
        """
        Args:
          images: [B, H, W, 3] NHWC, uint8 RGB (normalized here) or already
            normalized float; None in precomputed mode
          boxes: [B, O, 4] or [B, O, 4+F] (precomputed)
          box_mask: [B, O] validity
          im_info: [B, >=2] = (w_img, h_img, ...) per image
          classes: [B, O] int class ids (for ``object_embed`` and the
            regularization loss)
          segms: [B, O, mh, mw] instance masks, mh x mw the RoI head's map
            (end-to-end mode; ignored with precomputed features, as in the
            JAX package)
          mvrc_ops: [B, O] int, 1 where a region is masked
          mask_visual_embed: [F] the masked regions' feature, or None
        Returns dict with obj_reps [B, O, final_dim] and obj_reps_raw
        [B, O, F]; under ``enable_cnn_reg_loss`` also obj_logits [B, O, 81]
        fp32, obj_labels and cnn_regularization_loss.
        """
        if classes is None and (self.enable_cnn_reg_loss
                                or self.image_semantic):
            raise ValueError("enable_cnn_reg_loss and image_semantic need "
                             "per-box `classes`")
        B, O = box_mask.shape
        d = self.compute_dtype
        maskf = box_mask.to(torch.float32)[..., None]

        if images is not None and images.dtype == torch.uint8:
            images = normalize_uint8_image(images, im_info, self.pixel_means,
                                           self.pixel_stds)

        if self.image_feat_precomputed:
            post_roialign = boxes[:, :, 4:]
            boxes = boxes[:, :, :4]
        else:
            body4 = self.backbone(images)
            # the JAX package casts ROIAlign's fp32 output to the compute
            # dtype; here the kernel stores it so, in the same pass
            rois = roi_align(body4, boxes, box_mask, pooled_h=14,
                             pooled_w=14, spatial_scale=1.0 / 16,
                             sampling_ratio=self.roi_sampling_ratio,
                             out_dtype=d)
            rois = rois.reshape(B * O, 14, 14, rois.shape[-1])
            feat = self.roi_head_feature_extractor(rois)
            feat = feat.reshape(B, O, *feat.shape[1:])
            if segms is not None:
                # the mask multiply in the compute dtype, before the pool
                feat = feat * segms[..., None].to(feat.dtype)
            # the mean in fp32 over the compute-dtype map, with no fp32
            # copy of the map
            post_roialign = feat.mean(dim=(2, 3), dtype=torch.float32)
            if self.frozen_backbone:
                post_roialign = post_roialign.detach()

        outputs = {}
        if self.enable_cnn_reg_loss:
            obj_labels = classes.long()
            obj_logits = self.regularizing_predictor(
                post_roialign.to(d)).to(torch.float32)
            outputs.update(obj_logits=obj_logits, obj_labels=obj_labels,
                           cnn_regularization_loss=losses.
                           masked_cross_entropy(obj_logits, obj_labels,
                                                box_mask))

        masked = post_roialign
        if mvrc_ops is not None and mask_visual_embed is not None:
            masked = torch.where((mvrc_ops == 1)[..., None],
                                 mask_visual_embed.to(masked.dtype), masked)
        feats = [masked.to(d)]
        if self.image_semantic:
            feats.append(self.object_embed(
                classes.long().clamp(0, NUM_CLASSES - 1)))

        coord_in = torch.cat(
            [boxes[..., :4].to(torch.float32),
             im_info[:, None, :2].to(torch.float32).expand(B, O, 2)], dim=-1)
        coord = coordinate_embeddings(coord_in, 256).reshape(B, O, -1)
        down_in = torch.cat([coord.to(d), *feats], dim=-1)
        obj_reps = torch.relu(self.obj_downsample(down_in))

        outputs["obj_reps_raw"] = post_roialign \
            * maskf.to(post_roialign.dtype)
        outputs["obj_reps"] = obj_reps * maskf.to(obj_reps.dtype)
        return outputs
