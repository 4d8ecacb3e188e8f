"""FastRCNN visual-feature extractor (port of vlbert_tpu/models/fast_rcnn.py).

Two modes, selected by ``image_feat_precomputed``:
  (a) precomputed: each box row is [x1, y1, x2, y2, feat_0..feat_{F-1}];
      the feature is sliced off.
  (b) end-to-end: ResNet stem + stages 1-3 -> stride-16 body4 map, ROIAlign
      to 14x14 (fp32, cast to the compute dtype), conv5 RoI head, mean pool
      in fp32 -> 2048-d.
Then for both: 2x4x256 sin/cos coordinate embeddings, concatenated before
the features, and ``obj_downsample`` (Dropout(0.1) + Linear) + ReLU. Masked
box slots are zeroed at the end.

Everything stays in the padded [B, O, ...] layout with a box validity
mask. Not ported yet (ROADMAP.md queue 1): VCR instance masks (``segms``),
MVRC feature masking (``mvrc_ops``), the 81-way class embedding
(``image_semantic``) and the CNN regularization loss.
"""

from __future__ import annotations

import torch
from torch import nn

from vlbert_tpu_torch.models.layers import Linear
from vlbert_tpu_torch.models.resnet import ResNetC4Backbone, ResNetRoIHead
from vlbert_tpu_torch.ops.coord_embed import coordinate_embeddings
from vlbert_tpu_torch.ops.image_norm import normalize_uint8_image
from vlbert_tpu_torch.ops.roi_align import roi_align

_NOT_PORTED = ("is not ported yet; see ROADMAP.md queue 1 (VCR, "
               "pretraining)")


class FastRCNN(nn.Module):
    def __init__(self, image_feat_precomputed=False, num_layers=101,
                 stride_in_1x1=False, c5_dilated=False, final_dim=768,
                 enable_cnn_reg_loss=False, image_semantic=False,
                 roi_sampling_ratio=1,
                 pixel_means=(102.9801, 115.9465, 122.7717),
                 pixel_stds=(1.0, 1.0, 1.0), visual_feat_dim=2048, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        if enable_cnn_reg_loss:
            raise NotImplementedError(f"the CNN regularization loss "
                                      f"{_NOT_PORTED}")
        if image_semantic:
            raise NotImplementedError(f"IMAGE_SEMANTIC {_NOT_PORTED}")
        self.image_feat_precomputed = image_feat_precomputed
        # 1 = one bilinear sample per bin, the reference's effective value
        self.roi_sampling_ratio = roi_sampling_ratio
        self.pixel_means = tuple(pixel_means)
        self.pixel_stds = tuple(pixel_stds)
        self.compute_dtype = dtype
        kw = dict(dtype=dtype, device=device)
        if not image_feat_precomputed:
            visual_feat_dim = 2048
            self.backbone = ResNetC4Backbone(num_layers, stride_in_1x1, **kw)
            self.roi_head_feature_extractor = ResNetRoIHead(
                num_layers, c5_dilated, stride_in_1x1, average_pool=True,
                **kw)
        self.obj_downsample = nn.Sequential(
            nn.Dropout(0.1),
            Linear(4 * 2 * 256 + visual_feat_dim, final_dim, **kw))

    def forward(self, images, boxes, box_mask, im_info, segms=None,
                mvrc_ops=None):
        """
        Args:
          images: [B, H, W, 3] NHWC, uint8 RGB (normalized here) or already
            normalized float; None in precomputed mode
          boxes: [B, O, 4] or [B, O, 4+F] (precomputed)
          box_mask: [B, O] validity
          im_info: [B, >=2] = (w_img, h_img, ...) per image
        Returns dict with obj_reps [B, O, final_dim] and obj_reps_raw
        [B, O, F].
        """
        if segms is not None or mvrc_ops is not None:
            raise NotImplementedError(f"segms / mvrc_ops {_NOT_PORTED}")
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
            rois = roi_align(body4, boxes, box_mask, pooled_h=14,
                             pooled_w=14, spatial_scale=1.0 / 16,
                             sampling_ratio=self.roi_sampling_ratio)
            rois = rois.to(d).reshape(B * O, 14, 14, rois.shape[-1])
            post_roialign = self.roi_head_feature_extractor(rois) \
                .reshape(B, O, -1)                  # fp32 mean pool

        coord_in = torch.cat(
            [boxes[..., :4].to(torch.float32),
             im_info[:, None, :2].to(torch.float32).expand(B, O, 2)], dim=-1)
        coord = coordinate_embeddings(coord_in, 256).reshape(B, O, -1)
        down_in = torch.cat([coord.to(d), post_roialign.to(d)], dim=-1)
        obj_reps = torch.relu(self.obj_downsample(down_in))

        return {
            "obj_reps_raw": post_roialign * maskf.to(post_roialign.dtype),
            "obj_reps": obj_reps * maskf.to(obj_reps.dtype),
        }
