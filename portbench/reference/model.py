"""Plain float32 VL-BERT for VCR from pixels, as functions of a dict of
weights named as the program names them.

What it computes, in forward order (the dropout sites are drawn in this
order from the step's seed, ``ops.Sites``):

* VCR from pixels: the uint8 image normalised (BGR minus the caffe means,
  zero outside the image); ResNet C4 (stem, stages 1-3, bottlenecks with
  the stride on the first 1x1 conv, frozen BN as a per-channel affine);
  ROIAlign 14x14 at stride 16, one sample a bin; the conv5 head (three
  bottlenecks, stride 1, dilation 2) over the live boxes; the instance
  mask multiply and the mean over the map. The box embedding and the
  features go through dropout (site 0), the 4096 -> 768 projection and a
  ReLU. Each token's visual embedding is its tagged box's.
* VL-BERT: text | objects | END, word + visual LayerNorm (text) or the
  object embedding + visual LayerNorm (objects), position and token-type
  embeddings, LayerNorm, dropout (site 1); per layer the attention with
  prob dropout (a site), the output dense with dropout (a site) and post
  LayerNorm, the GELU FFN with dropout (a site) and post LayerNorm.
* VCR: the pooled [CLS] (tanh) through dropout (a site) and a 768 -> 1
  classifier, sigmoid BCE over the four choices; plus the 81-way
  regularising head on the object outputs (its dropout rate is 0: no
  site), cross-entropy over the live (choice, box) slots.

The visual path of VCR runs an image at a time and twice: once without
gradients to get the pooled features, and again with them after the rest
of the step has given the features' gradient. That keeps the float32
reference inside the card beside the program's own peak.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import ops

PIXEL_MEANS = (102.9801, 115.9465, 122.7717)
RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BN_EPS = 1e-5
LN_EPS = 1e-12
VISUAL = "image_feature_extractor."


# ---------------------------------------------------------------- ResNet

def _bn(w, p, x):
    scale = w[p + ".weight"] / torch.sqrt(w[p + ".running_var"] + BN_EPS)
    shift = w[p + ".bias"] - w[p + ".running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _conv(w, p, x, stride=1, dilation=1):
    k = w[p + ".weight"]
    return ops.conv2d(x, k, stride, dilation * (k.shape[-1] - 1) // 2,
                      dilation)


def _bottleneck(w, p, x, stride, dilation, stride_in_1x1):
    s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
    if p + ".downsample.0.weight" in w:
        identity = _bn(w, p + ".downsample.1",
                       _conv(w, p + ".downsample.0", x, stride))
    else:
        identity = x
    out = torch.relu(_bn(w, p + ".bn1", _conv(w, p + ".conv1", x, s1)))
    out = torch.relu(_bn(w, p + ".bn2",
                         _conv(w, p + ".conv2", out, s3, dilation)))
    out = _bn(w, p + ".bn3", _conv(w, p + ".conv3", out))
    return torch.relu(out + identity)


def _stage(w, p, x, blocks, stride, dilation, stride_in_1x1):
    for i in range(blocks):
        x = _bottleneck(w, f"{p}.{i}", x, stride if i == 0 else 1, dilation,
                        stride_in_1x1)
    return x


def backbone(w, net, x):
    """[n, 3, H, W] normalised -> body4 [n, 1024, H/16, W/16]."""
    p = VISUAL + "backbone"
    blocks = RESNET_BLOCKS[net["IMAGE_NUM_LAYERS"]]
    s1x1 = net["IMAGE_STRIDE_IN_1x1"]
    x = torch.relu(_bn(w, p + ".bn1", _conv(w, p + ".conv1", x, 2)))
    x = F.max_pool2d(x, 3, 2, 1)
    x = _stage(w, p + ".layer1", x, blocks[0], 1, 1, False)
    x = _stage(w, p + ".layer2", x, blocks[1], 2, 1, s1x1)
    return _stage(w, p + ".layer3", x, blocks[2], 2, 1, s1x1)


def roi_head(w, net, x):
    """conv5 over RoI maps: [n, 1024, 14, 14] -> [n, 2048, h, w]."""
    stride, dilation = (1, 2) if net["IMAGE_C5_DILATED"] else (2, 1)
    return _stage(w, VISUAL + "roi_head_feature_extractor", x, 3, stride,
                  dilation, net["IMAGE_STRIDE_IN_1x1"])


def image_features(w, net, image, im_info, boxes, box_mask, segms):
    """One image: its live boxes' pooled conv5 features [O, 2048], zero at
    the padded slots (the program's are zero there too: its padded slots'
    instance masks are zero)."""
    x = ops.normalize_image(image[None], im_info[None], PIXEL_MEANS)
    body4 = backbone(w, net, x.permute(0, 3, 1, 2))[0].permute(1, 2, 0)
    live = box_mask.nonzero()[:, 0]
    rois = ops.roi_align(body4, boxes[live])             # [n, 14, 14, C]
    feat = roi_head(w, net, rois.permute(0, 3, 1, 2))
    pooled = (feat * segms[live][:, None]).mean(dim=(2, 3))
    out = torch.zeros(box_mask.shape[0], pooled.shape[1],
                      dtype=pooled.dtype, device=pooled.device)
    return out.index_copy(0, live, pooled)


# --------------------------------------------------------------- VL-BERT

def _dense(w, p, x):
    return ops.linear(x, w[p + ".weight"], w[p + ".bias"])


def _ln(w, p, x):
    return ops.layer_norm(x, w[p + ".weight"], w[p + ".bias"], LN_EPS)


def object_reps(w, post, boxes, box_mask, im_info, sites):
    """Box embedding and pooled features -> [B, O, 768], zero at padded
    slots."""
    down_in = torch.cat([ops.box_embedding(boxes, im_info), post], -1)
    down_in = ops.hidden_dropout(down_in, 0.1, sites)
    reps = torch.relu(_dense(w, VISUAL + "obj_downsample.1", down_in))
    return reps * box_mask[..., None].to(reps.dtype)


def encoder_layer(w, p, x, bias, vl, sites):
    B, L, Hd = x.shape
    heads = vl["num_attention_heads"]
    a = p + ".attention."
    q, k, v = (_dense(w, a + "self." + n, x).view(B, L, heads, -1)
               for n in ("query", "key", "value"))
    ctx = ops.attention(q, k, v, bias, vl["attention_probs_dropout_prob"],
                        sites).reshape(B, L, Hd)
    rate = vl["hidden_dropout_prob"]
    h = ops.hidden_dropout(_dense(w, a + "output.dense", ctx), rate, sites)
    attn = _ln(w, a + "output.LayerNorm", h + x)
    inter = F.gelu(_dense(w, p + ".intermediate.dense", attn))
    h = ops.hidden_dropout(_dense(w, p + ".output.dense", inter), rate, sites)
    return _ln(w, p + ".output.LayerNorm", h + attn)


def vlbert(w, vl, ids, types, text_visual, text_mask, obj_vl, obj_mask,
           sites):
    """Sequences [N, T] of text and [N, O] of objects -> hidden
    [N, T + O + 1, 768]."""
    N, T = ids.shape
    O = obj_vl.shape[1]
    H = vl["hidden_size"]
    dev = ids.device
    p = "vlbert."
    text = w[p + "word_embeddings.weight"][ids.long()] \
        + _ln(w, p + "visual_ln_text", text_visual)
    objs = obj_vl[..., H:] + _ln(w, p + "visual_ln_object", obj_vl[..., :H])
    end = w[p + "end_embedding.weight"][0].expand(N, 1, H)
    emb = torch.cat([text, objs, end], 1)
    type_ids = torch.cat([types.long(), torch.full((N, O + 1), 2,
                                                   dtype=torch.long,
                                                   device=dev)], 1)
    text_mask = text_mask.bool()
    ppi = vl["position_padding_idx"] + 1
    text_len = text_mask.long().sum(1, keepdim=True)
    pos = torch.cat([(torch.arange(T, device=dev) + ppi).expand(N, T),
                     (text_len + ppi).expand(N, O), text_len + 1 + ppi], 1)
    emb = emb + w[p + "position_embeddings.weight"][pos] \
        + w[p + "token_type_embeddings.weight"][type_ids]
    x = ops.hidden_dropout(_ln(w, p + "embedding_LayerNorm", emb),
                           vl["hidden_dropout_prob"], sites)
    mask = torch.cat([text_mask, obj_mask.bool(),
                      torch.ones(N, 1, dtype=torch.bool, device=dev)], 1)
    bias = (1.0 - mask[:, None, None, :].to(torch.float32)) * -10000.0
    for i in range(vl["num_hidden_layers"]):
        x = encoder_layer(w, f"{p}encoder.layer.{i}", x, bias, vl, sites)
    return x


# ----------------------------------------------------------------- tasks

def vcr_loss(w, cfg, post, batch, sites):
    """VCR Q2A from the pooled features [B, O, 2048]: the answer BCE plus
    the regularising head's cross-entropy."""
    (_, boxes, objects, _, box_mask, ids, types, tags, text_mask, im_info,
     label) = batch
    net, vl = cfg["NETWORK"], cfg["NETWORK"]["VLBERT"]
    B, C, T = ids.shape
    O, H = box_mask.shape[1], vl["hidden_size"]
    reps = object_reps(w, post, boxes, box_mask, im_info, sites)
    tag = tags.long().clamp(0, O - 1).reshape(B, -1)
    text_visual = torch.gather(reps, 1, tag[..., None].expand(-1, -1, H)) \
        .reshape(B * C, T, H)
    ling = w["object_linguistic_embeddings.weight"][
        objects.long().clamp(0, 0)]
    obj_vl = torch.cat([reps, ling], -1)[:, None].expand(B, C, O, 2 * H) \
        .reshape(B * C, O, 2 * H)
    mask_c = box_mask[:, None].expand(B, C, O)
    hidden = vlbert(w, vl, ids.reshape(B * C, T), types.reshape(B * C, T),
                    text_visual, text_mask.reshape(B * C, T), obj_vl,
                    mask_c.reshape(B * C, O), sites)
    pooled = torch.tanh(_dense(w, "vlbert.pooler.dense", hidden[:, 0]))
    pooled = ops.hidden_dropout(pooled, net["CLASSIFIER_DROPOUT"], sites)
    logits = _dense(w, "final_mlp.1", pooled).reshape(B, C)
    positive = torch.arange(C, device=ids.device)[None] \
        == label.long()[:, None]
    pw = net["CLASSIFIER_SIGMOID_LOSS_POSITIVE_WEIGHT"]
    weight = torch.where(positive, torch.full_like(logits, pw),
                         torch.ones_like(logits))
    loss = (pw + 1.0) / (2.0 * pw) * ops.bce_with_logits(
        logits, positive.to(torch.float32), weight) * net["ANS_LOSS_WEIGHT"]
    h_obj = hidden[:, T:T + O] * mask_c.reshape(B * C, O, 1).to(torch.float32)
    t = F.gelu(_dense(w, "cnn_loss_reg.0.dense", h_obj))
    t = ops.hidden_dropout(t, net["CNN_REG_DROPOUT"], sites)
    reg_logits = _dense(w, "cnn_loss_reg.2", t).reshape(B, C, O, -1)
    reg = ops.masked_cross_entropy(reg_logits,
                                   objects[:, None].expand(B, C, O), mask_c)
    return loss + reg * net["CNN_LOSS_WEIGHT"]


def loss_and_backward(w, cfg, task, batch, seed):
    """One step's loss; the gradients land in the trained leaves of
    ``w`` (``.grad``)."""
    if task != "vcr":
        raise ValueError(f"the reference does not compute task {task!r}")
    sites = ops.Sites(seed)
    net = cfg["NETWORK"]
    image, boxes, _, segms, box_mask = batch[:5]
    im_info = batch[9]
    B = image.shape[0]
    with torch.no_grad():
        post = torch.stack([image_features(w, net, image[i], im_info[i],
                                           boxes[i], box_mask[i], segms[i])
                            for i in range(B)])
    post.requires_grad_(True)
    loss = vcr_loss(w, cfg, post, batch, sites)
    loss.backward()
    for i in range(B):
        torch.autograd.backward(
            image_features(w, net, image[i], im_info[i], boxes[i],
                           box_mask[i], segms[i]), post.grad[i])
    return loss.detach()


# ------------------------------------------------------------- the leaves

def _bottleneck_shapes(p, cin, planes, downsample):
    out = {f"{p}.conv1.weight": (planes, cin, 1, 1),
           f"{p}.conv2.weight": (planes, planes, 3, 3),
           f"{p}.conv3.weight": (planes * 4, planes, 1, 1)}
    for i, c in ((1, planes), (2, planes), (3, planes * 4)):
        out.update(_bn_shapes(f"{p}.bn{i}", c))
    if downsample:
        out[f"{p}.downsample.0.weight"] = (planes * 4, cin, 1, 1)
        out.update(_bn_shapes(f"{p}.downsample.1", planes * 4))
    return out


def _bn_shapes(p, c):
    return {f"{p}.{k}": (c,) for k in ("weight", "bias", "running_mean",
                                       "running_var")}


def _stage_shapes(p, cin, planes, blocks, downsample):
    out = {}
    for i in range(blocks):
        out.update(_bottleneck_shapes(f"{p}.{i}", cin if i == 0
                                      else planes * 4, planes,
                                      downsample and i == 0))
    return out


def leaf_shapes(cfg, task):
    """{name: shape} of every weight and frozen-BN statistic of the
    configuration's model, named as the program names them."""
    net, vl = cfg["NETWORK"], cfg["NETWORK"]["VLBERT"]
    H, I = vl["hidden_size"], vl["intermediate_size"]
    if task != "vcr":
        raise ValueError(f"the reference has no leaves for task {task!r}")
    out = {}
    p = VISUAL + "backbone"
    blocks = RESNET_BLOCKS[net["IMAGE_NUM_LAYERS"]]
    out[p + ".conv1.weight"] = (64, 3, 7, 7)
    out.update(_bn_shapes(p + ".bn1", 64))
    out.update(_stage_shapes(p + ".layer1", 64, 64, blocks[0], True))
    out.update(_stage_shapes(p + ".layer2", 256, 128, blocks[1], True))
    out.update(_stage_shapes(p + ".layer3", 512, 256, blocks[2], True))
    out.update(_stage_shapes(VISUAL + "roi_head_feature_extractor", 1024,
                             512, 3, True))
    feat = 2048
    out[VISUAL + "obj_downsample.1.weight"] = (net["IMAGE_FINAL_DIM"],
                                               4 * 2 * 256 + feat)
    out[VISUAL + "obj_downsample.1.bias"] = (net["IMAGE_FINAL_DIM"],)
    out["object_linguistic_embeddings.weight"] = (1, H)

    def dense(p, n_in, n_out):
        out[p + ".weight"] = (n_out, n_in)
        out[p + ".bias"] = (n_out,)

    def ln(p):
        out[p + ".weight"] = out[p + ".bias"] = (H,)

    v = "vlbert."
    out[v + "word_embeddings.weight"] = (vl["vocab_size"], H)
    out[v + "end_embedding.weight"] = (1, H)
    out[v + "position_embeddings.weight"] = (vl["max_position_embeddings"], H)
    out[v + "token_type_embeddings.weight"] = (vl["type_vocab_size"], H)
    for n in ("embedding_LayerNorm", "visual_ln_text", "visual_ln_object"):
        ln(v + n)
    for i in range(vl["num_hidden_layers"]):
        p = f"{v}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            dense(p + "attention.self." + n, H, H)
        dense(p + "attention.output.dense", H, H)
        ln(p + "attention.output.LayerNorm")
        dense(p + "intermediate.dense", H, I)
        dense(p + "output.dense", I, H)
        ln(p + "output.LayerNorm")
    dense("cnn_loss_reg.0.dense", H, H)
    dense("cnn_loss_reg.2", H, 81)
    dense(v + "pooler.dense", H, H)
    dense("final_mlp.1", H, 1)
    return out
