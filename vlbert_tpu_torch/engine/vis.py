"""Attention-map dump (port of vlbert_tpu/engine/vis.py and of the entry
pretrain/vis_attention_maps.py).

    python -m vlbert_tpu_torch.engine.vis \\
        --cfg cfgs/pretrain/vis_attention_maps_coco.yaml [--ckpt F] \\
        [--result-path D] [--device cpu]

A forward-only pass over the config's validation split (the first entry
of a list DATASET) that writes, per example, ``{i}_attention_probs.npy``
(every layer's attention probabilities, [layers, heads, L, L] fp32) and a
``{i}_tokens.json`` sidecar naming each position (text tokens, then
``box_i``, then ``[END]``), which ``viz/attention_view.py::load_dump``
reads. The model is the pretraining model in fp32 (the vis yaml's
``ResNetVLBERTForAttentionVis``), with random weights from seed 0 and
``--ckpt`` loaded on reference names (a reference ``.model`` or any file
``engine.test`` reads); ``NETWORK.PARTIAL_PRETRAIN`` is not read, as the
JAX entry does not. It runs on ``cuda`` unless ``--device cpu`` is given,
with no fallback. From pixels, ROIAlign is kernel K1; the encoder takes
its plain attention route, since the kernels never write the probs.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from vlbert_tpu_torch.models.vlbert import VisualLinguisticBert


def attention_probs_fn(encoder):
    """``fn(text_ids, text_types, text_visual, text_mask, obj_vl,
    box_mask)`` -> every layer's attention probs stacked, [B, layers,
    heads, L, L], from ``encoder`` (a ``VisualLinguisticBert``) in a
    deterministic forward without gradients."""

    @torch.no_grad()
    def fn(text_ids, text_types, text_visual, text_mask, obj_vl, box_mask):
        was_training = encoder.training
        encoder.eval()
        try:
            _, _, probs = VisualLinguisticBert.forward(
                encoder, text_ids, text_types, text_visual, text_mask,
                obj_vl, box_mask, output_attention_probs=True)
        finally:
            encoder.train(was_training)
        return torch.stack(probs, dim=1)

    return fn


def _save(output_dir, index, probs, names):
    np.save(os.path.join(output_dir, f"{index}_attention_probs.npy"), probs)
    with open(os.path.join(output_dir, f"{index}_tokens.json"), "w") as f:
        json.dump(names, f)


def dump_attention_maps(encoder, batches, tokenizer, output_dir):
    """Run the vis forward over ``batches`` of (text_ids, text_types,
    text_visual, text_mask, obj_vl, box_mask) tensors and write each
    example's probs and sidecar; masked text and box positions are named
    ``[PAD]``. Returns the number of examples written."""
    os.makedirs(output_dir, exist_ok=True)
    fn = attention_probs_fn(encoder)
    index = 0
    for text_ids, text_types, text_visual, text_mask, obj_vl, box_mask \
            in batches:
        probs = fn(text_ids, text_types, text_visual, text_mask, obj_vl,
                   box_mask).to(torch.float32).cpu().numpy()
        ids = text_ids.cpu().numpy()
        tmask = text_mask.cpu().numpy()
        bmask = box_mask.cpu().numpy()
        for b in range(probs.shape[0]):
            toks = tokenizer.convert_ids_to_tokens([int(t) for t in ids[b]])
            names = ([t if m else "[PAD]" for t, m in zip(toks, tmask[b])]
                     + [f"box_{i}" if m else "[PAD]"
                        for i, m in enumerate(bmask[b])]
                     + ["[END]"])
            _save(output_dir, index, probs[b], names)
            index += 1
    return index


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Dump VL-BERT attention maps (PyTorch + CUDA)")
    parser.add_argument("--cfg", type=str, required=True,
                        help="path to a pretraining yaml")
    parser.add_argument("--ckpt", type=str, default="",
                        help="weights to load; random from seed 0 if none")
    parser.add_argument("--result-path", type=str, default="./results",
                        help="directory the dumps are written to")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda needs a card (no "
                             "fallback)")
    return parser.parse_args(argv)


def main(argv=None):
    """The entry point; returns the number of examples dumped."""
    from vlbert_tpu_torch.data.build import make_dataloader
    from vlbert_tpu_torch.data.tokenization import BertTokenizer
    from vlbert_tpu_torch.engine.test import _load_params
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.loop import to_device
    from vlbert_tpu_torch.utils.config import load_config

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda is not "
                           "available")
    config = load_config("pretrain", args.cfg)
    if isinstance(config.DATASET, list):
        config.DATASET = config.DATASET[0]
    tokenizer = BertTokenizer.from_pretrained(config.NETWORK.BERT_MODEL_NAME)
    model = build_module(config, "pretrain", dtype=torch.float32,
                         device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(0))
    if args.ckpt:
        _load_params(model, args.ckpt)
    model.eval()
    loader = make_dataloader(config, "pretrain", "val", tokenizer,
                             num_replicas=1, rank=0)
    out_dir = args.result_path
    os.makedirs(out_dir, exist_ok=True)
    index = 0
    try:
        with torch.inference_mode():
            for batch in loader:
                image, boxes, im_info, text = to_device(batch[:4], device)
                probs = model.attention_vis(image, boxes, im_info,
                                            text).cpu().numpy()
                text = text.cpu().numpy()
                T, O = text.shape[1], boxes.shape[1]
                for b in range(probs.shape[0]):
                    toks = tokenizer.convert_ids_to_tokens(
                        [int(t) for t in text[b] if t > 0])
                    names = (toks + ["[PAD]"] * (T - len(toks))
                             + [f"box_{i}" for i in range(O)] + ["[END]"])
                    _save(out_dir, index, probs[b], names)
                    index += 1
    finally:
        loader.shutdown()
    print(f"dumped {index} attention maps to {out_dir}")
    return index


if __name__ == "__main__":
    main()
