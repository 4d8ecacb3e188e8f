"""``train_net(..., "pretrain")`` on the CPU (``--device cpu``) over a
tiny Conceptual Captions split and text corpus, at the tiny width of
tests/test_torch_pretrain.py: the multitask loader, the steps, the
metrics and loss loggers, the checkpoints in the reference layout and
AUTO_RESUME; the single-dataset form with validation; the refusal of
``cuda`` without a card."""

import os
import types

import numpy as np
import pytest
import torch

from tests.test_torch_pretrain import C, F
from vlbert_tpu_torch.models.vlbert import TIED_DECODER


def write_pretrain_fixture(tmp_path, n=16):
    """A tiny Conceptual Captions split (jsonl db, frcnn jsons with base64
    boxes, class scores and 16-d features, one JPEG an item) and a text
    corpus, with the vocabulary of tests/test_data_pipeline.py."""
    import base64
    import json

    from PIL import Image

    from tests.test_data_pipeline import VOCAB

    vocab_dir = tmp_path / "bert"
    os.makedirs(vocab_dir, exist_ok=True)
    (vocab_dir / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    data = tmp_path / "cc"
    os.makedirs(data / "frcnn", exist_ok=True)
    os.makedirs(data / "img", exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        w, h = (64, 48) if i % 2 else (56, 48)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(data / "img" / f"{i}.jpg")
        nb = 3 + i % 3
        boxes = rng.uniform(0, 30, (nb, 4)).astype(np.float32)
        boxes[:, 2:] += boxes[:, :2] + 4
        frcnn = {"image_w": w, "image_h": h, "num_boxes": nb}
        scores = rng.uniform(size=(nb, C))      # a detector's softmax rows
        for key, arr in (("boxes", boxes),
                         ("classes", scores / scores.sum(-1, keepdims=True)),
                         ("features", rng.normal(size=(nb, F)))):
            frcnn[key] = base64.encodebytes(
                np.asarray(arr, np.float32).tobytes()).decode()
        (data / "frcnn" / f"{i}.json").write_text(json.dumps(frcnn))
        rows.append({"image": f"img/{i}.jpg", "frcnn": f"frcnn/{i}.json",
                     "caption": ["the cat sat on the mat",
                                 "a dog on the mat"][i % 2]})
    (data / "train_frcnn.json").write_text(
        "\n".join(json.dumps(r) for r in rows))
    corpus = tmp_path / "corpus.doc"
    corpus.write_text("\n".join(["the cat sat on the mat",
                                 "a dog sat"] * 16))
    return str(data), str(corpus), str(vocab_dir)


def _train_cfg(tmp_path, e2e, n=16):
    from tests.test_data_pipeline import VOCAB
    from vlbert_tpu_torch.utils.config import default_config as t_default

    data, corpus, vocab_dir = write_pretrain_fixture(tmp_path, n)
    cfg = t_default("pretrain")
    cfg.MODULE = "ResNetVLBERTForPretrainingMultitask"
    cfg.OUTPUT_PATH = str(tmp_path / "out")
    cfg.MODEL_PREFIX = "tiny"
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64
    v.vocab_size = len(VOCAB); v.max_position_embeddings = 64
    v.visual_ln = True
    v.visual_scale_text_init = 1.0; v.visual_scale_object_init = 1.0
    v.visual_region_classes = C
    n = cfg.NETWORK
    n.IMAGE_FINAL_DIM = 32
    n.IMAGE_FEAT_PRECOMPUTED = not e2e
    n.IMAGE_NUM_LAYERS = 50
    n.IMAGE_C5_DILATED = True
    n.IMAGE_FROZEN_BACKBONE_STAGES = [1, 2]
    n.BERT_MODEL_NAME = vocab_dir
    n.IMAGE_PRETRAINED = ""
    n.WITH_REL_LOSS = False         # as the shipped configs: no pooler
    cc, corp = cfg.DATASET.clone(), cfg.DATASET.clone()
    cc.DATASET = "conceptual_captions"
    cc.DATASET_PATH = data
    cc.ROOT_PATH = str(tmp_path)
    cc.TRAIN_IMAGE_SET = "train"
    cc.ADD_IMAGE_AS_A_BOX = True
    cc.PRECOMPUTED_FEAT_DIM = F
    corp.DATASET = "general_corpus"
    corp.TRAIN_ANNOTATION_FILE = corpus
    corp.MIN_SEQ_LEN = 8
    cfg.DATASET = [cc, corp]
    cfg.SCALES = (48, 64)
    t = cfg.TRAIN
    t.BATCH_IMAGES = [4, 4]
    t.OPTIMIZER = "AdamW"
    t.LR = 1e-4
    t.END_EPOCH = 2
    t.WARMUP = False
    t.AUTO_RESUME = True
    t.LOSS_LOGGERS = [("mlm_loss_wvc", "MLMLossWVC"),
                      ("mlm_loss_aux", "MLMLossAUX"), ("mvrc_loss", "MVRCLoss")]
    cfg.CHECKPOINT_FREQUENT = 1
    cfg.TPU.MAX_TEXT_LEN = 16
    cfg.TPU.MAX_BOXES = 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.PROCESS_WORKERS = False
    return cfg


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("e2e", [False, True], ids=["prec", "pixels"])
def test_train_net_pretrain(tmp_path, e2e):
    """train_net(..., "pretrain") on the CPU over the multitask loader: 2
    steps an epoch (8 captioned images, 4 a step), finite losses, the
    MLM / MVRC metrics and loss loggers in the history, no validation, a
    checkpoint each epoch mirrored to -best.model; a second run
    AUTO_RESUMEs past the last epoch."""
    from vlbert_tpu_torch.engine.train import train_net

    cfg = _train_cfg(tmp_path, e2e, n=8)
    args = types.SimpleNamespace(model_dir="", device="cpu")
    model, hist = train_net(args, cfg, "pretrain")
    assert len(hist["loss"]) == 2 * 2 and hist["val"] == []
    assert all(np.isfinite(hist["loss"]))
    for epoch in hist["train"]:
        assert {"MLMAcc", "MLMAccAUX", "MVRCAcc", "MLMLossWVC",
                "MLMLossAUX", "MVRCLoss"} <= set(epoch)
        assert all(np.isfinite(x) for x in epoch.values()), sorted(epoch.items())
    out = os.path.join(cfg.OUTPUT_PATH, "pretrain_train")
    assert {"tiny-0000.model", "tiny-0001.model", "tiny-best.model"} \
        <= set(os.listdir(out))
    blob = torch.load(os.path.join(out, "tiny-best.model"),
                      weights_only=True)
    assert "vlbert." + TIED_DECODER in blob["state_dict"]
    assert blob["step"] == 4
    _, again = train_net(args, cfg, "pretrain")
    assert (again["begin_epoch"], again["resumed_count"], again["loss"]) \
        == (2, 4, [])


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
def test_train_net_pretrain_without_corpus_validates(tmp_path):
    """A single DATASET (base_prec_withouttextonly's form): the module
    without corpus rows, a validation loader over the captions with
    MLMAcc as the host metric, -best.model from the best epoch."""
    from vlbert_tpu_torch.engine.train import train_net

    cfg = _train_cfg(tmp_path, False, n=8)
    cfg.MODULE = "ResNetVLBERTForPretraining"
    cfg.DATASET = cfg.DATASET[0]
    cfg.DATASET.VAL_IMAGE_SET = "train"
    cfg.TRAIN.BATCH_IMAGES = cfg.VAL.BATCH_IMAGES = 4
    cfg.TRAIN.END_EPOCH = 1
    cfg.TRAIN.LOSS_LOGGERS = [("mlm_loss", "MLMLossWVC")]
    args = types.SimpleNamespace(model_dir="", device="cpu")
    model, hist = train_net(args, cfg, "pretrain")
    assert not model.with_aux and len(hist["loss"]) == 2
    assert len(hist["val"]) == 1
    assert {"MLMAcc", "MVRCAcc"} <= set(hist["val"][0])
    assert "MLMAccAUX" not in hist["train"][0]
    out = os.path.join(cfg.OUTPUT_PATH, "pretrain_train")
    assert "tiny-best.model" in os.listdir(out)


def test_train_net_pretrain_refuses_cuda_without_a_card(tmp_path):
    """``python -m vlbert_tpu_torch.engine.train --task pretrain`` from the
    shipped e2e config runs on the card, with no CPU fallback."""
    import yaml

    from vlbert_tpu_torch.engine.train import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "cfgs", "pretrain",
                           "base_e2e_16x16G_fp16.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["OUTPUT_PATH"] = str(tmp_path / "out")
    path = tmp_path / "e2e.yaml"
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(RuntimeError, match="cuda is not available"):
        main(["--task", "pretrain", "--cfg", str(path)])
