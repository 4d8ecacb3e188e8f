"""The port's copies of the pretraining host code (data/masking.py, the
Conceptual Captions, COCO captions and text-corpus datasets, their
collates and the multitask loader of data/build.py) against the JAX
package's, exactly: the same inputs and seeds give the same draws and
the same batches, array for array and bit for bit."""

import json
import os

import jax
import numpy as np
import pytest

import vlbert_tpu.data.build as j_build
import vlbert_tpu.data.datasets.coco_captions as j_coco
import vlbert_tpu.data.datasets.conceptual_captions as j_cc
import vlbert_tpu.data.loader as j_loader
import vlbert_tpu.data.masking as j_masking
import vlbert_tpu.data.tokenization as j_tok
import vlbert_tpu.data.transforms as j_transforms
import vlbert_tpu.utils.config as j_config
import vlbert_tpu_torch.data.build as t_build
import vlbert_tpu_torch.data.datasets.coco_captions as t_coco
import vlbert_tpu_torch.data.datasets.conceptual_captions as t_cc
import vlbert_tpu_torch.data.loader as t_loader
import vlbert_tpu_torch.data.masking as t_masking
import vlbert_tpu_torch.data.tokenization as t_tok
import vlbert_tpu_torch.data.transforms as t_transforms
import vlbert_tpu_torch.utils.config as t_config
from tests.test_torch_host_copies import WORDPIECE_VOCAB, _assert_same
from tests.test_torch_pretrain import C, F
from tests.test_torch_pretrain_train import write_pretrain_fixture

JAX_MODS = (j_cc, j_tok, j_transforms, j_loader)
PORT_MODS = (t_cc, t_tok, t_transforms, t_loader)
WORDS = ["the", "cat", "unaffable", "hello", "world", "dog's", "a", "猫",
         "zzz", "red"]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_masking_gives_the_same_draws(tmp_path, seed):
    """random_word_wwm (whole words, sub-tokens, random replacements from
    the vocabulary), random_mask_region and the joint truncation, sample
    by sample from one seed."""
    (tmp_path / "vocab.txt").write_text("\n".join(WORDPIECE_VOCAB) + "\n")
    draws = []
    for masking, tok in ((j_masking, j_tok), (t_masking, t_tok)):
        tokenizer = tok.BertTokenizer.from_pretrained(str(tmp_path))
        rng = np.random.default_rng(seed)
        src = np.random.default_rng(100 + seed)
        out = []
        for _ in range(40):
            words = list(src.choice(WORDS, size=src.integers(1, 12)))
            toks, labels = masking.random_word_wwm(words, tokenizer, rng)
            scores = src.uniform(size=(int(src.integers(1, 9)), 5))
            ops, mvrc = masking.random_mask_region(scores, rng)
            boxes = src.uniform(size=(len(ops), 4)).astype(np.float32)
            text = list(range(len(toks) + 2))
            cut = masking.truncate_seq_and_boxes(
                text, [-1] + labels + [-1], boxes, ops, mvrc,
                int(src.integers(3, 16)))
            out.append((toks, labels, ops, mvrc, cut))
        draws.append(out)
    _assert_same(draws[1], draws[0])
    assert any(t == "[MASK]" for toks, *_ in draws[0] for t in toks)
    assert any(1 in ops for _, _, ops, _, _ in draws[0])


def _cc_batches(mods, data_dir, root, vocab_dir, precomputed, mask_raw,
                rel=True):
    cc, tok, tf, loader = mods
    cfg = j_config.default_config("pretrain")
    cfg.SCALES = (48, 64)
    tokenizer = tok.BertTokenizer.from_pretrained(vocab_dir)
    ds = cc.ConceptualCaptionsDataset(
        "train_frcnn.json", "train", root, data_dir, tokenizer=tokenizer,
        transform=None if precomputed else tf.build_transforms(
            cfg, "train", rng=np.random.default_rng(3), device_norm=False),
        seq_len=14, with_precomputed_visual_feat=precomputed,
        mask_raw_pixels=mask_raw, with_rel_task=rel,
        add_image_as_a_box=True, seed=5, fallback_fill_rgb=(123, 116, 103))
    items = [ds[i] for i in range(len(ds))]
    collate = cc.make_pretrain_collate(16, 8, C,
                                       precomputed_dim=F if precomputed
                                       else 0)
    dl = loader.DataLoader(ds, 4, collate, shuffle=True, seed=4,
                           num_threads=1, num_workers=0)
    try:
        dl.set_epoch(1)
        batches = list(dl)
    finally:
        dl.shutdown()
    return ds.database, items, collate(items[:4]), batches


@pytest.mark.parametrize("precomputed,mask_raw", [
    (True, True), (False, True), (False, False)],
    ids=["precomputed", "pixels_mask_raw", "pixels"])
def test_cc_dataset_and_collate_give_the_same_batches(tmp_path, precomputed,
                                                      mask_raw):
    """Items, a collated batch and a shuffled epoch of the loader: boxes
    sorted by score with the whole-image box first (its feature the mean,
    re-averaged over the unmasked regions in precomputed mode), clamped,
    -2 padding; caption swaps, whole-word MLM, MVRC ops and labels; the
    masked RoIs' pixels zeroed after normalization; the zero-image
    fallback (one JPEG is missing) filled with the rounded pixel
    means."""
    data_dir, _, vocab_dir = write_pretrain_fixture(tmp_path)
    os.remove(os.path.join(data_dir, "img", "3.jpg"))
    args = (data_dir, str(tmp_path), vocab_dir, precomputed, mask_raw)
    want = _cc_batches(JAX_MODS, *args)
    got = _cc_batches(PORT_MODS, *args)
    _assert_same(got, want)
    _, items, _, batches = got
    assert len(batches) == 4 and len(batches[0]) == 8
    assert any(s["relationship_label"] == 0 for s in items)
    assert any((s["mvrc_ops"] == 1).any() for s in items)
    if not precomputed:
        # the fallback image normalizes to ~0
        assert np.abs(items[3]["image"]).max() < 1.0
        if mask_raw:
            s = next(s for s in items if (s["mvrc_ops"] == 1).any())
            x1, y1, x2, y2 = s["boxes"][np.argmax(s["mvrc_ops"] == 1)]
            assert not s["image"][int(y1):int(y2) + 1,
                                  int(x1):int(x2) + 1].any()


def test_general_corpus_and_collate_give_the_same_batches(tmp_path):
    """Consecutive lines packed to MIN_SEQ_LEN, whole-word masking, cut
    to SEQ_LEN, padded with [PAD] and -1."""
    (tmp_path / "vocab.txt").write_text("\n".join(WORDPIECE_VOCAB) + "\n")
    corpus = tmp_path / "corpus.doc"
    rng = np.random.default_rng(2)
    corpus.write_text("\n".join(" ".join(rng.choice(WORDS, size=n))
                                for n in rng.integers(1, 9, 30)) + "\n\n")
    out = []
    for cc, tok, loader in ((j_cc, j_tok, j_loader), (t_cc, t_tok, t_loader)):
        tokenizer = tok.BertTokenizer.from_pretrained(str(tmp_path))
        ds = cc.GeneralCorpusDataset(str(corpus), tokenizer=tokenizer,
                                     seq_len=12, min_seq_len=9, seed=3)
        items = [ds[i] for i in range(len(ds))]
        dl = loader.DataLoader(ds, 4, cc.make_corpus_collate(14),
                               shuffle=True, seed=4, num_threads=1,
                               num_workers=0, loader_id=1)
        try:
            out.append((items, list(dl)))
        finally:
            dl.shutdown()
    _assert_same(out[1], out[0])
    assert out[0][1][0][0].shape == (4, 14)


def _coco_fixture(tmp_path):
    """COCO captions + instances json over two images (one without
    instances), unsorted category ids."""
    from PIL import Image

    d = tmp_path / "coco"
    os.makedirs(d / "annotations", exist_ok=True)
    os.makedirs(d / "val2017", exist_ok=True)
    rng = np.random.default_rng(1)
    for i in (1, 3):
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)) \
            .save(d / "val2017" / f"{i}.jpg")
    images = [{"id": i, "width": 64, "height": 48, "file_name": f"{i}.jpg"}
              for i in (1, 2, 3)]
    caps = {"images": images, "annotations": [
        {"image_id": 1, "caption": "a cat on the mat"},
        {"image_id": 1, "caption": "second caption"},
        {"image_id": 3, "caption": "the red dog"}]}
    inst = {"categories": [{"id": 12}, {"id": 7}, {"id": 3}],
            "images": images, "annotations": [
                {"image_id": 1, "category_id": 7, "bbox": [10, 10, 30, 20]},
                {"image_id": 1, "category_id": 12, "bbox": [40, 5, 20.4, 30]},
                {"image_id": 3, "category_id": 3, "bbox": [0, 0, 0.5, 47]},
                {"image_id": 3, "category_id": 12, "bbox": [5, 6, 50, 40]}]}
    (d / "annotations" / "captions_val2017.json").write_text(json.dumps(caps))
    (d / "annotations" / "instances_val2017.json").write_text(
        json.dumps(inst))
    return str(d)


def test_coco_captions_dataset_gives_the_same_items(tmp_path):
    """The live COCO index (one item per image with instances, xywh ->
    xyxy with TO_REMOVE = 1, one-hot scores over the sorted category
    remap) through the caption task pipeline, from pixels."""
    data = _coco_fixture(tmp_path)
    (tmp_path / "vocab.txt").write_text("\n".join(WORDPIECE_VOCAB) + "\n")
    cfg = j_config.default_config("pretrain")
    cfg.SCALES = (48, 64)
    out = []
    for coco, tok, tf in ((j_coco, j_tok, j_transforms),
                          (t_coco, t_tok, t_transforms)):
        ds = coco.COCOCaptionsDataset(
            ann_file="", image_set="val", root_path=str(tmp_path),
            data_path=data,
            tokenizer=tok.BertTokenizer.from_pretrained(str(tmp_path)),
            transform=tf.build_transforms(cfg, "train",
                                          rng=np.random.default_rng(3),
                                          device_norm=False),
            add_image_as_a_box=True, seq_len=20, seed=2)
        out.append((ds.database, [ds[i] for i in range(len(ds))]))
    _assert_same(out[1], out[0])
    assert len(out[0][1]) == 2


def _multitask_cfg(mod, data_dir, corpus, vocab_dir, precomputed,
                   batch_images):
    cfg = mod.default_config("pretrain")
    cfg.MODULE = "ResNetVLBERTForPretrainingMultitask"
    cfg.NETWORK.BERT_MODEL_NAME = vocab_dir
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = precomputed
    cfg.NETWORK.WITH_REL_LOSS = False
    cfg.NETWORK.VLBERT.visual_region_classes = C
    cc, corp = cfg.DATASET.clone(), cfg.DATASET.clone()
    cc.DATASET = "conceptual_captions"
    cc.DATASET_PATH = data_dir
    cc.TRAIN_IMAGE_SET = "train"
    cc.ADD_IMAGE_AS_A_BOX = True
    cc.PRECOMPUTED_FEAT_DIM = F
    cc.SEQ_LEN = 14
    corp.DATASET = "general_corpus"
    corp.TRAIN_ANNOTATION_FILE = corpus
    corp.MIN_SEQ_LEN = 6
    cfg.DATASET = [cc, corp]
    cfg.SCALES = (48, 64)
    cfg.TRAIN.BATCH_IMAGES = batch_images
    cfg.TPU.MAX_TEXT_LEN = 16
    cfg.TPU.MAX_BOXES = 8
    cfg.TPU.PROCESS_WORKERS = False
    return cfg


@pytest.mark.parametrize("precomputed", [True, False],
                         ids=["precomputed", "pixels"])
def test_multitask_dataloader_gives_the_same_stream(tmp_path, precomputed):
    """make_multitask_dataloader from a list-valued DATASET: per-entry
    BATCH_IMAGES, the master loader sets the epoch, the corpus loader
    restarts, each sub-loader's own RNG stream (loader_id), and host
    normalization under MASK_RAW_PIXELS: the same 10-tuples over two
    epochs. BATCH_IMAGES is per device in the JAX package (8 virtual CPU
    devices here) and per card in the port."""
    data_dir, corpus, vocab_dir = write_pretrain_fixture(tmp_path, n=32)
    n_dev = jax.local_device_count()
    epochs = []
    for build, cfg_mod, per in ((j_build, j_config, [2, 3]),
                                (t_build, t_config, [2 * n_dev, 3 * n_dev])):
        cfg = _multitask_cfg(cfg_mod, data_dir, corpus, vocab_dir,
                             precomputed, per)
        mt = build.make_multitask_dataloader(cfg, "pretrain", "train")
        try:
            out = []
            for epoch in range(2):
                mt.set_epoch(epoch)
                out.append(list(mt))
        finally:
            for dl in mt.loaders:
                dl.shutdown()
        epochs.append((len(mt), out))
    _assert_same(epochs[1], epochs[0])
    n, out = epochs[0]
    assert n == 32 // (2 * n_dev) and len(out[0][0]) == 10
    assert out[0][0][1].shape[0] == 2 * n_dev
    assert out[0][0][8].shape == (3 * n_dev, 16)
    if not precomputed:
        assert out[0][0][0].dtype == np.float32     # normalized on the host


def test_multitask_loader_shutdown_stops_every_sub_loader():
    """MultiTaskLoader.shutdown() stops the master and every aux loader,
    so its callers never reach into its sub-loaders."""
    stopped = []

    class Sub:
        def __init__(self, name):
            self.name = name

        def shutdown(self):
            stopped.append(self.name)

    t_loader.MultiTaskLoader([Sub("master"), Sub("aux0"),
                              Sub("aux1")]).shutdown()
    assert stopped == ["master", "aux0", "aux1"]
