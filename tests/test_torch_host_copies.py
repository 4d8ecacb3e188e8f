"""The port's copies of the JAX package's host code (config, tokenizer,
transforms, text assembly, VQA and RefCOCO+ datasets, collate, loader,
the converter's name rules and its checkpoint loaders and renamers)
against their originals, on the same inputs.

The port imports nothing of ``vlbert_tpu``; these tests are where the two
meet. Every comparison is exact: the copies are the originals' code."""

import glob
import os
import warnings

import numpy as np
import pytest
import torch

import vlbert_tpu.data.collate as j_collate
import vlbert_tpu.data.datasets.refcoco as j_refcoco
import vlbert_tpu.data.datasets.vcr as j_vcr
import vlbert_tpu.data.datasets.vqa as j_vqa
import vlbert_tpu.data.loader as j_loader
import vlbert_tpu.data.tokenization as j_tok
import vlbert_tpu.data.tokenization_roberta as j_rob
import vlbert_tpu.data.transforms as j_transforms
import vlbert_tpu.training.convert as j_convert
import vlbert_tpu.utils.config as j_config
import vlbert_tpu.utils.mask as j_mask
import vlbert_tpu_torch.data.collate as t_collate
import vlbert_tpu_torch.data.datasets.refcoco as t_refcoco
import vlbert_tpu_torch.data.datasets.vcr as t_vcr
import vlbert_tpu_torch.data.datasets.vqa as t_vqa
import vlbert_tpu_torch.data.loader as t_loader
import vlbert_tpu_torch.data.tokenization as t_tok
import vlbert_tpu_torch.data.tokenization_roberta as t_rob
import vlbert_tpu_torch.data.transforms as t_transforms
import vlbert_tpu_torch.training.convert as t_convert
import vlbert_tpu_torch.utils.config as t_config
import vlbert_tpu_torch.utils.mask as t_mask
from tests.test_data_pipeline import _write_refcoco_fixture, _write_vcr_fixture
from tests.test_entrypoints import VOCAB, _write_vqa_fixture
from tests.test_roberta_tokenizer import roberta_files  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, REPO) for p in
               glob.glob(os.path.join(REPO, "cfgs", "**", "*.yaml"),
                         recursive=True))
TASKS = ("vcr", "vqa", "refcoco", "pretrain")


def _plain(x):
    """Nested dicts, lists and tuples of plain values (AttrDict and
    FrozenConfig of either package become dicts)."""
    if hasattr(x, "raw"):
        x = x.raw()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _assert_same(a, b, path="batch"):
    """Exact equality of nested tuples/lists/dicts of arrays and scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_every_shipped_yaml_is_listed():
    assert len(YAMLS) == 24


@pytest.mark.parametrize("yaml_file", YAMLS)
def test_load_config_matches(yaml_file):
    task = yaml_file.split(os.sep)[1]
    path = os.path.join(REPO, yaml_file)
    want = _plain(j_config.load_config(task, path))
    got = _plain(t_config.load_config(task, path))
    assert got == want


@pytest.mark.parametrize("task", TASKS)
def test_default_config_matches(task):
    assert _plain(t_config.default_config(task)) \
        == _plain(j_config.default_config(task))


def test_update_config_is_strict_in_both(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("TRAIN:\n  NOT_A_KEY: 1\n")
    errors = []
    for mod in (j_config, t_config):
        with pytest.raises(Exception) as e:
            mod.load_config("vqa", str(bad))
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]


TEXTS = ["What is the cat doing?", "the RED dog, the blue cat!",
         "unaffable doing's", "Héllo wörld — 猫 dog", "  ", "red[MASK]blue",
         "a " * 40]
WORDPIECE_VOCAB = VOCAB + ["un", "##aff", "##able", "'", "s", ",", "!",
                           "the", "hello", "world", "猫", "a", "—"]


ROBERTA_TEXTS = ["the cat sat on the dog", "the cat.", "dog, cat", "cat",
                 "  the  cat\tsat\n", "snake_case don't abc123 café 中文",
                 ""]


def test_roberta_tokenizer_gives_the_same_ids(roberta_files):
    """The port's copy of tokenization_roberta.py against the original on
    tests/test_roberta_tokenizer.py's tiny local vocab: tokens, ids,
    encode and the special ids."""
    files = roberta_files
    assert t_rob.bytes_to_unicode() == j_rob.bytes_to_unicode()
    jt = j_rob.RobertaTokenizer.from_pretrained(files)
    tt = t_rob.RobertaTokenizer.from_pretrained(files)
    for text in ROBERTA_TEXTS:
        toks = tt.tokenize(text)
        assert toks == jt.tokenize(text), text
        assert tt.convert_tokens_to_ids(toks) \
            == jt.convert_tokens_to_ids(toks), text
        assert tt.encode(text) == jt.encode(text), text
    assert (tt.cls_id, tt.sep_id, tt.mask_id) \
        == (jt.cls_id, jt.sep_id, jt.mask_id)


def test_tokenizer_gives_the_same_ids(tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(WORDPIECE_VOCAB) + "\n")
    jt = j_tok.BertTokenizer.from_pretrained(str(tmp_path))
    tt = t_tok.BertTokenizer.from_pretrained(str(tmp_path))
    assert (tt.cls_id, tt.sep_id, tt.mask_id) \
        == (jt.cls_id, jt.sep_id, jt.mask_id)
    for text in TEXTS:
        toks = tt.tokenize(text)
        assert toks == jt.tokenize(text), text
        assert tt.convert_tokens_to_ids(toks) \
            == jt.convert_tokens_to_ids(toks), text


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("device_norm", [False, True])
def test_transforms_give_the_same_arrays(mode, device_norm):
    cfg = j_config.default_config("refcoco")
    cfg.SCALES = (64, 96)
    cfg.TRAIN.FLIP_PROB = 0.5
    rng = np.random.default_rng(7)
    for h, w in ((48, 70), (90, 40)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        boxes = np.asarray([[2, 3, 30, 40], [0, 0, w - 1, h - 1]], np.float32)
        outs = []
        for mod in (j_transforms, t_transforms):
            tf = mod.build_transforms(cfg, mode,
                                      rng=np.random.default_rng(3),
                                      device_norm=device_norm)
            outs.append([tf({"image": img.copy(), "boxes": boxes.copy(),
                             "im_info": np.asarray([w, h, 1, 1], np.float32),
                             "flipped": False})
                         for _ in range(4)])
        _assert_same(outs[1], outs[0])


def test_text_assembly_and_pad_give_the_same_arrays():
    rng = np.random.default_rng(5)
    for n_q, n_a, max_len in ((3, 2, 16), (20, 9, 16), (0, 0, 4), (7, 30, 24)):
        q = list(rng.integers(10, 99, n_q))
        a = list(rng.integers(10, 99, n_a))
        qt, at = list(rng.integers(0, 3, n_q)), list(rng.integers(0, 3, n_a))
        for kw in ({}, {"answer_first": True}, {"one_sent": True}):
            _assert_same(
                t_collate.assemble_qa_text(q, qt, a, at, max_len, 2, 3, **kw),
                j_collate.assemble_qa_text(q, qt, a, at, max_len, 2, 3, **kw))
        _assert_same(t_collate.assemble_expression_text(q, max_len, 2, 3),
                     j_collate.assemble_expression_text(q, max_len, 2, 3))
    x = rng.normal(size=(3, 5)).astype(np.float32)
    for shape, pad, dtype in (((4, 6), 0, None), ((2, 8), -2, np.float64),
                              ((3, 5), 1, np.int32)):
        _assert_same(t_collate.pad_to(x, shape, pad, dtype),
                     j_collate.pad_to(x, shape, pad, dtype))


def _vqa_batches(mods, data_dir, vocab_dir, mode, n_batches=2):
    vqa, tok, loader = mods
    tokenizer = tok.BertTokenizer.from_pretrained(vocab_dir)
    ds = vqa.VQADataset(
        ann_file=f"{mode}.jsonl", image_set="", root_path=data_dir,
        data_path=data_dir, tokenizer=tokenizer,
        answer_vocab_file=os.path.join(data_dir, "answers.txt"),
        test_mode=False, with_precomputed_visual_feat=True)
    items = [ds[i] for i in range(len(ds))]
    collate = vqa.make_vqa_collate(tokenizer, 16, 8, precomputed_dim=32)
    dl = loader.DataLoader(ds, 2, collate, shuffle=mode == "train", seed=4,
                           num_threads=1, num_workers=0)
    try:
        it = iter(dl)
        batches = [next(it) for _ in range(n_batches)]
    finally:
        dl.shutdown()
    return items, collate(items[:3]), batches


@pytest.mark.parametrize("mode", ["train", "val"])
def test_vqa_dataset_collate_and_loader_give_the_same_batches(tmp_path,
                                                              mode):
    data_dir, vocab_dir = _write_vqa_fixture(tmp_path)
    want = _vqa_batches((j_vqa, j_tok, j_loader), data_dir, vocab_dir, mode)
    got = _vqa_batches((t_vqa, t_tok, t_loader), data_dir, vocab_dir, mode)
    _assert_same(got, want)


def _tiny_port_module(task, cfg=None):
    """The port module of ``task`` at tiny width: from ``cfg`` (default:
    the task's default config) with the encoder cut to 2 layers of 32."""
    from vlbert_tpu_torch.models.task_modules import build_module

    if cfg is None:
        cfg = t_config.default_config(task)
        cfg.MODULE = ("ResNetVLBERTForPretrainingMultitask"
                      if task == "pretrain" else "ResNetVLBERT")
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64; v.vocab_size = 100
    v.max_position_embeddings = 64; v.visual_ln = True
    v.visual_region_classes = 11
    cfg.NETWORK.IMAGE_FINAL_DIM = 32
    cfg.NETWORK.IMAGE_NUM_LAYERS = 50
    if task == "vcr":        # the default: modes 1, the class embedding
        cfg.NETWORK.CNN_LOSS_TOP = True    # and the reg head on top
    if task == "vqa":
        cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = True
        cfg.NETWORK.CLASSIFIER_TYPE = "mlm"
        cfg.DATASET.ANSWER_VOCAB_SIZE = 6
        cfg.DATASET.PRECOMPUTED_FEAT_DIM = 16
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the ignored TPU.* knobs
        return build_module(cfg, task, dtype=torch.float32)


# reference-checkpoint spellings the port's own names never use
REFERENCE_NAMES = [
    "module.vlbert._module.encoder.layer.3.attention.output.LayerNorm.gamma",
    "module.vlbert.embedding_LayerNorm.beta",
    "relationsip_head.caption_image_relationship.weight",
    "bert.encoder.layer.0.output.dense.weight",
    "image_feature_extractor.backbone.layer2.1.downsample.0.weight",
    "image_feature_extractor.backbone.layer2.1.downsample.1.running_var",
    "image_feature_extractor.backbone.layer3.0.bn2.num_batches_tracked",
    "image_feature_extractor.roi_head_feature_extractor.2.conv3.weight",
    "image_feature_extractor.obj_downsample.1.weight",
    "final_mlp.4.bias", "final_mlp.0.LayerNorm.weight",
    "cnn_loss_reg.2.weight", "mvrc_head.region_cls_pred.bias",
    "mlm_head.predictions.transform.LayerNorm.gamma",
    "vlbert.object_mask_word_embedding.weight", "no.such.parameter",
    "module.image_feature_extractor.object_embed.weight",
    "image_feature_extractor.regularizing_predictor.bias",
    "final_mlp_rationale.1.weight", "module.cnn_loss_reg.0.dense.bias",
]


@pytest.mark.parametrize("task", ["refcoco", "vqa", "vcr", "pretrain"])
def test_converter_name_rules_match(task):
    names = list(_tiny_port_module(task).state_dict()) + REFERENCE_NAMES
    assert len(names) > 60
    for n in names:
        tn, jn = t_convert.normalize_torch_name(n), \
            j_convert.normalize_torch_name(n)
        assert tn == jn, n
        assert t_convert.map_reference_name(tn) \
            == j_convert.map_reference_name(jn), n


@pytest.mark.parametrize("depth", [18, 34])
def test_converter_name_rules_match_basic_block_resnets(depth):
    """ResNet-18 / 34's names (BasicBlock: conv1, bn1, conv2, bn2 and the
    downsample pair) map as the JAX converter maps them."""
    from vlbert_tpu_torch.models.fast_rcnn import FastRCNN

    fr = FastRCNN(num_layers=depth, final_dim=32, enable_cnn_reg_loss=True,
                  device="meta")
    names = ["module.image_feature_extractor." + n for n in fr.state_dict()]
    assert any(".downsample.0." in n for n in names)
    for n in names:
        tn = t_convert.normalize_torch_name(n)
        assert tn == j_convert.normalize_torch_name(n), n
        mapped = t_convert.map_reference_name(tn)
        assert mapped is not None and mapped \
            == j_convert.map_reference_name(tn), n


PRETRAIN_YAMLS = [y for y in YAMLS if y.startswith(
    os.path.join("cfgs", "pretrain"))]


@pytest.mark.parametrize("yaml_file", PRETRAIN_YAMLS)
def test_every_pretrain_yaml_builds_its_port_module(yaml_file):
    """Each shipped pretraining config's module builds in the port with no
    refusal, at tiny width on the CPU, with its heads, its masked-region
    embeddings and the corpus rows' embedding where the config asks (the
    attention-vis config's ResNetVLBERTForAttentionVis too, which the JAX
    package's registry lacks)."""
    cfg = t_config.load_config("pretrain", os.path.join(REPO, yaml_file))
    tm = _tiny_port_module("pretrain", cfg)
    names = set(tm.state_dict())
    net = cfg.NETWORK
    assert tm.with_aux == cfg.MODULE.endswith("Multitask")
    assert ("vlbert.mlm_head.predictions.bias" in names) == net.WITH_MLM_LOSS
    assert ("vlbert.mvrc_head.region_cls_pred.weight" in names) \
        == net.WITH_MVRC_LOSS
    assert ("object_mask_visual_embedding.weight" in names) \
        == (net.IMAGE_FEAT_PRECOMPUTED or not net.MASK_RAW_PIXELS)
    assert hasattr(tm.image_feature_extractor, "backbone") \
        != net.IMAGE_FEAT_PRECOMPUTED


# (rows, columns) of the instance-mask grids: VCR's MASK_SIZE 14, the
# fixture tests' 7, non-square ones (where the two axes' scales differ)
# and an image-sized one
MASK_SIZES = [(14, 14), (7, 7), (14, 9), (5, 12), (64, 48)]


def _polygons(rng, n):
    """n polygons of 3-9 vertices around a box, some past its edges."""
    box = np.asarray([10.0, 20.0, 70.0, 65.0])
    polys = []
    for _ in range(n):
        k = int(rng.integers(3, 10))
        xy = rng.uniform([box[0] - 8, box[1] - 8], [box[2] + 8, box[3] + 8],
                         (k, 2))
        polys.append(xy.astype(np.float32))
    return box, polys


@pytest.mark.parametrize("mask_size", MASK_SIZES)
def test_instance_masks_are_the_same(mask_size):
    rng = np.random.default_rng(sum(mask_size))
    box, polys = _polygons(rng, 12)
    for i in range(len(polys)):
        seg = polys[i:i + 1 + i % 3]
        _assert_same(t_mask.generate_instance_mask(seg, box, mask_size),
                     j_mask.generate_instance_mask(seg, box, mask_size))
    r, c = polys[0][:, 1], polys[0][:, 0]
    _assert_same(t_mask.polygon_fill(r, c, mask_size),
                 j_mask.polygon_fill(r, c, mask_size))


def test_the_grid_cache_is_bounded_and_leaves_the_masks_unchanged():
    """The copy keeps GRID_CACHE_SIZE grids however many shapes it sees
    (the original's dict grows with each); a shape evicted and asked for
    again gives the same mask."""
    box, polys = _polygons(np.random.default_rng(1), 1)
    shapes = [(4 + i, 6 + i) for i in range(3 * t_mask.GRID_CACHE_SIZE)]
    for shape in shapes + shapes[:2]:
        _assert_same(t_mask.generate_instance_mask(polys, box, shape),
                     j_mask.generate_instance_mask(polys, box, shape))
    assert t_mask._grid.cache_info().currsize <= t_mask.GRID_CACHE_SIZE


def _vcr_batches(mods, data_dir, root, vocab_dir, task, test_mode,
                 relevant):
    vcr, tok, tf, loader = mods
    cfg = j_config.default_config("vcr")
    cfg.SCALES = (48, 64)
    tokenizer = tok.BertTokenizer.from_pretrained(vocab_dir)
    ds = vcr.VCRDataset(
        "ann.jsonl", "val", root, data_path=data_dir, tokenizer=tokenizer,
        transform=tf.build_transforms(cfg, "test" if test_mode else "train",
                                      rng=np.random.default_rng(3)),
        task=task, test_mode=test_mode, only_use_relevant_dets=relevant,
        mask_size=(14, 14), seq_len=12)
    ds.epoch = 2
    items = [ds[i] for i in range(len(ds))]
    collate = vcr.make_vcr_collate(tokenizer, 16, 6, mask_size=(14, 14),
                                   answer_first=task == "Q2A",
                                   test_mode=test_mode, task=task)
    dl = loader.DataLoader(ds, 2, collate, shuffle=False, seed=4,
                           num_threads=1, num_workers=0)
    try:
        batch = next(iter(dl))
    finally:
        dl.shutdown()
    return ds.database, items, collate(items), batch


@pytest.mark.parametrize("task,test_mode,relevant", [
    ("Q2A", False, True), ("QA2R", False, False), ("Q2AR", False, True),
    ("QA2R", True, True), ("Q2A", True, False)])
def test_vcr_dataset_and_collate_give_the_same_batches(tmp_path, task,
                                                       test_mode, relevant):
    """Every layout of the collate: text [B, C, T] for Q2A and QA2R val,
    [B, A, C, T] for QA2R test (answer-conditioned), answer and rationale
    text for Q2AR; the retokenized tags, truncation, instance masks,
    relevant-detection remap and name rotation on the way."""
    d = _write_vcr_fixture(tmp_path, test_mode=test_mode)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(WORDPIECE_VOCAB + [
        "doing", "wearing", "hat", "ran", "left", "because", "it", "cold",
        "why", "and", "casey", "riley", "jessie"]) + "\n")
    args = (str(d), str(tmp_path), str(tmp_path), task, test_mode, relevant)
    want = _vcr_batches((j_vcr, j_tok, j_transforms, j_loader), *args)
    got = _vcr_batches((t_vcr, t_tok, t_transforms, t_loader), *args)
    _assert_same(got, want)
    if task == "QA2R" and test_mode:
        assert got[3][5].shape == (2, 4, 4, 16)


def _refcoco_batches(mods, data_dir, root, vocab_dir, boxes, test_mode):
    refcoco, tok, tf, loader = mods
    cfg = j_config.default_config("refcoco")
    cfg.SCALES = (48, 64)
    tokenizer = tok.BertTokenizer.from_pretrained(vocab_dir)
    ds = refcoco.RefCOCODataset(
        "ann.jsonl", "train", root, data_path=data_dir, tokenizer=tokenizer,
        transform=tf.build_transforms(cfg, "test" if test_mode else "train",
                                      rng=np.random.default_rng(3)),
        test_mode=test_mode, boxes=boxes)
    items = [ds[i] for i in range(len(ds))] * 3
    collate = refcoco.make_refcoco_collate(tokenizer, 12, 8,
                                           test_mode=test_mode)
    dl = loader.DataLoader(ds, 1, collate, shuffle=False, seed=4,
                           num_threads=1, num_workers=0)
    try:
        batch = next(iter(dl))
    finally:
        dl.shutdown()
    return ds.database, ds.group_ids, items, collate(items), batch


@pytest.mark.parametrize("boxes", ["gt", "proposal", "proposal+gt"])
@pytest.mark.parametrize("test_mode", [False, True])
def test_refcoco_dataset_and_collate_give_the_same_batches(tmp_path, boxes,
                                                           test_mode):
    d = _write_refcoco_fixture(tmp_path)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(WORDPIECE_VOCAB) + "\n")
    args = (str(d), str(tmp_path), str(tmp_path), boxes, test_mode)
    want = _refcoco_batches((j_refcoco, j_tok, j_transforms, j_loader),
                            *args)
    got = _refcoco_batches((t_refcoco, t_tok, t_transforms, t_loader), *args)
    _assert_same(got, want)
    iou = t_refcoco.bbox_iou(np.asarray([[0, 0, 9, 9], [5, 5, 14, 14]],
                                        np.float32), [0, 0, 9, 9])
    _assert_same(iou, j_refcoco.bbox_iou(np.asarray(
        [[0, 0, 9, 9], [5, 5, 14, 14]], np.float32), [0, 0, 9, 9]))


def test_refer_db_is_the_same(tmp_path):
    import json
    import pickle

    refs = [{"split": s, "image_id": 1, "ann_id": a, "sentences":
             [{"tokens": ["the", "red", "dog"]}, {"tokens": ["a", "cat"]}]}
            for s, a in (("train", 10), ("val", 11), ("testA", 10))]
    inst = {"images": [{"id": 1, "file_name": "COCO_1.jpg", "width": 80,
                        "height": 60}],
            "annotations": [{"id": 10, "image_id": 1, "bbox": [1, 2, 30, 20]},
                            {"id": 11, "image_id": 1,
                             "bbox": [10, 5, 40, 50]}]}
    with open(tmp_path / "refs(unc).p", "wb") as f:
        pickle.dump(refs, f)
    (tmp_path / "instances.json").write_text(json.dumps(inst))
    for splits in ({"train"}, {"val", "testA"}):
        args = (str(tmp_path / "refs(unc).p"),
                str(tmp_path / "instances.json"), splits)
        _assert_same(t_refcoco.load_refer_db(*args),
                     j_refcoco.load_refer_db(*args))


def _jax_named(sd):
    """Reference names -> the JAX converter's flax paths, layouts
    transformed, as the JAX package would hold the same tensors."""
    flat, skipped = j_convert.convert_state_dict(sd)
    assert skipped == []
    return flat


def _assert_same_flat(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), w, err_msg=k)


def _fake_bert(type_rows, rng):
    names = ["embeddings.word_embeddings.weight",
             "embeddings.position_embeddings.weight",
             "embeddings.token_type_embeddings.weight",
             "embeddings.LayerNorm.gamma", "embeddings.LayerNorm.beta",
             "encoder.layer.0.attention.self.query.weight",
             "encoder.layer.0.attention.output.LayerNorm.gamma",
             "encoder.layer.1.output.dense.bias", "pooler.dense.weight"]
    sd = {}
    for n in names:
        shape = (type_rows, 4) if "token_type" in n else (5, 4) \
            if n.endswith("weight") else (4,)
        sd["bert." + n] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32))
    sd["cls.predictions.transform.dense.weight"] = torch.ones(4, 4)
    sd["cls.predictions.transform.LayerNorm.gamma"] = torch.ones(4)
    sd["cls.predictions.bias"] = torch.ones(5)
    sd["cls.predictions.decoder.weight"] = torch.ones(5, 4)
    sd["cls.seq_relationship.weight"] = torch.ones(2, 4)
    sd["other.thing"] = torch.ones(1)
    return sd


@pytest.mark.parametrize("type_rows", [1, 2, 3])
def test_bert_renamer_matches(type_rows):
    sd = _fake_bert(type_rows, np.random.default_rng(type_rows))
    want, want_skipped = j_convert.convert_bert_checkpoint(sd)
    got, got_skipped = t_convert.convert_bert_checkpoint(sd)
    assert got_skipped == want_skipped
    _assert_same_flat(_jax_named(got), want)
    _assert_same_flat(_jax_named(t_convert.convert_torch_state_dict(sd)),
                      j_convert.convert_torch_state_dict(sd))
    # the MLM transform onto the VQA 'mlm' classifier, on either side's
    # names (the JAX VQA module names it final_mlp.transform_*)
    want = j_convert.mlm_transform_to_classifier(want)
    got = _jax_named(t_convert.mlm_transform_to_classifier(got))
    got = {k.replace("final_mlp_transform.dense.",
                     "final_mlp.transform_dense."): v for k, v in got.items()}
    _assert_same_flat(got, want)


def test_resnet_renamer_and_prefix_changes_match():
    rng = np.random.default_rng(0)
    sd = {}
    for n in ("conv1.weight", "bn1.weight", "bn1.running_var",
              "bn1.num_batches_tracked", "layer1.0.conv2.weight",
              "layer1.0.downsample.0.weight", "layer1.0.downsample.1.bias",
              "layer3.5.bn3.running_mean", "layer4.0.conv1.weight",
              "layer4.2.bn2.weight", "fc.weight", "fc.bias"):
        shape = (3, 2, 1, 1) if "conv" in n or "downsample.0" in n else (3,)
        sd[n] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    want, want_skipped = j_convert.convert_raw_resnet_checkpoint(sd)
    got, got_skipped = t_convert.convert_raw_resnet_checkpoint(sd)
    assert got_skipped == want_skipped
    _assert_same_flat(_jax_named(got), want)
    raw = {"module.vlbert.mvrc_head.transform.dense.weight": 1,
           "vlbert.mlm_head.predictions.transform.dense.bias": 2,
           "module.vlbert.encoder.layer.0.output.dense.weight": 3,
           "module.final_mlp.2.weight": 4, "x.y": 5}
    for yaml_file in YAMLS:
        task = yaml_file.split(os.sep)[1]
        rules = [tuple(r.split("->")) for r in j_config.load_config(
            task, os.path.join(REPO, yaml_file)).NETWORK.get(
                "PARTIAL_PRETRAIN_PREFIX_CHANGES", [])]
        assert t_convert.apply_reference_prefix_changes(raw, rules) \
            == j_convert.apply_reference_prefix_changes(raw, rules), yaml_file
        # the same rules for a JAX-native file's flax paths
        assert t_convert.translate_prefix_rules_for_native(rules) \
            == j_convert.translate_prefix_rules_for_native(rules), yaml_file


def test_checkpoint_formats_and_blob_loads_match(tmp_path):
    sd = {"module.vlbert.word_embeddings.weight": torch.ones(3, 2)}
    files = {}
    torch.save({"state_dict": sd, "epoch": 1}, tmp_path / "zip.model")
    files["zip.model"] = "torch"
    torch.save(sd, tmp_path / "legacy.bin", _use_new_zipfile_serialization=False)
    files["legacy.bin"] = "torch"
    np.savez(tmp_path / "conv.npz", **{"vlbert.a.kernel": np.ones(2)})
    files["conv.npz"] = "npz"
    (tmp_path / "native.model").write_bytes(b"\x82\xa6params\x80")
    files["native.model"] = "native"
    files["missing.model"] = "native"
    for name, fmt in files.items():
        path = str(tmp_path / name)
        assert t_convert.checkpoint_format(path) \
            == j_convert.checkpoint_format(path) == fmt, name
    for name in ("zip.model", "legacy.bin"):
        path = str(tmp_path / name)
        got, want = t_convert.load_torch_blob(path), \
            j_convert.load_torch_blob(path)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    _assert_same(t_convert.load_npz_checkpoint(str(tmp_path / "conv.npz")),
                 j_convert.load_npz_checkpoint(str(tmp_path / "conv.npz")))
    # a native file flax wrote: the port reads it onto its module's names
    # (raw False), as the JAX package's reader does onto its paths
    from flax import serialization as fs

    from tests.test_torch_train import _jax_vqa, _port_model

    cfg, _, v = _jax_vqa("2fc")
    path = str(tmp_path / "real_native.model")
    with open(path, "wb") as f:
        f.write(fs.msgpack_serialize({"params": v, "opt_state": {},
                                      "step": 3, "extra": {}}))
    assert t_convert.checkpoint_format(path) \
        == j_convert.checkpoint_format(path) == "native"
    tm = _port_model(cfg)
    sd, raw = t_convert.load_state_dict_file(path, tm)
    assert raw is False
    want = t_convert.state_dict_from_jax(
        {k: np.asarray(a) for k, a in
         j_convert.load_torch_or_native_checkpoint(path).items()}, tm)
    assert sd.keys() == want.keys() == tm.state_dict().keys()
    assert all(torch.equal(sd[k], want[k]) for k in want)


def test_stack_batch_pads_a_batch_of_mixed_canvases():
    """The one repair in the collate copy: a batch of a landscape and a
    portrait image (FixPadding's transposed canvases) is padded with
    zeros to the common largest canvas, each image at its top left; the
    original cannot stack it. A batch the original stacks is stacked the
    same."""
    rng = np.random.default_rng(0)
    land = rng.integers(1, 256, (4, 6, 3)).astype(np.uint8)
    port = rng.integers(1, 256, (6, 4, 3)).astype(np.uint8)
    same = [{"image": land, "boxes": np.ones((2, 4), np.float32),
             "label": None}, {"image": land[::-1].copy(),
                              "boxes": np.zeros((2, 4), np.float32),
                              "label": None}]
    _assert_same(t_collate.stack_batch(same), j_collate.stack_batch(same))
    mixed = [dict(same[0]), dict(same[1], image=port)]
    with pytest.raises(ValueError, match="same shape"):
        j_collate.stack_batch(mixed)
    got = t_collate.stack_batch(mixed)
    assert got["image"].shape == (2, 6, 6, 3) and got["label"] is None
    assert got["image"].dtype == np.uint8
    np.testing.assert_array_equal(got["image"][0, :4, :6], land)
    np.testing.assert_array_equal(got["image"][1, :6, :4], port)
    assert not got["image"][0, 4:].any() and not got["image"][1, :, 4:].any()
    np.testing.assert_array_equal(got["boxes"],
                                  np.stack([s["boxes"] for s in mixed]))
