"""The port's copies of the JAX package's host code (config, tokenizer,
transforms, text assembly, VQA dataset, collate, loader and the
converter's name rules) against their originals, on the same inputs.

The port imports nothing of ``vlbert_tpu``; these tests are where the two
meet. Every comparison is exact: the copies are the originals' code."""

import glob
import os
import warnings

import numpy as np
import pytest
import torch

import vlbert_tpu.data.collate as j_collate
import vlbert_tpu.data.datasets.vqa as j_vqa
import vlbert_tpu.data.loader as j_loader
import vlbert_tpu.data.tokenization as j_tok
import vlbert_tpu.data.transforms as j_transforms
import vlbert_tpu.training.convert as j_convert
import vlbert_tpu.utils.config as j_config
import vlbert_tpu_torch.data.collate as t_collate
import vlbert_tpu_torch.data.datasets.vqa as t_vqa
import vlbert_tpu_torch.data.loader as t_loader
import vlbert_tpu_torch.data.tokenization as t_tok
import vlbert_tpu_torch.data.transforms as t_transforms
import vlbert_tpu_torch.training.convert as t_convert
import vlbert_tpu_torch.utils.config as t_config
from tests.test_entrypoints import VOCAB, _write_vqa_fixture

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


def _tiny_port_module(task):
    from vlbert_tpu_torch.models.task_modules import build_module

    cfg = t_config.default_config(task)
    cfg.MODULE = "ResNetVLBERT"
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64; v.vocab_size = 100
    v.max_position_embeddings = 64; v.visual_ln = True
    cfg.NETWORK.IMAGE_FINAL_DIM = 32
    cfg.NETWORK.IMAGE_NUM_LAYERS = 50
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
]


@pytest.mark.parametrize("task", ["refcoco", "vqa"])
def test_converter_name_rules_match(task):
    names = list(_tiny_port_module(task).state_dict()) + REFERENCE_NAMES
    assert len(names) > 60
    for n in names:
        tn, jn = t_convert.normalize_torch_name(n), \
            j_convert.normalize_torch_name(n)
        assert tn == jn, n
        assert t_convert.map_reference_name(tn) \
            == j_convert.map_reference_name(jn), n
