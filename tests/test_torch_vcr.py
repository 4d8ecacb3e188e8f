"""The port's VCR inference path (vlbert_tpu_torch: FastRCNN with instance
masks, ResNetVLBERTForVCR / ResNetVLBERTForVCRQ2AR, the VCR metrics,
test_net_vcr, merge_vcr_results, the paired vcr_val, the training refusal)
against the JAX package on the CPU, at tiny width (2 layers, hidden 32,
2 heads, ResNet-50 with a dilated conv5) in fp32.

Each JAX module is initialised by JAX (in training mode, so that every
head has its parameters) and its params reach the port through
``state_dict_from_jax``; inputs come from numpy with a seed. Eval logits
are held to the bar of tests/test_fullsize_parity.py (rtol 1e-3 / atol
1e-4). The training-mode losses are compared with every dropout rate at
0: the config's rates, and the fixed Dropout(0.1) before FastRCNN's
``obj_downsample`` on both sides.
"""

import csv
import functools
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import vlbert_tpu.engine.test as j_test
import vlbert_tpu.models.fast_rcnn as j_fast_rcnn
import vlbert_tpu_torch.engine.test as t_test
from tests.test_data_pipeline import _write_vcr_fixture
from tests.test_torch_checkpoint import _reference_layout
from vlbert_tpu.models.task_modules import build_module as j_build_module
from vlbert_tpu.ops.dropout import Dropout as JDropout
from vlbert_tpu.training import metrics as j_metrics
from vlbert_tpu.training.checkpoint import flatten_params
from vlbert_tpu.utils.config import default_config
from vlbert_tpu_torch.engine import vcr_val
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.training import metrics as t_metrics
from vlbert_tpu_torch.training.convert import state_dict_from_jax

TOL = dict(rtol=1e-3, atol=1e-4)
B, C, T, O, F = 2, 4, 10, 5, 16
# the vocabulary of the driver tests: the fixture's words (test_data_pipeline)
VCR_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "is",
             "doing", "?", "wearing", "a", "hat", "ran", "left", "the", "dog",
             "red", "because", "it", "cold", "why", "and", "casey", "riley"]

# (name, NETWORK overrides, end-to-end visual path): the object word
# embedding modes, the ablations, the class embedding and both places of
# the CNN regularization head. The end-to-end cases run the instance-mask
# multiply; the others read precomputed features, which VCR's text paths
# do not tell apart.
VARIANTS = [
    ("mode2_e2e", {}, True),
    ("mode1", {"VLBERT.object_word_embed_mode": 1}, False),
    ("mode3", {"VLBERT.object_word_embed_mode": 3}, False),
    ("blind", {"BLIND": True}, False),
    ("no_grounding", {"NO_GROUNDING": True, "NO_OBJ_ATTENTION": True}, False),
    ("semantic_e2e", {"IMAGE_SEMANTIC": True}, True),
    ("cnn_top_e2e", {"ENABLE_CNN_REG_LOSS": True, "CNN_LOSS_TOP": True},
     True),
    ("cnn_frcnn_e2e", {"ENABLE_CNN_REG_LOSS": True, "CNN_LOSS_TOP": False,
                       "CLASSIFIER_SIGMOID": False}, True),
]


def _set(node, key, value):
    *path, leaf = key.split(".")
    for k in path:
        node = node[k]
    node[leaf] = value


def _cfg(task="Q2A", e2e=True, **net):
    cfg = default_config("vcr")
    cfg.MODULE = "ResNetVLBERT"
    cfg.DATASET.TASK = task
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64; v.vocab_size = 120
    v.max_position_embeddings = 64; v.visual_ln = True
    v.visual_scale_text_init = 1.0; v.visual_scale_object_init = 1.0
    v.hidden_dropout_prob = 0.0; v.attention_probs_dropout_prob = 0.0
    v.object_word_embed_mode = 2
    n = cfg.NETWORK
    n.IMAGE_FINAL_DIM = 32
    n.IMAGE_FEAT_PRECOMPUTED = not e2e
    n.IMAGE_NUM_LAYERS = 50
    n.IMAGE_STRIDE_IN_1x1 = True
    n.IMAGE_C5_DILATED = True          # the head's map is 14x14, as MASK_SIZE
    n.IMAGE_SEMANTIC = False
    n.ENABLE_CNN_REG_LOSS = False
    n.CLASSIFIER_TYPE = "2fc"
    n.CLASSIFIER_HIDDEN_SIZE = 24
    n.CLASSIFIER_DROPOUT = 0.0
    n.CLASSIFIER_SIGMOID = True
    n.CLASSIFIER_SIGMOID_LOSS_POSITIVE_WEIGHT = 3.0
    n.CNN_LOSS_WEIGHT = 0.5
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = F
    for k, val in net.items():
        _set(n, k, val)
    return cfg


def _text(rng):
    """[B, C, T] ids with [CLS] (101) and [SEP] (102) as mode 3 reads them,
    token types, tags from -2 (padding) over every slot and past the last,
    and a ragged mask (one choice with no word between its specials)."""
    ids = rng.integers(103, 120, (B, C, T)).astype(np.int32)
    ids[..., 0] = 101
    ids[..., 4] = 102
    ids[..., -1] = 102
    types = np.zeros((B, C, T), np.int32)
    types[..., 5:] = 1
    tags = rng.integers(-2, O + 2, (B, C, T)).astype(np.int32)
    mask = np.ones((B, C, T), bool)
    mask[0, 1, 7:] = False
    mask[1, 2, 2:] = False
    ids[1, 2, 1] = 102
    return ids, types, tags, mask


def _batch(seed=0, e2e=True, q2ar=False):
    """(model inputs, answer label, rationale label) of a tiny VCR batch."""
    rng = np.random.default_rng(seed)
    H, W = 48, 64
    im_info = np.tile(np.asarray([[W, H, 1.0, 1.0]], np.float32), (B, 1))
    xy = rng.uniform(0, 40, (B, O, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (B, O, 2))],
                           -1).astype(np.float32)
    boxes[:, 0] = (0, 0, W - 1, H - 1)        # the whole-image box
    box_mask = np.ones((B, O), bool)
    box_mask[1, 3:] = False
    objects = rng.integers(0, 81, (B, O)).astype(np.int32)
    segms = (rng.uniform(size=(B, O, 14, 14)) < 0.6).astype(np.float32)
    if e2e:
        image = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    else:
        image = None
        boxes = np.concatenate(
            [boxes, rng.normal(size=(B, O, F)).astype(np.float32)], -1)
    inputs = (image, boxes, objects, segms, box_mask, *_text(rng))
    if q2ar:
        inputs += _text(rng)
    return inputs + (im_info,), np.asarray([1, 3], np.int32), \
        np.asarray([2, 0], np.int32)


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """(cfg, JAX model, variables) of a variant; initialised in training
    mode, so that the heads used only by the loss have parameters."""
    net, e2e = {n: (o, e) for n, o, e in VARIANTS + [
        ("q2ar", {"ENABLE_CNN_REG_LOSS": True, "CNN_LOSS_TOP": True},
         True)]}[name]
    cfg = _cfg("Q2AR" if name == "q2ar" else "Q2A", e2e, **net)
    jm = j_build_module(cfg, "vcr", dtype=jnp.float32)
    inputs, a_label, r_label = _batch(e2e=e2e, q2ar=name == "q2ar")
    labels = (a_label, r_label) if name == "q2ar" else (a_label,)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)},
                *map(_jnp, inputs + labels), train=True)
    return cfg, jm, v


def _port(cfg, jax_vars):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the ignored TPU.* knobs
        tm = build_module(cfg, "vcr", dtype=torch.float32)
    flat = {k: np.asarray(a) for k, a in
            flatten_params(jax.device_get(jax_vars["params"])).items()}
    tm.load_state_dict(state_dict_from_jax(flat, tm))
    return tm


def _no_obj_dropout(tm, monkeypatch):
    """Dropout(0.1) before obj_downsample is fixed in both packages."""
    monkeypatch.setattr(j_fast_rcnn, "Dropout",
                        lambda rate: JDropout(rate=0.0))
    if hasattr(tm, "image_feature_extractor"):
        tm.image_feature_extractor.obj_downsample[0].rate = 0.0


def _compare(name, monkeypatch, out_keys, loss_keys):
    cfg, jm, v = _jax_model(name)
    tm = _port(cfg, v)
    e2e = not cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED
    inputs, a_label, r_label = _batch(e2e=e2e, q2ar=name == "q2ar")
    labels = (a_label, r_label) if name == "q2ar" else (a_label,)
    want = jm.apply(v, *map(_jnp, inputs), train=False)
    with torch.no_grad():
        got = tm.eval()(*map(_torch, inputs))
    assert set(got) == set(want) == set(out_keys)
    for k in out_keys:
        assert got[k].shape == (B, C)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)

    _no_obj_dropout(tm, monkeypatch)
    j_out, j_loss = jm.apply(v, *map(_jnp, inputs + labels), train=True,
                             rngs={"dropout": jax.random.PRNGKey(2)})
    t_out, t_loss = tm.train()(*map(_torch, inputs + labels))
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), **TOL)
    for k in loss_keys:
        np.testing.assert_allclose(float(t_out[k]), float(j_out[k]), **TOL,
                                   err_msg=k)
    t_loss.backward()
    assert all(p.grad is None or torch.isfinite(p.grad).all()
               for p in tm.parameters())
    return cfg, tm, t_out


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("name", [n for n, _, _ in VARIANTS])
def test_vcr_module_matches_jax(name, monkeypatch):
    cfg = _jax_model(name)[0]
    n = cfg.NETWORK
    loss_keys = ["ans_loss"] + (["cnn_regularization_loss"]
                                if n.ENABLE_CNN_REG_LOSS else []) \
        + (["positive_fraction"] if n.CLASSIFIER_SIGMOID else [])
    _, _, t_out = _compare(name, monkeypatch, ["label_logits"], loss_keys)
    assert set(loss_keys) <= set(t_out)


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
def test_vcr_q2ar_module_and_metrics_match_jax(monkeypatch, tmp_path):
    """One visual pass, two heads: the eval logits of both, the summed
    losses, and the Acc / RationaleAcc / JointAcc of device_metrics with
    wrap-padded samples marked invalid."""
    cfg, tm, _ = _compare(
        "q2ar", monkeypatch, ["label_logits", "rationale_logits"],
        ["ans_loss", "rationale_loss", "cnn_regularization_loss"])
    assert "final_mlp_rationale" in _jax_model("q2ar")[2]["params"]
    # the rationale head has no reference name; a reference-layout file
    # of the port's Q2AR model still loads it back with the rest
    path = str(tmp_path / "q2ar.model")
    torch.save({"state_dict": _reference_layout(tm.state_dict())}, path)
    fresh = _port(cfg, _jax_model("q2ar")[2])
    with torch.no_grad():
        for p in fresh.final_mlp_rationale.parameters():
            p.zero_()
    assert len(t_test._load_params(fresh, path)) == len(fresh.state_dict())
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    logits = np.asarray([[0.1, 2.0, -1.0, 0.0], [1.0, 0.5, 0.2, 3.0],
                         [0.0, 0.0, 4.0, 1.0]], np.float32)
    outputs = {"label_logits": logits, "rationale_logits": logits[:, ::-1],
               "label": np.asarray([1, 3, 0]),
               "rationale_label": np.asarray([2, 0, 1]),
               "valid": np.asarray([True, True, False])}
    want = j_metrics.device_metrics("vcr", cfg, {
        k: jnp.asarray(x) for k, x in outputs.items()})
    got = t_metrics.device_metrics("vcr", cfg, {
        k: torch.from_numpy(np.ascontiguousarray(x))
        for k, x in outputs.items()})
    assert set(got) == set(want) == {"Acc", "RationaleAcc", "JointAcc"}
    for k in want:
        assert [float(x) for x in got[k]] == [float(x) for x in want[k]], k
    assert t_metrics.HOST_METRIC_NAME["vcr"] \
        == j_metrics.HOST_METRIC_NAME["vcr"] == "Acc"


def test_collect_obj_reps_clips_tags_onto_the_whole_image_box():
    """Tags -1 and -2 take object 0 (not the last slot, as a wrap would),
    tags past the last slot take the last; the gather runs on int64."""
    from vlbert_tpu.models.task_modules import \
        collect_obj_reps as j_collect
    from vlbert_tpu_torch.models.task_modules import collect_obj_reps

    reps = np.random.default_rng(0).normal(size=(2, 4, 3)).astype(
        np.float32)
    tags = np.asarray([[[-2, -1, 0, 3, 9]], [[1, 2, -1, 4, 0]]], np.int32)
    got = collect_obj_reps(torch.from_numpy(tags), torch.from_numpy(reps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_collect(jnp.asarray(tags), jnp.asarray(reps))))
    np.testing.assert_array_equal(got[0, 0, 0].numpy(), reps[0, 0])
    np.testing.assert_array_equal(got[0, 0, 1].numpy(), reps[0, 0])
    np.testing.assert_array_equal(got[0, 0, 4].numpy(), reps[0, 3])


# ------------------------------------------------------------ drivers

def _driver_cfg(tmp_path, task, seed=5):
    """A tiny end-to-end VCR config on the fixture of
    tests/test_data_pipeline.py, written as a yaml (the entry points load
    it), and a reference-layout .model of random port weights for it.
    Returns (cfg, yaml path, checkpoint path)."""
    from vlbert_tpu.utils.config import load_config

    d = tmp_path / "vcrfix"
    if not d.exists():
        _write_vcr_fixture(tmp_path)
        _write_vcr_fixture(tmp_path, name="vcrtest", test_mode=True)
    vocab_dir = tmp_path / "bert"
    os.makedirs(vocab_dir, exist_ok=True)
    (vocab_dir / "vocab.txt").write_text("\n".join(VCR_VOCAB) + "\n")
    raw = {
        "MODULE": "ResNetVLBERT", "SCALES": [48, 64],
        "DATASET": {"DATASET": "vcr", "TASK": task,
                    "DATASET_PATH": str(d), "ROOT_PATH": str(tmp_path),
                    "VAL_ANNOTATION_FILE": "ann.jsonl",
                    "TEST_ANNOTATION_FILE": str(tmp_path / "vcrtest"
                                                / "ann.jsonl"),
                    "VAL_IMAGE_SET": "", "TEST_IMAGE_SET": "",
                    "ONLY_USE_RELEVANT_DETS": False, "MASK_SIZE": 14},
        "NETWORK": {
            "BERT_MODEL_NAME": str(vocab_dir), "IMAGE_FEAT_PRECOMPUTED": False,
            "IMAGE_NUM_LAYERS": 50, "IMAGE_STRIDE_IN_1x1": True,
            "IMAGE_C5_DILATED": True, "IMAGE_FINAL_DIM": 32,
            "IMAGE_SEMANTIC": False, "ENABLE_CNN_REG_LOSS": True,
            "CNN_LOSS_TOP": True, "CLASSIFIER_TYPE": "1fc",
            "CLASSIFIER_SIGMOID": True,
            "VLBERT": {"hidden_size": 32, "visual_size": 32,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "intermediate_size": 64,
                       "vocab_size": len(VCR_VOCAB),
                       "max_position_embeddings": 64,
                       "object_word_embed_mode": 2}},
        "VAL": {"BATCH_IMAGES": 2}, "TEST": {"BATCH_IMAGES": 2},
        "TPU": {"MAX_TEXT_LEN": 20, "MAX_BOXES": 4,
                "COMPUTE_DTYPE": "float32", "PROCESS_WORKERS": False}}
    path = tmp_path / f"vcr_{task}.yaml"
    path.write_text(yaml.safe_dump(raw))
    cfg = load_config("vcr", str(path))
    tm = build_module(cfg, "vcr", dtype=torch.float32)
    init_weights(tm, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():          # visual LN scales off their 0/1 init
        for n, p in tm.named_parameters():
            if "visual_scale" in n or "LayerNorm" in n:
                p.add_(torch.rand(p.shape, generator=g) * 0.5)
    ckpt = tmp_path / f"ref_vcr_{task}.model"
    torch.save({"state_dict": _reference_layout(tm.state_dict())}, ckpt)
    return cfg, str(path), str(ckpt)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], \
        np.asarray([[float(x) for x in r[1:]] for r in rows[1:]])


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("task,mode", [("Q2A", "val"), ("QA2R", "test")])
def test_test_net_vcr_matches_jax(tmp_path, task, mode):
    """The csv (header, annot ids, probabilities within 1e-4) and the .npy
    beside it; QA2R on the test split is answer-conditioned: 16 columns."""
    cfg, _, ckpt = _driver_cfg(tmp_path, task)
    out_j, out_t = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    want = j_test.test_net_vcr(cfg, ckpt, out_j, mode=mode)
    got = t_test.test_net_vcr(cfg, ckpt, out_t, mode=mode, device="cpu")
    assert len(got) == len(want) == 2
    hj, ids_j, pj = _read_csv(out_j)
    ht, ids_t, pt = _read_csv(out_t)
    assert ht == hj and ids_t == ids_j == ["val-0", "val-1"]
    assert pt.shape == (2, 16 if mode == "test" else 4)
    if mode == "test":
        assert ht[1] == "rationale_conditioned_on_a0_0" \
            and ht[-1] == "rationale_conditioned_on_a3_3"
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.load(str(tmp_path / "t.npy")),
                               np.load(str(tmp_path / "j.npy")), rtol=0,
                               atol=1e-4)
    # every conditioned block is a distribution over the 4 rationales
    np.testing.assert_allclose(pt.reshape(2, -1, 4).sum(-1), 1.0, atol=1e-6)


def test_merge_vcr_results_equals_the_pandas_merge(tmp_path):
    """The csv-module merge gives the JAX package's pandas merge: the same
    header and rows, the Q2A file's order, ids missing from either file
    dropped. The port copies each field as written; pandas' default float
    parser reads some 17-digit fields one float64 ulp off (it writes
    0.30000000000000004 back as 0.3), so values agree to 1 ulp and the
    port's fields equal the inputs'."""
    a_rows = [["annot_id", "answer_0", "answer_1"],
              ["test-2", 0.25, 0.75], ["test-0", 0.1234567890123, 0.8765],
              ["test-9", 0.5, 0.5], ["test-1", 1.0, 0.0]]
    r_rows = [["annot_id"] + [f"rationale_conditioned_on_a{i}_{j}"
                              for i in range(2) for j in range(2)],
              ["test-0", 0.1, 0.9, 0.30000000000000004, 0.7],
              ["test-1", 0.5, 0.5, 0.2, 0.8],
              ["test-2", 1e-08, 0.99999999, 0.6, 0.4],
              ["test-7", 0.3, 0.7, 0.1, 0.9]]
    paths = {}
    for name, rows in (("a", a_rows), ("r", r_rows)):
        paths[name] = str(tmp_path / f"{name}.csv")
        with open(paths[name], "w", newline="") as f:
            csv.writer(f).writerows(rows)
    want = j_test.merge_vcr_results(paths["a"], paths["r"],
                                    str(tmp_path / "j" / "merged.csv"))
    got = t_test.merge_vcr_results(paths["a"], paths["r"],
                                   str(tmp_path / "t" / "merged.csv"))
    hj, ids_j, vj = _read_csv(want)
    ht, ids_t, vt = _read_csv(got)
    assert ht == hj and ids_t == ids_j == ["test-2", "test-0", "test-1"]
    np.testing.assert_allclose(vt, vj, rtol=2.3e-16, atol=0)
    with open(got, newline="") as f:
        merged = list(csv.reader(f))[1:]
    fields = {str(x) for row in a_rows[1:] + r_rows[1:] for x in row}
    assert {x for row in merged for x in row} <= fields
    assert "0.30000000000000004" in merged[1]


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
def test_vcr_val_pairs_the_two_models_as_jax_does(tmp_path, monkeypatch):
    """python -m vlbert_tpu_torch.engine.vcr_val against the root
    vcr/val.py: the same three accuracies from the same two checkpoints,
    and the cached logits read back."""
    import vcr.val as j_vcr_val

    _, a_yaml, a_ckpt = _driver_cfg(tmp_path, "Q2A", seed=5)
    _, r_yaml, r_ckpt = _driver_cfg(tmp_path, "QA2R", seed=6)
    argv = ["--a-cfg", a_yaml, "--r-cfg", r_yaml, "--a-ckpt", a_ckpt,
            "--r-ckpt", r_ckpt]
    monkeypatch.setattr(sys, "argv", ["val.py"] + argv)
    want = j_vcr_val.main()
    cache = tmp_path / "logits"     # ROOT_PATH/cache holds the db pickles
    os.makedirs(cache)
    got = vcr_val.main(argv + ["--cache-dir", str(cache), "--device", "cpu"])
    assert got == want
    assert sorted(os.listdir(cache)) == ["a_pred.npy", "r_pred.npy"]
    assert vcr_val.main(argv + ["--cache-dir", str(cache), "--device",
                                "cuda"]) == got   # read from the cache
    # the accuracies from known logits: Q->A 1/2, QA->R 1/2, joint 0
    db = [{"answer_label": 1, "rationale_label": 0},
          {"answer_label": 2, "rationale_label": 3}]
    a = np.asarray([[0, 5, 0, 0], [9, 0, 0, 0]], np.float32)
    r = np.asarray([[0, 5, 0, 0], [0, 0, 0, 9]], np.float32)
    assert vcr_val.paired_accuracies(a, r, db) == (0.5, 0.5, 0.0)


def test_vcr_training_on_the_card_is_refused_before_a_step(tmp_path):
    """With K1b (the ROIAlign backward) VCR trains from pixels on the card:
    check_unported accepts it, and train_net on a machine without a card
    gets past it to the device check, which refuses without falling back
    to the CPU. What stays refused before a step is TRAIN.FP16 with
    TPU.FP16_PARITY_MODE."""
    import types

    from vlbert_tpu_torch.engine.train import check_unported, train_net

    cfg = _cfg()
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = False
    check_unported(cfg)
    if not torch.cuda.is_available():
        args = types.SimpleNamespace(model_dir=str(tmp_path), device="cuda")
        with pytest.raises(RuntimeError, match="cuda is not available"):
            train_net(args, cfg, "vcr")
    cfg.TRAIN.FP16 = True
    check_unported(cfg)
    cfg.TPU.FP16_PARITY_MODE = True
    with pytest.raises(NotImplementedError, match="FP16_PARITY_MODE"):
        check_unported(cfg)
