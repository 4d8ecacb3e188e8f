"""The port's VQA server and test drivers (vlbert_tpu_torch.engine.serve.
VQAServer, engine.test) against the JAX package on the CPU, at tiny width
in fp32, on the same weights and inputs.

Each driver pair scores one tiny fixture from one checkpoint the test
writes: a port checkpoint for VQA, a reference-layout ``.model``
(``module.`` and ``vlbert._module.`` prefixes) for RefCOCO+.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vlbert_tpu.engine.test as j_test
import vlbert_tpu_torch.engine.test as t_test
from tests.test_entrypoints import VOCAB, _tiny_vqa_cfg, _write_vqa_fixture
from tests.test_torch_checkpoint import _reference_layout
from tests.test_torch_train import TOL
from vlbert_tpu.engine.serve import VQAServer as JaxVQAServer
from vlbert_tpu.models.task_modules import build_module as j_build_module
from vlbert_tpu.training.checkpoint import flatten_params
from vlbert_tpu.utils.config import default_config
from vlbert_tpu_torch.engine.serve import VQAServer
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.training import checkpoint as ckpt
from vlbert_tpu_torch.training.convert import state_dict_from_jax
from vlbert_tpu_torch.training.optim import Optimizer

ANSWERS = ["<unk>", "red", "blue", "cat"]


class TinyTok:
    cls_id, sep_id, mask_id = 2, 3, 4

    def tokenize(self, text):
        return text.split()

    def convert_tokens_to_ids(self, toks):
        return [sum(map(ord, t)) % 90 + 10 for t in toks]


def _vqa_server_cfg(kind):
    cfg = default_config("vqa")
    cfg.MODULE = "ResNetVLBERT"
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64; v.vocab_size = 100
    v.max_position_embeddings = 64; v.visual_ln = True
    v.visual_scale_text_init = 1.0; v.visual_scale_object_init = 1.0
    cfg.NETWORK.IMAGE_FINAL_DIM = 32
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = True
    cfg.DATASET.ANSWER_VOCAB_SIZE = len(ANSWERS)
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = 16
    cfg.NETWORK.CLASSIFIER_TYPE = kind
    cfg.NETWORK.CLASSIFIER_HIDDEN_SIZE = 24
    return cfg


def _queries(rng, n=4):
    out = []
    for i in range(n):
        nb = 2 + i
        xy = rng.uniform(0, 50, (nb, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (nb, 2))],
                               1).astype(np.float32)
        feats = rng.normal(size=(nb, 16)).astype(np.float32)
        out.append((" ".join(["what", "color", "is", "the", "cat"][:2 + i])
                    + " ?", boxes, feats, 100 + 10 * i, 80))
    return out


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("kind", ["1fc", "mlm"])
def test_vqa_server_matches_jax(kind):
    cfg = _vqa_server_cfg(kind)
    qs = _queries(np.random.default_rng(0))
    jm = j_build_module(cfg, "vqa", dtype=jnp.float32)
    jsrv = JaxVQAServer(jm, None, TinyTok(), ANSWERS, max_text=16,
                        max_boxes=8, feat_dim=16)
    batch = jsrv.preprocess(*qs[0])
    jsrv.params = jm.init({"params": jax.random.PRNGKey(0),
                           "dropout": jax.random.PRNGKey(1)}, *batch,
                          train=False)
    tm = build_module(cfg, "vqa", dtype=torch.float32)
    flat = flatten_params(jax.device_get(jsrv.params)["params"])
    tm.load_state_dict(state_dict_from_jax(flat, tm))
    srv = VQAServer(tm, TinyTok(), ANSWERS, max_text=16, max_boxes=8,
                    feat_dim=16)
    assert not tm.training
    for q in qs:
        got_b, want_b = srv.preprocess(*q), jsrv.preprocess(*q)
        assert len(got_b) == len(want_b) == 8 and got_b[0] is None \
            and want_b[0] is None
        for a, b in zip(got_b[1:], want_b[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        got = srv.infer(got_b)["label_logits"]
        want = np.asarray(jsrv._infer(jsrv.params, *want_b))
        np.testing.assert_allclose(got, want, **TOL)
        assert srv.query(*q) == jsrv.query(*q)
    lat = srv.measure_latency(qs, warmup=1)
    assert lat["n"] == 4 and 0 < lat["p50_ms"] <= lat["p99_ms"]


def test_vqa_server_refuses_int8_and_the_default_bucket_is_173():
    """int8 is served now (tests/test_torch_quant.py holds it to JAX): at
    the default min_size only the 4096-element weights are int8; any
    other mode is refused."""
    from vlbert_tpu_torch.ops.quant import quantizable_layers

    cfg = _vqa_server_cfg("1fc")
    tm = build_module(cfg, "vqa", dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown quantize"):
        VQAServer(tm, TinyTok(), ANSWERS, quantize="fp8")
    assert not any(m.quantized for _, m in quantizable_layers(tm))
    VQAServer(tm, TinyTok(), ANSWERS, quantize="int8")
    assert {n for n, m in quantizable_layers(tm) if m.quantized} \
        == {n for n, m in quantizable_layers(tm)
            if m.weight.numel() >= 4096}
    srv = VQAServer(tm, TinyTok(), ANSWERS, feat_dim=16)
    b = srv.preprocess("what is the cat ?", np.zeros((3, 4), np.float32),
                       np.zeros((3, 16), np.float32), 100, 80)
    assert b[1].shape == (1, 108, 20) and b[4].shape == (1, 64)
    assert b[1].shape[1] + b[4].shape[1] + 1 == 173
    # [CLS] what is the cat ? [SEP] [MASK] [SEP]: the [MASK] slot is 7
    assert int(b[7][0]) == 7 and int(b[4][0, 7]) == TinyTok.mask_id


def _vqa_driver_cfg(tmp_path):
    data_dir, vocab_dir = _write_vqa_fixture(tmp_path, n=8)
    cfg = _tiny_vqa_cfg(tmp_path, data_dir, vocab_dir)
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = 32
    cfg.TPU.PROCESS_WORKERS = False
    cfg.TEST.BATCH_IMAGES = cfg.VAL.BATCH_IMAGES = 3
    cfg.NETWORK.VLBERT.num_hidden_layers = 2
    return cfg


def _save_port_checkpoint(cfg, task, path_prefix, seed=3):
    tm = build_module(cfg, task, dtype=torch.float32)
    init_weights(tm, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():          # visual LN scales off their 0/1 init
        for n, p in tm.named_parameters():
            if "visual_scale" in n or "LayerNorm" in n:
                p.add_(torch.rand(p.shape, generator=g) * 0.5)
    return ckpt.save_checkpoint(path_prefix, 0, tm, Optimizer(cfg, tm, 1))


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("mode", ["test", "val"])
def test_test_net_vqa_matches_jax(tmp_path, mode):
    cfg = _vqa_driver_cfg(tmp_path)
    path = _save_port_checkpoint(cfg, "vqa", str(tmp_path / "port"))
    out_j, out_t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = j_test.test_net_vqa(cfg, path, ANSWERS, out_j, mode=mode)
    got = t_test.test_net_vqa(cfg, path, ANSWERS, out_t, mode=mode,
                              device="cpu")
    assert got == want and len(got) == 4
    with open(out_j) as fj, open(out_t) as ft:
        assert json.load(ft) == json.load(fj)
    # the logits behind the answers, batch by batch
    res, _ = t_test.run_inference(cfg, "vqa", path, mode, "cpu")
    logits = np.concatenate([r["label_logits"] for r in res])[:4]
    _, params, infer, loader, _, n_label = j_test.setup_inference(
        cfg, "vqa", path, mode)
    batch = next(iter(loader))
    jl = np.asarray(infer(params, *(batch[:-n_label] if n_label
                                    else batch))["label_logits"])[:4]
    np.testing.assert_allclose(logits, jl, **TOL)


def _write_refcoco_rows(tmp_path, n=6):
    """n referring sentences over landscape images (a test batch shares
    one canvas orientation) in the documented jsonl form {image_fn, width,
    height, boxes, gt_box, sentence}."""
    d = tmp_path / "refcoco"
    os.makedirs(d / "img", exist_ok=True)
    rng = np.random.default_rng(3)
    rows = []
    for i in range(n):
        h, w = (60, 80) if i % 2 == 0 else (50, 70)
        fn = f"img/{i % 3}_{h}.jpg"
        if not (d / fn).exists():
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(d / fn)
        boxes = []
        for _ in range(2 + i % 3):
            x1, y1 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
            boxes.append([round(x1, 1), round(y1, 1),
                          round(min(x1 + rng.uniform(8, w * 0.4), w - 1), 1),
                          round(min(y1 + rng.uniform(8, h * 0.4), h - 1), 1)])
        rows.append({"image_id": i, "image_fn": fn, "width": w, "height": h,
                     "boxes": boxes, "gt_box": boxes[i % len(boxes)],
                     "sentence": ["the red dog", "what is the cat",
                                  "blue dog"][i % 3]})
    with open(d / "ann.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    return d


def _refcoco_driver_cfg(tmp_path):
    from tests.test_torch_serve import _tiny_cfg

    d = _write_refcoco_rows(tmp_path)
    vocab_dir = tmp_path / "bert"
    os.makedirs(vocab_dir, exist_ok=True)
    (vocab_dir / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    cfg = _tiny_cfg()
    cfg.NETWORK.VLBERT.vocab_size = len(VOCAB)
    cfg.NETWORK.BERT_MODEL_NAME = str(vocab_dir)
    cfg.DATASET.DATASET = "refcoco+"
    cfg.DATASET.DATASET_PATH = str(d)
    cfg.DATASET.ROOT_PATH = str(tmp_path)
    cfg.DATASET.VAL_ANNOTATION_FILE = "ann.jsonl"
    cfg.DATASET.TEST_ANNOTATION_FILE = "ann.jsonl"
    cfg.SCALES = [32, 48]
    cfg.TEST.BATCH_IMAGES = cfg.VAL.BATCH_IMAGES = 4
    cfg.TPU.MAX_TEXT_LEN = 8
    cfg.TPU.MAX_BOXES = 6
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.PROCESS_WORKERS = False
    return cfg


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("mode", ["test", "val"])
def test_test_net_refcoco_matches_jax(tmp_path, mode):
    cfg = _refcoco_driver_cfg(tmp_path)
    tm = build_module(cfg, "refcoco", dtype=torch.float32)
    init_weights(tm, torch.Generator().manual_seed(5))
    path = str(tmp_path / "ref_refcoco.model")
    torch.save({"state_dict": _reference_layout(tm.state_dict())}, path)
    out_j, out_t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want, want_acc = j_test.test_net_refcoco(cfg, path, out_j, mode=mode)
    got, got_acc = t_test.test_net_refcoco(cfg, path, out_t, mode=mode,
                                           device="cpu")
    assert len(got) == len(want) == 6 and got_acc == want_acc
    np.testing.assert_allclose([p["pred_box"] for p in got],
                               [p["pred_box"] for p in want], rtol=0,
                               atol=1e-4)
    with open(out_t) as f:
        assert len(json.load(f)) == 6


def test_test_entry_point_runs_on_the_cpu_only_when_asked(tmp_path):
    cfg = _vqa_driver_cfg(tmp_path)
    path = _save_port_checkpoint(cfg, "vqa", str(tmp_path / "port"))
    yaml_file = tmp_path / "tiny.yaml"
    lines = [f"MODULE: {cfg.MODULE}",
             "NETWORK:", f"  BERT_MODEL_NAME: '{cfg.NETWORK.BERT_MODEL_NAME}'",
             "  IMAGE_FEAT_PRECOMPUTED: true", "  IMAGE_FINAL_DIM: 32",
             "  CLASSIFIER_TYPE: '1fc'",
             "  VLBERT:"] + [f"    {k}: {getattr(cfg.NETWORK.VLBERT, k)}"
                             for k in ("hidden_size", "visual_size",
                                       "num_hidden_layers",
                                       "num_attention_heads",
                                       "intermediate_size", "vocab_size",
                                       "max_position_embeddings")] + [
             "DATASET:", "  DATASET: vqa",
             f"  DATASET_PATH: '{cfg.DATASET.DATASET_PATH}'",
             f"  ROOT_PATH: '{cfg.DATASET.ROOT_PATH}'",
             "  TEST_ANNOTATION_FILE: val.jsonl",
             f"  ANSWER_VOCAB_FILE: '{cfg.DATASET.ANSWER_VOCAB_FILE}'",
             "  ANSWER_VOCAB_SIZE: 4", "  PRECOMPUTED_FEAT_DIM: 32",
             "TEST:", "  BATCH_IMAGES: 2",
             "TPU:", "  MAX_TEXT_LEN: 16", "  MAX_BOXES: 8",
             "  COMPUTE_DTYPE: float32", "  PROCESS_WORKERS: false"]
    yaml_file.write_text("\n".join(lines) + "\n")
    argv = ["--task", "vqa", "--cfg", str(yaml_file), "--ckpt", path,
            "--result-path", str(tmp_path / "res"), "--result-name", "r"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_test.main(argv)
    assert t_test.main(argv + ["--device", "cpu"]) == 0
    with open(tmp_path / "res" / "r_vqa2_test.json") as f:
        answers = json.load(f)
    assert [a["question_id"] for a in answers] == [0, 1, 2, 3]
    # VCR is one of the entry point's tasks, on the card by default; its
    # leaderboard csv takes Q2A or QA2R, as the reference's does
    from vlbert_tpu_torch.engine.cli import parse_test_args

    args = parse_test_args(["--task", "vcr", "--cfg", "c.yaml", "--ckpt",
                            path])
    assert (args.task, args.device, args.split) == ("vcr", "cuda", "test")
    cfg.DATASET.TASK = "Q2AR"
    with pytest.raises(ValueError, match="Q2A or QA2R"):
        t_test.test_net_vcr(cfg, path, "x.csv")
