"""The port's serving slice as a whole, against the JAX package on the CPU.

Port RefCOCOServer vs JAX RefCOCOServer on the same weights (the tiny
ResNet-50 setup of tests/test_serve.py), and the port's demo entry point.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vlbert_tpu.engine.serve import RefCOCOServer as JaxRefCOCOServer
from vlbert_tpu.models.task_modules import build_module as jax_build_module
from vlbert_tpu.training.checkpoint import flatten_params
from vlbert_tpu.utils.config import default_config
from vlbert_tpu_torch.engine.serve import RefCOCOServer
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.training.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TinyTok:
    cls_id, sep_id, mask_id = 2, 3, 4

    def tokenize(self, text):
        return text.split()

    def convert_tokens_to_ids(self, toks):
        return [sum(map(ord, t)) % 90 + 10 for t in toks]


def _tiny_cfg():
    cfg = default_config("refcoco")
    cfg.MODULE = "ResNetVLBERT"
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64; v.vocab_size = 100
    v.max_position_embeddings = 64; v.visual_ln = True
    v.visual_scale_text_init = 1.0; v.visual_scale_object_init = 1.0
    cfg.NETWORK.IMAGE_FINAL_DIM = 32
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = False    # full e2e backbone path
    cfg.NETWORK.IMAGE_NUM_LAYERS = 50
    cfg.NETWORK.IMAGE_STRIDE_IN_1x1 = True        # as the shipped config
    cfg.NETWORK.IMAGE_C5_DILATED = True
    return cfg


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
def test_refcoco_server_matches_jax(rng):
    cfg = _tiny_cfg()
    jm = jax_build_module(cfg, "refcoco", dtype=jnp.float32)
    jsrv = JaxRefCOCOServer(jm, None, TinyTok(), transform=None,
                            max_text=12, max_boxes=6)
    img = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    cand = np.asarray([[2, 2, 20, 20], [10, 8, 50, 38], [30, 0, 55, 39],
                       [0, 20, 12, 39]], np.float32)
    expr = "the red thing on the left"
    batch = jsrv.preprocess(img, cand, expr)
    jsrv.params = jm.init({"params": jax.random.PRNGKey(0)}, *batch,
                          train=False)
    want = jax.device_get(jsrv._infer(jsrv.params, *batch))
    want_q = jsrv.query(img, cand, expr)

    tm = build_module(cfg, "refcoco", dtype=torch.float32)
    flat = flatten_params(jax.device_get(jsrv.params)["params"])
    tm.load_state_dict(state_dict_from_jax(flat, tm))
    srv = RefCOCOServer(tm, TinyTok(), transform=None, max_text=12,
                        max_boxes=6)
    for a, b in zip(srv.preprocess(img, cand, expr), batch):
        np.testing.assert_array_equal(a, b)
    got = srv.infer(srv.preprocess(img, cand, expr))
    np.testing.assert_allclose(got["label_logits"],
                               np.asarray(want["label_logits"]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["pred_boxes"],
                               np.asarray(want["pred_boxes"]), rtol=1e-6)

    r = srv.query(img, cand, expr)
    assert r["best_index"] == want_q["best_index"]
    np.testing.assert_array_equal(r["box"], want_q["box"])
    np.testing.assert_array_equal(r["box"], cand[r["best_index"]])
    np.testing.assert_allclose(r["candidate_scores"],
                               want_q["candidate_scores"], atol=1e-5)

    lat = srv.measure_latency([(img, cand, f"thing {i}") for i in range(3)],
                              warmup=1)
    assert lat["n"] == 3 and lat["p50_ms"] <= lat["p99_ms"]
    # int8 is served now (tests/test_torch_quant.py holds it to JAX's
    # int8 server): the same box, the logits moved a little
    srv8 = RefCOCOServer(tm, TinyTok(), transform=None, max_text=12,
                         max_boxes=6, quantize="int8")
    got8 = srv8.infer(srv8.preprocess(img, cand, expr))["label_logits"]
    assert np.isfinite(got8).all() and got8.shape == got["label_logits"] \
        .shape
    assert srv8.query(img, cand, expr)["best_index"] == r["best_index"]


def test_demo_refcoco_torch_tiny_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "demo_refcoco_torch.py"),
         "--tiny", "--device", "cpu"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["backend"] == "cpu" and out["image_hw"] == [120, 160]
    assert 0 <= out["best_candidate"] < 3
    assert len(out["candidate_scores"]) == 3 and len(out["pred_box_xyxy"]) == 4


def test_the_demo_serves_a_native_checkpoint(tmp_path):
    """tools/demo_refcoco_torch.py --ckpt: a JAX-native file (the JAX
    converter's tree of a seed-5 tiny model, written by flax) gives the
    demo's model every tensor, tokenized with the config's vocab."""
    import warnings

    import yaml
    from flax import serialization as fs

    from tests.test_entrypoints import VOCAB
    from vlbert_tpu.training.convert import (convert_state_dict,
                                             fuse_qkv_params)
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.utils.config import load_config

    repo = REPO
    shipped = os.path.join(repo, "cfgs", "refcoco", "base_gt_boxes_4x16G.yaml")
    with open(shipped) as f:
        raw = yaml.safe_load(f)
    (tmp_path / "bert").mkdir()
    (tmp_path / "bert" / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    raw["NETWORK"]["BERT_MODEL_NAME"] = str(tmp_path / "bert")
    cfg_path = tmp_path / "demo.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    # the demo's --tiny model
    cfg = load_config("refcoco", str(cfg_path))
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = False
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 1
    v.num_attention_heads = 2; v.intermediate_size = 64
    cfg.NETWORK.IMAGE_FINAL_DIM = 32
    cfg.NETWORK.IMAGE_NUM_LAYERS = 50
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = build_module(cfg, "refcoco", dtype=torch.float32)
    init_weights(tm, torch.Generator().manual_seed(5))
    flat, skipped = convert_state_dict(tm.state_dict())
    tree = {}
    for k, a in fuse_qkv_params(flat).items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(a)
    ckpt = tmp_path / "native.model"
    ckpt.write_bytes(fs.msgpack_serialize(
        {"params": {"params": tree}, "opt_state": {}, "step": 0,
         "extra": {}}))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "demo_refcoco_torch.py"),
         "--tiny", "--device", "cpu", "--cfg", str(cfg_path), "--ckpt",
         str(ckpt)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["weights"] == str(ckpt)
    assert out["loaded_tensors"] == len(tm.state_dict()) - len(skipped)
    assert 0 <= out["best_candidate"] < 3
