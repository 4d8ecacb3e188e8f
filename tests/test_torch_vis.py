"""The port's attention-map dump (vlbert_tpu_torch/engine/vis.py and the
pretraining model's ``attention_vis``) against the JAX package's on the
CPU, at tiny width in fp32 with inputs from a numpy seed: probs at rtol
1e-3 / atol 1e-4, the token sidecars exactly.

The shipped cfgs/pretrain/vis_attention_maps_coco.yaml names
``ResNetVLBERTForAttentionVis``, which the JAX package's module registry
lacks; the port registers it as the pretraining model without the corpus
rows, and the JAX side here builds that model by its other name, as the
JAX package's own test does.
"""

import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_entrypoints import VOCAB
from tests.test_torch_checkpoint import _reference_layout
from tests.test_torch_pretrain import _batch, _flat, _jax_model, _port
from tests.test_torch_pretrain_data import _coco_fixture
from viz.attention_view import load_dump
from vlbert_tpu.engine.vis import dump_attention_maps as j_dump
from vlbert_tpu.models.task_modules import (
    ResNetVLBERTForPretrainingMultitask as JPretrain)
from vlbert_tpu.models.task_modules import build_module as j_build_module
from vlbert_tpu.models.vlbert import VisualLinguisticBert as JVLBert
from vlbert_tpu.models.vlbert import VLBertConfig as JVLBertConfig
from vlbert_tpu.utils.config import load_config as j_load_config
from vlbert_tpu_torch.data.build import make_dataloader
from vlbert_tpu_torch.data.tokenization import BertTokenizer
from vlbert_tpu_torch.engine import vis
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.models.vlbert import VisualLinguisticBert, VLBertConfig
from vlbert_tpu_torch.training.convert import state_dict_from_jax
from vlbert_tpu_torch.utils.config import load_config

TOL = dict(rtol=1e-3, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIS_YAML = os.path.join(REPO, "cfgs", "pretrain",
                        "vis_attention_maps_coco.yaml")
pytestmark = pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")


@pytest.mark.parametrize("name", ["prec_aux", "pixels_embed"])
def test_attention_vis_matches_jax(name):
    """Precomputed features (with the corpus rows' module) and from pixels
    (ResNet-50, ROIAlign): every layer's probs, in either module mode."""
    cfg, jm, v = _jax_model(name)
    tm = _port(cfg, v)
    image, boxes, im_info, text = _batch(name, seed=3)[:4]
    want = np.asarray(jm.apply(
        v, *(None if a is None else jnp.asarray(a)
             for a in (image, boxes, im_info, text)),
        method=JPretrain.attention_vis))
    for training in (True, False):
        tm.train(training)
        got = tm.attention_vis(*(None if a is None else torch.from_numpy(a)
                                 for a in (image, boxes, im_info, text)))
        assert tm.training == training
        assert got.dtype == torch.float32
        assert got.shape == (2, 2, 2, text.shape[1] + boxes.shape[1] + 1,
                             text.shape[1] + boxes.shape[1] + 1)
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(want.sum(-1), 1.0, rtol=1e-5)


class TinyTok:
    def convert_ids_to_tokens(self, ids):
        return [f"tok{i}" for i in ids]


def test_dump_attention_maps_matches_jax(tmp_path):
    """engine.vis.dump_attention_maps over the encoder: the same files,
    probs within the bar, sidecars equal, two batches."""
    kw = dict(vocab_size=100, hidden_size=32, visual_size=32,
              num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=64, max_position_embeddings=64,
              hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
              visual_ln=True, visual_scale_text_init=1.0,
              visual_scale_object_init=1.0, with_pooler=False)
    rng = np.random.default_rng(4)
    B, T, O = 2, 6, 3
    batches = []
    for n_text in (5, 3):
        tmask = np.broadcast_to(np.arange(T)[None] < n_text, (B, T)).copy()
        omask = np.ones((B, O), bool)
        omask[1, 2] = False
        batches.append((rng.integers(1, 100, (B, T)).astype(np.int32),
                        np.zeros((B, T), np.int32),
                        rng.normal(size=(B, T, 32)).astype(np.float32),
                        tmask,
                        rng.normal(size=(B, O, 64)).astype(np.float32),
                        omask))
    jm = JVLBert(JVLBertConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, batches[0]))
    n_j = j_dump(jm, v, [tuple(map(jnp.asarray, b)) for b in batches],
                 TinyTok(), str(tmp_path / "jax"))
    enc = VisualLinguisticBert(VLBertConfig(**kw))
    enc.load_state_dict(state_dict_from_jax(_flat(v["params"]), enc))
    enc.train()                      # the dump is deterministic anyway
    n_t = vis.dump_attention_maps(
        enc, [tuple(map(torch.from_numpy, b)) for b in batches], TinyTok(),
        str(tmp_path / "port"))
    assert n_t == n_j == 4 and enc.training
    for i in range(4):
        got, got_names = load_dump(str(tmp_path / "port"), i)
        want, want_names = load_dump(str(tmp_path / "jax"), i)
        assert got.dtype == np.float32 and got.shape == (2, 2, 10, 10)
        np.testing.assert_allclose(got, want, **TOL)
        assert got_names == want_names and got_names[-1] == "[END]"
    assert load_dump(str(tmp_path / "port"), 3)[1][3:6] \
        == ["[PAD]"] * 3


def _tiny_vis_yaml(tmp_path):
    """The shipped vis yaml at tiny width over a two-image COCO fixture:
    ResNet-18 (the yaml's dilated conv5, stride in 1x1), 2 layers of 32,
    the fixture's vocabulary, the loader in this process."""
    data = _coco_fixture(tmp_path)
    vocab_dir = tmp_path / "bert"
    os.makedirs(vocab_dir, exist_ok=True)
    vocab = VOCAB + ["a", "cat", "on", "the", "mat", "red", "dog"]
    (vocab_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")
    with open(VIS_YAML) as f:
        y = yaml.safe_load(f)
    y["DATASET"].update(DATASET_PATH=data, ROOT_PATH=str(tmp_path))
    y["NETWORK"].update(BERT_MODEL_NAME=str(vocab_dir), IMAGE_NUM_LAYERS=18)
    y["NETWORK"]["VLBERT"].update(
        hidden_size=32, visual_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        vocab_size=len(vocab), visual_scale_text_init=1.0,
        visual_scale_object_init=1.0)
    y["NETWORK"]["IMAGE_FINAL_DIM"] = 32
    y["SCALES"] = [48, 64]
    y["TPU"] = {"MAX_TEXT_LEN": 12, "MAX_BOXES": 6,
                "PROCESS_WORKERS": False}
    path = tmp_path / "vis_tiny.yaml"
    path.write_text(yaml.safe_dump(y))
    return str(path)


def test_vis_main_dumps_what_jax_attention_vis_gives(tmp_path):
    """``python -m vlbert_tpu_torch.engine.vis`` on the shipped yaml's
    module: JAX-initialised weights through a reference-layout .model
    (--ckpt), the COCO val loader, dumps read back by load_dump and held
    to JAX's attention_vis on the same batches; the card by default."""
    path = _tiny_vis_yaml(tmp_path)
    cfg = load_config("pretrain", path)
    tok = BertTokenizer.from_pretrained(cfg.NETWORK.BERT_MODEL_NAME)
    loader = make_dataloader(cfg, "pretrain", "val", tok, num_replicas=1,
                             rank=0)
    try:
        batches = [tuple(np.asarray(a) for a in b[:4]) for b in loader]
        sample = next(iter(loader))
    finally:
        loader.shutdown()
    assert len(batches) == 2

    jcfg = j_load_config("pretrain", path)
    jcfg.MODULE = "ResNetVLBERTForPretraining"   # JAX lacks the vis name
    jm = j_build_module(jcfg, "pretrain", dtype=jnp.float32)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)},
                *(jnp.asarray(a) for a in sample), train=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = build_module(cfg, "pretrain", dtype=torch.float32)
    assert not tm.with_aux
    ckpt = str(tmp_path / "vis.model")
    torch.save({"state_dict": _reference_layout(
        state_dict_from_jax(_flat(v["params"]), tm))}, ckpt)

    argv = ["--cfg", path, "--ckpt", ckpt, "--result-path",
            str(tmp_path / "dump")]
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m",
                               "vlbert_tpu_torch.engine.vis", *argv],
                              capture_output=True, text=True, timeout=300,
                              cwd=REPO)
        assert proc.returncode != 0 and "cuda" in proc.stderr
    assert vis.main(argv + ["--device", "cpu"]) == 2
    for i, (image, boxes, im_info, text) in enumerate(batches):
        want = np.asarray(jm.apply(
            v, *map(jnp.asarray, (image, boxes, im_info, text)),
            method=JPretrain.attention_vis))[0]
        got, names = load_dump(str(tmp_path / "dump"), i)
        assert got.shape == (2, 2, 19, 19) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
        toks = tok.convert_ids_to_tokens([int(t) for t in text[0] if t > 0])
        assert names == toks + ["[PAD]"] * (12 - len(toks)) \
            + [f"box_{k}" for k in range(6)] + ["[END]"]
        assert names[0] == "[CLS]"
    with open(tmp_path / "dump" / "1_tokens.json") as f:
        assert len(json.load(f)) == 19
