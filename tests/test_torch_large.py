"""VL-BERT-large (24 layers, 1024 wide, 16 heads, FFN 4096) on the port
(vlbert_tpu_torch) against the JAX package on the CPU, and TPU.REMAT, the
port's per-layer activation checkpointing.

Large's geometry in the pieces a CPU test can afford: its width and heads
at 2 layers; its 24 layers at a narrow width, through the converter both
ways (``encoder.layer_1x`` beside ``layer_x``); the four large task models
built on the meta device beside JAX's under ``jax.eval_shape`` (names and
shapes only, nothing allocated); the other shipped large yamls; a
``bert-large-uncased`` state dict on the meta device through
``convert_bert_checkpoint``. fp32 eval, the bar of
tests/test_fullsize_parity.py (rtol 1e-3 / atol 1e-4).

REMAT: a step with each layer checkpointed equals the unrolled step bit
for bit with dropout active, its backward outside the ``dropout_seeds``
block; the recompute replays the forward's dropout seeds.
"""

import contextlib
import functools
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlbert_tpu_torch.models.bert as t_bert
from tests.test_entrypoints import _tiny_vqa_cfg, _write_vqa_fixture
from tests.test_torch_train import _batch as _vqa_batch
from tests.test_torch_train import _cfg as _vqa_cfg
from vlbert_tpu.models import vlbert as j_vlbert
from vlbert_tpu.models.task_modules import build_module as j_build_module
from vlbert_tpu.training.checkpoint import flatten_params
from vlbert_tpu.training.convert import convert_state_dict, fuse_qkv_params
from vlbert_tpu.utils.config import load_config as j_load_config
from vlbert_tpu_torch.engine.train import compute_policy
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.models.vlbert import (TIED_DECODER,
                                            VisualLinguisticBert,
                                            VLBertConfig)
from vlbert_tpu_torch.ops import dropout as t_dropout
from vlbert_tpu_torch.training.convert import (convert_bert_checkpoint,
                                               state_dict_from_jax)
from vlbert_tpu_torch.utils.config import load_config

TOL = dict(rtol=1e-3, atol=1e-4)
CFGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "cfgs")
LARGE = dict(hidden_size=1024, num_attention_heads=16, intermediate_size=4096)


def _flat(variables):
    return {k: np.asarray(v) for k, v in flatten_params(
        jax.device_get(variables)["params"]).items()}


def _quiet_build(cfg, task, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the ignored TPU.* knobs
        return build_module(cfg, task, **kw)


def _vl_inputs(rng, B, T, O, visual, vocab):
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    types_ = np.zeros((B, T), np.int32)
    types_[:, T // 2:] = 1
    tve = rng.normal(size=(B, T, visual)).astype(np.float32)
    tmask = np.ones((B, T), bool)
    tmask[1, T - 3:] = False
    obj = rng.normal(size=(B, O, 2 * visual)).astype(np.float32)
    omask = np.ones((B, O), bool)
    omask[0, O - 4:] = False
    return ids, types_, tve, tmask, obj, omask


def _vl_pair(cfg, args, fused_qkv=False):
    """(JAX VisualLinguisticBert variables, outputs; the port's, loaded
    from them, and its outputs) in eval."""
    jm = j_vlbert.VisualLinguisticBert(
        j_vlbert.VLBertConfig(**cfg, fused_qkv=fused_qkv))
    jargs = tuple(map(jnp.asarray, args))
    v = jm.init(jax.random.PRNGKey(0), *jargs)
    want = jm.apply(v, *jargs, output_text_and_object_separately=True)
    tm = VisualLinguisticBert(VLBertConfig(**cfg, fused_qkv=fused_qkv))
    tm.load_state_dict(state_dict_from_jax(_flat(v), tm))
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, args),
                        output_text_and_object_separately=True)
    return v, want, tm, got


def test_large_width_and_heads_match_jax(rng):
    """(a) 1024 wide, 16 heads of 64, FFN 4096, 2 layers, L = 13 + 10 +
    1 = 24, a small vocabulary."""
    cfg = dict(vocab_size=1100, visual_size=1024, num_hidden_layers=2,
               max_position_embeddings=64, visual_ln=True, with_pooler=True,
               visual_scale_text_init=0.7, visual_scale_object_init=1.3,
               **LARGE)
    args = _vl_inputs(rng, 2, 13, 10, 1024, 1100)
    _, want, tm, got = _vl_pair(cfg, args)
    assert tm.encoder.layer[0].attention.self.num_heads == 16
    assert tm.encoder.layer[0].attention.self.head_dim == 64
    for g, w in zip(got[:3], want[:3]):
        assert g.shape[-1] == 1024
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_24_layers_round_trip_and_match_jax(rng, fused_qkv):
    """(b) 24 layers at 64 wide and 4 heads: JAX -> port -> JAX gives back
    every leaf exactly, layer_10 .. layer_23 included, each port layer
    holds its own JAX layer's weights, and the outputs match."""
    cfg = dict(vocab_size=1100, hidden_size=64, visual_size=64,
               num_hidden_layers=24, num_attention_heads=4,
               intermediate_size=128, max_position_embeddings=64,
               visual_ln=True, with_pooler=True, visual_scale_text_init=0.7,
               visual_scale_object_init=1.3)
    args = _vl_inputs(rng, 2, 13, 10, 64, 1100)
    v, want, tm, got = _vl_pair(cfg, args, fused_qkv)
    flat = _flat(v)
    assert {f"encoder.layer_{i}" for i in range(24)} == {
        ".".join(k.split(".")[:2]) for k in flat if k.startswith("encoder.")}
    for i in (1, 2, 10, 12, 19, 23):
        layer = tm.encoder.layer[i].output.dense.weight.detach().numpy()
        np.testing.assert_array_equal(
            layer, flat[f"encoder.layer_{i}.output_dense.kernel"].T)
    back, skipped = convert_state_dict(tm.state_dict())
    if fused_qkv:
        back = fuse_qkv_params(back)
    assert skipped == [] and back.keys() == flat.keys()
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _shape_inputs(cfg, task):
    """A batch of one for ``jax.eval_shape`` of the JAX model's init (the
    parameter shapes do not depend on it): 64x64 pixels or precomputed
    features, 5 box slots, 8 text tokens, the labels a training-mode init
    needs."""
    O, T, C = 5, 8, 4
    i32 = np.int32
    im_info = np.asarray([[64, 64, 1.0, 1.0]], np.float32)
    image = np.zeros((1, 64, 64, 3), np.uint8)
    boxes = np.tile(np.asarray([0, 0, 63, 63], np.float32), (1, O, 1))
    mask = np.ones((1, O), bool)
    if task == "vcr":
        text = tuple(np.ones((1, C, T), t) for t in (i32, i32, i32, bool))
        return (image, boxes, np.zeros((1, O), i32),
                np.ones((1, O, 14, 14), np.float32), mask, *text, im_info,
                np.zeros((1,), i32))
    ids, tmask = np.full((1, T), 1000, i32), np.ones((1, T), bool)
    if task == "vqa":
        feats = np.zeros((1, O, cfg.DATASET.PRECOMPUTED_FEAT_DIM), np.float32)
        return (None, np.concatenate([boxes, feats], -1), mask, im_info, ids,
                np.zeros((1, T), i32), tmask, np.zeros((1,), i32),
                np.zeros((1, cfg.DATASET.ANSWER_VOCAB_SIZE), np.float32))
    if task == "refcoco":
        return (image, boxes, mask, im_info, ids, tmask,
                np.zeros((1, O), i32))
    classes = cfg.NETWORK.VLBERT.visual_region_classes
    return (image.astype(np.float32), boxes, im_info, ids,
            np.zeros((1,), i32), np.full((1, T), -1, i32),
            np.zeros((1, O), i32), np.zeros((1, O, classes), np.float32),
            ids, np.full((1, T), -1, i32))


# (c) the four large architectures, by their shipped yamls
LARGE_MODELS = {"vcr_q2a": ("vcr", "vcr/large_q2a_4x16G_fp16.yaml"),
                "vqa": ("vqa", "vqa/large_4x16G_fp32.yaml"),
                "refcoco": ("refcoco", "refcoco/large_gt_boxes_4x16G.yaml"),
                "pretrain_e2e": ("pretrain",
                                 "pretrain/large_e2e_16x16G_fp16.yaml")}


@pytest.mark.parametrize("name", list(LARGE_MODELS))
def test_large_model_shapes_match_jax(name):
    """(c) The port's model on the meta device and JAX's under
    jax.eval_shape: every converted name has one JAX leaf of its shape,
    every leaf is used, and the parameter counts are equal."""
    task, yaml_path = LARGE_MODELS[name]
    path = os.path.join(CFGS, yaml_path)
    jcfg = j_load_config(task, path)
    jm = j_build_module(jcfg, task, dtype=jnp.float32)
    shapes = jax.eval_shape(
        functools.partial(jm.init, train=True),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *(None if a is None else jnp.asarray(a)
          for a in _shape_inputs(jcfg, task)))
    flat = {k: np.broadcast_to(np.zeros((), s.dtype), s.shape)
            for k, s in flatten_params(shapes["params"]).items()}

    tm = _quiet_build(load_config(task, path), task, dtype=torch.float32,
                      device="meta")
    enc = tm.vlbert.encoder
    assert len(enc.layer) == 24 and enc.layer[23].output.dense.weight.shape \
        == (1024, 4096)
    assert enc.layer[0].attention.self.num_heads == 16
    sd = state_dict_from_jax(flat, tm)           # strict: names and shapes
    want = tm.state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].is_meta and sd[k].shape == want[k].shape for k in sd)
    # the tied decoder is a second name of the word table
    port_count = sum(t.numel() for k, t in want.items()
                     if not k.endswith(TIED_DECODER))
    assert port_count == sum(a.size for a in flat.values())
    assert port_count > 300e6


# (d) the other shipped large yamls
OTHER_LARGE = ["vcr/large_q2a_16x16G_fp16.yaml", "vcr/large_q2a_v5e_bf16.yaml",
               "vcr/large_qa2r_16x16G_fp16.yaml",
               "vcr/large_qa2r_4x16G_fp16.yaml",
               "vcr/large_qa2r_v5e_bf16.yaml",
               "refcoco/large_detected_regions_4x16G.yaml",
               "pretrain/large_prec_4x16G_fp16.yaml"]


def test_every_large_yaml_is_covered():
    shipped = sorted(f"{d}/{f}" for d in os.listdir(CFGS)
                     if os.path.isdir(os.path.join(CFGS, d))
                     for f in os.listdir(os.path.join(CFGS, d))
                     if f.startswith("large_"))
    assert shipped == sorted(OTHER_LARGE + [p for _, p in
                                            LARGE_MODELS.values()])


@pytest.mark.parametrize("yaml_path", OTHER_LARGE)
def test_other_large_yamls_build_on_meta(yaml_path):
    """(d) Each builds at 24 x 1024 x 16 on the meta device, and its dtype
    policy is the JAX package's (TRAIN.FP16 trains in bf16 with no loss
    scale; its 'dynamic' scale is read only under FP16_PARITY_MODE)."""
    task = yaml_path.split("/")[0]
    cfg = load_config(task, os.path.join(CFGS, yaml_path))
    dtype, scale = compute_policy(cfg)
    assert scale == 1.0
    assert dtype == (torch.bfloat16 if cfg.TRAIN.FP16 else
                     {"bfloat16": torch.bfloat16, "float16": torch.float16}
                     .get(cfg.TPU.COMPUTE_DTYPE, torch.float32))
    tm = _quiet_build(cfg, task, device="meta")
    enc = tm.vlbert.encoder
    assert len(enc.layer) == 24
    assert enc.layer[0].attention.self.num_heads == 16
    assert all(p.is_meta for p in tm.parameters())
    assert sum(p.numel() for p in tm.parameters()) > 300e6


def _bert_large_state_dict():
    """bert-large-uncased's pytorch_model.bin names and shapes on the meta
    device: 24 layers of 1024 x 16 heads, FFN 4096, 2 token types, the
    TF-era LayerNorm gamma / beta, the MLM and NSP heads."""
    H, F, V = 1024, 4096, 30522
    shapes = {"bert.embeddings.word_embeddings.weight": (V, H),
              "bert.embeddings.position_embeddings.weight": (512, H),
              "bert.embeddings.token_type_embeddings.weight": (2, H),
              "bert.embeddings.LayerNorm.gamma": (H,),
              "bert.embeddings.LayerNorm.beta": (H,),
              "bert.pooler.dense.weight": (H, H),
              "bert.pooler.dense.bias": (H,),
              "cls.predictions.bias": (V,),
              "cls.predictions.transform.dense.weight": (H, H),
              "cls.predictions.transform.dense.bias": (H,),
              "cls.predictions.transform.LayerNorm.gamma": (H,),
              "cls.predictions.transform.LayerNorm.beta": (H,),
              "cls.predictions.decoder.weight": (V, H),
              "cls.seq_relationship.weight": (2, H),
              "cls.seq_relationship.bias": (2,)}
    for i in range(24):
        p = f"bert.encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            shapes[p + name + ".weight"] = (H, H)
            shapes[p + name + ".bias"] = (H,)
        shapes[p + "intermediate.dense.weight"] = (F, H)
        shapes[p + "intermediate.dense.bias"] = (F,)
        shapes[p + "output.dense.weight"] = (H, F)
        shapes[p + "output.dense.bias"] = (H,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[p + ln + ".gamma"] = (H,)
            shapes[p + ln + ".beta"] = (H,)
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


def test_convert_bert_large_checkpoint_onto_the_large_models():
    """``convert_bert_checkpoint`` maps bert-large-uncased onto the large
    models' names: every tensor lands on a port tensor of its shape (the
    24 layers, the MLM transform and bias on the pretraining model; the
    pooler on VCR's; the NSP head has no place in either), the tied
    decoder is skipped (the word table is its weight), and the token-type
    table grows to VL-BERT's 3 rows."""
    out, skipped = convert_bert_checkpoint(_bert_large_state_dict())
    assert skipped == ["vlbert." + TIED_DECODER]
    assert out["vlbert.token_type_embeddings.weight"].shape == (3, 1024)
    models = {task: _quiet_build(load_config(task, os.path.join(CFGS, y)),
                                 task, device="meta").state_dict()
              for task, y in (("pretrain",
                               "pretrain/large_e2e_16x16G_fp16.yaml"),
                              ("vcr", "vcr/large_q2a_4x16G_fp16.yaml"))}
    nsp = "vlbert.relationship_head.caption_image_relationship."
    for k, t in out.items():
        homes = [m[k].shape for m in models.values() if k in m]
        assert homes == [t.shape] * len(homes) and (homes or
                                                    k.startswith(nsp)), k
    pre, vcr = models["pretrain"], models["vcr"]
    encoder = {k for k in pre if k.startswith("vlbert.encoder.")}
    assert len(encoder) == 24 * 16 and encoder <= set(out)
    assert {k for k in pre if k.startswith("vlbert.mlm_head.")} \
        - {"vlbert." + TIED_DECODER} <= set(out)
    assert {"vlbert.pooler.dense.weight", "vlbert.pooler.dense.bias"} \
        <= set(out) & set(vcr)


# ----------------------------------------------------------------- REMAT

def _remat_model(remat, layers=3, rate=0.1):
    """The tiny VQA model of tests/test_torch_train.py at ``layers``
    layers, attention and hidden dropout ``rate``, seed-0 weights."""
    cfg = _vqa_cfg(dropout=rate)
    cfg.NETWORK.VLBERT.num_hidden_layers = layers
    cfg.TPU.REMAT = remat
    tm = _quiet_build(cfg, "vqa", dtype=torch.float32)
    init_weights(tm, torch.Generator().manual_seed(0))
    return tm


@contextlib.contextmanager
def _layer_calls(tm):
    """Counts the forward runs of each BertLayer (a recompute runs it
    again). Yields the list of counts."""
    calls = [0] * len(tm.vlbert.encoder.layer)
    hooks = [layer.register_forward_pre_hook(
        lambda m, a, i=i: calls.__setitem__(i, calls[i] + 1))
        for i, layer in enumerate(tm.vlbert.encoder.layer)]
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()


def _remat_step(remat, seed=7):
    """One training forward inside ``dropout_seeds`` and its backward
    after the block has exited, as ``make_train_step`` runs them: (loss,
    {name: grad}, the site counter at the end of the forward, layer
    runs)."""
    tm = _remat_model(remat).train()
    inputs, label = _vqa_batch()
    args = [None if a is None else torch.from_numpy(np.asarray(a))
            for a in inputs + (label,)]
    with _layer_calls(tm) as calls:
        with t_dropout.dropout_seeds(seed):
            _, loss = tm(*args)
            sites = t_dropout.site_state()[1]
        assert t_dropout.site_state() == (None, 0)
        loss.backward()
    return (loss.detach(), {n: p.grad for n, p in tm.named_parameters()
                            if p.grad is not None}, sites, calls)


def test_remat_step_equals_the_unrolled_step_bit_for_bit():
    """3 layers, attention and hidden dropout 0.1: the same loss and every
    gradient bit for bit, the same number of dropout sites drawn, and each
    checkpointed layer ran twice (its forward and the recompute inside
    backward())."""
    loss0, g0, sites0, calls0 = _remat_step(False)
    loss1, g1, sites1, calls1 = _remat_step(True)
    assert calls0 == [1, 1, 1] and calls1 == [2, 2, 2]
    # the model's sites (3 a layer and those around the encoder), drawn
    # in the forward only
    assert sites0 == sites1 > 3 * 3
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys() and len(g0) > 0
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    # and the masks are live: another step seed gives other gradients
    loss2, g2, _, _ = _remat_step(True, seed=8)
    assert not torch.equal(loss0, loss2)


def test_a_recompute_without_the_seed_replay_raises(monkeypatch):
    """The replay is what lets backward() recompute a layer after the
    ``dropout_seeds`` block has exited: without it the recompute draws
    from no seed."""
    monkeypatch.setattr(t_bert, "replay_sites",
                        lambda state: contextlib.nullcontext())
    with pytest.raises(RuntimeError, match="needs a seed"):
        _remat_step(True)


def test_replay_sites_restores_the_outer_state_and_can_rerun():
    with t_dropout.dropout_seeds(5):
        t_dropout.next_site_seed()
        state = t_dropout.site_state()
        first = [t_dropout.next_site_seed() for _ in range(3)]
        outer = t_dropout.site_state()
        replay = t_dropout.replay_sites(state)
        for _ in range(2):                 # a backward with retain_graph
            with replay:
                assert [t_dropout.next_site_seed()
                        for _ in range(3)] == first
            assert t_dropout.site_state() == outer
    with replay:
        assert t_dropout.next_site_seed() == first[0]
    assert t_dropout.site_state() == (None, 0)


@pytest.mark.parametrize("mode", ["eval", "no_grad", "probs"])
def test_remat_takes_the_unrolled_path(mode, monkeypatch):
    """Eval, a forward without grad and the attention-probs path run each
    layer once, without the checkpoint."""
    def refuse(*a, **kw):
        raise AssertionError("checkpointed")

    monkeypatch.setattr(t_bert, "checkpoint", refuse)
    tm = _remat_model(True)
    enc = tm.vlbert.encoder
    x = torch.randn(2, 6, 32, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    bias = torch.zeros(2, 1, 1, 6)
    ctx = torch.no_grad() if mode == "no_grad" else contextlib.nullcontext()
    enc.train(mode != "eval")
    with _layer_calls(tm) as calls, t_dropout.dropout_seeds(0), ctx:
        out = enc(x, bias, output_attention_probs=mode == "probs")
    assert calls == [1, 1, 1]
    if mode == "probs":
        out, probs = out
        assert len(probs) == 3 and probs[0].shape == (2, 2, 6, 6)
    assert out.shape == (2, 6, 32)


def test_remat_eval_logits_match_jax():
    """JAX's build_module(..., remat=True) and the port's under TPU.REMAT
    give the same eval logits."""
    cfg = _vqa_cfg(dropout=0.1)
    cfg.NETWORK.VLBERT.num_hidden_layers = 3
    cfg.TPU.REMAT = True
    jm = j_build_module(cfg, "vqa", dtype=jnp.float32, remat=True)
    inputs, _ = _vqa_batch()
    jargs = [None if a is None else jnp.asarray(a) for a in inputs]
    v = jm.init(jax.random.PRNGKey(0), *jargs, train=False)
    want = jm.apply(v, *jargs, train=False)["label_logits"]
    tm = _quiet_build(cfg, "vqa", dtype=torch.float32)
    assert tm.vlbert.encoder.remat
    tm.load_state_dict(state_dict_from_jax(_flat(v), tm))
    with torch.no_grad():
        got = tm.eval()(*[None if a is None else torch.from_numpy(a)
                          for a in inputs])["label_logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_train_net_with_remat_gives_the_same_losses(tmp_path):
    """engine.train on the tiny fixture of tests/test_entrypoints.py, 2
    layers with their default dropout 0.1: TPU.REMAT true and false give
    the same losses, step for step."""
    from vlbert_tpu_torch.engine.train import train_net

    data_dir, vocab_dir = _write_vqa_fixture(tmp_path)
    losses = {}
    for remat in (False, True):
        cfg = _tiny_vqa_cfg(tmp_path / str(remat), data_dir, vocab_dir)
        cfg.NETWORK.VLBERT.num_hidden_layers = 2
        cfg.DATASET.PRECOMPUTED_FEAT_DIM = 32
        cfg.TPU.PROCESS_WORKERS = False
        cfg.TRAIN.END_EPOCH, cfg.TRAIN.WARMUP = 1, False
        cfg.TPU.REMAT = remat
        cfg.RNG_SEED = 0
        args = types.SimpleNamespace(model_dir=cfg.OUTPUT_PATH, device="cpu")
        model, history = train_net(args, cfg, "vqa")
        assert model.vlbert.encoder.remat is remat
        losses[remat] = history["loss"]
    assert len(losses[False]) >= 2 and np.isfinite(losses[False]).all()
    assert losses[True] == losses[False]


def test_build_module_warns_for_attn_remat_and_scan_layers():
    cfg = _vqa_cfg()
    with pytest.warns(UserWarning, match="ignored") as rec:
        build_module(cfg, "vqa", dtype=torch.float32, device="meta")
    message = str(rec[0].message)
    assert "TPU.ATTN_REMAT" in message and "TPU.SCAN_LAYERS" in message
    assert "K3/K4 keep only q, k, v" in message
