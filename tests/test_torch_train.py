"""The port's VQA training path (vlbert_tpu_torch: ResNetVLBERTForVQA,
losses, optimizer, train step, schedules, converter, train_net) against
the JAX package on the CPU, at tiny width (2 layers, hidden 32, 2 heads)
in fp32.

Each JAX module is initialised by JAX and its params reach the port
through ``state_dict_from_jax``; inputs come from numpy with a seed.
Dropout is off where the two packages are compared (their generators
differ); the JAX FastRCNN's fixed Dropout(0.1) before ``obj_downsample``
is set to 0 on both sides for those tests.
"""

import functools
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlbert_tpu.models.fast_rcnn as j_fast_rcnn
from tests.test_entrypoints import _tiny_vqa_cfg, _write_vqa_fixture
from vlbert_tpu.models.task_modules import build_module as j_build_module
from vlbert_tpu.ops.dropout import Dropout as JDropout
from vlbert_tpu.training.checkpoint import flatten_params
from vlbert_tpu.training.convert import convert_state_dict, fuse_qkv_params
from vlbert_tpu.training.loop import create_train_state
from vlbert_tpu.training.loop import make_train_step as j_make_train_step
from vlbert_tpu.training.optim import make_lr_schedule as j_make_lr_schedule
from vlbert_tpu.utils.config import default_config
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.ops.dropout import dropout_seeds
from vlbert_tpu_torch.training.convert import state_dict_from_jax
from vlbert_tpu_torch.training.loop import make_train_step
from vlbert_tpu_torch.training.optim import Optimizer, make_lr_schedule

# the bar of tests/test_torch_models.py (fp32, dropout off)
TOL = dict(rtol=1e-3, atol=1e-4)
# gradients: fp32 sums in another order, relative to the largest entry
GRAD_RTOL = 1e-4
B, T, O, F, A = 4, 8, 5, 16, 6


def _cfg(kind="2fc", dropout=0.0):
    cfg = default_config("vqa")
    cfg.MODULE = "ResNetVLBERT"
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64
    v.vocab_size = 1050; v.max_position_embeddings = 32
    v.visual_ln = True
    v.visual_scale_text_init = 1.0; v.visual_scale_object_init = 1.0
    v.hidden_dropout_prob = dropout; v.attention_probs_dropout_prob = dropout
    cfg.NETWORK.IMAGE_FINAL_DIM = 32
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = True
    cfg.NETWORK.CLASSIFIER_TYPE = kind
    cfg.NETWORK.CLASSIFIER_HIDDEN_SIZE = 24
    cfg.NETWORK.CLASSIFIER_DROPOUT = dropout
    cfg.DATASET.ANSWER_VOCAB_SIZE = A
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = F
    cfg._world_size = 1
    return cfg


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (B, O, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (B, O, 2)),
                            rng.normal(size=(B, O, F))], -1).astype(np.float32)
    box_mask = np.ones((B, O), bool)
    box_mask[1, 3:] = False
    im_info = np.tile(np.asarray([[100, 90, 1.0, 1.0]], np.float32), (B, 1))
    ids = rng.integers(1000, 1050, (B, T)).astype(np.int32)
    text_mask = np.ones((B, T), bool)
    text_mask[2, 6:] = False
    ans_pos = np.asarray([5, 6, 4, 7], np.int32)
    label = rng.uniform(0, 1, (B, A)).astype(np.float32) \
        * (rng.uniform(size=(B, A)) < 0.4)
    return (None, boxes, box_mask, im_info, ids, np.zeros((B, T), np.int32),
            text_mask, ans_pos), label


def _port_model(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the ignored TPU.* knobs
        return build_module(cfg, "vqa", dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _jax_vqa(kind):
    """(JAX model, its variables) of the tiny VQA config, dropout 0."""
    cfg = _cfg(kind)
    jm = j_build_module(cfg, "vqa", dtype=jnp.float32)
    inputs, _ = _batch()
    v = jm.init(jax.random.PRNGKey(0), *map(_jnp, inputs), train=False)
    return cfg, jm, v


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _flat(tree):
    return {k: np.asarray(a) for k, a in
            flatten_params(jax.device_get(tree)).items()}


def _loaded(kind):
    cfg, jm, v = _jax_vqa(kind)
    tm = _port_model(cfg)
    tm.load_state_dict(state_dict_from_jax(_flat(v["params"]), tm))
    return cfg, jm, v, tm


def _no_obj_dropout(tm, monkeypatch):
    """Dropout(0.1) before obj_downsample is fixed in both packages."""
    monkeypatch.setattr(j_fast_rcnn, "Dropout",
                        lambda rate: JDropout(rate=0.0))
    tm.image_feature_extractor.obj_downsample[0].rate = 0.0


# the reference's mlm head names, as the JAX converter maps them, vs the
# JAX VQA module's names (the port's converter renames these itself)
_MLM = {"final_mlp_transform.dense.": "final_mlp.transform_dense.",
        "final_mlp_fc.": "final_mlp.dense_0."}


def _to_jax_names(sd):
    """Port names -> the JAX tree's (the default VQA config fuses QKV)."""
    flat, skipped = convert_state_dict(sd)
    assert skipped == []
    flat = fuse_qkv_params(flat)
    out = {}
    for k, a in flat.items():
        for old, new in _MLM.items():
            if k.startswith(old):
                k = new + k[len(old):]
        out[k] = a
    return out


@pytest.mark.parametrize("kind", ["1fc", "2fc", "mlm"])
def test_state_dict_from_jax_round_trip(kind):
    cfg, _, v = _jax_vqa(kind)
    flat = _flat(v["params"])
    tm = _port_model(cfg)
    sd = state_dict_from_jax(flat, tm)
    assert sd.keys() == tm.state_dict().keys()
    back = _to_jax_names(sd)
    assert back.keys() == flat.keys()
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


@pytest.mark.parametrize("kind", ["1fc", "2fc", "mlm"])
def test_vqa_eval_logits_match_jax(kind):
    cfg, jm, v, tm = _loaded(kind)
    inputs, _ = _batch(1)
    want = jm.apply(v, *map(_jnp, inputs), train=False)["label_logits"]
    with torch.no_grad():
        got = tm.eval()(*map(_torch, inputs))["label_logits"]
    assert got.dtype == torch.float32 and got.shape == (B, A)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _port_grads(tm):
    sd = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
          for n, p in tm.named_parameters()}
    return _to_jax_names(sd)


def test_train_step_grads_match_jax_at_rate_zero(monkeypatch):
    cfg, jm, v, tm = _loaded("2fc")
    _no_obj_dropout(tm, monkeypatch)
    inputs, label = _batch(2)

    def lf(p):
        _, loss = jm.apply({"params": p}, *map(_jnp, inputs),
                           jnp.asarray(label), train=True,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return loss

    jloss, jgrads = jax.value_and_grad(lf)(v["params"])
    tm.train()
    with dropout_seeds(0):
        outputs, loss = tm(*map(_torch, inputs), _torch(label))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got, want = _port_grads(tm), _flat(jgrads)
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-3)
        assert np.abs(got[k] - w).max() <= GRAD_RTOL * scale, k


def _step_cfg(optimizer="AdamW"):
    cfg = _cfg("2fc")
    t = cfg.TRAIN
    t.BATCH_IMAGES = B
    t.LR = 2.5e-4                   # base LR 2.5e-4 x 4 = 1e-3
    t.LR_SCHEDULE = "triangle"
    t.WARMUP = False
    t.END_EPOCH = 2
    t.WD = 1e-4
    t.CLIP_GRAD_NORM = 1.0
    t.OPTIMIZER = optimizer
    t.LR_MULT = [("final_mlp", 10.0), ("embedding_LayerNorm", 0.5)]
    return cfg


@pytest.mark.parametrize("optimizer", ["AdamW", "Adam", "SGD"])
def test_two_optimizer_steps_match_jax(monkeypatch, optimizer):
    cfg = _step_cfg(optimizer)
    _, jm, v = _jax_vqa("2fc")
    tm = _port_model(cfg)
    tm.load_state_dict(state_dict_from_jax(_flat(v["params"]), tm))
    _no_obj_dropout(tm, monkeypatch)
    inputs, label = _batch(3)
    batch = (*inputs, label)

    state, tx, _, _ = create_train_state(jm, None, cfg, 4, params=v)
    jstep = jax.jit(j_make_train_step(jm, tx, "vqa", cfg))
    opt = Optimizer(cfg, tm, 4)
    step = make_train_step(tm, opt, "vqa", cfg)
    for i in range(2):
        state, jloss, jdm = jstep(state, tuple(map(_jnp, batch)),
                                  jax.random.PRNGKey(i))
        loss, dm = step(tuple(map(_torch, batch)), i)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(dm["grad_total_norm"][0]),
                                   float(jdm["grad_total_norm"][0]),
                                   rtol=1e-4)
    assert opt.count == int(state.step) == 2
    got = _to_jax_names(tm.state_dict())
    for k, w in _flat(state.params["params"]).items():
        # an Adam step moves a weight by ~lr g/(|g|+eps): 1e-5 is 1% of
        # the base LR
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5, err_msg=k)


def test_grad_accumulation_equals_the_full_batch():
    inputs, label = _batch(4)
    batch = tuple(map(_torch, (*inputs, label)))
    params = []
    for accum in (1, 2):
        cfg = _step_cfg()
        # BATCH_IMAGES is the microbatch; the base LR scales with both
        cfg.TRAIN.GRAD_ACCUMULATE_STEPS = accum
        cfg.TRAIN.BATCH_IMAGES = B // accum
        torch.manual_seed(0)
        tm = _port_model(cfg)
        tm.image_feature_extractor.obj_downsample[0].rate = 0.0
        opt = Optimizer(cfg, tm, 4)
        loss, _ = make_train_step(tm, opt, "vqa", cfg, accum)(batch, 7)
        params.append((loss.item(), tm.state_dict()))
    (l1, p1), (l2, p2) = params
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("schedule,warmup,method", [
    ("step", True, "linear"), ("step", True, "constant"),
    ("triangle", True, "linear"), ("triangle", False, "linear"),
    ("plateau", False, "linear")])
def test_lr_schedules_match_jax(schedule, warmup, method):
    cfg = default_config("vqa")
    t = cfg.TRAIN
    t.BATCH_IMAGES, t.GRAD_ACCUMULATE_STEPS, t.LR = 16, 2, 1e-6
    t.LR_SCHEDULE, t.WARMUP, t.WARMUP_METHOD = schedule, warmup, method
    t.WARMUP_STEPS, t.WARMUP_FACTOR = 50, 0.1
    t.LR_STEP, t.LR_FACTOR, t.END_EPOCH = (1.0, 2.5), 0.1, 4
    cfg._world_size = 2
    jsched, jbase = j_make_lr_schedule(cfg, 60)
    sched, base = make_lr_schedule(cfg, 60, world_size=2)
    assert base == pytest.approx(jbase, rel=1e-12)
    for s in (0, 1, 25, 49, 50, 51, 59, 60, 61, 149, 150, 200, 239, 240, 300):
        assert sched(s) == pytest.approx(float(jsched(jnp.asarray(s))),
                                         rel=1e-5, abs=1e-12), s


def test_plateau_detector_matches_jax():
    from vlbert_tpu.training.optim import ReduceLROnPlateau as JPlateau
    from vlbert_tpu_torch.training.optim import ReduceLROnPlateau

    a, b = JPlateau(factor=0.1), ReduceLROnPlateau(factor=0.1)
    for v in (0.1, 0.2, 0.2, 0.19, 0.2, 0.2, 0.2, 0.2, 0.3, 0.3, 0.3, 0.3):
        assert b.step(v) == a.step(v)
    assert b.scale < 1.0


def test_train_net_end_to_end(tmp_path):
    """train_net on the tiny fixture of tests/test_entrypoints.py: two
    epochs, the loss falls, validation SoftAcc is logged, a checkpoint per
    epoch and the best are saved, and --do-test scores the best."""
    from vlbert_tpu.training.convert import load_torch_or_native_checkpoint
    from vlbert_tpu_torch.engine.train import train_net

    data_dir, vocab_dir = _write_vqa_fixture(tmp_path)
    cfg = _tiny_vqa_cfg(tmp_path, data_dir, vocab_dir)
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = 32
    cfg.TPU.PROCESS_WORKERS = False
    cfg.TRAIN.LR, cfg.TRAIN.WARMUP = 1e-3, False
    cfg.RNG_SEED = 0
    args = types.SimpleNamespace(model_dir=str(tmp_path / "out"),
                                 device="cpu", do_test=True, ckpt="",
                                 result_path=str(tmp_path / "res"),
                                 result_name="tiny")
    model, history = train_net(args, cfg, "vqa")
    loss = history["loss"]
    assert len(loss) == 16 and len(history["val"]) == 2
    assert np.isfinite(loss).all() and np.mean(loss[-4:]) < np.mean(loss[:4])
    assert all("SoftAcc" in v for v in history["val"])
    out = os.path.join(cfg.OUTPUT_PATH, "vqa_train")
    with open(os.path.join(out, "train_rank0.log")) as f:
        log = f.read()
    assert "val: {'SoftAcc'" in log and "saved checkpoint" in log
    assert {"tiny-0000.model", "tiny-0001.model", "tiny-best.model"} \
        <= set(os.listdir(out))
    # the JAX package reads the port's checkpoint as a torch file
    flat = load_torch_or_native_checkpoint(os.path.join(out,
                                                        "tiny-0001.model"))
    assert len(flat) == len(model.state_dict())
    assert len(history["test"]) == 4
    assert os.path.exists(tmp_path / "res" / "tiny_vqa2_test.json")


def test_train_net_refuses_what_is_not_ported(tmp_path):
    from vlbert_tpu_torch.engine.train import train_net

    data_dir, vocab_dir = _write_vqa_fixture(tmp_path)
    cfg = _tiny_vqa_cfg(tmp_path, data_dir, vocab_dir)
    cfg.TPU.PROCESS_WORKERS = False
    args = types.SimpleNamespace(model_dir="", device="cpu")
    # a JAX-native (flax msgpack) checkpoint needs flax
    native = tmp_path / "vl-bert.model"
    native.write_bytes(b"\x82\xa6params\x80\xa4step\x00")
    cfg.NETWORK.PARTIAL_PRETRAIN = str(native)
    with pytest.raises(ValueError, match="'native'"):
        train_net(args, cfg, "vqa")
    cfg.NETWORK.PARTIAL_PRETRAIN = ""
    # what the reference refuses too, and a dataset no package has
    cfg.NETWORK.FOR_MASK_VL_MODELING_PRETRAIN = True
    with pytest.raises(NotImplementedError,
                       match="FOR_MASK_VL_MODELING_PRETRAIN"):
        train_net(args, cfg, "vqa")
    cfg.NETWORK.FOR_MASK_VL_MODELING_PRETRAIN = False
    cfg.DATASET.DATASET = "no_such_dataset"
    with pytest.raises(ValueError, match="unknown dataset"):
        train_net(args, cfg, "vqa")
    # VCR trains from pixels on the card (K1b); without a card the device
    # check refuses before anything is built or loaded: no CPU fallback
    cfg.DATASET.DATASET = "vcr"
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = False
    args.device = "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda is not available"):
            train_net(args, cfg, "vcr")


def test_fp16_parity_mode_is_refused(tmp_path):
    """No longer refused: TRAIN.FP16 with TPU.FP16_PARITY_MODE trains in
    float16 with the static loss scale, as the JAX package does (on the
    CPU through the plain versions): the tiny fixture's two epochs run,
    the model computes in float16 and the loss falls. TRAIN.FP16 alone
    trains in bfloat16."""
    from vlbert_tpu_torch.engine.train import compute_policy, train_net

    data_dir, vocab_dir = _write_vqa_fixture(tmp_path)
    cfg = _tiny_vqa_cfg(tmp_path, data_dir, vocab_dir)
    cfg.DATASET.PRECOMPUTED_FEAT_DIM = 32
    cfg.TPU.PROCESS_WORKERS = False
    cfg.TRAIN.LR, cfg.TRAIN.WARMUP = 1e-3, False
    cfg.RNG_SEED = 0
    cfg.TRAIN.FP16 = True
    assert compute_policy(cfg) == (torch.bfloat16, 1.0)
    cfg.TPU.FP16_PARITY_MODE = True
    cfg.TRAIN.FP16_LOSS_SCALE = 128.0
    assert compute_policy(cfg) == (torch.float16, 128.0)
    args = types.SimpleNamespace(model_dir="", device="cpu")
    model, history = train_net(args, cfg, "vqa")
    assert {m.compute_dtype for m in model.modules()
            if hasattr(m, "compute_dtype")} == {torch.float16}
    loss = history["loss"]
    assert len(loss) == 16 and np.isfinite(loss).all()
    assert np.mean(loss[-4:]) < np.mean(loss[:4])


def test_compute_dtype_float16_is_refused(tmp_path, monkeypatch):
    """No longer refused: TPU.COMPUTE_DTYPE float16 builds the model in
    float16 with no loss scale, as the JAX package does (it trained in
    fp32 unannounced before it was refused). Under TRAIN.FP16 without the
    parity mode both packages take bfloat16; float32 stays float32."""
    import vlbert_tpu_torch.engine.train as t_train

    data_dir, vocab_dir = _write_vqa_fixture(tmp_path)
    cfg = _tiny_vqa_cfg(tmp_path, data_dir, vocab_dir)
    cfg.TPU.COMPUTE_DTYPE = "float16"
    args = types.SimpleNamespace(model_dir="", device="cpu")
    built = []

    class Built(Exception):
        pass

    def stop(*a, dtype=None, **kw):
        built.append(dtype)
        raise Built

    monkeypatch.setattr(t_train, "build_module", stop)
    with pytest.raises(Built):
        t_train.train_net(args, cfg, "vqa")
    assert built == [torch.float16]
    assert t_train.compute_policy(cfg) == (torch.float16, 1.0)
    cfg.TRAIN.FP16 = True
    assert t_train.compute_policy(cfg) == (torch.bfloat16, 1.0)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.FP16 = False
    assert t_train.compute_policy(cfg) == (torch.float32, 1.0)
