"""float16 training on the port (TRAIN.FP16 with TPU.FP16_PARITY_MODE,
TPU.COMPUTE_DTYPE float16) against the JAX package on the CPU.

The dtype and loss-scale policy is held to the JAX package's own code:
its train_net runs up to its build_module, which reports the dtype it was
asked for, and its make_train_step reads the scale (with the shipped
configs' 'dynamic' it raises exactly where it would use one). The static
loss scale is exact in fp32: a scaled fp32 step equals the unscaled one
bit for bit in the port, and JAX's scaled step at the bar of
tests/test_training.py's test_fp16_static_loss_scale_parity.

The fp16 steps run the tiny models of tests/test_torch_train.py (VQA from
precomputed features) and tests/test_torch_vcr.py (VCR from pixels:
ResNet-50, ROIAlign and its dF by the plain versions), with dropout on:
every dropout site, hidden and attention probs, takes the same explicit
uint16 bits on both sides, drawn from a seed in forward order (JAX's
'bits16' rule). fp16 rounds at other places in the two packages (XLA
rounds P to fp16 before P V and keeps fp16 between ops that the port runs
in fp32, or the reverse), each a few fp16 steps (2**-11 relative). VQA is
held to FP16_TOL: the loss to 1e-3 relative, the logits to 5e-3 of their
largest, each gradient leaf to 2e-2 of its largest element (they read
2.5e-5, 2.2e-4 and 5e-3). The VCR step is held through its fp16 error
against fp32 (see its test).
"""

import contextlib
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_train as tt
import tests.test_torch_vcr as tv
import vlbert_tpu.engine.train as j_train
import vlbert_tpu.models.bert as j_bert
import vlbert_tpu.ops.dropout as j_dropout
from tests.test_entrypoints import _tiny_vqa_cfg, _write_vqa_fixture
from vlbert_tpu.models.task_modules import build_module as j_build_module
from vlbert_tpu.training import metrics as j_metrics
from chip_smoke import calibrate_frozen_bn
from vlbert_tpu.training.checkpoint import flatten_params
from vlbert_tpu.training.checkpoint import partial_load as j_partial_load
from vlbert_tpu.training.convert import convert_state_dict
from vlbert_tpu.training.loop import create_train_state
from vlbert_tpu.training.loop import make_train_step as j_make_train_step
from vlbert_tpu.training.optim import trainable_mask as j_trainable_mask
from vlbert_tpu_torch import ops
from vlbert_tpu_torch.engine import test as t_test
from vlbert_tpu_torch.engine import train as t_train
from vlbert_tpu_torch.models import bert as t_bert
from vlbert_tpu_torch.models import layers as t_layers
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.ops import attention as tattn
from vlbert_tpu_torch.ops import dropout as tdrop
from vlbert_tpu_torch.training import metrics as t_metrics
from vlbert_tpu_torch.training.convert import state_dict_from_jax
from vlbert_tpu_torch.training.loop import loss_scale, make_train_step
from vlbert_tpu_torch.training.optim import Optimizer, apply_trainable_mask

FP16_TOL = {"loss": 1e-3, "logits": 5e-3, "leaf": 2e-2}
# the key biases' gradient is zero in exact arithmetic (softmax ignores a
# per-row shift): both sides give them only rounding noise, ~1e-7 of the
# largest gradient element, so a leaf's scale is floored at this much of it
LEAF_FLOOR = 1e-4


class _Built(Exception):
    """Raised by a patched build_module: carries the dtype asked for."""


def _stop_at_build(*args, dtype=None, **kw):
    raise _Built(dtype)


# -------------------------------------------------------------- the policy

@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return _write_vqa_fixture(tmp_path_factory.mktemp("fp16"))


def _policy_cfg(fixture, tmp, fp16, parity, compute, scale):
    data_dir, vocab_dir = fixture
    cfg = _tiny_vqa_cfg(tmp, data_dir, vocab_dir)
    cfg.TRAIN.FP16 = fp16
    cfg.TPU.FP16_PARITY_MODE = parity
    cfg.TPU.COMPUTE_DTYPE = compute
    cfg.TRAIN.FP16_LOSS_SCALE = scale
    return cfg


def _jax_dtype(cfg, tmp, monkeypatch):
    """The dtype JAX's train_net builds its model in for ``cfg``."""
    monkeypatch.setattr(j_train, "build_module", _stop_at_build)
    args = types.SimpleNamespace(model_dir=str(tmp / "jax_out"))
    with _threefry(), pytest.raises(_Built) as e:
        j_train.train_net(args, cfg, "vqa")
    return {jnp.float16: "float16", jnp.bfloat16: "bfloat16",
            jnp.float32: "float32"}[e.value.args[0]]


def _jax_scale_used(cfg):
    """Whether JAX's train step multiplies the loss by a scale: with the
    scale 'dynamic' its float() raises exactly then."""
    c = cfg.clone()
    c.TRAIN.FP16_LOSS_SCALE = "dynamic"
    try:
        j_make_train_step(None, None, "vqa", c)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("compute", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("fp16", [False, True])
def test_dtype_and_scale_policy_match_jax(vocab, tmp_path, monkeypatch,
                                          fp16, parity, compute):
    """compute_policy against JAX's train_net and train step, over every
    TRAIN.FP16 x FP16_PARITY_MODE x COMPUTE_DTYPE; and the port's
    train_net builds its model in that dtype."""
    cfg = _policy_cfg(vocab, tmp_path, fp16, parity, compute, 128.0)
    want = _jax_dtype(cfg, tmp_path, monkeypatch)
    dtype, scale = t_train.compute_policy(cfg)
    assert str(dtype)[6:] == want
    assert scale == (128.0 if _jax_scale_used(cfg) else 1.0)
    assert scale == loss_scale(cfg)
    monkeypatch.setattr(t_train, "build_module", _stop_at_build)
    args = types.SimpleNamespace(model_dir=str(tmp_path / "out"),
                                 device="cpu")
    with pytest.raises(_Built) as e:
        t_train.train_net(args, cfg, "vqa")
    assert e.value.args[0] == dtype


def test_float16_sets_the_gemm_reduction_to_fp32(vocab, tmp_path,
                                                 monkeypatch):
    """Under float16 compute train_net turns off cuBLAS's fp16 reduction
    in split-K GEMMs (XLA's fp16 dots accumulate in fp32) and says so."""
    cfg = _policy_cfg(vocab, tmp_path, True, True, "bfloat16", 128.0)
    monkeypatch.setattr(t_train, "build_module", _stop_at_build)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_fp16_reduced_precision_reduction", True)
    args = types.SimpleNamespace(model_dir=str(tmp_path / "out"),
                                 device="cpu")
    with pytest.raises(_Built):
        t_train.train_net(args, cfg, "vqa")
    assert not torch.backends.cuda.matmul \
        .allow_fp16_reduced_precision_reduction
    log = t_train.train_output_path(cfg, args, "vqa") + "/train_rank0.log"
    with open(log) as f:
        assert "float16 compute, static loss scale 128" in f.read()


def test_inference_builds_fp32_under_float16(vocab, tmp_path, monkeypatch):
    """The test driver under COMPUTE_DTYPE float16 builds its model in
    fp32, as JAX's setup_inference does."""
    import vlbert_tpu.engine.test as j_test

    cfg = _policy_cfg(vocab, tmp_path, False, False, "float16", 128.0)
    monkeypatch.setattr(j_test, "make_mesh", lambda *a, **kw: None)
    monkeypatch.setattr(j_test, "build_module", _stop_at_build)
    with pytest.raises(_Built) as e:
        j_test.setup_inference(cfg, "vqa", "none")
    assert e.value.args[0] == jnp.float32
    monkeypatch.setattr(t_test, "build_module", _stop_at_build)
    with pytest.raises(_Built) as e:
        t_test.setup_inference(cfg, "vqa", "none", device="cpu")
    assert e.value.args[0] == torch.float32


def test_dynamic_loss_scale_raises_in_both_packages(vocab, tmp_path,
                                                    monkeypatch):
    """The shipped fp16 configs' 'dynamic' scale under the parity mode:
    JAX's train step raises ValueError on it; the port raises ValueError
    naming TRAIN.FP16_LOSS_SCALE before any model is built, from train_net
    and from make_train_step. Outside the parity mode it is never read."""
    cfg = _policy_cfg(vocab, tmp_path, True, True, "bfloat16", "dynamic")
    with pytest.raises(ValueError):
        j_make_train_step(None, None, "vqa", cfg)
    built = []
    monkeypatch.setattr(t_train, "build_module",
                        lambda *a, **kw: built.append(1))
    args = types.SimpleNamespace(model_dir=str(tmp_path / "out"),
                                 device="cpu")
    with pytest.raises(ValueError, match="TRAIN.FP16_LOSS_SCALE 'dynamic'"):
        t_train.train_net(args, cfg, "vqa")
    assert not built
    with pytest.raises(ValueError, match="FP16_LOSS_SCALE"):
        make_train_step(None, types.SimpleNamespace(params=[]), "vqa", cfg)
    cfg.TPU.FP16_PARITY_MODE = False
    assert t_train.compute_policy(cfg) == (torch.bfloat16, 1.0)


# ------------------------------------------------- the scale in fp32 steps

def _scaled(cfg, scale=128.0):
    c = cfg.clone()
    c.TRAIN.FP16 = True
    c.TPU.FP16_PARITY_MODE = True
    c.TRAIN.FP16_LOSS_SCALE = scale
    return c


@pytest.mark.parametrize("accum", [1, 2])
def test_scaled_fp32_step_equals_the_unscaled_step_bit_for_bit(
        monkeypatch, accum):
    """Two fp32 optimizer steps (AdamW) with the static scale 128 and with
    none, from the same weights, batch and seeds (dropout on): the same
    losses, grad norms and parameters, bit for bit; and a scaled SGD step
    against JAX's scaled step at rtol 1e-5 on the loss and 2e-4 / atol
    1e-7 on the parameters (tests/test_training.py's bar)."""
    cfg = tt._step_cfg()
    _, jm, v = tt._jax_vqa("2fc")
    inputs, label = tt._batch(3)
    batch = tuple(map(tt._torch, (*inputs, label)))
    drop = cfg.clone()
    drop.TRAIN.GRAD_ACCUMULATE_STEPS = accum
    drop.TRAIN.BATCH_IMAGES = tt.B // accum
    for k in ("hidden_dropout_prob", "attention_probs_dropout_prob"):
        drop.NETWORK.VLBERT[k] = 0.1
    drop.NETWORK.CLASSIFIER_DROPOUT = 0.1
    runs = []
    for c in (drop, _scaled(drop)):
        tm = tt._port_model(c)
        tm.load_state_dict(state_dict_from_jax(tt._flat(v["params"]), tm))
        opt = Optimizer(c, tm, 4)
        step = make_train_step(tm, opt, "vqa", c, accum)
        out = [step(batch, i) for i in range(2)]
        runs.append(([float(x[0]) for x in out],
                     [float(x[1]["grad_total_norm"][0]) for x in out],
                     tm.state_dict()))
    (l1, n1, p1), (l2, n2, p2) = runs
    assert l1 == l2 and n1 == n2
    assert all(torch.equal(p1[k], p2[k]) for k in p1)

    if accum > 1:
        return
    # JAX's scaled step, dropout 0 on both sides, under SGD: its update is
    # linear in the gradient (AdamW's first step divides by |g| + eps and
    # moves an element whose |g| lies near eps by up to lr)
    sc = _scaled(tt._step_cfg("SGD"))
    tm = tt._port_model(sc)
    tm.load_state_dict(state_dict_from_jax(tt._flat(v["params"]), tm))
    tt._no_obj_dropout(tm, monkeypatch)
    state, tx, _, _ = create_train_state(jm, None, sc, 4, params=v)
    jstate, jloss, _ = jax.jit(j_make_train_step(jm, tx, "vqa", sc))(
        state, tuple(map(tt._jnp, (*inputs, label))), jax.random.PRNGKey(0))
    loss, _ = make_train_step(tm, Optimizer(sc, tm, 4), "vqa", sc)(batch, 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = tt._to_jax_names(tm.state_dict())
    for k, w in tt._flat(jstate.params["params"]).items():
        np.testing.assert_allclose(got[k], w, rtol=2e-4, atol=1e-7,
                                   err_msg=k)


# ------------------------------------------- fp16 steps, explicit dropout

class _Bits:
    """uint16 dropout bits for the n-th dropout call in forward order,
    from numpy with a seed; the shapes asked for are recorded."""

    def __init__(self, seed):
        self.seed, self.shapes = seed, []

    def __call__(self, shape):
        self.shapes.append(tuple(shape))
        rng = np.random.default_rng(self.seed + len(self.shapes))
        return rng.integers(0, 65536, shape).astype(np.int32)


def _jax_explicit_dropout(monkeypatch, source):
    """The JAX package's dropout (hidden sites and the attention probs of
    its XLA core) on the bits of ``source``: its 'bits16' rule."""
    def apply(x, key, rate, impl=None):
        rate = float(rate)
        if rate == 0.0:
            return x
        b = jnp.asarray(source(x.shape).astype(np.uint16))
        keep = b >= jnp.uint16(int(round(rate * 65536.0)))
        scale = jnp.asarray(1.0 / (1.0 - rate), x.dtype)
        return jax.lax.select(keep, x * scale, jnp.zeros_like(x))

    monkeypatch.setattr(j_dropout, "dropout_apply", apply)
    monkeypatch.setattr(j_bert, "dropout_apply", apply)


def _port_explicit_dropout(monkeypatch, source):
    """The port's dropout sites and attention probs on the bits of
    ``source`` (explicit-bits mode of the plain versions)."""
    def hidden(x, rate, seed=None, bits=None):
        return tdrop.plain_dropout(x, rate, bits=torch.from_numpy(
            source(x.shape)))

    def attention(q, k, v, bias, rate, seed=None, bits=None):
        B, L, H, _ = q.shape
        return tattn.plain_attention_dropout(
            q, k, v, bias, rate,
            bits=torch.from_numpy(source((B, H, L, L))))

    monkeypatch.setattr(tdrop, "hw_dropout", hidden)
    monkeypatch.setattr(t_bert, "fused_attention_dropout", attention)


def _fp16_cfg(cfg, rate=0.1):
    c = cfg.clone()
    c.NETWORK.VLBERT.hidden_dropout_prob = rate
    c.NETWORK.VLBERT.attention_probs_dropout_prob = rate
    c.NETWORK.CLASSIFIER_DROPOUT = rate
    return _scaled(c)


def _jax_fp16_step(cfg, task, v, inputs, labels, scale):
    """JAX's float16 loss, outputs and unscaled gradients: its train
    step's one_micro (loss x scale, value_and_grad, grads x 1/scale) on
    build_module(..., dtype=jnp.float16)."""
    jm = j_build_module(cfg, task, dtype=jnp.float16)

    def lf(p):
        out, loss = jm.apply({**v, "params": p}, *map(tt._jnp, inputs),
                             *map(jnp.asarray, labels), train=True,
                             rngs={"dropout": jax.random.PRNGKey(1)})
        return loss * scale, out

    (loss, out), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        v["params"])
    inv = 1.0 / scale
    return (float(loss * inv), out,
            jax.tree_util.tree_map(lambda g: g * inv, grads), jm)


def _port_fp16_step(cfg, task, v, inputs, labels, scale,
                    dtype=torch.float16):
    """The port's float16 (``dtype``) loss, outputs and unscaled
    gradients: the train step's loss x scale backward, then / scale."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the ignored TPU.* knobs
        tm = build_module(cfg, task, dtype=dtype)
    flat = {k: np.asarray(a) for k, a in
            flatten_params(jax.device_get(v["params"])).items()}
    tm.load_state_dict(state_dict_from_jax(flat, tm))
    apply_trainable_mask(tm, cfg)
    with tdrop.dropout_seeds(0):
        out, loss = tm.train()(*map(tt._torch, inputs),
                               *map(tt._torch, labels))
    (loss * scale).backward()
    return float(loss.detach()), out, {
        n: None if p.grad is None else p.grad / scale
        for n, p in tm.named_parameters()}, tm


def _assert_fp16_step(jres, tres, out_key, cfg):
    """The loss, ``out_key`` and every gradient leaf within FP16_TOL: JAX's
    gradients masked by its trainable mask, as its train step masks them;
    the port's frozen leaves have none. Returns {leaf: its gap}."""
    jloss, jout, jgrads, _ = jres
    tloss, tout, tgrads, tm = tres
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=FP16_TOL["loss"])
    a = tout[out_key].float().detach().numpy()
    b = np.asarray(jout[out_key], np.float32)
    assert np.abs(a - b).max() <= FP16_TOL["logits"] * np.abs(b).max()
    mask = j_trainable_mask(jgrads, cfg)
    jgrads = jax.tree_util.tree_map(
        lambda g, m: g if m else jnp.zeros_like(g), jgrads, mask)
    sd = state_dict_from_jax({k: np.asarray(g, np.float32) for k, g in
                              flatten_params(jax.device_get(jgrads))
                              .items()}, tm)
    want = {n: np.asarray(sd[n], np.float32) for n in tgrads}
    floor = LEAF_FLOOR * max(np.abs(w).max() for w in want.values())
    worst = {}
    for name, g in tgrads.items():
        if g is None:
            assert not want[name].any(), f"JAX trains the frozen {name}"
            continue
        got = g.float().numpy()
        assert np.isfinite(got).all(), name
        worst[name] = np.abs(got - want[name]).max() \
            / max(np.abs(want[name]).max(), floor)
        assert worst[name] <= FP16_TOL["leaf"], (name, worst[name])
    return worst


def test_fp16_vqa_step_matches_jax(monkeypatch):
    """A float16 VQA training step from precomputed features with the
    static scale, every dropout on the same explicit bits: the loss, the
    logits and every gradient leaf against JAX's build_module(...,
    dtype=float16) step, within FP16_TOL."""
    cfg = _fp16_cfg(tt._cfg("2fc"))
    _, _, v = tt._jax_vqa("2fc")
    inputs, label = tt._batch(5)
    jbits, tbits = _Bits(70), _Bits(70)
    _jax_explicit_dropout(monkeypatch, jbits)
    jres = _jax_fp16_step(cfg, "vqa", v, inputs, (label,), 128.0)
    _port_explicit_dropout(monkeypatch, tbits)
    tres = _port_fp16_step(cfg, "vqa", v, inputs, (label,), 128.0)
    assert jbits.shapes == tbits.shapes and len(tbits.shapes) >= 7
    _assert_fp16_step(jres, tres, "label_logits", cfg)


def _conv_accumulates_in_fp32(monkeypatch):
    """The port's fp16 convolutions on the CPU as cuDNN runs them on the
    card and XLA on the CPU: fp16 operands, fp32 sums, each result rounded
    to fp16 once (forward and both gradients). This CPU's own fp16
    convolution backward takes seconds a call."""
    real = t_layers.Conv2d._conv_forward

    def conv(self, x, w, b):
        if x.dtype != torch.float16:
            return real(self, x, w, b)
        return real(self, x.float(), w.float(), b).half()

    monkeypatch.setattr(t_layers.Conv2d, "_conv_forward", conv)


def _all_boxes_live(inputs):
    """tests/test_torch_vcr.py's batch with every box slot live: a text
    tag on a padded slot gathers its all-zero object row into the visual
    LayerNorm, whose fp16 input gradient there is 1/sqrt(1e-12) times the
    incoming one and overflows in both packages alike (fp32 is fine)."""
    inputs = list(inputs)
    inputs[4] = np.ones_like(inputs[4])
    return tuple(inputs)


def _calibrated(cfg, v, inputs, label):
    """JAX variables ``v`` with each frozen BN's statistics set by
    chip_smoke.calibrate_frozen_bn from one fp32 forward of the batch in
    the port: the random ResNet's activations otherwise grow past fp16's
    range, where both packages' fp16 steps give NaN gradients alike."""
    tm = tv._port(cfg, v)
    calibrate_frozen_bn(tm, (*map(tt._torch, inputs), tt._torch(label)))
    bn = {k: t for k, t in tm.state_dict().items()
          if k.endswith(("running_mean", "running_var"))}
    flat, skipped = convert_state_dict(bn)
    params, loaded = j_partial_load(v["params"], flat)
    assert not skipped and len(loaded) == len(bn) > 0
    return {**v, "params": params}


def _rel(a, b):
    """Relative L2 distance of two lists of arrays."""
    a = np.concatenate([np.ravel(x) for x in a])
    b = np.concatenate([np.ravel(x) for x in b])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# VCR from pixels, the leaf groups compared and the parameter prefixes
VCR_GROUPS = {"vlbert": "vlbert.",
              "stage3": "image_feature_extractor.backbone.layer2.",
              "stage4": "image_feature_extractor.backbone.layer3.",
              "conv5_head":
                  "image_feature_extractor.roi_head_feature_extractor."}


@contextlib.contextmanager
def _threefry():
    """JAX's default PRNG, whatever an earlier test's JAX train_net set
    (it applies TPU.RNG_IMPL process-wide)."""
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", prev)


def _jax_vcr18():
    """tests/test_torch_vcr.py's cnn_top_e2e variant on ResNet-18: JAX
    variables initialised in training mode, and the config."""
    cfg = tv._cfg("Q2A", True, ENABLE_CNN_REG_LOSS=True, CNN_LOSS_TOP=True,
                  IMAGE_NUM_LAYERS=18)
    jm = j_build_module(cfg, "vcr", dtype=jnp.float32)
    inputs, a_label, _ = tv._batch()
    with _threefry():
        v = jax.jit(lambda r, *a: jm.init(r, *a, train=True))(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            *map(tt._jnp, inputs + (a_label,)))
    return cfg, v


def test_fp16_vcr_step_from_pixels_matches_jax(monkeypatch):
    """A float16 VCR Q2A step from pixels (ResNet-18: stages 3-4 and the
    conv5 head train through ROIAlign's plain forward and dF; the CNN
    regularization loss on), the static scale, explicit dropout bits,
    against JAX's float16 step and the port's fp32 step. The loss within
    1e-3 of JAX's; the logits, VL-BERT's gradient (relative L2) and every
    gradient leaf outside the image path (FP16_TOL's leaf bar) within 2e-2
    of JAX's (they read 4e-3). A random ResNet is chaotic: an fp16
    rounding grows about 2x a block, so stages 3-4 and the head's weight
    gradients depart from the fp32 step by 4e-2 to 1e-1 in both packages
    (ResNet-50: 0.3 to 0.8); there the port's relative L2 error against
    the fp32 step may not exceed 1.5x JAX's (with these weights they read
    0.96-1.05x; other random weights gave up to 1.26x). Every gradient is
    finite."""
    cfg, v = _jax_vcr18()
    cfg = _fp16_cfg(cfg)
    inputs, label, _ = tv._batch(seed=3)
    inputs = _all_boxes_live(inputs)
    _conv_accumulates_in_fp32(monkeypatch)
    v = _calibrated(cfg, v, inputs, label)
    jbits, tbits, rbits = _Bits(90), _Bits(90), _Bits(90)
    _jax_explicit_dropout(monkeypatch, jbits)
    jloss, jout, jgrads, _ = _jax_fp16_step(cfg, "vcr", v, inputs, (label,),
                                            128.0)
    _port_explicit_dropout(monkeypatch, tbits)
    tloss, tout, tgrads, tm = _port_fp16_step(cfg, "vcr", v, inputs,
                                              (label,), 128.0)
    _port_explicit_dropout(monkeypatch, rbits)
    _, rout, rgrads, _ = _port_fp16_step(cfg, "vcr", v, inputs, (label,),
                                         128.0, dtype=torch.float32)
    assert jbits.shapes == tbits.shapes == rbits.shapes
    np.testing.assert_allclose(tloss, jloss, rtol=FP16_TOL["loss"])
    mask = j_trainable_mask(jgrads, cfg)
    jgrads = jax.tree_util.tree_map(
        lambda g, m: g if m else jnp.zeros_like(g), jgrads, mask)
    sd = {n: np.asarray(g, np.float32) for n, g in state_dict_from_jax(
        {k: np.asarray(g, np.float32) for k, g in
         flatten_params(jax.device_get(jgrads)).items()}, tm).items()}
    assert all(np.isfinite(g.float().numpy()).all()
               for g in tgrads.values() if g is not None)
    trained = {n: g for n, g in rgrads.items() if g is not None}
    floor = LEAF_FLOOR * max(float(g.abs().max()) for g in trained.values())
    for name, g in trained.items():
        if name.startswith("image_feature_extractor."):
            continue
        gap = np.abs(tgrads[name].float().numpy() - sd[name]).max() \
            / max(np.abs(sd[name]).max(), floor)
        assert gap <= FP16_TOL["leaf"], (name, gap)
    got = {"logits": ([tout["label_logits"].float().detach().numpy()],
                      [np.asarray(jout["label_logits"], np.float32)],
                      [rout["label_logits"].float().detach().numpy()])}
    for group, prefix in VCR_GROUPS.items():
        keys = [n for n in trained if n.startswith(prefix)]
        assert keys, group
        got[group] = ([tgrads[n].float().numpy() for n in keys],
                      [sd[n] for n in keys],
                      [rgrads[n].float().numpy() for n in keys])
    for group, (port16, jax16, fp32) in got.items():
        if group in ("logits", "vlbert"):
            assert _rel(port16, jax16) <= 2e-2, group
        else:
            e_port, e_jax = _rel(port16, fp32), _rel(jax16, fp32)
            assert e_port <= 1.5 * e_jax, (group, e_port, e_jax)


def test_fp16_validation_matches_jax():
    """float16 inference of the trained dtype, as train_net's validation
    runs it: the VQA logits and the validation metrics' (sum, count)
    against JAX's float16 model on the same weights."""
    cfg = tt._cfg("2fc")
    _, _, v = tt._jax_vqa("2fc")
    inputs, label = tt._batch(6)
    jm = j_build_module(cfg, "vqa", dtype=jnp.float16)
    jout = dict(jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        v, *map(tt._jnp, inputs)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = build_module(cfg, "vqa", dtype=torch.float16)
    tm.load_state_dict(state_dict_from_jax(tt._flat(v["params"]), tm))
    with torch.no_grad():
        tout = dict(tm.eval()(*map(tt._torch, inputs)))
    a = tout["label_logits"].float().numpy()
    b = np.asarray(jout["label_logits"], np.float32)
    assert {m.compute_dtype for m in tm.modules()
            if hasattr(m, "compute_dtype")} == {torch.float16}
    assert np.abs(a - b).max() <= FP16_TOL["logits"] * np.abs(b).max()
    jout["label"] = jnp.asarray(label)
    tout["label"] = torch.from_numpy(label)
    want = j_metrics.device_metrics("vqa", cfg, jout)
    got = t_metrics.device_metrics("vqa", cfg, tout)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k][0]), float(want[k][0]),
                                   rtol=FP16_TOL["logits"], atol=1e-3,
                                   err_msg=k)
        assert float(got[k][1]) == float(want[k][1])


def test_dtype_codes_are_the_kernels():
    """The wrappers' dtype codes are csrc/common.cuh's DtypeCode values,
    which the entry points switch on."""
    import re

    from vlbert_tpu_torch.kernels import build

    text = (build.CSRC_DIR / "common.cuh").read_text()
    enum = dict(re.findall(r"(k\w+) = (\d)", re.search(
        r"enum DtypeCode \{([^}]*)\}", text).group(1)))
    assert {k: int(v) for k, v in enum.items()} == {
        "kF32": ops.DTYPE_CODES[torch.float32],
        "kBF16": ops.DTYPE_CODES[torch.bfloat16],
        "kF16": ops.DTYPE_CODES[torch.float16]}
