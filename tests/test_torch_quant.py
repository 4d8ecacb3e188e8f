"""The port's weight-only int8 (vlbert_tpu_torch/ops/quant.py, the int8
state of models/layers.py, engine/serve.py's ``quantize="int8"``, tools/
int8_accuracy_torch.py) against the JAX package's on the CPU.

q and scale are held bit for bit after the layout transpose, the set of
quantized weights to JAX's quantized leaves through the converter's name
rules, and the int8 servers to JAX's int8 servers on the same weights in
fp32 at rtol 1e-3 / atol 1e-4. The tiny models have H = 32, so every
``min_size`` here lies outside (H^2, 3 H^2], where JAX's fused [H, 3H]
QKV kernel and the port's separate q, k and v select alike.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_infer import (ANSWERS, TinyTok, _queries,
                                    _vqa_server_cfg)
from tests.test_torch_serve import _tiny_cfg
from tests.test_torch_train import TOL
from vlbert_tpu.engine.serve import RefCOCOServer as JaxRefCOCOServer
from vlbert_tpu.engine.serve import VQAServer as JaxVQAServer
from vlbert_tpu.models.task_modules import build_module as j_build_module
from vlbert_tpu.ops import quant as j_quant
from vlbert_tpu.training.checkpoint import flatten_params
from vlbert_tpu_torch.engine.serve import RefCOCOServer, VQAServer
from vlbert_tpu_torch.models.layers import Conv2d, Linear
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.ops import quant
from vlbert_tpu_torch.training.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")

# (JAX layout, the permutation that gives the port's)
LAYOUTS = {"dense": ((96, 48), (1, 0)),
           "conv": ((3, 3, 16, 24), (3, 2, 0, 1)),
           "conv1x1": ((1, 1, 64, 32), (3, 2, 0, 1))}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_quantize_leaf_is_bit_identical_to_jax(layout):
    shape, perm = LAYOUTS[layout]
    rng = np.random.default_rng(1)
    w = (rng.normal(size=shape) * rng.uniform(0.01, 3, shape[-1])) \
        .astype(np.float32)
    w[..., 2] = 0.0                          # an all-zero channel: 1e-12
    node = j_quant.quantize_leaf(w)
    q, scale = quant.quantize_leaf(w.transpose(perm))
    assert q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(q, node[j_quant._Q8].transpose(perm))
    np.testing.assert_array_equal(scale,
                                  node[j_quant._Q8_SCALE].transpose(perm))
    assert scale.shape == (shape[-1],) + (1,) * (len(shape) - 1)


def _jax_refcoco(rng):
    """JAX RefCOCO+ server, its params and a query (the tiny ResNet-50
    end-to-end model of tests/test_torch_serve.py)."""
    cfg = _tiny_cfg()
    jm = j_build_module(cfg, "refcoco", dtype=jnp.float32)
    img = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    cand = np.asarray([[2, 2, 20, 20], [10, 8, 50, 38], [30, 0, 55, 39],
                       [0, 20, 12, 39]], np.float32)
    query = (img, cand, "the red thing on the left")
    jsrv = JaxRefCOCOServer(jm, None, TinyTok(), transform=None,
                            max_text=12, max_boxes=6)
    params = jm.init({"params": jax.random.PRNGKey(0)},
                     *jsrv.preprocess(*query), train=False)
    return cfg, jm, jax.device_get(params), [query]


def _jax_vqa(kind):
    cfg = _vqa_server_cfg(kind)
    qs = _queries(np.random.default_rng(0))
    jm = j_build_module(cfg, "vqa", dtype=jnp.float32)
    jsrv = JaxVQAServer(jm, None, TinyTok(), ANSWERS, max_text=16,
                        max_boxes=8, feat_dim=16)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)},
                     *jsrv.preprocess(*qs[0]), train=False)
    return cfg, jm, jax.device_get(params), qs


def _port(cfg, task, params):
    tm = build_module(cfg, task, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_jax(
        flatten_params(params["params"]), tm))
    return tm


def _jax_quantized(params, min_size):
    """{flat path: (q, scale)} of the leaves JAX quantizes."""
    qp = j_quant.quantize_params(params, min_size=min_size)["params"]
    out = {}

    def walk(node, path):
        if j_quant.is_quantized_leaf(node):
            out[path] = (node[j_quant._Q8], node[j_quant._Q8_SCALE])
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)

    walk(qp, "")
    return out


@pytest.mark.parametrize("min_size", [512, 4096])
@pytest.mark.parametrize("task", ["refcoco", "vqa"])
def test_quantized_weights_are_jax_quantized_leaves(task, min_size):
    """The converter maps the port's quantized weights onto exactly the
    leaves JAX quantizes (QKV fused on JAX's side, as the default config
    has it), and each q and scale equals JAX's bit for bit."""
    cfg, _, params, _ = (_jax_refcoco(np.random.default_rng(0))
                         if task == "refcoco" else _jax_vqa("mlm"))
    flat = flatten_params(params["params"])
    jq = _jax_quantized(params, min_size)
    assert jq and any(k.endswith("qkv.kernel") for k in jq) \
        == (min_size <= 3 * 32 * 32)
    tm = _port(cfg, task, params)
    # JAX's q, its scale broadcast to the kernel, and a quantized-leaf
    # indicator, each through the converter onto the port's names
    q_flat, s_flat, is_q = {}, {}, {}
    for k, v in flat.items():
        hit = jq.get(k)
        q_flat[k] = v if hit is None else hit[0].astype(np.float32)
        s_flat[k] = np.zeros_like(v) if hit is None \
            else np.broadcast_to(hit[1], v.shape).astype(np.float32)
        is_q[k] = np.full(v.shape, float(hit is not None), np.float32)
    want_q = state_dict_from_jax(q_flat, tm)
    want_s = state_dict_from_jax(s_flat, tm)
    want_names = {n for n, t in state_dict_from_jax(is_q, tm).items()
                  if t.numel() and bool((t == 1).all())}

    done = quant.quantize_module(tm, min_size)
    got_names = {f"{n}.weight" for n in done}
    assert got_names == want_names and got_names
    layers = dict(quant.quantizable_layers(tm))
    for n in done:
        m = layers[n]
        assert m.weight.dtype == torch.int8
        torch.testing.assert_close(m.weight.to(torch.float32),
                                   want_q[f"{n}.weight"], rtol=0, atol=0)
        torch.testing.assert_close(m.weight_scale.expand(m.weight.shape),
                                   want_s[f"{n}.weight"], rtol=0, atol=0)
    # the byte accounting equals JAX's on the same quantized tree
    assert quant.quantized_bytes(tm) == j_quant.quantized_bytes(
        j_quant.quantize_params(params, min_size=min_size))


@pytest.mark.parametrize("kind", ["1fc", "mlm"])
def test_int8_vqa_server_matches_jax(kind):
    cfg, jm, params, qs = _jax_vqa(kind)
    jsrv = JaxVQAServer(jm, params, TinyTok(), ANSWERS, max_text=16,
                        max_boxes=8, feat_dim=16, quantize="int8",
                        quantize_min_size=512)
    srv = VQAServer(_port(cfg, "vqa", params), TinyTok(), ANSWERS,
                    max_text=16, max_boxes=8, feat_dim=16, quantize="int8",
                    quantize_min_size=512)
    assert quant.is_quantized(srv.model)
    full = VQAServer(_port(cfg, "vqa", params), TinyTok(), ANSWERS,
                     max_text=16, max_boxes=8, feat_dim=16)
    for q in qs:
        b = srv.preprocess(*q)
        got = srv.infer(b)["label_logits"]
        want = np.asarray(jsrv._infer(jsrv.params, *jsrv.preprocess(*q)))
        np.testing.assert_allclose(got, want, **TOL)
        assert srv.query(*q) == jsrv.query(*q)
        # int8 moves the logits, a little
        delta = np.abs(got - full.infer(b)["label_logits"]).max()
        assert 0 < delta < 0.1 * np.abs(want).max()


def test_int8_refcoco_server_matches_jax():
    cfg, jm, params, (query,) = _jax_refcoco(np.random.default_rng(0))
    jsrv = JaxRefCOCOServer(jm, params, TinyTok(), transform=None,
                            max_text=12, max_boxes=6, quantize="int8",
                            quantize_min_size=512)
    srv = RefCOCOServer(_port(cfg, "refcoco", params), TinyTok(),
                        transform=None, max_text=12, max_boxes=6,
                        quantize="int8", quantize_min_size=512)
    want = jax.device_get(jsrv._infer(jsrv.params, *jsrv.preprocess(*query)))
    got = srv.infer(srv.preprocess(*query))
    np.testing.assert_allclose(got["label_logits"],
                               np.asarray(want["label_logits"]), **TOL)
    np.testing.assert_allclose(got["pred_boxes"],
                               np.asarray(want["pred_boxes"]), rtol=1e-6)
    r, jr = srv.query(*query), jsrv.query(*query)
    assert r["best_index"] == jr["best_index"]
    np.testing.assert_allclose(r["candidate_scores"], jr["candidate_scores"],
                               atol=1e-5)


def test_quantizing_twice_changes_nothing_and_loads_requantize():
    cfg, _, params, qs = _jax_vqa("1fc")
    tm = _port(cfg, "vqa", params)
    fp32_sd = {k: v.clone() for k, v in tm.state_dict().items()}
    srv = VQAServer(tm, TinyTok(), ANSWERS, max_text=16, max_boxes=8,
                    feat_dim=16, quantize="int8", quantize_min_size=512)
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    b = srv.preprocess(*qs[1])
    before = srv.infer(b)["label_logits"]
    # a second quantization, by either route, leaves the state as it is
    assert quant.quantize_module(tm, 64) == []
    again = VQAServer(tm, TinyTok(), ANSWERS, max_text=16, max_boxes=8,
                      feat_dim=16, quantize="int8", quantize_min_size=64)
    for k, v in tm.state_dict().items():
        assert v.dtype == sd[k].dtype and torch.equal(v, sd[k]), k
    np.testing.assert_array_equal(again.infer(b)["label_logits"], before)
    # fp32 weights loaded into the quantized model are quantized on the
    # way in; the int8 state dict loads into a fresh fp32 model as int8
    tm.load_state_dict(fp32_sd)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    fresh = build_module(cfg, "vqa", dtype=torch.float32)
    fresh.load_state_dict(sd)
    assert {n for n, m in quant.quantizable_layers(fresh) if m.quantized} \
        == {n for n, m in quant.quantizable_layers(tm) if m.quantized}
    np.testing.assert_array_equal(
        VQAServer(fresh, TinyTok(), ANSWERS, max_text=16, max_boxes=8,
                  feat_dim=16).infer(b)["label_logits"], before)


def test_min_size_selects_and_bytes_shrink():
    m = torch.nn.Sequential(Linear(64, 64), Linear(64, 8),
                            Conv2d(16, 32, 3), torch.nn.LayerNorm(64))
    full = quant.quantized_bytes(m)
    assert full["quantized_bytes"] == full["fp32_bytes"] \
        == 4 * sum(p.numel() for p in m.parameters())
    # 64x64 = 4096 and 32x16x3x3 = 4608 elements: quantized at the
    # default; 64x8 = 512 is not
    assert quant.quantize_module(m) == ["0", "2"]
    assert not m[1].quantized and m[0].quantized and m[2].quantized
    assert m[0].weight_scale.shape == (64, 1)
    assert m[2].weight_scale.shape == (32, 1, 1, 1)
    acct = quant.quantized_bytes(m)
    assert acct["fp32_bytes"] == full["fp32_bytes"]
    assert acct["quantized_bytes"] == full["fp32_bytes"] \
        - 3 * (4096 + 4608) + 4 * (64 + 32)
    # the dequantized weight is within half a step of the fp32 one
    x = torch.randn(5, 64)
    w8 = m[0].op_weight(torch.float32)
    assert w8.dtype == torch.float32 and w8.shape == (64, 64)
    assert m[0](x).shape == (5, 64)
    assert m[0].op_weight(torch.bfloat16).dtype == torch.bfloat16


def test_int8_accuracy_tool_runs_tiny_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "int8_accuracy_torch.py"),
         "--tiny", "--device", "cpu", "--B", "4"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["card"] is None
    for task in ("vqa", "refcoco"):
        r = out[task]
        assert r["n_samples"] == 4 and r["argmax_flips_beyond_margin"] == 0
        assert 0 < r["max_abs_logit_delta"] < r["logit_std"]
        # the tiny models' bytes are mostly the 30522-word table's
        assert r["quantized_bytes"] < r["fp32_bytes"]


def test_dequant_rounds_once_in_the_compute_dtype():
    """The op's weight is the JAX package's fp32 dequant cast to the
    compute dtype, one rounding: not q and scale each cast to bf16 first,
    which rounds the scale before the product."""
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.05, (256, 64)).astype(np.float32)
    layer = Linear(64, 256, dtype=torch.bfloat16)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
    assert layer.quantize_int8_(1024)
    node = j_quant.quantize_leaf(w.T)
    want = np.asarray(j_quant.dequantize_leaf(node)).T      # fp32
    got = layer.op_weight(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, torch.from_numpy(want).bfloat16(),
                               rtol=0, atol=0)
    twice = layer.weight.bfloat16() * layer.weight_scale.bfloat16()
    assert not torch.equal(got, twice)
    x = torch.randn(3, 64)
    torch.testing.assert_close(
        layer(x), torch.nn.functional.linear(x.bfloat16(), got,
                                             layer.bias.bfloat16()),
        rtol=0, atol=0)
