"""The JAX package's own checkpoints (flax msgpack) read by the port on
the CPU: the format, resume, ``engine.test --ckpt`` and PARTIAL_PRETRAIN,
against the JAX package at tiny width in fp32, dropout off.

* the decoder (``vlbert_tpu_torch/training/jax_format.py``) against
  ``flax.serialization.msgpack_restore`` bit for bit, and its writer
  against ``msgpack_serialize`` byte for byte, on hypothesis trees and on
  every msgpack width, chunked arrays included;
* a VQA model trained two steps by the JAX package and saved by its
  ``save_checkpoint``: the port's AUTO_RESUME and one step equal the JAX
  package's resume and one step (dense and masked moments, AdamW and SGD,
  FUSED_QKV on and off, SCAN_LAYERS, the plateau schedule's scale and
  ``extra``);
* ``engine.test`` from a native file equals the JAX driver on it, and a
  native pretraining file's PARTIAL_PRETRAIN equals the JAX package's;
* two tensor-parallel ranks at [1, 2] resume from a native file as one
  port process does.

The rank processes import this module and tests/test_torch_dist.py: jax
and the JAX package's models are imported inside the parent's functions
only.
"""

import math
import os
import pickle
import struct
import sys
import types
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import tests.test_torch_dist as td
from vlbert_tpu_torch.training import jax_format as jf

TOL = dict(rtol=1e-3, atol=1e-4)
B = 4
MESH12 = [1, 2]


# ------------------------------------------------------------- the format

def _same(got, want):
    """``loads``' tree against ``msgpack_restore``'s: arrays by dtype name,
    shape and bytes (a 0-d tensor for a numpy scalar), floats with nan
    equal to nan."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor)
        assert jf.NAMES[got.dtype] == want.dtype.name
        assert tuple(got.shape) == want.shape
        assert got.contiguous().reshape(-1).view(torch.uint8).numpy() \
            .tobytes() == want.tobytes()
    elif isinstance(want, float):
        assert type(got) is float
        assert (math.isnan(got) and math.isnan(want)) \
            or struct.pack(">d", got) == struct.pack(">d", want)
    else:
        assert type(got) is type(want) and got == want


def _bf16():
    import jax.numpy as jnp

    return np.dtype(jnp.bfloat16)


DTYPES = ("float32", "float16", "bfloat16", "int8", "int32", "uint8",
          "bool", "int64", "float64")


@st.composite
def arrays(draw):
    name = draw(st.sampled_from(DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 3), max_size=3)))
    seed = draw(st.integers(0, 2 ** 16))
    rng = np.random.default_rng(seed)
    dtype = _bf16() if name == "bfloat16" else np.dtype(name)
    if name == "bool":
        a = rng.integers(0, 2, shape).astype(bool)
    elif dtype.kind in "iu":
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, shape, dtype=dtype,
                         endpoint=True)
    else:
        a = (rng.normal(size=shape) * 100).astype(dtype)
        if a.size:
            a.reshape(-1)[0] = draw(st.sampled_from(
                [np.inf, -np.inf, np.nan, 0.0, -0.0]))
    if a.size and draw(st.booleans()):
        return a.reshape(-1)[0]            # a numpy scalar
    return a


LEAVES = (st.none() | st.booleans()
          | st.integers(-2 ** 63, 2 ** 64 - 1)
          | st.floats(allow_nan=True, allow_infinity=True)
          | st.text(max_size=40) | st.binary(max_size=300)
          | st.complex_numbers(allow_nan=False) | arrays())
TREES = st.recursive(
    LEAVES, lambda kids: st.lists(kids, max_size=4)
    | st.dictionaries(st.text(max_size=6), kids, max_size=5),
    max_leaves=20)


@settings(max_examples=150, deadline=None, database=None)
@given(tree=TREES)
def test_decoder_and_writer_equal_flax_on_hypothesis_trees(tree):
    from flax import serialization as fs

    data = fs.msgpack_serialize(tree)
    _same(jf.loads(data), fs.msgpack_restore(data))
    assert jf.dumps(tree) == data


def _as_torch(tree):
    """numpy arrays (bf16 too) -> tensors of the same dtype and bytes."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    if isinstance(tree, np.ndarray):
        if tree.dtype == _bf16():
            return torch.from_numpy(tree.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(tree.copy())
    return tree


def test_every_msgpack_width_and_extension():
    """Each form msgpack has, against ``msgpack.unpackb`` (forms flax
    never writes: float32, ints wider than they need) and against
    flax's round trip (the 16- and 32-bit lengths, fixext 16, ext 8 / 16
    / 32); a tree of tensors is written as the same tree of arrays."""
    import msgpack
    from flax import serialization as fs

    raw = [b"\xcc\x05", b"\xcd\x00\x05", b"\xce\x00\x00\x00\x05",
           b"\xcf" + struct.pack(">Q", 2 ** 64 - 1), b"\xd0\x80",
           b"\xd1\x80\x00", b"\xd2\x80\x00\x00\x00",
           b"\xd3" + struct.pack(">q", -2 ** 63), b"\xe0", b"\x7f",
           msgpack.packb(1.5, use_single_float=True),
           msgpack.packb(float("-inf"), use_single_float=True),
           b"\xd9\x03abc", b"\xda\x00\x03abc", b"\xdb\x00\x00\x00\x03abc",
           b"\xc4\x02\x00\x01", b"\xc5\x00\x01\x07",
           b"\xc6\x00\x00\x00\x01\x07", b"\xdc\x00\x01\xc0",
           b"\xdd\x00\x00\x00\x01\xc3", b"\xde\x00\x01\xa1k\xc2",
           b"\xdf\x00\x00\x00\x01\xa1k\x01", b"\xc0", b"\xc2", b"\xc3"]
    for data in raw:
        _same(jf.loads(data), msgpack.unpackb(data, raw=False))
    rng = np.random.default_rng(0)
    tree = {"str16": "s" * 300, "str32": "t" * 70000, "bin16": b"b" * 300,
            "bin32": b"c" * 70000, "array16": list(range(20)),
            "array32": list(range(70000)),
            "map16": {f"k{i}": i for i in range(20)},
            "map32": {f"m{i:05d}": i for i in range(70000)},
            "fixext16": np.float32(0.5),          # 16-byte ndarray payload
            "ext8": np.zeros((2, 3), np.int8),
            "ext16": rng.normal(size=(100,)).astype(np.float32),
            "ext32": rng.normal(size=(20000,)).astype(np.float32),
            "scalars": [np.int64(-3), np.float16(2.5), np.bool_(True),
                        np.asarray(1.0, _bf16())[()]],
            "zero_d": np.asarray(7, np.int32), "empty": np.zeros((0, 5)),
            "complex": 1.5 - 2j}
    data = fs.msgpack_serialize(tree)
    _same(jf.loads(data), fs.msgpack_restore(data))
    assert jf.dumps(tree) == data
    assert jf.dumps(_as_torch(tree)) == data
    for b in (0xd4, 0xd5, 0xd6, 0xd7):              # fixext 1 ... 8
        n = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8}[b]
        with pytest.raises(ValueError, match="extension type 9"):
            jf.loads(bytes([b, 9]) + b"\x00" * n)
    with pytest.raises(ValueError, match="truncated"):
        jf.loads(data[:-3])
    with pytest.raises(ValueError, match="after the object"):
        jf.loads(data + b"\xc0")


def test_chunked_arrays_equal_flax(monkeypatch):
    """flax's MAX_CHUNK_SIZE made small: arrays above it, at the top and
    as map values, are written in chunks and joined again; arrays in
    lists are not chunked, as flax leaves them."""
    from flax import serialization as fs

    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 24)
    monkeypatch.setattr(jf, "MAX_CHUNK_SIZE", 24)
    rng = np.random.default_rng(1)
    bf = rng.normal(size=(5, 7)).astype(_bf16())
    tree = {"a": {"w": rng.normal(size=(4, 9)).astype(np.float32),
                  "b": bf, "small": np.arange(3, dtype=np.int32),
                  "s": np.asarray(1.0, np.float64)},
            "l": [rng.normal(size=(40,)).astype(np.float32)],
            "i8": np.arange(100, dtype=np.int8)}
    data = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = jf.loads(data)
    _same(got, fs.msgpack_restore(data))
    assert jf.dumps(tree) == data
    assert jf.dumps(_as_torch(tree)) == data
    top = rng.normal(size=(3, 5)).astype(np.float32)
    data = fs.msgpack_serialize(top)
    _same(jf.loads(data), fs.msgpack_restore(data))
    assert jf.dumps(top) == data


# --------------------------------------------------------- the JAX runs

# (optimizer, masked moments, FUSED_QKV, SCAN_LAYERS, LR_SCHEDULE)
CASES = {
    "adamw_dense_fused": ("AdamW", False, True, False, "triangle"),
    "adamw_masked_scan_plateau": ("AdamW", True, True, True, "plateau"),
    "sgd_dense_unfused": ("SGD", False, False, False, "triangle"),
    "sgd_masked_fused_scan": ("SGD", True, True, True, "step"),
}
PLATEAU = {"best": 0.375, "num_bad_epochs": 1, "cooldown_counter": 2,
           "scale": 0.5}


def _case_cfg(name, batch_images=B):
    """tests/test_torch_dist.py's tiny VQA config under ``name``'s levers,
    BATCH_IMAGES ``batch_images``."""
    optimizer, masked, fused, scan, schedule = CASES[name]
    cfg = td._cfg("vqa", batch_images)
    t = cfg.TRAIN
    t.OPTIMIZER, t.LR_SCHEDULE = optimizer, schedule
    t.LR_STEP, t.LR_FACTOR, t.MOMENTUM = (0.75,), 0.1, 0.9
    cfg.TPU.MASKED_OPT_STATE = masked
    cfg.TPU.FUSED_QKV = fused
    cfg.TPU.SCAN_LAYERS = scan
    return cfg


def _batch(seed):
    inputs, label = td._global_batch("vqa", B, seed=seed)
    return (*inputs, label)


def _jax_run(name, tmp):
    """The JAX package: two steps, a save (with ``extra`` and, under
    'plateau', the scale 0.5 in the optimizer state), its resume from the
    file and one step. Returns the file's prefix, the saved and the
    stepped state as numpy trees and the resumed ``extra``."""
    import jax
    import jax.numpy as jnp

    import vlbert_tpu.models.fast_rcnn as j_fast_rcnn
    from vlbert_tpu.models.task_modules import build_module as j_build
    from vlbert_tpu.ops.dropout import Dropout as JDropout
    from vlbert_tpu.training import checkpoint as j_ckpt
    from vlbert_tpu.training.loop import create_train_state
    from vlbert_tpu.training.loop import make_train_step as j_make_step
    from vlbert_tpu.training.optim import set_plateau_scale

    cfg = _case_cfg(name)
    saved = j_fast_rcnn.Dropout
    j_fast_rcnn.Dropout = lambda rate: JDropout(rate=0.0)
    try:
        jm = j_build(cfg, "vqa", dtype=jnp.float32)
        batch = [None if x is None else jnp.asarray(x) for x in _batch(0)]
        v = jm.init(jax.random.PRNGKey(0), *batch[:-1], train=False)
        state, tx, _, _ = create_train_state(jm, None, cfg, 4, params=v)
        step = jax.jit(j_make_step(jm, tx, "vqa", cfg))
        for i in range(2):
            state, _, _ = step(state, batch, jax.random.PRNGKey(i))
        extra = {"best_val": 0.375}
        if cfg.TRAIN.LR_SCHEDULE == "plateau":
            state = state.replace(opt_state=set_plateau_scale(
                state.opt_state, 0.5))
            extra["plateau"] = PLATEAU
        prefix = os.path.join(tmp, name, "jax")
        path = j_ckpt.save_checkpoint(prefix, 0, state, extra=extra)
        template, _, _, _ = create_train_state(jm, None, cfg, 4, params=v)
        resumed, got_extra = j_ckpt.load_checkpoint(path, template)
        stepped, _, _ = step(resumed, batch, jax.random.PRNGKey(9))
    finally:
        j_fast_rcnn.Dropout = saved
    host = jax.device_get
    return {"prefix": prefix, "path": path, "saved": host(state),
            "stepped": host(stepped.params), "extra": got_extra,
            "cfg": cfg}


def _port(cfg, seed=5):
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.training.optim import (Optimizer,
                                                 apply_trainable_mask)

    tm = td._port_model(cfg, "vqa")
    init_weights(tm, torch.Generator().manual_seed(seed))
    apply_trainable_mask(tm, cfg)
    return tm, Optimizer(cfg, tm, 4)


def _jax_flat(tree):
    return {k: np.asarray(a) for k, a in td._jax_flat(tree).items()}


def _port_as_jax(named, cfg):
    """Port tensors by name -> the JAX package's flat paths of ``cfg``'s
    tree (its converter, qkv fused, layers stacked)."""
    from vlbert_tpu.training.convert import (convert_state_dict,
                                             fuse_qkv_params,
                                             stack_layer_params)

    flat, skipped = convert_state_dict(
        {k: v.detach() for k, v in named.items()})
    assert skipped == []
    if cfg.TPU.FUSED_QKV:
        flat = fuse_qkv_params(flat)
    if cfg.TPU.SCAN_LAYERS:
        flat = stack_layer_params(flat, cfg.NETWORK.VLBERT.num_hidden_layers)
    return flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs of every case; the [1, 2] tp ranks start on the first
    one's file while the others are made."""
    tmp = str(tmp_path_factory.mktemp("jax_ckpt"))
    out = {"tmp": tmp}
    first = next(iter(CASES))
    out[first] = _jax_run(first, tmp)
    payload = {"path": out[first]["path"], "batch": _batch(0)}
    started = td.start_ranks("resume12", tmp, payload,
                             module="tests.test_torch_jax_checkpoint")
    try:
        for name in CASES:
            if name not in out:
                out[name] = _jax_run(name, tmp)
    except BaseException:
        td.finish_ranks(started)
        raise
    out["ranks"] = started
    return out


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("name", list(CASES))
def test_auto_resume_from_a_jax_checkpoint_then_a_step_equals_jax(
        runs, name, monkeypatch):
    from vlbert_tpu_torch.training import checkpoint as ckpt
    from vlbert_tpu_torch.training.convert import checkpoint_format
    from vlbert_tpu_torch.training.loop import make_train_step

    run = runs[name]
    cfg = _case_cfg(name)
    assert checkpoint_format(run["path"]) == "native"
    tm, opt = _port(cfg)
    cfg.TRAIN.AUTO_RESUME, cfg.TRAIN.END_EPOCH = True, 3
    assert ckpt.has_resumable_checkpoint(run["prefix"], cfg)
    begin, extra = ckpt.smart_resume(run["prefix"], tm, opt, cfg)
    assert begin == 1 and extra == run["extra"]
    assert extra["best_val"] == 0.375
    if cfg.TRAIN.LR_SCHEDULE == "plateau":
        assert extra["plateau"] == PLATEAU and opt.plateau_scale == 0.5
    else:
        assert opt.plateau_scale == 1.0
    assert opt.count == int(run["saved"].step) == 2
    # the weights and moments as the JAX package holds them, bit for bit
    saved = run["saved"]
    want = _jax_flat(saved.params["params"])
    got = _port_as_jax(tm.state_dict(), cfg)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    from vlbert_tpu.training.checkpoint import flatten_params
    from flax import serialization as fs

    opt_sd = fs.to_state_dict(saved.opt_state)
    keys = ("mu", "nu") if opt.kind != "SGD" else ("trace",)
    found = _moments_of(opt_sd)
    for key, live in zip(keys, (opt.mu, opt.nu)):
        mine = _port_as_jax(dict(zip(opt.names, live)), cfg)
        theirs = {k: np.asarray(a) for k, a in
                  flatten_params(found[key]).items()}
        assert set(theirs) <= set(mine) or CASES[name][1]
        for k, w in theirs.items():
            np.testing.assert_array_equal(mine[k], w, err_msg=(key, k))
    # one more step in each package
    batch = tuple(None if x is None else torch.from_numpy(np.asarray(x))
                  for x in _batch(0))
    make_train_step(tm, opt, "vqa", cfg)(batch, 9)
    want = _jax_flat(run["stepped"]["params"])
    got = _port_as_jax(tm.state_dict(), cfg)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)


def _moments_of(opt_sd):
    """The moment trees of a JAX optimizer state dict, by key."""
    out = {}

    def walk(node):
        if isinstance(node, dict):
            for k in ("mu", "nu", "trace"):
                if k in node and isinstance(node[k], dict):
                    out[k] = node[k]
            for v in node.values():
                walk(v)

    walk(opt_sd)
    return out


def test_jax_reads_what_the_writer_writes(runs, tmp_path):
    """A JAX checkpoint's payload as tensors, written by ``jax_format``:
    the same bytes as the JAX package's file, and its
    ``load_checkpoint`` restores it."""
    import jax
    from flax import serialization as fs

    from vlbert_tpu.training import checkpoint as j_ckpt

    run = runs["adamw_masked_scan_plateau"]
    tree = fs.msgpack_restore(open(run["path"], "rb").read())
    path = str(tmp_path / "w-0000.model")
    jf.dump(_as_torch(tree), path)
    with open(path, "rb") as a, open(run["path"], "rb") as b:
        assert a.read() == b.read()
    state, extra = j_ckpt.load_checkpoint(path, run["saved"])
    assert extra["plateau"] == PLATEAU
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(run["saved"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_wrong_optimizer_is_refused_by_name(runs):
    from vlbert_tpu_torch.training import checkpoint as ckpt

    cfg = _case_cfg("sgd_dense_unfused")
    cfg.TRAIN.OPTIMIZER = "AdamW"
    tm, opt = _port(cfg)
    with pytest.raises(ValueError, match="not adam"):
        ckpt.load_checkpoint(runs["sgd_dense_unfused"]["path"], tm, opt)


# ------------------------------------------------- engine.test, warm starts

@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
def test_engine_test_from_a_native_checkpoint_equals_jax(tmp_path):
    """The JAX package writes a native file of a port checkpoint's
    weights; both test drivers score the tiny fixture from it."""
    import jax

    import vlbert_tpu.engine.test as j_test
    import vlbert_tpu_torch.engine.test as t_test
    from tests.test_torch_infer import (ANSWERS, _save_port_checkpoint,
                                        _vqa_driver_cfg)
    from vlbert_tpu.training import checkpoint as j_ckpt

    cfg = _vqa_driver_cfg(tmp_path)
    assert cfg.TPU.FUSED_QKV
    port = _save_port_checkpoint(cfg, "vqa", str(tmp_path / "port"))
    _, params, infer, loader, _, n_label = j_test.setup_inference(
        cfg, "vqa", port, "val")
    state = types.SimpleNamespace(params=jax.device_get(params),
                                  opt_state={}, step=0)
    native = j_ckpt.save_checkpoint(str(tmp_path / "native"), 0, state)
    out_j, out_t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = j_test.test_net_vqa(cfg, native, ANSWERS, out_j, mode="val")
    got = t_test.test_net_vqa(cfg, native, ANSWERS, out_t, mode="val",
                              device="cpu")
    assert got == want and len(got) == 4
    res, _ = t_test.run_inference(cfg, "vqa", native, "val", "cpu")
    logits = np.concatenate([r["label_logits"] for r in res])[:4]
    _, jparams, infer, loader, _, n_label = j_test.setup_inference(
        cfg, "vqa", native, "val")
    batch = next(iter(loader))
    jl = np.asarray(infer(jparams, *batch[:-n_label])["label_logits"])[:4]
    np.testing.assert_allclose(logits, jl, **TOL)


def _pretrain_native(path):
    """A JAX pretraining model (its ``vlbert.bert`` nesting, fused qkv)
    at the VQA test model's widths, saved by the JAX package."""
    import jax

    import tests.test_torch_pretrain as tp
    from vlbert_tpu.models.task_modules import build_module as j_build
    from vlbert_tpu.training import checkpoint as j_ckpt

    cfg = tp._cfg("prec_no_aux")
    v_ = cfg.NETWORK.VLBERT
    v_.vocab_size, v_.max_position_embeddings = 1050, 32
    import jax.numpy as jnp

    jm = j_build(cfg, "pretrain", dtype=jnp.float32)
    v = jm.init({"params": jax.random.PRNGKey(7),
                 "dropout": jax.random.PRNGKey(1)},
                *map(tp._jnp, tp._batch("prec_no_aux")), train=True)
    v = jax.device_get(v)
    assert "bert" in v["params"]["vlbert"]
    state = types.SimpleNamespace(params=v, opt_state={}, step=0)
    return j_ckpt.save_checkpoint(path, 0, state)


@pytest.mark.filterwarnings("ignore:TPU.FUSED_ATTENTION")
@pytest.mark.parametrize("case", ["vqa_mlm_shipped", "vqa_2fc_vcr_rules"])
def test_partial_pretrain_from_a_native_file_equals_jax(tmp_path, case):
    """The shipped VQA rules with the MLM transform copied into the
    classifier; VCR's rules (the mvrc head's translated rule) with the
    segment-B row and the NSP surgery."""
    import jax

    import vlbert_tpu.engine.train as j_train
    import vlbert_tpu_torch.engine.train as t_train
    from tests.test_torch_checkpoint import (SHIPPED, _assert_port_equals_jax,
                                             _port_from_jax, _state)
    from tests.test_torch_train import _jax_vqa
    from vlbert_tpu.utils.config import load_config

    kind = "mlm" if "mlm" in case else "2fc"
    cfg, _, v = _jax_vqa(kind)
    cfg = cfg.clone()
    cfg.TPU.FUSED_QKV = True
    jp = jax.device_get(v)
    tm = _port_from_jax(cfg, "vqa", jp)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    cfg.NETWORK.PARTIAL_PRETRAIN = _pretrain_native(str(tmp_path / "pre"))
    if kind == "mlm":
        rules = load_config("vqa", SHIPPED["vqa"]).NETWORK \
            .PARTIAL_PRETRAIN_PREFIX_CHANGES
        cfg.NETWORK.CLASSIFIER_PRETRAINED = True
    else:
        rules = ["vlbert.mvrc_head.transform->cnn_loss_reg.0",
                 "module.vlbert.mvrc_head.transform->module.cnn_loss_reg.0",
                 "module.vlbert->module.vlbert._module",
                 "vlbert->vlbert._module"]
        cfg.NETWORK.PARTIAL_PRETRAIN_SEGMB_INIT = True
        cfg.NETWORK.LOAD_REL_HEAD = True
    cfg.NETWORK.PARTIAL_PRETRAIN_PREFIX_CHANGES = list(rules)
    loaded, _, _ = t_train.apply_partial_pretrain(tm, cfg)
    jstate = j_train.apply_partial_pretrain(_state(jp), cfg)
    _assert_port_equals_jax(tm, jstate.params)
    changed = sorted(k for k, t in tm.state_dict().items()
                     if not torch.equal(t, before[k]))
    assert set(changed) <= set(loaded)
    assert any("encoder.layer.1" in k for k in changed)
    assert ("final_mlp.0.dense.weight" in changed) == (kind == "mlm")
    tt = tm.state_dict()["vlbert.token_type_embeddings.weight"]
    assert torch.equal(tt[1], tt[0]) == (kind == "2fc")


# --------------------------------------------------- tensor parallelism

def _rank_main(scenario, tmp):
    """One of two tp ranks at [1, 2]: AUTO_RESUME from the JAX file and
    one step; pickles the gathered state after the load and the step."""
    from vlbert_tpu_torch.parallel import dist as dist_lib
    from vlbert_tpu_torch.parallel import tp as tp_lib
    from vlbert_tpu_torch.training import checkpoint as ckpt_lib
    from vlbert_tpu_torch.training.loop import make_train_step

    torch.set_num_threads(2)
    with open(os.path.join(tmp, f"{scenario}.pkl"), "rb") as f:
        d = pickle.load(f)
    with dist_lib.process_group("gloo", "cpu"):
        rank, world = dist_lib.rank_world()
        cfg = _case_cfg(next(iter(CASES)), B // world)
        cfg.TPU.PARTITION_MODE = "tp"
        cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES = MESH12, ["data", "model"]
        dist_lib.check_partition(cfg, world)
        tm, opt = _port_tp(cfg)
        extra = ckpt_lib.load_checkpoint(d["path"], tm, opt)
        count = opt.count
        loaded = ckpt_lib.snapshot(tm, opt)
        batch = tuple(None if x is None else torch.from_numpy(np.asarray(x))
                      for x in d["batch"])
        make_train_step(tm, opt, "vqa", cfg)(batch, 9)
        stepped = ckpt_lib.snapshot(tm, opt)
        out = {"extra": extra, "count": count, "loaded": loaded,
               "stepped": stepped}
    out["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(tmp, f"{scenario}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _port_tp(cfg):
    from vlbert_tpu_torch.parallel import tp as tp_lib
    from vlbert_tpu_torch.training.optim import (Optimizer,
                                                 apply_trainable_mask)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = td._port_model(cfg, "vqa")
    apply_trainable_mask(tm, cfg)
    tp_lib.shard_module(tm, tp_lib.make_mesh(cfg))
    return tm, Optimizer(cfg, tm, 4, 2)


def test_tp_ranks_resume_from_a_jax_file_as_one_process(runs):
    """Rank 0's gathered state after the load equals one port process's
    load bit for bit, and after a step within 1e-5 of each tensor's
    largest element (the tp bar of tests/test_torch_tp.py)."""
    from vlbert_tpu_torch.training import checkpoint as ckpt
    from vlbert_tpu_torch.training.loop import make_train_step

    ranks = td.finish_ranks(runs["ranks"])
    first = next(iter(CASES))
    cfg = _case_cfg(first)
    tm, opt = _port(cfg)
    extra = ckpt.load_checkpoint(runs[first]["path"], tm, opt)
    sd, o = ckpt.snapshot(tm, opt)
    assert [r["extra"] for r in ranks] == [extra, extra]
    assert [r["count"] for r in ranks] == [2, 2]
    rsd, ro = ranks[0]["loaded"]
    assert ranks[1]["loaded"] == (None, None)
    assert rsd.keys() == sd.keys()
    for k, t in sd.items():
        assert torch.equal(rsd[k], t), k
    for key in ("mu", "nu"):
        for n, t in o[key].items():
            assert torch.equal(ro[key][n], t), (key, n)
    batch = tuple(None if x is None else torch.from_numpy(np.asarray(x))
                  for x in _batch(0))
    make_train_step(tm, opt, "vqa", cfg)(batch, 9)
    sd, _ = ckpt.snapshot(tm, opt)
    rsd, _ = ranks[0]["stepped"]
    for k, t in sd.items():
        scale = max(t.abs().max().item(), 1e-2)
        assert (rsd[k] - t).abs().max().item() <= 1e-5 * scale, k

