"""Package-level checks of the PyTorch port (vlbert_tpu_torch) on the CPU:
no import of jax or of the JAX package, the weight round trip, the nvcc
command line, and no fallback when the kernels cannot be built."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from vlbert_tpu.training.convert import convert_state_dict, fuse_qkv_params
from vlbert_tpu.utils.config import default_config
from vlbert_tpu_torch.kernels import build
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.ops.attention import (fused_attention,
                                            fused_attention_dropout)
from vlbert_tpu_torch.ops.dropout import hw_dropout
from vlbert_tpu_torch.ops.roi_align import roi_align
from vlbert_tpu_torch.training.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vlbert_tpu_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_imports_no_jax():
    """Importing every port module, chip_smoke.py and the port's tools
    loads neither jax nor the JAX package (``vlbert_tpu``)."""
    mods = _port_modules() + ["chip_smoke"] + [
        f"tools.{os.path.basename(p)[:-3]}" for p in _port_tools()]
    assert {"vlbert_tpu_torch.ops.roi_align",
            "vlbert_tpu_torch.training.checkpoint",
            "vlbert_tpu_torch.engine.test",
            "vlbert_tpu_torch.data.datasets.refcoco",
            "vlbert_tpu_torch.data.datasets.vcr",
            "vlbert_tpu_torch.utils.mask",
            "vlbert_tpu_torch.engine.vcr_val",
            "vlbert_tpu_torch.parallel.dist",
            "vlbert_tpu_torch.parallel.fsdp",
            "vlbert_tpu_torch.parallel.tp"} <= set(mods)
    assert len(mods) >= 21
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'vlbert_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def _port_tools():
    return sorted(glob.glob(os.path.join(REPO, "tools", "*_torch.py")))


# an import of the JAX package, at any indentation (imports inside
# functions too); vlbert_tpu_torch does not match
JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from\s+vlbert_tpu(\.|\s)|import\s+vlbert_tpu(\.|\s|,|$))"
    r"|import_module\(\s*[\"']vlbert_tpu[\"'.]", re.M)


def test_port_files_import_nothing_of_the_jax_package():
    """A static scan of the port's sources, chip_smoke.py and the port's
    tools: it sees imports inside functions, which importing cannot."""
    for bad in ("from vlbert_tpu.data.loader import DataLoader",
                "    import vlbert_tpu.utils.config as c",
                "from vlbert_tpu import ops", "import vlbert_tpu",
                "importlib.import_module('vlbert_tpu.ops')"):
        assert JAX_PACKAGE_IMPORT.search(bad), bad
    for good in ("from vlbert_tpu_torch.data.loader import DataLoader",
                 "import vlbert_tpu_torch.ops.dropout as dropout",
                 "# replaces vlbert_tpu/ops/attention.py:300"):
        assert not JAX_PACKAGE_IMPORT.search(good), good
    files = (sorted(glob.glob(os.path.join(PKG, "**", "*.py"),
                              recursive=True))
             + [os.path.join(REPO, "chip_smoke.py")] + _port_tools())
    assert len(files) >= 33 and len(_port_tools()) >= 2
    for new in ("training/checkpoint.py", "engine/test.py",
                "data/datasets/refcoco.py"):
        assert os.path.join(PKG, new) in files, new
    offenders = []
    for f in files:
        with open(f, encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                if JAX_PACKAGE_IMPORT.search(line):
                    offenders.append(f"{os.path.relpath(f, REPO)}:{i}: "
                                     f"{line.strip()}")
    assert not offenders, offenders


def test_chip_smoke_stops_every_process_it_started():
    """After a loader with worker processes has shut down, its forkserver
    and the resource tracker still run; chip_smoke.py's exit stops both
    and kills any other leftover child."""
    code = ("import os, subprocess, numpy as np, chip_smoke\n"
            "from vlbert_tpu_torch.data.loader import DataLoader\n"
            "dl = DataLoader(list(range(8)), 4, np.asarray, shuffle=False, "
            "num_workers=2)\n"
            "assert next(iter(dl)).tolist() == [0, 1, 2, 3]\n"
            "dl.shutdown()\n"
            "assert len(chip_smoke.descendants(os.getpid())) >= 2\n"
            "stray = subprocess.Popen(['sleep', '60'])\n"
            "assert chip_smoke.stop_child_processes() == [stray.pid]\n"
            "assert chip_smoke.descendants(os.getpid()) == []\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def _tiny_refcoco(fused_qkv):
    cfg = default_config("refcoco")
    cfg.MODULE = "ResNetVLBERT"
    v = cfg.NETWORK.VLBERT
    v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 2
    v.num_attention_heads = 2; v.intermediate_size = 64; v.vocab_size = 100
    v.max_position_embeddings = 64; v.visual_ln = True
    cfg.NETWORK.IMAGE_FINAL_DIM = 32
    cfg.NETWORK.IMAGE_NUM_LAYERS = 50
    cfg.TPU.FUSED_QKV = fused_qkv
    with pytest.warns(UserWarning, match="ignored"):
        return build_module(cfg, "refcoco", dtype=torch.float32)


@pytest.mark.parametrize("fused_qkv", [True, False])
def test_convert_round_trip(fused_qkv):
    m = _tiny_refcoco(fused_qkv)
    assert m.vlbert.encoder.layer[0].attention.self.fused_qkv is fused_qkv
    init_weights(m, torch.Generator().manual_seed(3))
    sd = m.state_dict()
    flat, skipped = convert_state_dict(sd)
    assert skipped == []
    if fused_qkv:
        flat = fuse_qkv_params(flat)
        assert any(k.endswith("attention.self.qkv.kernel") for k in flat)
    back = state_dict_from_jax(flat, m)
    assert back.keys() == sd.keys()
    for k, t in sd.items():
        assert torch.equal(back[k], t), k
    with pytest.raises(KeyError, match="not used"):
        state_dict_from_jax({**flat, "stray.kernel": np.zeros(1)}, m)
    del flat["vlbert.word_embeddings.embedding"]
    with pytest.raises(KeyError, match="no JAX source"):
        state_dict_from_jax(flat, m)


def test_nvcc_command_targets_sm90a_and_repo_sources(tmp_path):
    srcs = build.sources()
    assert {s.name for s in srcs} >= {"roi_align.cu", "roi_align_bwd.cu",
                                      "attention_f32_mma.cu", "dropout.cu",
                                      "attention_dropout_mma.cu"}
    assert not {"attention.cu", "attention_dropout.cu"} & {
        s.name for s in srcs}
    objs = [tmp_path / f"{s.stem}.o" for s in srcs]
    for src, obj in zip(srcs, objs):
        cmd = build.compile_command("nvcc", src, obj)
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-std=c++17", "-O3", "-fPIC", "-c"):
            assert flag in cmd
        inputs = [c for c in cmd if c.endswith((".cu", ".cpp", ".c"))]
        assert inputs == [str(src)]
        assert os.path.dirname(inputs[0]) == os.path.join(PKG, "csrc")
    link = build.link_command("nvcc", objs, tmp_path / "lib.so")
    assert "-shared" in link and link[-len(objs):] == list(map(str, objs))


def test_every_source_and_header_is_in_the_digest(tmp_path, monkeypatch):
    srcs = build.sources()
    full = build._digest(srcs)
    for i in range(len(srcs)):
        assert build._digest(srcs[:i] + srcs[i + 1:]) != full
    # each header counts too: a copy of csrc with one header changed
    headers = sorted(p.name for p in build.CSRC_DIR.glob("*.cuh"))
    assert {"common.cuh", "attention_dropout.cuh",
            "roi_align.cuh"} <= set(headers)
    for name in headers:
        copy = tmp_path / name.replace(".", "_")
        copy.mkdir()
        for p in build.CSRC_DIR.iterdir():
            text = p.read_bytes() + (b"\n" if p.name == name else b"")
            (copy / p.name).write_bytes(text)
        monkeypatch.setattr(build, "CSRC_DIR", copy)
        assert build._digest([copy / s.name for s in srcs]) != full, name


def test_ctypes_signatures_match_the_c_entry_points():
    """Each extern "C" entry point in csrc has a SIGNATURES entry with as
    many arguments, each of the ctypes type of its C type (ctypes would
    otherwise pass them wrongly)."""
    import ctypes
    import re

    def ctype(param):
        decl = " ".join(param.split()[:-1]) if "*" not in param else "*"
        return {"*": ctypes.c_void_p, "int": ctypes.c_int,
                "float": ctypes.c_float, "long long": ctypes.c_longlong,
                "unsigned": ctypes.c_uint,
                "unsigned long long": ctypes.c_ulonglong}[decl]

    found, where = {}, {}
    for src in build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            assert m.group(1) not in found, m.group(1)
            found[m.group(1)] = [ctype(p) for p in m.group(2).split(",")]
            where[m.group(1)] = src.name
    assert set(found) == set(build.SIGNATURES)
    assert {"roi_align_fwd", "roi_align_bwd", "attention_fwd_f32",
            "attention_fwd_bf16", "attention_fwd_fp16",
            "attention_dropout_fwd_f32", "attention_dropout_bwd_f32",
            "attention_dropout_fwd_bf16", "attention_dropout_bwd_bf16",
            "attention_dropout_fwd_fp16", "attention_dropout_bwd_fp16"} \
        <= set(found)
    for name, types_ in found.items():
        assert list(build.SIGNATURES[name]) == types_, name
    # fp32 K2 and K4 live in the split-TF32 source, with the arguments of
    # their bf16 twins
    assert where["attention_fwd_f32"] == "attention_f32_mma.cu"
    assert where["attention_dropout_bwd_f32"] == "attention_f32_mma.cu"
    assert found["attention_fwd_f32"] == found["attention_fwd_bf16"]
    assert (found["attention_dropout_bwd_f32"]
            == found["attention_dropout_bwd_bf16"])
    # fp16 attention: the bf16 source's entry points, with their arguments
    for kind in ("fwd", "dropout_fwd", "dropout_bwd"):
        name = f"attention_{kind}_fp16"
        assert where[name] == "attention_dropout_mma.cu"
        assert found[name] == found[f"attention_{kind}_bf16"]
    # feat, feat_dtype, boxes, box_mask, out, out_dtype, ...: a dtype code
    # (0 fp32, 1 bf16, 2 fp16) for the map and for the output
    assert found["roi_align_fwd"][:2] == [ctypes.c_void_p, ctypes.c_int]
    assert found["roi_align_fwd"][4:6] == [ctypes.c_void_p, ctypes.c_int]
    assert len(found["roi_align_fwd"]) == 17
    # x, out, n, dtype, ...
    assert found["dropout_fwd"][3] == ctypes.c_int
    # g, g_dtype, boxes, box_mask, dfeat, dfeat_dtype, ...: K1b takes
    # K1's arguments in K1's order, g and dF in place of map and output
    assert found["roi_align_bwd"] == found["roi_align_fwd"]


def test_no_fallback_without_nvcc_and_cpu_counters(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    real_isfile = os.path.isfile
    monkeypatch.setattr(os.path, "isfile", lambda p: not str(p).endswith(
        "nvcc") and real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(tmp_path / "kernels")
    assert not any((tmp_path / "kernels").glob("*.so"))

    roi_align.launches = fused_attention.launches = 0
    hw_dropout.launches = fused_attention_dropout.launches = 0
    f = torch.randn(1, 6, 7, 8)
    out = roi_align(f, torch.tensor([[[0.0, 0.0, 50.0, 40.0]]]),
                    torch.ones(1, 1, dtype=torch.bool))
    q = torch.randn(1, 5, 2, 64)
    fused_attention(q, q, q, torch.zeros(1, 1, 1, 5))
    fused_attention_dropout(q, q, q, torch.zeros(1, 1, 1, 5), 0.1, seed=1)
    hw_dropout(q, 0.1, seed=1)
    assert out.shape == (1, 1, 14, 14, 8)
    assert (roi_align.launches, fused_attention.launches, hw_dropout.launches,
            fused_attention_dropout.launches) == (0, 0, 0, 0)
    # a tensor on neither the CPU nor CUDA is refused, not moved
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align(f.to("meta"), torch.zeros(1, 1, 4, device="meta"),
                  torch.ones(1, 1, dtype=torch.bool, device="meta"))
