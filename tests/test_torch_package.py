"""Package-level checks of the PyTorch port (vlbert_tpu_torch) on the CPU:
no jax import, the weight round trip, the nvcc command line, and no
fallback when the kernels cannot be built."""

import os
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
from vlbert_tpu_torch.ops.attention import fused_attention
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
    mods = _port_modules()
    assert "vlbert_tpu_torch.ops.roi_align" in mods and len(mods) >= 15
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
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


def test_nvcc_command_targets_sm90a_and_repo_sources():
    srcs = build.sources()
    assert {s.name for s in srcs} >= {"roi_align.cu", "attention.cu"}
    cmd = build.nvcc_command("nvcc", srcs, "/tmp/lib.so")
    i = cmd.index("-gencode")
    assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    inputs = [c for c in cmd if c.endswith((".cu", ".cpp", ".c"))]
    assert inputs and all(os.path.dirname(c) == os.path.join(PKG, "csrc")
                          for c in inputs)


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
    f = torch.randn(1, 6, 7, 8)
    out = roi_align(f, torch.tensor([[[0.0, 0.0, 50.0, 40.0]]]),
                    torch.ones(1, 1, dtype=torch.bool))
    q = torch.randn(1, 5, 2, 64)
    fused_attention(q, q, q, torch.zeros(1, 1, 1, 5))
    assert out.shape == (1, 1, 14, 14, 8)
    assert (roi_align.launches, fused_attention.launches) == (0, 0)
    # a tensor on neither the CPU nor CUDA is refused, not moved
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align(f.to("meta"), torch.zeros(1, 1, 4, device="meta"),
                  torch.ones(1, 1, dtype=torch.bool, device="meta"))
