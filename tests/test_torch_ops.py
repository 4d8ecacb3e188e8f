"""Port ops (vlbert_tpu_torch.ops) against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both. On the CPU the
port's kernel wrappers take their plain PyTorch versions; the JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_roi_align import _random_case, roi_align_np
from vlbert_tpu.ops import attention as jattn
from vlbert_tpu.ops.coord_embed import coordinate_embeddings as j_coord
from vlbert_tpu.ops.image_norm import normalize_uint8_image as j_norm
from vlbert_tpu.ops.roi_align import roi_align as j_roi_align
from vlbert_tpu_torch.ops import attention as tattn
from vlbert_tpu_torch.ops.coord_embed import coordinate_embeddings
from vlbert_tpu_torch.ops.image_norm import normalize_uint8_image
from vlbert_tpu_torch.ops.roi_align import roi_align, roi_align_weights

T = torch.from_numpy


@pytest.mark.parametrize("to_bgr255,stds", [(True, (1.0, 1.0, 1.0)),
                                            (True, (57.4, 57.1, 58.4)),
                                            (False, (0.229, 0.224, 0.225))])
def test_image_norm_matches_jax(rng, to_bgr255, stds):
    img = rng.integers(0, 256, (2, 9, 13, 3)).astype(np.uint8)
    im_info = np.asarray([[13, 9, 1, 1], [7, 5, 1, 1]], np.float32)
    means = (102.9801, 115.9465, 122.7717) if to_bgr255 else (0.4, 0.45, 0.5)
    want = np.asarray(j_norm(jnp.asarray(img), jnp.asarray(im_info), means,
                             stds, to_bgr255))
    got = normalize_uint8_image(T(img), T(im_info), means, stds,
                                to_bgr255).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.all(got[1, 5:] == 0) and np.all(got[1, :, 7:] == 0)


def test_coord_embed_matches_jax(rng):
    xy = rng.uniform(0, 300, (3, 5, 2))
    wh = rng.uniform(1, 200, (3, 5, 2))
    boxes = np.concatenate([xy, xy + wh, np.broadcast_to(
        np.asarray([640.0, 480.0]), (3, 5, 2))], -1).astype(np.float32)
    want = np.asarray(j_coord(jnp.asarray(boxes), 256))
    got = coordinate_embeddings(T(boxes), 256).numpy()
    assert got.shape == (3, 5, 4, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sampling_ratio", [0, 1, 2])
def test_roi_align_matches_jax_and_golden(rng, sampling_ratio):
    features, boxes, mask = _random_case(rng, B=2, O=5, H=12, W=10, C=128)
    # boxes on and past the map edge, and a degenerate box
    boxes[0, 2] = (150.0, 180.0, 170.0, 200.0)
    boxes[0, 3] = (-40.0, -40.0, 400.0, 400.0)
    boxes[1, 0] = (0.0, 0.0, 0.0, 0.0)
    kw = dict(pooled_h=7, pooled_w=7, spatial_scale=1 / 16,
              sampling_ratio=sampling_ratio)
    got = roi_align(T(features), T(boxes), T(mask), **kw).numpy()
    jf, jb, jm = map(jnp.asarray, (features, boxes, mask))
    for impl in ("xla", "pallas"):
        want = np.asarray(j_roi_align(jf, jb, jm, impl=impl, **kw))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    rois = np.asarray([[b, *boxes[b, o]] for b in range(boxes.shape[0])
                       for o in range(boxes.shape[1])], np.float32)
    golden = roi_align_np(features, rois, 7, 7, 1 / 16, sampling_ratio)
    golden = golden.reshape(got.shape)
    np.testing.assert_allclose(got[mask], golden[mask], rtol=0, atol=1e-4)
    assert np.all(got[~mask] == 0)


def test_roi_align_rejects_oversized_sampling_ratio():
    with pytest.raises(ValueError, match="MAX_GRID"):
        roi_align_weights(torch.zeros(1, 1, 4), 8, 8, 7, 7, 1 / 16,
                          sampling_ratio=9)


def _attn_case(rng, L, B=2, H=4, D=16):
    q, k, v = (rng.normal(size=(B, L, H, D)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, L), np.float32)
    mask[0, L - min(5, L - 1):] = 0.0
    mask[1, :L // 2] = 0.0
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("L", [7, 41, 130])
def test_attention_matches_jax(rng, L):
    q, k, v, bias = _attn_case(rng, L)
    got = tattn.fused_attention(*map(T, (q, k, v, bias))).numpy()
    assert np.isfinite(got).all()
    jargs = list(map(jnp.asarray, (q, k, v, bias)))
    want_fused = np.asarray(jattn.fused_attention(*jargs))
    want_xla, _ = jattn._xla_attention(*jargs)
    np.testing.assert_allclose(got, want_fused, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want_xla), rtol=0, atol=1e-5)


def test_attention_all_keys_masked_matches_jax(rng):
    # -10000 is added, not used to skip keys: a row whose keys are all
    # masked still averages V uniformly, as the reference does
    q, k, v, bias = _attn_case(rng, 9)
    bias[1] = -10000.0
    got = tattn.fused_attention(*map(T, (q, k, v, bias))).numpy()
    want, _ = jattn._xla_attention(*map(jnp.asarray, (q, k, v, bias)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_attention_rejects_non_key_bias(rng):
    q, k, v, _ = _attn_case(rng, 7)
    with pytest.raises(ValueError, match=r"\[B,1,1,L\]"):
        tattn.fused_attention(T(q), T(k), T(v), torch.zeros(2, 4, 7, 7))
