"""Training attention of the port (vlbert_tpu_torch.ops.attention: the
plain versions of kernels K3/K4 and K2's gradient) against the JAX package
on the CPU, and the autograd wiring of the CUDA route.

The JAX Pallas kernels run in interpret mode (``hw=False``: uint16 bits
from jax.random); the same [B, H, L, L] bits go to the port. Tolerances:
fp32 on both sides with sums in another order, atol 1e-4 on outputs (sums
of up to 130 products scaled by 1/(1-rate); measured up to 3.7e-5 at
L=130) and on gradients (sums over L queries and H heads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ops import _attn_case
from vlbert_tpu.ops import attention as jattn
from vlbert_tpu.ops.dropout import dropout_apply as j_dropout_apply
from vlbert_tpu_torch import ops
from vlbert_tpu_torch.models.vlbert import VisualLinguisticBert, VLBertConfig
from vlbert_tpu_torch.ops import attention as tattn
from vlbert_tpu_torch.ops import roi_align as troi
from vlbert_tpu_torch.ops.dropout import dropout_seeds

T = torch.from_numpy
OUT_TOL = dict(rtol=0, atol=1e-4)
GRAD_TOL = dict(rtol=0, atol=1e-4)


def _jax_grads(fn, args, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_grads(fn, args, g):
    leaves = [T(a).requires_grad_() for a in args]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, T(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _jax_bits16_attention(q, k, v, bias, key, rate):
    """The JAX package's unfused training attention under
    DROPOUT_IMPL='bits16' (models/bert.py _core in fp32): the same mask as
    fused_attention_dropout(..., hw=False) from the same key."""
    _, p = jattn._xla_attention(q, k, v, bias)
    pd = j_dropout_apply(p, key, rate, "bits16")
    return jnp.einsum("bhqk,bkhd->bqhd", pd, v).astype(q.dtype)


@pytest.mark.parametrize("L", [7, 41, 130])
def test_plain_attention_dropout_matches_jax(rng, L):
    q, k, v, bias = _attn_case(rng, L)
    bias[1] = -10000.0                         # a row with every key masked
    g = rng.normal(size=q.shape).astype(np.float32)
    rate = 0.2
    key = jax.random.PRNGKey(L)
    B, _, H, _ = q.shape
    bits = np.asarray(jax.random.bits(key, (B, H, L, L), jnp.uint16))
    got, tg = _port_grads(
        lambda *a: tattn.fused_attention_dropout(
            *a, rate, bits=T(bits.astype(np.int32))), (q, k, v, bias), g)
    want, jg = _jax_grads(
        lambda *a: _jax_bits16_attention(*a, key, rate), (q, k, v, bias), g)
    np.testing.assert_allclose(got, want, **OUT_TOL)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), tg, jg):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
    # the Pallas kernel (interpret mode) agrees wherever a row has a live
    # key; on an all-masked row it averages over its padded length instead
    # of L (its padded keys carry the same -10000), so row 1 is left out
    kernel, kg = _jax_grads(
        lambda *a: jattn.fused_attention_dropout(*a, key, rate, False),
        (q, k, v, bias), g)
    np.testing.assert_allclose(got[0], kernel[0], **OUT_TOL)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), tg, kg):
        np.testing.assert_allclose(a[0], b[0], err_msg=name, **GRAD_TOL)


def test_attention_backward_matches_jax_vjp(rng):
    """F1: K2's gradient (attention_bwd_plain) is the JAX package's _bwd."""
    q, k, v, bias = _attn_case(rng, 41)
    bias[0, ..., :3] = -10000.0
    g = rng.normal(size=q.shape).astype(np.float32)
    _, jg = _jax_grads(jattn.fused_attention, (q, k, v, bias), g)
    tg = tattn.attention_bwd_plain(*map(T, (q, k, v, bias, g)))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), tg, jg):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **GRAD_TOL)


def test_kernel_attention_route_has_a_gradient(rng, monkeypatch):
    """F1: on the CUDA route the kernel's output (here the plain forward on
    graph-free tensors) carries the JAX package's gradient."""
    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")

    def fake_launch(q, k, v, bias):
        with torch.no_grad():
            return tattn.plain_attention(q, k, v, bias)

    monkeypatch.setattr(tattn, "_attention_launch", fake_launch)
    monkeypatch.setattr(tattn.fused_attention, "launches", 0)
    q, k, v, bias = _attn_case(rng, 9)
    g = rng.normal(size=q.shape).astype(np.float32)
    _, jg = _jax_grads(jattn.fused_attention, (q, k, v, bias), g)
    _, tg = _port_grads(tattn.fused_attention, (q, k, v, bias), g)
    assert tattn.fused_attention.launches == 1
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), tg, jg):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def test_kernel_attention_dropout_route_replays_the_seed(rng, monkeypatch):
    """The K3/K4 Function: the backward launch gets the forward's seed and
    its gradients are the plain version's."""
    seeds = []

    def fake_fwd(q, k, v, bias, rate, seed, bits):
        seeds.append(seed)
        with torch.no_grad():
            return tattn.plain_attention_dropout(q, k, v, bias, rate,
                                                 seed=seed)

    def fake_bwd(q, k, v, bias, g, rate, seed, bits):
        seeds.append(seed)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
            out = tattn.plain_attention_dropout(*leaves, rate, seed=seed)
            return torch.autograd.grad(out, leaves, g)

    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(tattn, "_attention_dropout_launch", fake_fwd)
    monkeypatch.setattr(tattn, "_attention_dropout_bwd_launch", fake_bwd)
    q, k, v, bias = _attn_case(rng, 12)
    g = rng.normal(size=q.shape).astype(np.float32)
    got, tg = _port_grads(lambda *a: tattn.fused_attention_dropout(
        *a, 0.3, seed=2 ** 63 + 5), (q, k, v, bias), g)
    monkeypatch.setattr(ops, "device_kind", lambda t: t.device.type)
    want, wg = _port_grads(lambda *a: tattn.plain_attention_dropout(
        *a, 0.3, seed=2 ** 63 + 5), (q, k, v, bias), g)
    assert seeds == [2 ** 63 + 5] * 2
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tg, wg):
        np.testing.assert_array_equal(a, b)


def test_attention_bits_follow_the_philox_counter():
    bits = tattn.attention_bits(2, 3, 5, seed=11)
    from vlbert_tpu_torch.ops.dropout import philox_bits

    b, h, q, k = 1, 2, 3, 4
    want = philox_bits(*(torch.tensor([c]) for c in (k, q, b * 3 + h, 1)),
                       11)
    assert int(bits[b, h, q, k]) == int(want)


def _tiny_vlbert(attn_rate):
    cfg = VLBertConfig(vocab_size=1050, hidden_size=32, visual_size=32,
                       num_hidden_layers=2, num_attention_heads=2,
                       intermediate_size=64, max_position_embeddings=32,
                       visual_ln=True, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=attn_rate)
    torch.manual_seed(0)
    return VisualLinguisticBert(cfg)


def test_train_mode_draws_attention_prob_dropout(rng, monkeypatch):
    """F2: in training the attention core applies prob dropout (K3/K4's
    function), one call per layer, each with its own site seed."""
    import vlbert_tpu_torch.models.bert as bert

    calls = []
    real = bert.fused_attention_dropout

    def spy(q, k, v, bias, rate, seed=None, bits=None):
        calls.append((rate, seed))
        return real(q, k, v, bias, rate, seed=seed, bits=bits)

    monkeypatch.setattr(bert, "fused_attention_dropout", spy)
    B, T_, O = 2, 6, 4
    args = (torch.from_numpy(rng.integers(0, 1050, (B, T_))),
            torch.zeros(B, T_, dtype=torch.long),
            torch.from_numpy(rng.normal(size=(B, T_, 32)).astype(np.float32)),
            torch.ones(B, T_, dtype=torch.bool),
            torch.from_numpy(rng.normal(size=(B, O, 64)).astype(np.float32)),
            torch.ones(B, O, dtype=torch.bool))
    m = _tiny_vlbert(0.5)
    with torch.no_grad():
        eval_out = m.eval()(*args)[0]
        with dropout_seeds(5):
            train_out = m.train()(*args)[0]
    assert [c[0] for c in calls] == [0.5, 0.5]
    assert len({c[1] for c in calls}) == 2
    assert not torch.allclose(train_out, eval_out)
    with torch.no_grad(), dropout_seeds(5):
        same = _tiny_vlbert(0.0).train()(*args)[0]
    torch.testing.assert_close(same, eval_out)


def test_roi_align_refuses_a_gradient_on_cuda(monkeypatch):
    """F3: the CUDA route has no backward yet; asking for one raises."""
    launched = []
    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(troi, "_roi_align_cuda",
                        lambda *a: launched.append(a) or "launched")
    f = torch.randn(1, 6, 7, 8, requires_grad=True)
    boxes = torch.tensor([[[0.0, 0.0, 50.0, 40.0]]])
    mask = torch.ones(1, 1, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="K1b"):
        troi.roi_align(f, boxes, mask)
    assert launched == []
    with torch.no_grad():
        assert troi.roi_align(f, boxes, mask) == "launched"
    assert troi.roi_align(f.detach(), boxes, mask) == "launched"
