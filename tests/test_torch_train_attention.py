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
    head place (the defaults: heads 0.. of the launch's own H) and its
    gradients are the plain version's."""
    seeds = []

    def fake_fwd(q, k, v, bias, rate, seed, bits, heads):
        seeds.append((seed, heads))
        with torch.no_grad():
            return tattn.plain_attention_dropout(q, k, v, bias, rate,
                                                 seed=seed)

    def fake_bwd(q, k, v, bias, g, rate, seed, bits, heads):
        seeds.append((seed, heads))
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
    assert seeds == [(2 ** 63 + 5, (0, q.shape[2]))] * 2
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tg, wg):
        np.testing.assert_array_equal(a, b)


def test_attention_bits_follow_the_philox_counter():
    """Key k of query q in head (b, h) takes word k % 4 of one Philox
    evaluation at counter (k // 4, q, b*H + h, 1): four neighbouring keys
    share an evaluation, and L need not be a multiple of 4."""
    from vlbert_tpu_torch.ops.dropout import philox4x32

    B, H, L, seed = 2, 3, 7, 11
    bits = tattn.attention_bits(B, H, L, seed=seed)
    assert bits.shape == (B, H, L, L)
    for b, h, q, k in ((1, 2, 3, 4), (0, 0, 0, 0), (1, 1, 6, 6), (0, 2, 5, 3),
                       (1, 0, 2, 5)):
        words = philox4x32(*(torch.tensor([c]) for c in
                             (k // 4, q, b * H + h, 1)), seed)
        assert int(bits[b, h, q, k]) == int(words[k % 4]), (b, h, q, k)
    # every element, against the counter layout written out per element
    c0, q, bh = torch.meshgrid(torch.arange(L) // 4, torch.arange(L),
                               torch.arange(B * H), indexing="ij")
    one = torch.ones((), dtype=torch.int64)
    words = torch.stack(philox4x32(c0, q, bh, one, seed), -1)
    word = words.gather(-1, (torch.arange(L) % 4)[:, None, None, None]
                        .expand(L, L, B * H, 1))[..., 0]
    assert torch.equal(bits, word.permute(2, 1, 0).reshape(B, H, L, L))


def _order_probe(grid, flip, B=4, L=41, H=12):
    """plain_attention_dropout's output and gradients with 7 padded keys
    and batch row 1 all masked; flip reverses the head dim of q and k,
    which sums each q.k in another fp32 order."""
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(B, L, 3 * H * 64, generator=g)
    if grid:
        qk = torch.round(qkv[..., :2 * H * 64] * 64).clamp(-255, 255) / 64
        qkv = torch.cat([qk, qkv[..., 2 * H * 64:]], -1)
    gy = torch.randn(B, L, H, 64, generator=g)
    m = torch.ones(B, L)
    m[:, -7:] = 0
    m[1] = 0
    bias = ((1.0 - m) * -10000.0)[:, None, None, :].requires_grad_()
    x = qkv.requires_grad_()
    q, k, v = x.view(B, L, 3, H, 64).unbind(2)
    if flip:
        q, k = q.flip(-1), k.flip(-1)
    out = tattn.plain_attention_dropout(q, k, v, bias, 0.1, seed=12)
    return [out, *torch.autograd.grad(out, (x, bias), gy)]


def test_exact_score_inputs_make_fp32_sums_order_free():
    """Why chip_smoke.py's K3/K4 parity puts q and k on a 2**-6 grid: on a
    row whose keys all carry -10000 an fp32 score's step is 2**-10, so two
    fp32 summation orders of q.k move that row's output and gradients by
    ~1e-4, the fp32 tolerance itself; elsewhere by ~1e-6. On the grid every
    q.k is exact in fp32 and the two orders agree bit for bit."""
    for a, b in zip(_order_probe(False, False), _order_probe(False, True)):
        masked = (a[1] - b[1]).abs().max().item()
        live = max((a[i] - b[i]).abs().max().item() for i in (0, 2, 3))
        assert masked > 2e-5 and masked > 10 * live, (masked, live)
    for a, b in zip(_order_probe(True, False), _order_probe(True, True)):
        assert torch.equal(a, b)


def test_bf16_kernel_route_refuses_rows_off_16_byte_boundaries():
    """The bf16 K3/K4 and the fp32 K4 copy each row of q, k, v and g in
    16-byte pieces (fp32 K3 shares K4's checks): the fused QKV projection's
    views pass in both dtypes; a view that starts 2 (bf16) or 4 (fp32)
    bytes in, or a row stride that is not a multiple of 16 bytes, is
    refused before any launch."""
    B, L, H = 2, 5, 2
    qkv = torch.zeros(B, L, 3 * H * 64, dtype=torch.bfloat16)
    q, k, v = qkv.view(B, L, 3, H, 64).unbind(2)
    bias = torch.zeros(B, 1, 1, L)
    tattn._check_dropout_args(q, k, v, bias, g=torch.zeros_like(q))
    shifted = torch.zeros(B * L * H * 64 + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte boundaries"):
        tattn._check_dropout_args(shifted.view(B, L, H, 64), k, v, bias)
    odd = torch.zeros(B, L, H * 64 + 4, dtype=torch.bfloat16)[..., :H * 64]
    with pytest.raises(ValueError, match="16-byte boundaries"):
        tattn._check_dropout_args(q, k, odd.view(B, L, H, 64), bias)
    with pytest.raises(ValueError, match="g rows"):
        tattn._check_dropout_args(q, k, v, bias,
                                  g=shifted.view(B, L, H, 64))
    # fp32: K4 is on the tensor cores too
    q32, k32, v32 = torch.zeros(B, L, 3 * H * 64).view(
        B, L, 3, H, 64).unbind(2)
    tattn._check_dropout_args(q32, k32, v32, bias, g=torch.zeros_like(q32))
    shifted32 = torch.zeros(B * L * H * 64 + 1)[1:].view(B, L, H, 64)
    with pytest.raises(ValueError, match="16-byte boundaries"):
        tattn._check_dropout_args(shifted32, k32, v32, bias)
    odd32 = torch.zeros(B, L, H * 64 + 2)[..., :H * 64].view(B, L, H, 64)
    with pytest.raises(ValueError, match="k rows"):
        tattn._check_dropout_args(q32, odd32, v32, bias)
    with pytest.raises(ValueError, match="g rows"):
        tattn._check_dropout_args(q32, k32, v32, bias, g=shifted32)


def test_bf16_attention_route_refuses_rows_off_16_byte_boundaries(
        monkeypatch):
    """K2 is on the tensor cores in bf16 and fp32, and copies rows of q, k,
    v in 16-byte pieces: the serve path's fused-QKV views (row stride
    3*H*64) and unfused views pass; a view 2 (bf16) or 4 (fp32) bytes in,
    or a row stride that is not a multiple of 16 bytes, is refused on the
    CUDA route before any launch."""
    B, L, H = 2, 5, 2
    qkv = torch.zeros(B, L, 3 * H * 64, dtype=torch.bfloat16)
    q, k, v = qkv.view(B, L, 3, H, 64).unbind(2)
    bias = torch.zeros(B, 1, 1, L)
    tattn._check_cuda_args(q, k, v, bias, "fused_attention")
    unfused = [torch.zeros(B, L, H * 64, dtype=torch.bfloat16).view(
        B, L, H, 64) for _ in range(3)]
    tattn._check_cuda_args(*unfused, bias, "fused_attention")

    def no_launch(*a):
        raise AssertionError("launched")

    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(tattn.fused_attention, "launches", 0)
    import vlbert_tpu_torch.kernels.build as build
    monkeypatch.setattr(build, "load", no_launch)
    shifted = torch.zeros(B * L * H * 64 + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError,
                       match="fused_attention: the kernel needs q rows"):
        tattn.fused_attention(shifted.view(B, L, H, 64), k, v, bias)
    odd = torch.zeros(B, L, H * 64 + 4, dtype=torch.bfloat16)[..., :H * 64]
    with pytest.raises(ValueError,
                       match="fused_attention: the kernel needs v rows"):
        tattn.fused_attention(q, k, odd.view(B, L, H, 64), bias)
    # fp32: the same rule, 4-element steps
    q32, k32, v32 = torch.zeros(B, L, 3 * H * 64).view(
        B, L, 3, H, 64).unbind(2)
    tattn._check_cuda_args(q32, k32, v32, bias, "fused_attention")
    shifted32 = torch.zeros(B * L * H * 64 + 1)[1:].view(B, L, H, 64)
    with pytest.raises(ValueError,
                       match="fused_attention: the kernel needs q rows"):
        tattn.fused_attention(shifted32, k32, v32, bias)
    odd32 = torch.zeros(B, L, H * 64 + 2)[..., :H * 64].view(B, L, H, 64)
    with pytest.raises(ValueError,
                       match="fused_attention: the kernel needs k rows"):
        tattn.fused_attention(q32, odd32, v32, bias)
    assert tattn.fused_attention.launches == 0


def test_attention_kernels_are_chosen_by_dtype():
    """bf16 and fp16 launch the tensor-core kernels of
    attention_dropout_mma.cu (K2, K3, K4), each type its own entry points;
    fp32 launches K2, K3 and K4 of attention_f32_mma.cu (the tensor cores
    by a three-product TF32 split). Each entry point is defined in that
    one source; no other dtype has a kernel."""
    import re
    import types

    from vlbert_tpu_torch.kernels import build

    lib = types.SimpleNamespace(**{n: n for n in (
        "attention_fwd_bf16", "attention_fwd_f32", "attention_fwd_fp16",
        "attention_dropout_fwd_bf16", "attention_dropout_bwd_bf16",
        "attention_dropout_fwd_f32", "attention_dropout_bwd_f32",
        "attention_dropout_fwd_fp16", "attention_dropout_bwd_fp16")})
    q16 = torch.zeros(1, 2, 1, 64, dtype=torch.bfloat16)
    q32 = q16.float()
    qh = q16.half()
    assert tattn._attention_kernel(lib, q16) == "attention_fwd_bf16"
    assert tattn._attention_kernel(lib, q32) == "attention_fwd_f32"
    assert tattn._attention_kernel(lib, qh) == "attention_fwd_fp16"
    assert tattn._dropout_kernels(lib, q16) == (
        "attention_dropout_fwd_bf16", "attention_dropout_bwd_bf16")
    assert tattn._dropout_kernels(lib, q32) == (
        "attention_dropout_fwd_f32", "attention_dropout_bwd_f32")
    assert tattn._dropout_kernels(lib, qh) == (
        "attention_dropout_fwd_fp16", "attention_dropout_bwd_fp16")
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        tattn._check_cuda_args(q32.double(), q32.double(), q32.double(),
                               torch.zeros(1, 1, 1, 2), "fused_attention")
    defined = {}
    for src in build.sources():
        for name in re.findall(r'extern "C" int (\w+)\(', src.read_text()):
            defined.setdefault(name, []).append(src.name)
    assert {n: defined[n] for n in vars(lib)} == {
        "attention_fwd_bf16": ["attention_dropout_mma.cu"],
        "attention_dropout_fwd_bf16": ["attention_dropout_mma.cu"],
        "attention_dropout_bwd_bf16": ["attention_dropout_mma.cu"],
        "attention_fwd_fp16": ["attention_dropout_mma.cu"],
        "attention_dropout_fwd_fp16": ["attention_dropout_mma.cu"],
        "attention_dropout_bwd_fp16": ["attention_dropout_mma.cu"],
        "attention_fwd_f32": ["attention_f32_mma.cu"],
        "attention_dropout_bwd_f32": ["attention_f32_mma.cu"],
        "attention_dropout_fwd_f32": ["attention_f32_mma.cu"]}


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
    """F3, repaired with K1b: on CUDA a map that requires grad goes
    through the autograd Function (K1 forward, K1b backward) and gets the
    plain dF; the only gradient refused is the boxes' (they come from
    data), before any launch. Without grad the route launches K1 alone."""
    launched = []

    def fwd(*a):
        launched.append("K1")
        return troi.roi_align_plain(a[0], a[1], a[2], pooled_h=a[3],
                                    pooled_w=a[4], spatial_scale=a[5],
                                    sampling_ratio=a[6], out_dtype=a[7])

    def bwd(g, boxes, mask, shape, dtype, *a):
        launched.append("K1b")
        return troi.roi_align_bwd_plain(
            torch.empty(shape, dtype=dtype), boxes, mask, g, pooled_h=a[0],
            pooled_w=a[1], spatial_scale=a[2], sampling_ratio=a[3])

    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(troi, "_roi_align_cuda", fwd)
    monkeypatch.setattr(troi, "_roi_align_bwd_cuda", bwd)
    f = torch.randn(1, 6, 7, 8, requires_grad=True)
    boxes = torch.tensor([[[0.0, 0.0, 50.0, 40.0]]])
    mask = torch.ones(1, 1, dtype=torch.bool)
    out = troi.roi_align(f, boxes, mask)
    assert launched == ["K1"] and out.grad_fn is not None
    g = torch.randn(out.shape)
    out.backward(g)
    assert launched == ["K1", "K1b"]
    torch.testing.assert_close(
        f.grad, troi.roi_align_bwd_plain(f.detach(), boxes, mask, g),
        rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="no gradient for boxes"):
        troi.roi_align(f, boxes.clone().requires_grad_(), mask)
    assert launched == ["K1", "K1b"]
    launched.clear()
    with torch.no_grad():
        assert troi.roi_align(f, boxes, mask).grad_fn is None
    assert troi.roi_align(f.detach(), boxes, mask).grad_fn is None
    assert launched == ["K1", "K1"]
