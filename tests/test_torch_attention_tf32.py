"""The arithmetic of the fp32 tensor-core attention kernels (K2 forward, K3
forward with prob dropout, K4 backward;
``vlbert_tpu_torch/csrc/attention_f32_mma.cu``), emulated in plain PyTorch
on the CPU and held to the tolerances chip_smoke.py holds the kernels to
on the card.

Each fp32 operand x splits into big = x rounded to TF32 (round to
nearest, ties away from zero, the 13 low bits of the fp32 word cleared:
``cvt.rna.tf32.f32``) and small = (x - big) rounded to TF32. Each product
is three m16n8k8 MMAs into one fp32 accumulator, small terms first:
small*big + big*small + big*big. The emulation adds each MMA's eight exact
products (fp64) to the fp32 accumulator and rounds once per MMA; the
tensor core's own adder is not modelled further. Scores, softmax, dS and
the scaling follow the kernels: s = fmaf(q.k, 1/8, bias), p = exp(s - m),
out = (e V) / l; K3 keeps l over every key and takes out = (keep e V) *
(drop_scale / l).

The inputs are chip_smoke.py's fp32 parity inputs at a smaller batch:
randn q, k, v (views of one fused projection) with 5 masked keys
(``k2_parity``), and ``_train_qkv``'s q, k on a 2**-6 grid with 7 padded
keys and a batch row whose keys are all masked (``k34_parity``); K3 and
K4 with the Philox mask at rate 0.1, K3 also with explicit bits (the JAX
package's 'bits16' rule, drawn by jax.random.bits). The split stays
within K2_ATOL and K3_ATOL (1e-5) and BWD_RTOL (1e-4, of max(1, max
|reference|)); one TF32 pass misses them, which is why the kernels take
three.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_attention import _jax_bits16_attention
from vlbert_tpu_torch.ops import attention as tattn
from vlbert_tpu_torch.ops.dropout import keep_mask

K2_ATOL = 1e-5      # chip_smoke.py K2_ATOL["float32"]
K3_ATOL = 1e-5      # chip_smoke.py K3_ATOL["float32"]
JAX_ATOL = 1e-4     # the port against the JAX package's fp32 XLA path
BWD_RTOL = 1e-4     # chip_smoke.py BWD_RTOL["float32"]
RATE = 0.1          # chip_smoke.py DROP_RATE
H, D = 12, 64
SCALE = 1.0 / math.sqrt(D)


def tf32(x):
    """x rounded to TF32 by bit operations on its fp32 word: add half of
    the 13 dropped bits' weight to the magnitude (a carry runs into the
    exponent), then clear them: to nearest, ties away from zero."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mma_product(a, b, passes=3):
    """a @ b ([..., M, K] x [..., K, N], fp32) as the kernels compute it:
    k in steps of 8, each step three TF32 MMAs (small*big, big*small,
    big*big) or, with passes=1, one (big*big)."""
    pad = -a.shape[-1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ab, asm), (bb, bsm) = split(a), split(b)
    terms = ((asm, bb), (ab, bsm), (ab, bb)) if passes == 3 else ((ab, bb),)
    c = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            c = (c.double() + x[..., k0:k0 + 8].double()
                 @ y[..., k0:k0 + 8, :].double()).float()
    return c


def _heads(*ts):
    return [t.permute(0, 2, 1, 3) for t in ts]


def _scores(qh, kh, bias, passes):
    """e = exp(s - m) and l = sum e for s = fmaf(q.k, 1/8, bias)."""
    s = mma_product(qh, kh.transpose(-1, -2), passes)
    x = (s.double() * SCALE + bias.double()).float()
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e, e.sum(-1, keepdim=True)


def emulated_k2(q, k, v, bias, passes=3):
    qh, kh, vh = _heads(q, k, v)
    e, l = _scores(qh, kh, bias, passes)
    return _heads(mma_product(e, vh, passes) / l)[0]


def emulated_k3(q, k, v, bias, keep, passes=3):
    """K3: K2's sweep with the keep mask on the exponentials that enter
    P V; the row sum l still counts every key; out = (keep e V) *
    (drop_scale / l)."""
    drop_scale = torch.tensor(1.0 / (1.0 - RATE), dtype=torch.float32)
    qh, kh, vh = _heads(q, k, v)
    e, l = _scores(qh, kh, bias, passes)
    pv = mma_product(torch.where(keep, e, 0.0), vh, passes)
    return _heads(pv * (drop_scale / l))[0]


def emulated_k4(q, k, v, bias, g, keep, passes=3):
    """K4's rows and keys passes, its five products: S = Q K^T and dP =
    g V^T, D = sum_j P_j keep_j drop_scale dP_j (= g . out), then dQ = dS K,
    dK = dS^T Q, dV = Pd^T g."""
    drop_scale = 1.0 / (1.0 - RATE)
    qh, kh, vh, gh = _heads(q, k, v, g)
    e, l = _scores(qh, kh, bias, passes)
    p = e * (1.0 / l)
    dp = mma_product(gh, vh.transpose(-1, -2), passes)
    dpm = torch.where(keep, dp * drop_scale, 0.0)
    dd = (p * dpm).sum(-1, keepdim=True)
    ds = p * (dpm - dd)
    dq = mma_product(ds, kh, passes) * SCALE
    dk = mma_product(ds.transpose(-1, -2), qh, passes) * SCALE
    dv = mma_product(torch.where(keep, p * drop_scale, 0.0)
                     .transpose(-1, -2), gh, passes)
    dbias = ds.sum(2, keepdim=True).sum(1, keepdim=True)
    return [*_heads(dq, dk, dv), dbias]


def parity_inputs(kind, B=2, L=128, seed=0):
    """(fused qkv, (q, k, v), bias) as chip_smoke.py makes them: "randn"
    as k2_parity (5 masked keys), "grid" as _train_qkv (q, k on a 2**-6
    grid in (-4, 4), 7 padded keys, batch row 1 all masked)."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(
        rng.standard_normal((B, L, 3 * H * D)).astype(np.float32))
    m = torch.ones(B, L)
    if kind == "grid":
        qk = torch.round(qkv[..., :2 * H * D] * 64).clamp(-255, 255) / 64
        qkv = torch.cat([qk, qkv[..., 2 * H * D:]], -1)
        m[:, -7:] = 0
        m[1] = 0
    else:
        m[:, -5:] = 0
    q, k, v = qkv.view(B, L, 3, H, D).unbind(2)
    return qkv, (q, k, v), ((1.0 - m) * -10000.0)[:, None, None, :]


def _rel_err(a, b):
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


def _plain_dropout_grads(qkv, bias, g, seed):
    B, L = qkv.shape[:2]
    x, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    q, k, v = x.view(B, L, 3, H, D).unbind(2)
    out = tattn.plain_attention_dropout(q, k, v, b, RATE, seed=seed)
    return torch.autograd.grad(out, (q, k, v, b), g)


def test_tf32_rounding_is_to_nearest_ties_away_with_13_bits_cleared():
    ulp = 2.0 ** -10                      # TF32's step in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 2 - 3 * ulp / 4, 2 - ulp / 2, 0.0,
                      float("inf")], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 2 - ulp, 2.0, 0.0,
            float("inf")]
    got = tf32(x)
    assert got.tolist() == want
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # big + small leaves at most 2**-22 of x; small is rarely 0
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        100_000).astype(np.float32))
    big, small = split(r)
    assert ((r.double() - big.double() - small.double()).abs()
            <= 2.0 ** -22 * r.double().abs()).all()
    assert small.ne(0).float().mean() > 0.99


def test_scores_on_the_grid_are_exact():
    """chip_smoke.py's exact-score inputs: q, k on a 2**-6 grid in (-4, 4)
    have at most 8 significant bits, so small is 0, and the split's q.k
    equals the exact sum."""
    _, (q, k, _), _ = parity_inputs("grid", L=41)
    for x in (q, k):
        big, small = split(x.contiguous())
        assert torch.equal(big, x) and not small.any()
    qh, kh = _heads(q, k)
    exact = qh.double() @ kh.double().transpose(-1, -2)
    assert torch.equal(mma_product(qh, kh.transpose(-1, -2)).double(), exact)


@pytest.mark.parametrize("kind,L", [("randn", 41), ("randn", 128),
                                    ("grid", 41), ("grid", 128)])
def test_split_k2_is_within_the_fp32_tolerance(kind, L):
    _, (q, k, v), bias = parity_inputs(kind, L=L)
    want = tattn.plain_attention(q, k, v, bias)
    err = (emulated_k2(q, k, v, bias) - want).abs().max().item()
    assert err <= K2_ATOL / 4, err
    # one TF32 pass is off by 2**-11 of each product: it misses 1e-5
    one = (emulated_k2(q, k, v, bias, passes=1) - want).abs().max().item()
    assert one > 10 * K2_ATOL, one


@pytest.mark.parametrize("kind,L", [("randn", 41), ("randn", 128),
                                    ("grid", 41), ("grid", 128)])
def test_split_k4_is_within_the_fp32_tolerance(kind, L):
    qkv, (q, k, v), bias = parity_inputs(kind, L=L)
    B, seed = q.shape[0], 12
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        q.shape).astype(np.float32))
    keep = keep_mask(tattn.attention_bits(B, H, L, seed), RATE, False)
    want = _plain_dropout_grads(qkv, bias, g, seed)
    got = emulated_k4(q, k, v, bias, g, keep)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    assert max(errs) <= BWD_RTOL / 10, errs
    one = emulated_k4(q, k, v, bias, g, keep, passes=1)
    assert max(_rel_err(a, b) for a, b in zip(one, want)) > BWD_RTOL


@pytest.mark.parametrize("mode", ["philox", "bits"])
@pytest.mark.parametrize("L", [41, 128, 173])
def test_split_k3_is_within_the_fp32_tolerance(mode, L):
    """K3 on the split, on k34_parity's inputs (q, k on the 2**-6 grid, 7
    padded keys, an all-masked batch row), against plain_attention_dropout
    with the same mask: Philox from a seed, or explicit bits; in bits mode
    also against the JAX package's fp32 training attention under
    'bits16' with the same bits (its XLA path: the Pallas kernel averages
    an all-masked row over its padded length)."""
    _, (q, k, v), bias = parity_inputs("grid", L=L)
    B = q.shape[0]
    if mode == "philox":
        kw = dict(seed=12)
        keep = keep_mask(tattn.attention_bits(B, H, L, 12), RATE, False)
    else:
        key = jax.random.PRNGKey(L)
        bits = np.asarray(jax.random.bits(key, (B, H, L, L), jnp.uint16))
        kw = dict(bits=torch.from_numpy(bits.astype(np.int32)))
        keep = keep_mask(kw["bits"].long(), RATE, True)
    want = tattn.plain_attention_dropout(q, k, v, bias, RATE, **kw)
    got = emulated_k3(q, k, v, bias, keep)
    err = (got - want).abs().max().item()
    assert err <= K3_ATOL / 4, err
    # the mask drops about a tenth of every row's probs
    assert abs((~keep).float().mean().item() - RATE) < 0.01
    if mode == "bits":
        jx = _jax_bits16_attention(*(jnp.asarray(t.contiguous().numpy())
                                     for t in (q, k, v, bias)), key, RATE)
        np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=0,
                                   atol=JAX_ATOL)
    one = (emulated_k3(q, k, v, bias, keep, passes=1) - want).abs().max()
    assert one.item() > 10 * K3_ATOL, one.item()
