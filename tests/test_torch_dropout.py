"""Dropout of the port (vlbert_tpu_torch.ops.dropout, kernel K5's plain
version and its plain Philox generator) against the JAX package on the CPU.

The JAX package's 'bits16' dropout draws uint16 bits with jax.random; the
same bits go to the port's explicit-bits mode. The Philox mode has no JAX
counterpart (the TPU's hardware generator cannot be reproduced): it is
held to the published Philox4x32-10 known-answer vectors and to its own
contract (replay, keep rate, seed sensitivity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlbert_tpu.ops.dropout import dropout_apply as j_dropout_apply
from vlbert_tpu_torch import ops
from vlbert_tpu_torch.ops import dropout as tdrop

T = torch.from_numpy


def _round_np(x, dtype):
    """x rounded to ``dtype`` (a jnp name), as fp32 numpy."""
    return x if dtype == "float32" else np.asarray(
        jnp.asarray(x, getattr(jnp, dtype)).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.25, 1.0])
def test_plain_dropout_matches_jax_bits16(rng, rate, dtype):
    # tolerance 0: both sides do one multiply by the same scale rounded to
    # x's dtype (1/(1-0.1) is 1.109375 in bf16, 1.111328125 in fp16) and
    # round once
    shape = (3, 5, 40)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(int(rate * 100))
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint16)).astype(
        np.int32)
    jd = getattr(jnp, dtype)
    jout, vjp = jax.vjp(lambda a: j_dropout_apply(a, key, rate, "bits16"),
                        jnp.asarray(x, jd))
    (jgrad,) = vjp(jnp.asarray(g, jd))

    td = getattr(torch, dtype)
    xt = T(x).to(td).requires_grad_()
    out = tdrop.dropout_apply(xt, rate, bits=T(bits))
    # at rate 1 the output is a constant zero tensor: no graph, gradient 0
    grad = (torch.autograd.grad(out, xt, T(g).to(td))[0] if out.requires_grad
            else torch.zeros_like(xt))
    assert out.dtype == td
    np.testing.assert_array_equal(out.float().detach().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    np.testing.assert_array_equal(grad.float().numpy(),
                                  np.asarray(jgrad.astype(jnp.float32)))
    if 0 < rate < 1:
        kept = out.float().detach().numpy() != 0
        scale = float(np.asarray(jnp.asarray(1 / (1 - rate), jd)
                                 .astype(jnp.float32)))
        if rate == 0.1 and dtype != "float32":
            assert scale == {"bfloat16": 1.109375,
                             "float16": 1.111328125}[dtype]
        np.testing.assert_array_equal(
            out.float().detach().numpy()[kept],
            _round_np(_round_np(x, dtype)[kept] * scale, dtype))


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_plain_philox_known_answers(ctr, key, want):
    # Random123's kat_vectors for philox4x32_10
    words = tdrop.philox4x32(*(torch.tensor([c]) for c in ctr),
                             key[0] | (key[1] << 32))
    assert tuple(int(w) for w in words) == want


def test_philox_dropout_replays_its_mask_in_backward():
    x = torch.ones(4, 33, 65, requires_grad=True)
    out = tdrop.dropout_apply(x, 0.3, seed=12345)
    (dx,) = torch.autograd.grad(out, x, torch.ones_like(out))
    keep = tdrop.keep_mask(tdrop.flat_index_bits(x.shape, 12345), 0.3, False)
    assert torch.equal(out != 0, keep) and torch.equal(dx != 0, keep)
    np.testing.assert_allclose(out[keep].detach().numpy(), 1 / 0.7,
                               rtol=1e-6)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_philox_keep_fraction_and_seed_sensitivity(rate):
    shape = (64, 128, 32)                      # 262144 draws
    a = tdrop.keep_mask(tdrop.flat_index_bits(shape, 1), rate, False)
    b = tdrop.keep_mask(tdrop.flat_index_bits(shape, 2), rate, False)
    n = a.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    for m in (a, b):
        assert abs(m.float().mean().item() - (1 - rate)) <= 5 * sigma
    # two seeds disagree on about 2 rate (1 - rate) of the elements
    diff = (a != b).float().mean().item()
    assert abs(diff - 2 * rate * (1 - rate)) <= 10 * sigma


def test_flat_index_bits_take_word_i_mod_4_of_group_i_div_4():
    """K5's layout: one Philox evaluation per four consecutive elements;
    flat element i takes word i % 4 of the evaluation at counter
    (g & 0xffffffff, g >> 32, 0, 0), g = i // 4. n = 21 is not a multiple
    of 4, so the last evaluation feeds only one element."""
    seed = 2 ** 63 + 17
    bits = tdrop.flat_index_bits((3, 7), seed)
    assert bits.shape == (3, 7)
    for i, b in enumerate(bits.reshape(-1).tolist()):
        words = tdrop.philox4x32(*(torch.tensor([c]) for c in
                                   (i // 4, 0, 0, 0)), seed)
        assert b == int(words[i % 4]), i
    # flat indices above 2**32, on the counter arithmetic alone: element
    # 2**32 + 9 is word 1 of group 2**30 + 2, counter (2**30 + 2, 0, 0, 0);
    # element 2**34 + 22 is word 2 of group 2**32 + 5, counter (5, 1, 0, 0)
    for i, ctr in ((2 ** 32 + 9, (2 ** 30 + 2, 0, 0, 0)),
                   (2 ** 34 + 22, (5, 1, 0, 0))):
        got = tdrop.philox_bits(torch.tensor([i // 4]), seed)[0, i % 4]
        words = tdrop.philox4x32(*(torch.tensor([c]) for c in ctr), seed)
        assert int(got) == int(words[i % 4]), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("skip", range(8))
def test_k5_buffers_meet_16_byte_boundaries_at_the_same_element(dtype,
                                                                skip):
    """K5 moves x, out and the explicit int32 bits 16 bytes at a time from
    x's first 16-byte boundary: whatever x's storage offset, the wrapper's
    out and bits buffers meet a boundary at that same flat element."""
    n = 37
    x = torch.zeros(n + skip, dtype=dtype)[skip:]
    head = (-x.data_ptr() % 16) // x.element_size()
    assert (x.data_ptr() + head * x.element_size()) % 16 == 0
    for want in (dtype, torch.int32):
        buf = tdrop._aligned_like(x, want)
        assert buf.shape == x.shape and buf.dtype == want
        assert buf.is_contiguous()
        assert (buf.data_ptr() + head * buf.element_size()) % 16 == 0


def test_rate_one_gives_zeros_and_rate_zero_identity():
    x = torch.randn(3, 7)
    assert torch.equal(tdrop.dropout_apply(x, 1.0, seed=3),
                       torch.zeros_like(x))
    assert tdrop.dropout_apply(x, 0.0, seed=3) is x
    # the threshold saturates below 2**32 at rate 1, as the JAX kernel's
    assert tdrop.threshold(1.0, False) == 2 ** 32 - 1
    assert tdrop.threshold(0.25, True) == 16384


def test_dropout_module_needs_a_seed_and_sites_differ():
    m = tdrop.Dropout(0.5).train()
    x = torch.ones(8, 64)
    with pytest.raises(RuntimeError, match="dropout_seeds"):
        m(x)
    with tdrop.dropout_seeds(9):
        a, b = m(x), m(x)                      # sites 0 and 1
    with tdrop.dropout_seeds(9):
        a2 = m(x)
    assert torch.equal(a, a2) and not torch.equal(a, b)
    assert torch.equal(a, tdrop.plain_dropout(x, 0.5,
                                              seed=tdrop.fold_in(9, 0)))
    assert m.eval()(x) is x


def test_kernel_wrapper_is_an_autograd_function_that_replays(monkeypatch):
    """The CUDA route, with the launch swapped for the plain version on
    graph-free tensors: the gradient must come from the wrapper's own
    backward, which relaunches with the forward's seed."""
    calls = []

    def fake_launch(x, rate, seed, bits):
        calls.append(seed)
        with torch.no_grad():
            return tdrop.plain_dropout(x, rate, seed=seed)

    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(tdrop, "_dropout_launch", fake_launch)
    monkeypatch.setattr(tdrop.hw_dropout, "launches", 0)
    monkeypatch.setattr(tdrop.hw_dropout, "bwd_launches", 0)
    x = torch.randn(5, 17, requires_grad=True)
    g = torch.randn(5, 17)
    out = tdrop.hw_dropout(x, 0.2, seed=77)
    (dx,) = torch.autograd.grad(out, x, g)
    want = tdrop.plain_dropout(x, 0.2, seed=77)
    (want_dx,) = torch.autograd.grad(want, x, g)
    assert calls == [77, 77]
    assert (tdrop.hw_dropout.launches, tdrop.hw_dropout.bwd_launches) == (1, 1)
    assert torch.equal(out, want.detach()) and torch.equal(dx, want_dx)
