"""The port's attention kernels: their plain versions (forward, backward,
dropout mask) against the TPU package's Pallas kernels in interpret mode and
their ``jax.vjp``, the autograd Function by gradcheck, the routing rule
against the TPU package's, and (on a card only) each CUDA kernel against its
plain version.

The machine with the card has no JAX, so JAX is imported inside the tests
that compare with it, and the card's test runs there with
``python -m pytest --noconftest -m gpu tests/test_torch_attention.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from dphubert_torch.configs import AttentionSpec
from dphubert_torch.models.components import SelfAttention, attention_route
from dphubert_torch.ops.attention_common import (
    NEG_INF,
    dropout_keep_mask,
    dropout_threshold,
    keep_mask,
    kernel_body,
    softmax_parts,
)
from dphubert_torch.ops.flash_attention import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_qkv,
    flash_attention_reference,
)
from dphubert_torch.ops.mask_readout import backward_mask_readout, forward_mask_readout
from dphubert_torch.ops.packed_attention import (
    PackedAttentionFn,
    _launch_fwd,
    packed_attention,
    packed_attention_bwd_dkv,
    packed_attention_bwd_dq,
    packed_attention_bwd_reference,
    packed_attention_qkv,
    packed_attention_reference,
    packed_num_groups,
)
from dphubert_torch.ops.wavlm_attention import (
    wavlm_attention,
    wavlm_attention_bwd_dbias,
    wavlm_attention_bwd_dkv,
    wavlm_attention_bwd_dkv_general,
    wavlm_attention_bwd_dq,
    wavlm_attention_bwd_fused,
    wavlm_attention_bwd_reference,
    wavlm_attention_fwd,
    wavlm_attention_fwd_general,
    wavlm_attention_qkv,
    wavlm_attention_reference,
    wavlm_kernel_body,
)


@pytest.fixture
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each test with one intra-op thread: the inputs are tiny, and with
    several test workers on one machine torch's default of one OpenMP thread
    per core oversubscribes the cores (spinning threads slow tiny ops by
    orders of magnitude)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tpu_op(module, name):
    # importlib: the TPU ops package exports functions named like its modules
    return getattr(importlib.import_module(f"dphubert_tpu.ops.{module}"), name)


def _qkv(seed, B, H, L, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H * D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,H,L,D,lengths", [
    (2, 3, 149, 64, None),
    (3, 2, 256, 64, [256, 100, 17]),
    (2, 4, 800, 64, [800, 743]),  # packed_num_groups == 2 on the TPU
])
def test_packed_reference_matches_pallas(jnp, B, H, L, D, lengths):
    j_packed_attention = _tpu_op("packed_attention", "packed_attention")
    q, k, v = _qkv(0, B, H, L, D)
    j_len = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    want = j_packed_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_len, num_heads=H,
        interpret=True,
    )
    t_len = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    got = packed_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), t_len,
        num_heads=H,
    )
    # whole arrays: padded query rows attend to the valid keys in both
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _pallas_flash_fwd(jnp, q, k, v, lengths, block):
    """The TPU flash forward kernel (interpret mode) with its m and l, cut
    back to L rows; ``block`` rows per q and KV tile."""
    B, H, L, D = q.shape
    Lp = -(-L // block) * block
    pad = [(0, 0), (0, 0), (0, Lp - L), (0, 0)]
    lens = jnp.asarray(lengths if lengths is not None else [L] * B, jnp.int32)
    out, m, l = _tpu_op("flash_attention", "_fwd")(
        jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad), lens,
        jnp.zeros((1,), jnp.int32), D ** -0.5, block, block, True, 0.0,
    )
    return (np.asarray(out)[:, :, :L], np.asarray(m)[:, :, :L, 0],
            np.asarray(l)[:, :, :L, 0])


@pytest.mark.parametrize("B,H,L,D,lengths,block", [
    (2, 3, 200, 64, None, 256),           # one KV tile
    (2, 2, 300, 64, [300, 131], 128),     # three KV tiles, online softmax
    (1, 2, 130, 16, [77], 128),           # two KV tiles, narrow heads
])
def test_flash_reference_matches_pallas(jnp, B, H, L, D, lengths, block):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(3))
    want_out, want_m, want_l = _pallas_flash_fwd(
        jnp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths, block
    )
    # the public JAX wrapper agrees with the kernel call above
    j_len = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    np.testing.assert_allclose(
        np.asarray(_tpu_op("flash_attention", "flash_attention")(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_len,
            block_q=block, block_kv=block, interpret=True)),
        want_out, atol=2e-5,
    )
    t_len = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out, m, l = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), t_len
    )
    np.testing.assert_allclose(out.numpy(), want_out, atol=2e-5)
    np.testing.assert_allclose(m.numpy(), want_m, atol=2e-5)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=2e-5)


def test_routing_matches_tpu_package(jnp):
    """packed_num_groups and the layer's kernel choice equal the TPU
    package's on a grid of (L, H, D), including the pruned head counts."""
    j_packed_num_groups = _tpu_op("packed_attention", "packed_num_groups")
    for D in (16, 64, 80):
        for H in range(1, 17):
            for L in (1, 49, 99, 128, 149, 255, 256, 499, 699, 768, 769, 799,
                      899, 999, 1023, 1024, 1025, 1099, 1299, 1749):
                want = j_packed_num_groups(L, H, D)
                assert packed_num_groups(L, H, D) == want, (L, H, D)
                assert attention_route(L, H, D) == ("packed" if want > 0 else "flash")


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 2, 40, 16))
    lens = torch.tensor([40, 9], dtype=torch.int32)
    wrappers = (packed_attention, flash_attention, packed_attention_bwd_dq,
                packed_attention_bwd_dkv)
    counts = [w.launches for w in wrappers]
    torch.testing.assert_close(
        packed_attention(q, k, v, lens, num_heads=2),
        packed_attention_reference(q, k, v, lens, num_heads=2),
    )
    heads = lambda t: t.view(2, 40, 2, 16).transpose(1, 2)
    got = flash_attention(heads(q), heads(k), heads(v), lens)
    want = flash_attention_reference(heads(q), heads(k), heads(v), lens)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)
    # the backward wrappers, with dropout (m, l and di are the kernels' own)
    kw = dict(num_heads=2, scale=0.25, dropout_rate=0.1, seed=torch.tensor([5], dtype=torch.int32))
    out = packed_attention(q, k, v, lens, **kw)
    dout = torch.randn(2, 40, 32, generator=torch.Generator().manual_seed(0))
    want = packed_attention_bwd_reference(q, k, v, out, dout, lens, **kw)
    dq, di = packed_attention_bwd_dq(q, k, v, out, dout, None, None, lens, **kw)
    dk, dv = packed_attention_bwd_dkv(q, k, v, out, dout, None, None, di, lens, **kw)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b)
    torch.testing.assert_close(di, (out * dout).view(2, 40, 2, 16).sum(-1).transpose(1, 2))
    assert [w.launches for w in wrappers] == counts


def test_plain_versions_round_p_to_the_input_dtype():
    """bf16 inputs: packed rounds the normalised p, flash the unnormalised
    p, each before the PV product, as the two TPU kernels do."""
    q, k, v = (torch.from_numpy(x[0]).bfloat16() for x in _qkv(3, 1, 1, 33, 16))
    s = (q.float() @ k.float().T) * 0.25
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l_inv = 1.0 / e.sum(-1, keepdim=True)
    want = ((e * l_inv).bfloat16().float() @ v.float()).bfloat16()
    got = packed_attention_reference(q[None], k[None], v[None], num_heads=1)[0]
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    want_f = ((e.bfloat16().float() @ v.float()) * l_inv).bfloat16()
    got_f, _, _ = flash_attention_reference(q[None, None], k[None, None], v[None, None])
    torch.testing.assert_close(got_f[0, 0], want_f, atol=0, rtol=0)


def test_plain_backward_rounds_p_and_ds_to_bf16():
    """bf16 inputs: both plain backwards round p~ and scale * ds to bf16
    before the dV, dK and dQ products, as the tensor-core kernels' A operands
    are; fp32 inputs are not rounded.  Pinned bit for bit against the
    formulas written out here, dropout on."""
    rng = np.random.default_rng(5)
    B, H, L, D, rate, scale = 1, 2, 33, 16, 0.1, 0.25
    seed = torch.tensor([77], dtype=torch.int32)
    inv_keep = 1.0 / (1.0 - rate)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, out, do = (torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32))
                            .to(dtype) for _ in range(5))
        f = lambda t: t.float()
        s = torch.matmul(f(q), f(k).transpose(-1, -2)) * scale
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e * (1.0 / e.sum(dim=-1, keepdim=True))
        keep = keep_mask(seed, rate, B, H, L, "cpu")
        p_used = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, torch.matmul(f(do), f(v).transpose(-1, -2)) * inv_keep, 0.0)
        ds = p * (dp - (f(out) * f(do)).sum(dim=-1, keepdim=True)) * scale
        ds_r, p_r = ds.to(dtype).float(), p_used.to(dtype).float()
        want = [torch.matmul(ds_r, f(k)), torch.matmul(ds_r.transpose(-1, -2), f(q)),
                torch.matmul(p_r.transpose(-1, -2), f(do))]
        kw = dict(scale=scale, dropout_rate=rate, seed=seed)
        got = flash_attention_bwd_reference(q, k, v, out, do, **kw)
        packed = lambda t: t.transpose(1, 2).reshape(B, L, H * D)
        got_p = packed_attention_bwd_reference(*(packed(t) for t in (q, k, v, out, do)),
                                               num_heads=H, **kw)
        for name, g, gp, w in zip("qkv", got, got_p, want):
            torch.testing.assert_close(g, w.to(dtype), atol=0, rtol=0, msg=f"flash d{name}")
            torch.testing.assert_close(gp, packed(w.to(dtype)), atol=0, rtol=0,
                                       msg=f"packed d{name}")
        if dtype == torch.bfloat16:  # the rounding shows in the results
            unrounded = torch.matmul(p_used.transpose(-1, -2), f(do)).to(dtype)
            assert not torch.equal(got[2], unrounded)


def test_wavlm_plain_backward_rounds_p_and_ds_to_bf16():
    """bf16 inputs: the WavLM plain backward rounds p~ and scale * ds to
    bf16 before the dV, dK and dQ products, as the tensor-core kernels' A
    operands are, while dgate = sum_j ds * bias and dbias = sum_b gate * ds
    come from the unrounded fp32 ds, as the kernels sum them; fp32 inputs
    are not rounded.  Pinned bit for bit against the formulas written out
    here, with the gated bias in the scores, lengths and dropout on."""
    rng = np.random.default_rng(6)
    B, H, L, D, rate, scale = 2, 2, 33, 16, 0.1, 0.25
    seed = torch.tensor([-909], dtype=torch.int32)
    lens = torch.tensor([33, 20], dtype=torch.int32)
    inv_keep = 1.0 / (1.0 - rate)
    bias = torch.from_numpy(rng.standard_normal((H, L, L)).astype(np.float32))
    gate = torch.from_numpy(rng.uniform(0.5, 2.0, (B, H, L)).astype(np.float32))
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, out, do = (torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32))
                            .to(dtype) for _ in range(5))
        f = lambda t: t.float()  # noqa: E731
        s = torch.matmul(f(q), f(k).transpose(-1, -2)) * scale + gate[..., None] * bias[None]
        valid = torch.arange(L)[None, :] < lens[:, None]
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e * (1.0 / e.sum(dim=-1, keepdim=True))
        keep = keep_mask(seed, rate, B, H, L, "cpu")
        p_used = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, torch.matmul(f(do), f(v).transpose(-1, -2)) * inv_keep, 0.0)
        ds = p * (dp - (f(out) * f(do)).sum(dim=-1, keepdim=True))
        ds_r, p_r = (ds * scale).to(dtype).float(), p_used.to(dtype).float()
        want = [torch.matmul(ds_r, f(k)), torch.matmul(ds_r.transpose(-1, -2), f(q)),
                torch.matmul(p_r.transpose(-1, -2), f(do))]
        want_dbias = (gate[..., None] * ds).sum(dim=0)
        want_dgate = (ds * bias[None]).sum(dim=-1)
        got = wavlm_attention_bwd_reference(q, k, v, bias, gate, out, do, lens, scale=scale,
                                            dropout_rate=rate, seed=seed)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(g, w.to(dtype), atol=0, rtol=0, msg=name)
        torch.testing.assert_close(got[3], want_dbias, atol=0, rtol=0, msg="dbias")
        torch.testing.assert_close(got[4], want_dgate, atol=0, rtol=0, msg="dgate")
        if dtype == torch.bfloat16:  # the rounding shows, and dbias/dgate do not take it
            assert not torch.equal(got[2], torch.matmul(p_used.transpose(-1, -2), f(do)).to(dtype))
            assert not torch.equal(got[3], (gate[..., None] * ds_r / scale).sum(dim=0))


def test_dropout_threshold_is_truncated_from_a_double():
    # 0.9 * 4294967295.0 = 3865470565.5: truncated, as np.uint32 does
    assert dropout_threshold(0.9) == 3865470565
    assert dropout_threshold(1.0) == 4294967295
    assert dropout_threshold(0.5) == 2147483647


@pytest.mark.parametrize("seed,b,h,q_off,kv_off,keep", [
    (123, 0, 0, 0, 0, 0.9),
    (-5, 3, 11, 256, 0, 0.9),
    (-2**31, 7, 2, 2**31 - 64, 2**32 - 100, 0.9),  # offsets wrap past 2**32
    (2**31 - 1, 15, 1, 10**9, 5, 0.5),
    (0, 0, 0, 0, 0, 1.0),
])
def test_dropout_mask_bit_exact(jnp, seed, b, h, q_off, kv_off, keep):
    """Bit for bit the TPU package's _dropout_keep_mask, in uint32
    arithmetic, for negative seeds and offsets past 2**31."""
    j_mask = _tpu_op("flash_attention", "_dropout_keep_mask")
    want = np.asarray(j_mask((64, 96), keep, jnp.asarray(seed, jnp.int32), b, h, q_off, kv_off))
    got = dropout_keep_mask((64, 96), keep, seed, b, h, q_off, kv_off).numpy()
    np.testing.assert_array_equal(got, want)
    # the batched form used by the plain attention: (B, H, rows, cols)
    bb = torch.arange(b + 1).view(-1, 1, 1, 1)
    hh = torch.arange(h + 1).view(1, -1, 1, 1)
    batched = dropout_keep_mask((64, 96), keep, seed, bb, hh, q_off, kv_off)
    np.testing.assert_array_equal(batched[b, h].numpy(), want)


def _jax_packed_vjp(jnp, q, k, v, do, lengths, H, rate, key_seed):
    """The TPU packed kernels in interpret mode: forward and jax.vjp, plus
    the int32 seed the JAX wrapper derives from its dropout key."""
    import jax

    j_packed_attention = _tpu_op("packed_attention", "packed_attention")
    j_len = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    rng = jax.random.key(key_seed) if rate else None
    seed = 0
    if rate:
        seed = int(jax.random.bits(rng, (1,), jnp.uint32).astype(jnp.int32)[0])

    def f(q_, k_, v_):
        return j_packed_attention(q_, k_, v_, j_len, num_heads=H, interpret=True,
                                  dropout_rate=rate, dropout_rng=rng)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))], seed


@pytest.mark.parametrize("B,H,L,D,lengths,rate", [
    (2, 3, 149, 64, None, 0.0),
    (2, 3, 149, 64, [149, 77], 0.1),
    (3, 2, 256, 64, [256, 100, 17], 0.0),
    (2, 2, 256, 64, None, 0.1),
    (1, 4, 800, 64, [743], 0.1),  # packed_num_groups == 2 on the TPU
    (1, 4, 800, 64, None, 0.0),
])
def test_packed_forward_and_backward_match_pallas_vjp(jnp, B, H, L, D, lengths, rate):
    """Plain forward (with dropout) and plain backward (dq, dk, dv) against
    the Pallas kernels and their custom VJP; fp32, unit-normal inputs, bound
    1e-5 absolute (measured errors are below 1e-6: only summation order
    differs).  Whole arrays: the JAX wrapper pads L to a tile multiple and
    masks the pad, which is the same math as the port's unpadded kernels."""
    rng = np.random.default_rng(L + B)
    q, k, v, do = (rng.standard_normal((B, L, H * D)).astype(np.float32) for _ in range(4))
    want, want_grads, seed = _jax_packed_vjp(jnp, q, k, v, do, lengths, H, rate, key_seed=L)
    t_len = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    t_seed = torch.tensor([seed], dtype=torch.int32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out = packed_attention_reference(tq, tk, tv, t_len, num_heads=H, dropout_rate=rate, seed=t_seed)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)
    grads = packed_attention_bwd_reference(tq, tk, tv, out, tdo, t_len, num_heads=H,
                                           dropout_rate=rate, seed=t_seed)
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0, err_msg=f"d{name}")
    # the autograd Function on the CPU runs the same plain versions
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1)).requires_grad_()
    got = packed_attention_qkv(qkv, t_len, num_heads=H, dropout_rate=rate, seed=t_seed)
    got.backward(tdo)
    np.testing.assert_array_equal(got.detach().numpy(), out.numpy())
    np.testing.assert_array_equal(qkv.grad.numpy(), torch.cat(grads, dim=-1).numpy())


@pytest.mark.parametrize("lengths,rate", [(None, 0.0), ([12, 7], 0.2), ([5, 12], 0.0)])
def test_packed_attention_fn_gradcheck(lengths, rate):
    """gradcheck of PackedAttentionFn in float64 on the CPU, dropout
    included (the mask is a function of the seed, so the map is smooth);
    2 heads x 4 at L = 12."""
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 12, 3 * 2 * 4, dtype=torch.float64, generator=gen, requires_grad=True)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    seed = torch.tensor([-77], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda x: PackedAttentionFn.apply(x, lens, seed, 2, 0.35, rate), (qkv,)
    )


def test_flash_route_refuses_training():
    """The forward-only flash wrapper refuses autograd and names the
    differentiable form; the layer's flash route (3 heads x 16 at L = 800)
    no longer refuses training: with grad enabled and dropout on it goes
    through FlashAttentionFn, on the CPU as on the card, and every
    parameter gets a finite gradient."""
    spec = AttentionSpec(embed_dim=48, num_heads=3, head_dim=16, dropout=0.1)
    attn = SelfAttention(spec)
    gen = torch.Generator().manual_seed(0)
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.1, generator=gen)
    x = torch.randn(1, 800, 48, generator=gen)
    assert attention_route(800, 3, 16) == "flash"
    attn(x, None, generator=gen).square().sum().backward()
    for name, p in attn.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    with torch.no_grad():
        assert attn(x, None).shape == (1, 800, 48)  # serving still runs
    with pytest.raises(NotImplementedError, match="FlashAttentionFn"):
        flash_attention(*(t.requires_grad_() for t in torch.randn(3, 1, 2, 40, 16)))


def _jax_flash_vjp(q, k, v, do, lengths, rate, key_seed):
    """The TPU flash kernels in interpret mode: forward and jax.vjp, plus
    the int32 seed the JAX wrapper derives from its dropout key."""
    import jax
    import jax.numpy as jnp

    j_flash = _tpu_op("flash_attention", "flash_attention")
    j_len = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    rng = jax.random.key(key_seed) if rate else None
    seed = int(jax.random.bits(rng, (1,), jnp.uint32).astype(jnp.int32)[0]) if rate else 0

    def f(q_, k_, v_):
        return j_flash(q_, k_, v_, j_len, interpret=True, dropout_rate=rate, dropout_rng=rng)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))], seed


@pytest.mark.parametrize("B,H,L,D", [(2, 3, 200, 16), (2, 2, 300, 64)])
@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_forward_and_backward_match_pallas_vjp(jnp, B, H, L, D, with_lengths, rate):
    """Plain flash forward with dropout and FlashAttentionFn's backward
    against the TPU flash kernels (interpret mode) and their custom VJP,
    given the same int32 seed; fp32, unit-normal inputs, bound 1e-5
    absolute (only summation order differs).  Whole arrays: the JAX wrapper
    pads L to its block and masks the pad, the same math unpadded."""
    rng = np.random.default_rng(L + 7 * B + int(10 * rate) + with_lengths)
    q, k, v, do = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4))
    lengths = [L, L * 2 // 3] if with_lengths else None
    want, want_grads, seed = _jax_flash_vjp(q, k, v, do, lengths, rate, key_seed=L + B)
    t_len = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    t_seed = torch.tensor([seed], dtype=torch.int32)
    tq, tk, tv, tdo = (torch.from_numpy(x).requires_grad_() for x in (q, k, v, do))
    out, m, l = flash_attention(tq.detach(), tk.detach(), tv.detach(), t_len,
                                dropout_rate=rate, seed=t_seed)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)
    got = FlashAttentionFn.apply(tq, tk, tv, t_len, t_seed, D ** -0.5, rate)
    np.testing.assert_array_equal(got.detach().numpy(), out.numpy())
    got.backward(tdo.detach())
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-5, rtol=0, err_msg=f"d{name}")
    # the wrappers of the two backward kernels run the same plain version
    kw = dict(scale=D ** -0.5, dropout_rate=rate, seed=t_seed)
    dq, di = flash_attention_bwd_dq(tq.detach(), tk.detach(), tv.detach(), out, tdo.detach(),
                                    m, l, t_len, **kw)
    dk, dv = flash_attention_bwd_dkv(tq.detach(), tk.detach(), tv.detach(), out, tdo.detach(),
                                     m, l, di, t_len, **kw)
    for name, g, t in zip("qkv", (dq, dk, dv), (tq, tk, tv)):
        np.testing.assert_array_equal(g.numpy(), t.grad.numpy(), err_msg=f"d{name}")
    np.testing.assert_allclose(di.numpy(), (out * tdo.detach()).sum(-1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("lengths,rate", [(None, 0.0), ([12, 7], 0.2), ([5, 12], 0.0)])
def test_flash_attention_fn_gradcheck(lengths, rate):
    """gradcheck of FlashAttentionFn in float64 on the CPU, dropout
    included; 2 heads x 4 at L = 12."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 2, 12, 4, dtype=torch.float64, generator=gen, requires_grad=True)
               for _ in range(3))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    seed = torch.tensor([913], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttentionFn.apply(a, b, c, lens, seed, 0.35, rate), (q, k, v)
    )


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc there")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in full fp32


def _assert_close(got, want, rel, what):
    """max abs error <= rel * max |want|"""
    err = (got.float() - want.float()).abs().max().item()
    bound = rel * want.float().abs().max().item()
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


# (dtype, L): fp32 at L = 130 (three 64-row tiles), bf16 at L = 200 (the
# codes stay below 2**4, so they survive the bf16 output)
FORWARD_READOUT_CASES = [(torch.float32, 130), (torch.bfloat16, 200)]


@pytest.mark.parametrize("dtype,L", FORWARD_READOUT_CASES)
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_dropout_mask_read_out_of_the_forward(device, dtype, L):
    """The forward's dropout mask, bit for bit the plain mask, for a
    negative seed and the int32 extremes (``forward_mask_readout``: q = k
    = 0 and value row j holding 2**(j // D) in column j % D, so out * L *
    keep is an integer whose bits are the mask); on the card that is the
    device hash of csrc/attention_common.cuh inside the packed forward,
    through the fp32 CUDA-core body and, in bf16, at every accumulator
    element's (row, column) of the tensor-core body, where a wrong fragment
    map flips bits."""
    if device == "cuda":
        _card()
    n = packed_attention.launches
    seeds = (-123456789, 2**31 - 1, -2**31)
    for seed, got, want, _ in forward_mask_readout("packed", device, dtype, seeds, L=L):
        assert torch.equal(got, want), f"seed {seed}: {(got != want).sum().item()} bits"
        assert 0.85 < want.float().mean().item() < 0.95
    assert packed_attention.launches == n + (len(seeds) if device == "cuda" else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("lengths,rate", [(None, 0.1), ([333, 200, 1], 0.0), ([333, 64, 130], 0.1)])
def test_backward_kernels_match_plain_versions_on_card(dtype, rel, lengths, rate):
    """Forward with dropout, dq and dkv against their plain versions, given
    the same inputs and the kernel's own output (for di).  Bound: max abs
    error <= rel * max |plain|; fp32 differs only in summation order, bf16
    also in the final rounding of dq, dk, dv (2**-8 relative) and in the
    forward's rounding of the unnormalised p (ROADMAP queue 3)."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, L, H, D = 3, 333, 12, 64
    qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(dtype)
    dout = torch.randn(B, L, H * D, device="cuda", generator=gen).to(dtype)
    q, k, v = qkv.split(H * D, dim=-1)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    seed = torch.tensor([987654321], dtype=torch.int32, device="cuda")
    kw = dict(num_heads=H, scale=D ** -0.5, dropout_rate=rate, seed=seed)

    with torch.no_grad():
        out = packed_attention(q, k, v, lens, **kw)
        _assert_close(out, packed_attention_reference(q, k, v, lens, **kw), rel, "out")
    counts = (packed_attention.launches, packed_attention_bwd_dq.launches,
              packed_attention_bwd_dkv.launches)
    x = qkv.clone().requires_grad_()
    y = packed_attention_qkv(x, lens, **kw)
    y.backward(dout)
    assert (packed_attention.launches, packed_attention_bwd_dq.launches,
            packed_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    torch.testing.assert_close(y.detach(), out, atol=0, rtol=0)
    want = packed_attention_bwd_reference(q, k, v, out, dout, lens, **kw)
    for name, got, w in zip("qkv", x.grad.split(H * D, dim=-1), want):
        _assert_close(got, w, rel, f"d{name}")
    # deterministic: no atomics, so a second backward is bit-identical
    x2 = qkv.clone().requires_grad_()
    packed_attention_qkv(x2, lens, **kw).backward(dout)
    assert torch.equal(x.grad, x2.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("layout", ["packed", "flash", "wavlm"])
def test_dropout_mask_read_out_of_the_backward(layout, device, dtype):
    """The backward entries' dropout mask, bit for bit the plain mask, for
    a negative seed and the int32 extremes, read out of dq, dk and dv (and,
    for WavLM's single route, dbias: every batch row's mask) as in
    ``backward_mask_readout``; on the card that is the device hash at each
    accumulator element's (row, column) inside the bf16 tensor-core bodies
    (WavLM's dq, dbias and dkv bodies among them) and the fp32 CUDA-core
    ones, so a wrong fragment map flips bits.  L = 200 ends mid-tile (3 x
    64 + 8); in bf16 the codes (< 2**4) survive the roundings of p~, ds and
    the output."""
    if device == "cuda":
        _card()
    fns = {"packed": (packed_attention_bwd_dq, packed_attention_bwd_dkv),
           "flash": (flash_attention_bwd_dq, flash_attention_bwd_dkv),
           "wavlm": (wavlm_attention_bwd_fused, wavlm_attention_bwd_dkv)}[layout]
    before = [f.launches for f in fns]
    seeds = (-123456789, 2**31 - 1, -2**31)
    found = backward_mask_readout(layout, device, dtype, seeds)
    assert [w for _, w, _, _ in found] == (["dq", "dbias", "dk", "dv"] if layout == "wavlm"
                                           else ["dq", "dk", "dv"]) * len(seeds)
    for seed, what, got, want in found:
        assert torch.equal(got, want), f"{what}, seed {seed}: {(got != want).sum().item()} bits"
        assert 0.85 < want.float().mean().item() < 0.95
    n = 3 * len(seeds) if device == "cuda" else 0
    assert [f.launches for f in fns] == [c + n for c in before]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_dropout_mask_read_out_of_the_wavlm_general_backward(device, dtype):
    """The WavLM general route's backward entries (``wavlm_attention_bwd_dq``,
    ``_dbias`` given dq's di, and ``_dkv_general``) give up the same mask
    as the single route's pair, read out as in
    ``test_dropout_mask_read_out_of_the_backward``
    (``backward_mask_readout(route="general")``): dq, dbias (every batch
    row's mask), dk and dv, bit for bit the plain mask.  On the card, bf16
    takes the tensor-core dq, dbias and dkv bodies, fp32 the CUDA-core
    ones; each entry counts one launch per run, the single pair none."""
    if device == "cuda":
        _card()
    general = (wavlm_attention_bwd_dq, wavlm_attention_bwd_dbias, wavlm_attention_bwd_dkv_general)
    single = (wavlm_attention_bwd_fused, wavlm_attention_bwd_dkv)
    before = [f.launches for f in general + single]
    seeds = (-123456789, 2**31 - 1, -2**31)
    found = backward_mask_readout("wavlm", device, dtype, seeds, route="general")
    assert [w for _, w, _, _ in found] == ["dq", "dbias", "dk", "dv"] * len(seeds)
    for seed, what, got, want in found:
        assert torch.equal(got, want), f"{what}, seed {seed}: {(got != want).sum().item()} bits"
        assert 0.85 < want.float().mean().item() < 0.95
    n = 3 * len(seeds) if device == "cuda" else 0
    assert [f.launches for f in general + single] == [c + n for c in before[:3]] + before[3:]
    with pytest.raises(ValueError, match="route"):
        backward_mask_readout("wavlm", device, dtype, seeds, route="single_block")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_kernels_match_plain_versions_on_card(dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc there")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in full fp32
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, L, H, D = 3, 333, 12, 64
    qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(dtype)
    q, k, v = qkv.split(H * D, dim=-1)
    lens = torch.tensor([L, 200, 0], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        n = packed_attention.launches
        got = packed_attention(q, k, v, lens, num_heads=H)
        assert packed_attention.launches == n + 1
        want = packed_attention_reference(q, k, v, lens, num_heads=H)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
        heads = lambda t: t.view(B, L, H, D).transpose(1, 2)
        n = flash_attention.launches
        got = flash_attention(heads(q), heads(k), heads(v), lens)
        assert flash_attention.launches == n + 1
        want = flash_attention_reference(heads(q), heads(k), heads(v), lens)
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
        torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    with pytest.raises(NotImplementedError, match="forward-only"):
        packed_attention(qg, kg, vg, lens, num_heads=H)


def test_kernel_body_is_the_tensor_core_one_for_bf16_at_head_dim_64():
    """The rows and tests name the body an entry ran: the tensor-core
    (wgmma) bodies of attention_fwd.cu and attention_bwd.cu take bf16 at
    head_dim 64, the CUDA-core (fma) bodies fp32 and head_dim 80."""
    assert kernel_body(torch.bfloat16, 64) == "wgmma"
    for dtype, head_dim in ((torch.float32, 64), (torch.float32, 80), (torch.bfloat16, 80)):
        assert kernel_body(dtype, head_dim) == "fma"


def test_wavlm_kernel_body_is_the_tensor_core_one_for_every_entry_in_bf16_at_64():
    """All seven WavLM entries (both forwards, the single route's backward
    pair and the general route's dq, dbias and dkv) run tensor-core bodies
    in bf16 at head_dim 64, and the CUDA-core bodies in fp32 or at head_dim
    80; a name that is no entry is refused."""
    assert len(WAVLM_KERNELS) == 7
    for fn in WAVLM_KERNELS:
        name = fn.__name__
        assert wavlm_kernel_body(name, torch.bfloat16, 64) == "wgmma"
        for dtype, head_dim in ((torch.float32, 64), (torch.float32, 80), (torch.bfloat16, 80)):
            assert wavlm_kernel_body(name, dtype, head_dim) == "fma"
    with pytest.raises(ValueError, match="no WavLM entry"):
        wavlm_kernel_body("wavlm_attention_bwd", torch.bfloat16, 64)


def _assert_stats(m, l, want_m, want_l):
    """m within 1e-4 absolute, l within 1e-4 relative of the plain softmax's."""
    assert (m - want_m).abs().max().item() <= 1e-4
    assert ((l - want_l).abs() / want_l).max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("lengths,rate", [(None, 0.1), ([333, 200, 0], 0.0), ([333, 64, 1], 0.1)])
def test_wgmma_forward_matches_plain_version_on_card(lengths, rate):
    """The packed forward's tensor-core body (bf16, head_dim 64) on views of
    a fused QKV tensor, L = 333 ending mid-tile, a row of length 0 (v
    averaged over all L) and of length 1: out within 2e-2 x max |plain|, m
    and l within 1e-4 of the plain softmax's; the serving call (no m, l)
    gives the same bits, and so does a rerun."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, L, H, D = 3, 333, 12, 64
    qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = qkv.split(H * D, dim=-1)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    seed = torch.tensor([-77], dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    kw = dict(num_heads=H, scale=scale, dropout_rate=rate, seed=seed)
    with torch.no_grad():
        n = packed_attention.launches
        out, m, l = _launch_fwd(q, k, v, lens, seed, H, scale, rate, stats=True)
        _assert_close(out, packed_attention_reference(q, k, v, lens, **kw), 2e-2, "out")
        heads = lambda t: t.view(B, L, H, D).transpose(1, 2)  # noqa: E731
        _, want_m, want_l, _ = softmax_parts(heads(q), heads(k), lens, scale)
        _assert_stats(m, l, want_m[..., 0], want_l[..., 0])
        assert torch.equal(packed_attention(q, k, v, lens, **kw), out)
        again, m2, l2 = _launch_fwd(q, k, v, lens, seed, H, scale, rate, stats=True)
        assert torch.equal(again, out) and torch.equal(m2, m) and torch.equal(l2, l)
        assert packed_attention.launches == n + 3


@pytest.mark.gpu
@pytest.mark.parametrize("H,lengths,rate", [(11, None, 0.1), (9, [333, 200, 0], 0.0),
                                            (9, [333, 64, 1], 0.1)])
def test_flash_wgmma_forward_matches_plain_version_on_card(H, lengths, rate):
    """The flash forward's tensor-core body on (B, H, L, D) views of a fused
    QKV tensor with 11 and 9 heads (row strides of 2112 and 1728 elements,
    as the pruned students' layers): out within 2e-2 x max |plain|, m and l
    within 1e-4; a rerun gives the same bits."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, L, D = 3, 333, 64
    qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = (t.view(B, L, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    seed = torch.tensor([31337], dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, dropout_rate=rate, seed=seed)
    with torch.no_grad():
        out, m, l = flash_attention(q, k, v, lens, **kw)
        want, want_m, want_l = flash_attention_reference(q, k, v, lens, **kw)
        _assert_close(out, want, 2e-2, "out")
        _assert_stats(m, l, want_m, want_l)
        again = flash_attention(q, k, v, lens, **kw)
        assert all(torch.equal(a, b) for a, b in zip(again, (out, m, l)))


@pytest.mark.gpu
def test_wgmma_forward_refuses_misaligned_views_on_card():
    """bf16 at head_dim 64 runs the tensor-core body or raises: a view whose
    pointer is not 16-byte aligned, or whose row stride is not a multiple of
    8 elements, gets cudaErrorMisalignedAddress (716) from the dispatch, and
    the wrapper raises without counting a launch."""
    _card()
    B, L, H, D = 2, 100, 12, 64
    HD = H * D
    shifted = torch.randn(B, L, 3 * HD + 8, device="cuda").to(torch.bfloat16)[..., 4:]
    odd_rows = torch.randn(B, L, 3 * HD + 4, device="cuda").to(torch.bfloat16)[..., :3 * HD]
    with torch.no_grad():
        for qkv in (shifted, odd_rows):
            q, k, v = qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:3 * HD]
            n, nf = packed_attention.launches, flash_attention.launches
            with pytest.raises(RuntimeError, match="cudaError 716"):
                packed_attention(q, k, v, None, num_heads=H)
            heads = [t.unflatten(-1, (H, D)).transpose(1, 2) for t in (q, k, v)]
            with pytest.raises(RuntimeError, match="cudaError 716"):
                flash_attention(*heads, None)
            assert (packed_attention.launches, flash_attention.launches) == (n, nf)


@pytest.mark.parametrize("dtype,L", FORWARD_READOUT_CASES)
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_flash_dropout_mask_read_out_of_the_forward(device, dtype, L):
    """The flash forward's dropout mask, bit for bit the plain mask, read
    out as in ``test_dropout_mask_read_out_of_the_forward`` on the (B, H, L,
    D) layout with 11 heads; on the card that is the device hash inside
    ``flash_attention_fwd``'s two bodies.  l is the undropped sum."""
    if device == "cuda":
        _card()
    seeds = (-123456789, 2**31 - 1, -2**31)
    for seed, got, want, l in forward_mask_readout("flash", device, dtype, seeds, H=11, L=L):
        assert torch.equal(l, torch.full_like(l, float(L)))
        assert torch.equal(got, want), f"seed {seed}: {(got != want).sum().item()} bits"
        assert 0.85 < want.float().mean().item() < 0.95


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,lengths,rate", [(11, None, 0.1), (9, [333, 200, 1], 0.0),
                                            (9, [333, 64, 130], 0.1)])
def test_flash_backward_kernels_match_plain_versions_on_card(dtype, rel, H, lengths, rate):
    """The flash forward with dropout, dq and dkv against their plain
    versions, through FlashAttentionFn on (B, H, L, D) views of a fused QKV
    tensor (the model's strides), with the launch counts; a second backward
    is bit-identical (no atomics).  Bound as for the packed kernels."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, L, D = 3, 333, 64
    qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(dtype)
    dout = torch.randn(B, L, H * D, device="cuda", generator=gen).to(dtype)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    seed = torch.tensor([-424242], dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, dropout_rate=rate, seed=seed)

    def heads(t):
        return t.view(B, L, H, D).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(H * D, dim=-1))
    with torch.no_grad():
        out, _, _ = flash_attention(q, k, v, lens, **kw)
        _assert_close(out, flash_attention_reference(q, k, v, lens, **kw)[0], rel, "out")
    counts = (flash_attention.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)

    def grad():
        x = qkv.clone().requires_grad_()
        y = flash_attention_qkv(x, lens, num_heads=H, **kw)
        y.backward(dout)
        return y.detach(), x.grad

    y, g = grad()
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    torch.testing.assert_close(y, out.transpose(1, 2).reshape(B, L, H * D), atol=0, rtol=0)
    want = flash_attention_bwd_reference(q, k, v, out, heads(dout).contiguous(), lens, **kw)
    for name, got, w in zip("qkv", g.split(H * D, dim=-1), want):
        _assert_close(heads(got), w, rel, f"d{name}")
    assert torch.equal(g, grad()[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_kv", [None, 64])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_wavlm_dropout_mask_read_out_of_the_forward(device, block_kv, dtype):
    """The WavLM forward's dropout mask, bit for bit the plain mask, read
    out as in ``test_dropout_mask_read_out_of_the_forward``
    (``forward_mask_readout("wavlm")``): with q = k = 0 and a zero bias
    (the gate then scales nothing) every key gets the same weight.  On the
    card that is the device hash inside ``wavlm_attention_fwd`` (block_kv
    None, the single route) and ``wavlm_attention_fwd_general`` (block_kv
    64: two KV blocks of the padded 128): in bf16 at every accumulator
    element's (row, column) of the tensor-core body, where a wrong fragment
    map flips bits, in fp32 through the CUDA-core body.  The head index is
    the index in the tensors' heads (the selected heads of a pruned layer).
    L = 130 spans three 64-row tiles; its codes (at most 7) survive the bf16
    output's rounding."""
    if device == "cuda":
        _card()
    counts = (wavlm_attention_fwd.launches, wavlm_attention_fwd_general.launches)
    seeds = (-123456789, 2**31 - 1, -2**31)
    for seed, got, want, l in forward_mask_readout("wavlm", device, dtype, seeds, H=7, L=130,
                                                   block_kv=block_kv):
        assert torch.equal(l, torch.full_like(l, 130.0))  # l is the undropped sum
        assert torch.equal(got, want), f"seed {seed}: {(got != want).sum().item()} bits"
        assert 0.85 < want.float().mean().item() < 0.95
    n = len(seeds) if device == "cuda" else 0
    single = block_kv is None
    assert (wavlm_attention_fwd.launches, wavlm_attention_fwd_general.launches) == (
        counts[0] + n * single, counts[1] + n * (not single))


WAVLM_KERNELS = (wavlm_attention_fwd, wavlm_attention_bwd_fused, wavlm_attention_bwd_dkv,
                 wavlm_attention_fwd_general, wavlm_attention_bwd_dq, wavlm_attention_bwd_dbias,
                 wavlm_attention_bwd_dkv_general)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("block_kv", [None, 128])
@pytest.mark.parametrize("B,L,H,lengths,rate", [
    (3, 333, 12, None, 0.1), (3, 333, 7, [333, 200, 1], 0.0), (3, 333, 7, [333, 64, 130], 0.1),
    (2, 749, 12, None, 0.1), (2, 780, 12, None, 0.1),  # the DPWavLM steps' lengths
])
def test_wavlm_backward_kernels_match_plain_versions_on_card(dtype, rel, block_kv, B, L, H,
                                                             lengths, rate):
    """The WavLM forward with dropout and its route's backward kernels
    (single: fused dq/dgate/dbias and dkv; general, block_kv 128: dq/dgate,
    dbias and dkv; in bf16 both the tensor-core bodies) against their plain
    versions, through WavLMAttentionFn on (B, H, L, D) views of a fused QKV
    tensor with fp32 bias and gate needing gradients, with the launch
    counts.  A second backward is bit-identical: no float atomics, dbias
    summed over the batch in one block.  Bound: max abs error <= rel * max
    |plain| for out, dq, dk, dv, dgate and dbias."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    D = 64
    qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(dtype)
    dout = torch.randn(B, L, H * D, device="cuda", generator=gen).to(dtype)
    bias = torch.randn(H, L, L, device="cuda", generator=gen)
    gate = 1.0 + 2.0 * torch.rand(B, H, L, device="cuda", generator=gen)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    seed = torch.tensor([-31337], dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, dropout_rate=rate, seed=seed)

    def heads(t):
        return t.view(B, L, H, D).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(H * D, dim=-1))
    with torch.no_grad():
        out, m, l = wavlm_attention(q, k, v, bias, gate, lens, block_kv=block_kv, **kw)
        want_out, want_m, want_l = wavlm_attention_reference(q, k, v, bias, gate, lens, **kw)
        _assert_close(out, want_out, rel, "out")
        torch.testing.assert_close(m, want_m, atol=1e-4, rtol=0)
        torch.testing.assert_close(l, want_l, atol=0, rtol=1e-4)
    before = [f.launches for f in WAVLM_KERNELS]

    def grad():
        x = qkv.clone().requires_grad_()
        bg, gg = bias.clone().requires_grad_(), gate.clone().requires_grad_()
        y = wavlm_attention_qkv(x, bg, gg, lens, num_heads=H, block_kv=block_kv, **kw)
        y.backward(dout)
        return y.detach(), x.grad, bg.grad, gg.grad

    y, gx, gb, gg = grad()
    grew = [f.launches - n for f, n in zip(WAVLM_KERNELS, before)]
    assert grew == ([1, 1, 1, 0, 0, 0, 0] if block_kv is None else [0, 0, 0, 1, 1, 1, 1])
    torch.testing.assert_close(y, out.transpose(1, 2).reshape(B, L, H * D), atol=0, rtol=0)
    want = wavlm_attention_bwd_reference(q, k, v, bias, gate, out, heads(dout).contiguous(),
                                         lens, **kw)
    for name, got, w in zip(("dq", "dk", "dv"), gx.split(H * D, dim=-1), want):
        _assert_close(heads(got), w, rel, name)
    _assert_close(gb, want[3], rel, "dbias")
    _assert_close(gg, want[4], rel, "dgate")
    again = grad()
    for name, a, b2 in zip(("dqkv", "dbias", "dgate"), (gx, gb, gg), again[1:]):
        assert torch.equal(a, b2), f"{name}: a second backward differs"


@pytest.mark.gpu
def test_wavlm_backward_pair_refuses_misaligned_views_on_card():
    """bf16 at head_dim 64 runs the WavLM tensor-core bodies or raises:
    views whose pointer is not 16-byte aligned, or whose row stride is not a
    multiple of 8 elements, get cudaErrorMisalignedAddress (716) from the
    dispatch, and the wrappers raise without counting a launch: both
    forward entries, and the single backward pair given out, m and l from
    the plain forward (no kernel forward takes such views)."""
    _card()
    B, L, H, D = 2, 100, 12, 64
    HD = H * D
    shifted = torch.randn(B, L, 3 * HD + 8, device="cuda").to(torch.bfloat16)[..., 4:]
    odd_rows = torch.randn(B, L, 3 * HD + 4, device="cuda").to(torch.bfloat16)[..., :3 * HD]
    bias = torch.randn(H, L, L, device="cuda")
    gate = torch.rand(B, H, L, device="cuda") + 1.0
    kw = dict(scale=D ** -0.5)
    with torch.no_grad():
        for qkv in (shifted, odd_rows):
            q, k, v = (t.unflatten(-1, (H, D)).transpose(1, 2)
                       for t in (qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:3 * HD]))
            n = (wavlm_attention_fwd.launches, wavlm_attention_fwd_general.launches)
            for fwd in (wavlm_attention_fwd, wavlm_attention_fwd_general):
                with pytest.raises(RuntimeError, match="cudaError 716"):
                    fwd(q, k, v, bias, gate, None, **kw)
            assert (wavlm_attention_fwd.launches, wavlm_attention_fwd_general.launches) == n
            out, m, l = wavlm_attention_reference(q, k, v, bias, gate, None, **kw)
            dout = torch.randn_like(out)
            n = (wavlm_attention_bwd_fused.launches, wavlm_attention_bwd_dkv.launches)
            with pytest.raises(RuntimeError, match="cudaError 716"):
                wavlm_attention_bwd_fused(q, k, v, bias, gate, out, dout, m, l, None, **kw)
            with pytest.raises(RuntimeError, match="cudaError 716"):
                wavlm_attention_bwd_dkv(q, k, v, bias, gate, out, dout, m, l, torch.zeros_like(m),
                                        None, **kw)
            assert (wavlm_attention_bwd_fused.launches, wavlm_attention_bwd_dkv.launches) == n


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,lengths,rate", [
    (16, 749, 12, None, 0.1),            # the DPWavLM step
    (2, 1299, 12, [1049, 1299], 0.0),    # serving's batch of 21 s and 26 s
    (3, 333, 7, [333, 200, 64], 0.1),    # a pruned layer's 7 heads
    (4, 130, 12, [130, 64, 1, 0], 0.1),  # rows of length 1 and 0
])
def test_wavlm_wgmma_forward_matches_plain_version_on_card(B, L, H, lengths, rate):
    """Both WavLM forward entries' tensor-core body (bf16, head_dim 64) on
    (B, H, L, D) views of a fused QKV tensor, with the fp32 gate * bias in
    the scores: out within 2e-2 x max |plain| of
    ``wavlm_attention_reference``, m within 1e-4 and l within 1e-4
    relative of the plain softmax's; the general entry (another block
    order, the same body) equals the single one bit for bit, and each
    counts one launch."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    D = 64
    qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = (t.view(B, L, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
    bias = torch.randn(H, L, L, device="cuda", generator=gen)
    gate = 1.0 + 2.0 * torch.rand(B, H, L, device="cuda", generator=gen)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    seed = torch.tensor([271828], dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, dropout_rate=rate, seed=seed)
    args = (q, k, v, bias, gate, lens)
    assert wavlm_kernel_body("wavlm_attention_fwd", torch.bfloat16, D) == "wgmma"
    with torch.no_grad():
        n = (wavlm_attention_fwd.launches, wavlm_attention_fwd_general.launches)
        out, m, l = wavlm_attention_fwd(*args, **kw)
        got_g = wavlm_attention_fwd_general(*args, **kw)
        assert (wavlm_attention_fwd.launches, wavlm_attention_fwd_general.launches) == (
            n[0] + 1, n[1] + 1)
        want, want_m, want_l = wavlm_attention_reference(*args, **kw)
    _assert_close(out, want, 2e-2, "out")
    _assert_stats(m, l, want_m, want_l)
    for name, a, b in zip(("out", "m", "l"), got_g, (out, m, l)):
        assert torch.equal(a, b), f"general entry's {name} differs from the single entry's"


@pytest.mark.gpu
def test_wavlm_fused_length_limit_holds_for_the_cuda_core_body_only_on_card():
    """The fused entry's (32 x ceil64(L)) dbias strip limits its CUDA-core
    body to L <= fused_max_len (1344 at head_dim 64): fp32 at L = 1400 still
    raises before it launches.  The tensor-core bodies (bf16 at head_dim
    64) hold no strip, so bf16 at L = 1400 runs the single route and agrees
    with the plain version within 2e-2 x max |plain|."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, H, L, D = 1, 2, 1400, 64
    kw = dict(scale=D ** -0.5, dropout_rate=0.1,
              seed=torch.tensor([1234], dtype=torch.int32, device="cuda"))
    bias = torch.randn(H, L, L, device="cuda", generator=gen)
    gate = 1.0 + torch.rand(B, H, L, device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (torch.randn(B, H, L, D, device="cuda", generator=gen).to(dtype)
                         for _ in range(4))
        args = (q, k, v, bias, gate)
        with torch.no_grad():
            out, m, l = wavlm_attention_fwd(*args, None, **kw)
            if dtype == torch.float32:
                n = wavlm_attention_bwd_fused.launches
                with pytest.raises(ValueError, match="dbias strip"):
                    wavlm_attention_bwd_fused(*args, out, dout, m, l, None, **kw)
                assert wavlm_attention_bwd_fused.launches == n
                continue
            dq, dgate, dbias, di = wavlm_attention_bwd_fused(*args, out, dout, m, l, None, **kw)
            dk, dv = wavlm_attention_bwd_dkv(*args, out, dout, m, l, di, None, **kw)
            want = wavlm_attention_bwd_reference(*args, out, dout, None, **kw)
        for name, got, w in zip(("dq", "dk", "dv", "dbias", "dgate"),
                                (dq, dk, dv, dbias, dgate), want):
            _assert_close(got, w, 2e-2, name)


@pytest.mark.gpu
def test_wavlm_general_entries_equal_single_entries_on_card():
    """The general entries compute the single entries' function: fp32, the
    same inputs, within 1e-5 relative (the blocks' order changes nothing
    of a sum but dbias, summed over the batch in another block)."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, H, L, D = 4, 5, 300, 64
    q, k, v, dout = (torch.randn(B, H, L, D, device="cuda", generator=gen) for _ in range(4))
    bias = torch.randn(H, L, L, device="cuda", generator=gen)
    gate = 1.0 + torch.rand(B, H, L, device="cuda", generator=gen)
    lens = torch.tensor([300, 250, 17, 64], dtype=torch.int32, device="cuda")
    seed = torch.tensor([5], dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, dropout_rate=0.1, seed=seed)
    args = (q, k, v, bias, gate)
    with torch.no_grad():
        out, m, l = wavlm_attention_fwd(*args, lens, **kw)
        out_g, m_g, l_g = wavlm_attention_fwd_general(*args, lens, **kw)
        dq, dgate, dbias, di = wavlm_attention_bwd_fused(*args, out, dout, m, l, lens, **kw)
        dk, dv = wavlm_attention_bwd_dkv(*args, out, dout, m, l, di, lens, **kw)
        dq_g, dgate_g, di_g = wavlm_attention_bwd_dq(*args, out, dout, m, l, lens, **kw)
        dbias_g = wavlm_attention_bwd_dbias(*args, out, dout, m, l, di_g, lens, **kw)
        dk_g, dv_g = wavlm_attention_bwd_dkv_general(*args, out, dout, m, l, di_g, lens, **kw)
    torch.cuda.synchronize()
    for name, a, b in (("out", out, out_g), ("m", m, m_g), ("l", l, l_g), ("dq", dq, dq_g),
                       ("dgate", dgate, dgate_g), ("dbias", dbias, dbias_g), ("di", di, di_g),
                       ("dk", dk, dk_g), ("dv", dv, dv_g)):
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * b.abs().max().item(), f"{name}: {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,lengths,rate", [
    (16, 749, 12, None, 0.1),           # the DPWavLM step
    (3, 333, 7, [333, 200, 64], 0.1),   # a pruned layer's 7 heads
    (4, 130, 12, [130, 64, 1, 0], 0.0),  # rows of length 1 and 0
])
def test_wavlm_general_backward_equals_single_bit_for_bit_in_bf16_on_card(B, L, H, lengths,
                                                                           rate):
    """In bf16 at head_dim 64 the general route's backward entries run the
    single route's tensor-core bodies (dq, then dbias reading dq's di; dkv)
    with the same blocks: dq, dgate, di, dbias, dk and dv equal the fused
    entry's and the single dkv's bit for bit, on (B, H, L, D) views of a
    fused QKV tensor, and within 2e-2 x max |plain| of the plain backward;
    each entry counts one launch.  The dbias entry refuses a missing di."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(10)
    D = 64
    qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = (t.view(B, L, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
    dout = torch.randn(B, H, L, D, device="cuda", generator=gen).to(torch.bfloat16)
    bias = torch.randn(H, L, L, device="cuda", generator=gen)
    gate = 1.0 + 2.0 * torch.rand(B, H, L, device="cuda", generator=gen)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    seed = torch.tensor([-4242], dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, dropout_rate=rate, seed=seed)
    args = (q, k, v, bias, gate)
    general = (wavlm_attention_bwd_dq, wavlm_attention_bwd_dbias, wavlm_attention_bwd_dkv_general)
    for name in ("wavlm_attention_bwd_dq", "wavlm_attention_bwd_dbias",
                 "wavlm_attention_bwd_dkv_general"):
        assert wavlm_kernel_body(name, torch.bfloat16, D) == "wgmma"
    with torch.no_grad():
        out, m, l = wavlm_attention_fwd(*args, lens, **kw)
        dq, dgate, dbias, di = wavlm_attention_bwd_fused(*args, out, dout, m, l, lens, **kw)
        dk, dv = wavlm_attention_bwd_dkv(*args, out, dout, m, l, di, lens, **kw)
        n = [f.launches for f in general]
        dq_g, dgate_g, di_g = wavlm_attention_bwd_dq(*args, out, dout, m, l, lens, **kw)
        dbias_g = wavlm_attention_bwd_dbias(*args, out, dout, m, l, di_g, lens, **kw)
        dk_g, dv_g = wavlm_attention_bwd_dkv_general(*args, out, dout, m, l, di_g, lens, **kw)
        assert [f.launches for f in general] == [c + 1 for c in n]
        with pytest.raises(ValueError, match="di"):
            wavlm_attention_bwd_dbias(*args, out, dout, m, l, None, lens, **kw)
        want = wavlm_attention_bwd_reference(*args, out, dout, lens, **kw)
    torch.cuda.synchronize()
    for name, a, b in (("dq", dq_g, dq), ("dgate", dgate_g, dgate), ("di", di_g, di),
                       ("dbias", dbias_g, dbias), ("dk", dk_g, dk), ("dv", dv_g, dv)):
        assert torch.equal(a, b), f"general {name} differs from the single route's"
    for name, got, w in zip(("dq", "dk", "dv", "dbias", "dgate"),
                            (dq_g, dk_g, dv_g, dbias_g, dgate_g), want):
        _assert_close(got, w, 2e-2, name)


@pytest.mark.gpu
def test_wavlm_general_backward_refuses_misaligned_views_on_card():
    """The general route's backward entries in bf16 at head_dim 64 run the
    tensor-core bodies or raise: views whose pointer is not 16-byte
    aligned, or whose row stride is not a multiple of 8 elements, get
    cudaErrorMisalignedAddress (716) and no launch is counted; the
    CUDA-core body is never taken for them."""
    _card()
    B, L, H, D = 2, 100, 12, 64
    HD = H * D
    shifted = torch.randn(B, L, 3 * HD + 8, device="cuda").to(torch.bfloat16)[..., 4:]
    odd_rows = torch.randn(B, L, 3 * HD + 4, device="cuda").to(torch.bfloat16)[..., :3 * HD]
    bias = torch.randn(H, L, L, device="cuda")
    gate = torch.rand(B, H, L, device="cuda") + 1.0
    kw = dict(scale=D ** -0.5)
    general = (wavlm_attention_bwd_dq, wavlm_attention_bwd_dbias, wavlm_attention_bwd_dkv_general)
    with torch.no_grad():
        for qkv in (shifted, odd_rows):
            q, k, v = (t.unflatten(-1, (H, D)).transpose(1, 2)
                       for t in (qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:3 * HD]))
            out, m, l = wavlm_attention_reference(q, k, v, bias, gate, None, **kw)
            dout = torch.randn_like(out)
            args = (q, k, v, bias, gate, out, dout, m, l)
            di = torch.zeros_like(m)
            n = [f.launches for f in general]
            with pytest.raises(RuntimeError, match="cudaError 716"):
                wavlm_attention_bwd_dq(*args, None, **kw)
            with pytest.raises(RuntimeError, match="cudaError 716"):
                wavlm_attention_bwd_dbias(*args, di, None, **kw)
            with pytest.raises(RuntimeError, match="cudaError 716"):
                wavlm_attention_bwd_dkv_general(*args, di, None, **kw)
            assert [f.launches for f in general] == n
