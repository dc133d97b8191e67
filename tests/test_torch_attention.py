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
    dropout_keep_mask,
    dropout_threshold,
)
from dphubert_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from dphubert_torch.ops.packed_attention import (
    PackedAttentionFn,
    packed_attention,
    packed_attention_bwd_dkv,
    packed_attention_bwd_dq,
    packed_attention_bwd_reference,
    packed_attention_qkv,
    packed_attention_reference,
    packed_num_groups,
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
    """The flash route has no backward yet: with grad enabled or with
    dropout it raises, on the CPU as on the card, and never trains silently
    without dropout.  3 heads x 16 at L = 800 take the flash route."""
    spec = AttentionSpec(embed_dim=48, num_heads=3, head_dim=16, dropout=0.1)
    attn = SelfAttention(spec)
    gen = torch.Generator().manual_seed(0)
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.1, generator=gen)
    x = torch.randn(1, 800, 48, generator=gen)
    assert attention_route(800, 3, 16) == "flash"
    with pytest.raises(NotImplementedError, match="queue 2, item 2"):
        attn(x, None)  # parameters require grad
    with torch.no_grad(), pytest.raises(NotImplementedError, match="queue 2, item 2"):
        attn(x, None, generator=gen)  # dropout on
    with torch.no_grad():
        assert attn(x, None).shape == (1, 800, 48)  # serving still runs
    with pytest.raises(NotImplementedError, match="forward-only"):
        flash_attention(*(t.requires_grad_() for t in torch.randn(3, 1, 2, 40, 16)))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc there")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in full fp32


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_dropout_mask_read_out_of_the_forward(device):
    """The forward's dropout mask, bit for bit the plain mask, for a
    negative seed and the int32 extremes; on the card that is the device
    hash of csrc/attention_common.cuh inside the packed forward kernel.
    With q = k = 0 every key gets the same weight, and value row j holds
    2**(j // D) in column j % D, so out * L * keep is the integer
    sum_blk keep(i, blk * D + d) * 2**blk: its bits are the mask.  L = 130
    spans three 64-row tiles."""
    if device == "cuda":
        _card()
    B, H, L, D, rate = 2, 12, 130, 64, 0.1
    keep = 1.0 - rate
    j = torch.arange(L, device=device)
    v1 = torch.zeros(L, D, device=device)
    v1[j, j % D] = 2.0 ** (j // D).float()
    v = v1.repeat(1, H).expand(B, L, H * D).contiguous()
    qk = torch.zeros_like(v)
    b = torch.arange(B, device=device).view(B, 1, 1, 1)
    h = torch.arange(H, device=device).view(1, H, 1, 1)
    for seed in (-123456789, 2**31 - 1, -2**31):
        t_seed = torch.tensor([seed], dtype=torch.int32, device=device)
        with torch.no_grad():
            out = packed_attention(qk, qk, v, None, num_heads=H, dropout_rate=rate, seed=t_seed)
        code = torch.round(out.view(B, L, H, D).transpose(1, 2).double() * L * keep).long()
        got = (code[..., j % D] >> (j // D)) & 1
        want = dropout_keep_mask((L, L), keep, seed, b, h, device=device)
        assert torch.equal(got.bool(), want)
        assert 0.85 < want.float().mean().item() < 0.95


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

    def close(got, want, what):
        err = (got.float() - want.float()).abs().max().item()
        bound = rel * want.float().abs().max().item()
        assert err <= bound, f"{what}: max abs err {err} > {bound}"

    with torch.no_grad():
        out = packed_attention(q, k, v, lens, **kw)
        close(out, packed_attention_reference(q, k, v, lens, **kw), "out")
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
        close(got, w, f"d{name}")
    # deterministic: no atomics, so a second backward is bit-identical
    x2 = qkv.clone().requires_grad_()
    packed_attention_qkv(x2, lens, **kw).backward(dout)
    assert torch.equal(x.grad, x2.grad)


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
