"""The port's attention kernels: their plain versions against the TPU
package's Pallas kernels in interpret mode, the routing rule against the TPU
package's, and (on a card only) each CUDA kernel against its plain version.

The machine with the card has no JAX, so JAX is imported inside the tests
that compare with it, and the card's test runs there with
``python -m pytest --noconftest -m gpu tests/test_torch_attention.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from dphubert_torch.models.components import attention_route
from dphubert_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from dphubert_torch.ops.packed_attention import (
    packed_attention,
    packed_attention_reference,
    packed_num_groups,
)


@pytest.fixture
def jnp():
    return pytest.importorskip("jax.numpy")


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
    n_packed, n_flash = packed_attention.launches, flash_attention.launches
    torch.testing.assert_close(
        packed_attention(q, k, v, lens, num_heads=2),
        packed_attention_reference(q, k, v, lens, num_heads=2),
    )
    heads = lambda t: t.view(2, 40, 2, 16).transpose(1, 2)
    got = flash_attention(heads(q), heads(k), heads(v), lens)
    want = flash_attention_reference(heads(q), heads(k), heads(v), lens)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)
    assert (packed_attention.launches, flash_attention.launches) == (n_packed, n_flash)


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
