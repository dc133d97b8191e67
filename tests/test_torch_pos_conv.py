"""The positional conv's autograd function (``ops.pos_conv``): its input
gradient as a forward convolution of the output gradient with the
group-transposed, time-reversed weight.

On the CPU, in float64, the function's forward is the module's old
``F.conv1d`` call and trim bit for bit, and its three gradients equal
autograd through that call; the module's whole pos conv (weight norm, the
function, GELU) equals the TPU package's ``pos_conv_forward`` under
``jax.vjp``.  The ``gpu`` test holds the bf16 input gradient against the
float32 autograd one at the stage-1 rungs' shapes, and finds no cuDNN
backward-data kernel in the backward (``python -m pytest --noconftest -m gpu
tests/test_torch_pos_conv.py``: this module imports no JAX at the top).
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dphubert_torch.models.components import ConvolutionalPositionalEmbedding
from dphubert_torch.ops import PosConvFn

# (C, G, K): HuBERT / WavLM Base, wav2vec 2.0 Large, the tests' tiny
# models, an odd kernel
SHAPES = [(768, 16, 128), (1024, 16, 128), (64, 4, 16), (32, 4, 15)]


def conv_and_trim(x, w, b, groups):
    """The module's path before ``ops.pos_conv``: conv1d, then an even
    kernel's last frame dropped."""
    k = w.shape[-1]
    y = F.conv1d(x, w, b, padding=k // 2, groups=groups)
    return y[..., :-1] if k % 2 == 0 else y


def _inputs(C, G, K, B, L, dtype, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, L, C, dtype=dtype, device=device, generator=gen)
    w = torch.randn(C, C // G, K, dtype=dtype, device=device, generator=gen) / (C // G * K) ** 0.5
    b = 0.1 * torch.randn(C, dtype=dtype, device=device, generator=gen)
    return x, w, b


def _grads(fn, x, w, b, groups, dout):
    """(y, dx, dw, db) of ``gelu(fn(x^T)) ^T`` against ``dout``, x (B, L, C)
    laid out as the encoder lays it out."""
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    y = fn(x.transpose(1, 2), w, b, groups)
    out = F.gelu(y).transpose(1, 2)
    return (y.detach(), *torch.autograd.grad(out, (x, w, b), dout))


@pytest.mark.parametrize("C,G,K", SHAPES)
def test_pos_conv_matches_autograd_through_conv1d(C, G, K):
    x, w, b = _inputs(C, G, K, 2, 13, torch.float64)
    dout = torch.randn(2, 13, C, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    n = PosConvFn.launches
    got = _grads(PosConvFn.apply, x, w, b, G, dout)
    assert PosConvFn.launches == n + 1
    want = _grads(conv_and_trim, x, w, b, G, dout)
    assert torch.equal(got[0], want[0])
    for name, g, v in zip(("dx", "dw", "db"), got[1:], want[1:]):
        assert g.shape == v.shape, name
        assert (g - v).abs().max().item() <= 1e-10, name


def test_pos_conv_module_matches_the_tpu_package_under_vjp():
    """The tiny models' pos conv (64 channels, 4 groups, 16 taps) in
    float32, its output and the gradients of its input, ``weight_g``,
    ``weight_v`` and bias against ``pos_conv_forward`` under ``jax.vjp``;
    bound 1e-4 absolute, as the model parity tests."""
    import jax
    import jax.numpy as jnp

    from dphubert_tpu.models.components import pos_conv_forward

    C, G, K, B, L = 64, 4, 16, 2, 21
    module = ConvolutionalPositionalEmbedding(C, K, G)
    module.conv.reset_parameters(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    cot = rng.standard_normal((B, L, C)).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_()
    y = module(xt)
    params = [module.conv.weight_g, module.conv.weight_v, module.conv.bias]
    gx, gg, gv, gb = torch.autograd.grad(y, [xt, *params], torch.from_numpy(cot))

    p = {"conv": {"weight_g": jnp.asarray(module.conv.weight_g.detach().numpy()),
                  "weight_v": jnp.asarray(module.conv.weight_v.detach().numpy()),
                  "bias": jnp.asarray(module.conv.bias.detach().numpy())}}
    spec = types.SimpleNamespace(pos_conv_kernel=K, pos_conv_groups=G)
    jy, vjp = jax.vjp(lambda p, x: pos_conv_forward(p, spec, x), p, jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(cot))
    pairs = [("y", y, jy), ("dx", gx, jx), ("dweight_g", gg, jp["conv"]["weight_g"]),
             ("dweight_v", gv, jp["conv"]["weight_v"]), ("dbias", gb, jp["conv"]["bias"])]
    for name, got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", [(80, 99), (26, 305), (10, 780)])
def test_pos_conv_bf16_input_gradient_on_card(B, L, monkeypatch):
    """HuBERT Base's pos conv at a stage-1 rung's shape in bf16: the
    function's dx within 2e-2 of max |dx| of the float32 autograd gradient
    (the repo's bf16 bound for backward kernels), and no ``dgrad_engine``
    among the backward's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN picks the kernels there")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    C, G, K = 768, 16, 128
    x, w, b = _inputs(C, G, K, B, L, torch.float32, "cuda")
    dout = torch.randn(B, L, C, device="cuda", generator=torch.Generator("cuda").manual_seed(2))
    want = _grads(conv_and_trim, x, w, b, G, dout)[1]
    half = [t.to(torch.bfloat16) for t in (x, w, b, dout)]
    _grads(PosConvFn.apply, *half[:3], G, half[3])  # warm: cuDNN's plans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = _grads(PosConvFn.apply, *half[:3], G, half[3])[1]
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert kernels and not [k for k in kernels if "dgrad_engine" in k], kernels
    err = (got.float() - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err
