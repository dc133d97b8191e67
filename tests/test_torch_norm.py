"""The fp32-statistics LayerNorm / GroupNorm of the port (``ops/norm.py``,
``csrc/norm.cu``).

On the CPU: the plain versions of the kernels' forward and backward
formulas against ``models.components._layer_norm`` and its autograd (the
CPU path, unchanged), and against float64 autograd of the plain forward;
the route from shapes and strides, and where the strided backward reads
dy; a CPU tensor taking today's path, and the kernels' wrappers refusing
it.  The
``gpu`` tests hold the kernels against the plain versions at the cells'
shapes (forward, mean, rstd, dx, dweight, dbias), the backward bit for bit
over two runs, a CUDA graph's replay bit for bit the eager call, the
kernels' names, and a tiny model's forward and gradients on the card
against the CPU (``python -m pytest --noconftest -m gpu
tests/test_torch_norm.py``: this module imports no JAX).
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import dphubert_torch as pt
from dphubert_torch.models import components
from dphubert_torch.models.components import LN_EPS, _layer_norm
from dphubert_torch.ops import norm as N
from dphubert_torch.ops.norm import (
    NormFn,
    dy_strides,
    layer_norm,
    norm_bwd,
    norm_bwd_reference,
    norm_fwd,
    norm_geometry,
    norm_reference,
)


def todays_layer_norm(x, weight, bias, dim=-1, affine_dim=None):
    """``components._layer_norm`` as the port had it before the kernels:
    the path a CPU tensor still takes, kept here as it was."""
    if affine_dim is None:
        affine_dim = dim
    shape = [1] * x.ndim
    shape[affine_dim] = x.shape[affine_dim]
    if x.dtype == torch.float32:
        mean = x.mean(dim=dim, keepdim=True)
        var = (x - mean).square().mean(dim=dim, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + LN_EPS)
        if weight is not None:
            y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
        return y
    x32 = x.float()
    mean = x32.mean(dim=dim, keepdim=True)
    mean_sq = x32.square().mean(dim=dim, keepdim=True)
    var = (mean_sq - mean.square()).clamp_min(0.0)
    scale = torch.rsqrt(var + LN_EPS)
    shift = -mean * scale
    if weight is not None:
        w32 = weight.float().reshape(shape)
        scale = scale * w32
        shift = shift * w32 + bias.float().reshape(shape)
    return (x32 * scale + shift).to(x.dtype)


# (name, shape, dim, affine_dim or None, transposed): the model's three
# geometries at small odd sizes: LayerNorm over the last dim, GroupNorm(C,
# C) over time, the channel LayerNorm over dim 1, the feature projection's
# LayerNorm on the extractor's transposed output, no affine
CASES = [
    ("layer_norm", (3, 5, 37), -1, -1, False),
    ("group_norm", (2, 7, 33), 2, 1, False),
    ("channel_layer_norm", (2, 7, 33), 1, 1, False),
    ("projection", (2, 9, 7), -1, -1, True),
    ("no_affine", (3, 11), -1, None, False),
]


def _inputs(shape, affine_dim, transposed, dtype, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = 3.0 * torch.randn(shape, generator=gen, device=device) + 1.0
    if transposed:  # (B, L, C) read through the strides of (B, C, L)
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    x = x.to(dtype)
    w = b = None
    if affine_dim is not None:
        w = 1.0 + 0.5 * torch.randn(shape[affine_dim], generator=gen, device=device)
        b = 0.5 * torch.randn(shape[affine_dim], generator=gen, device=device)
    dy = torch.randn(shape, generator=gen, device=device).to(dtype)
    return x, w, b, dy


def _grads(fn, x, w, b, dy, dim, affine_dim):
    """(y, dx, dw, db) of fn through autograd."""
    leaves = [t.detach().requires_grad_() for t in (x, w, b) if t is not None]
    y = fn(*leaves, *([None, None] if w is None else []), dim, affine_dim)
    grads = torch.autograd.grad(y, leaves, dy)
    return (y.detach(), *grads) if w is not None else (y.detach(), grads[0], None, None)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape,dim,affine_dim,transposed", CASES)
def test_plain_versions_match_layer_norm_and_its_autograd(name, shape, dim, affine_dim,
                                                           transposed, dtype):
    """The plain versions' output and gradients (``norm_reference``, then
    ``norm_bwd_reference`` from its mean and rstd) against ``_layer_norm``
    through autograd.  float32 within 1e-6 of the largest value (summation
    order), bf16 within one rounding of the output (1e-2) and 1e-5 on the
    float32 affine gradients."""
    x, w, b, dy = _inputs(shape, affine_dim, transposed, dtype)
    y, mean, rstd = norm_reference(x, w, b, dim, affine_dim, LN_EPS)
    got = (y, *norm_bwd_reference(x, dy, w, mean, rstd, dim, affine_dim))
    want = _grads(_layer_norm, x, w, b, dy, dim, affine_dim)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    for label, g, v in zip(("y", "dx", "dw", "db"), got, want):
        if v is None:
            assert g is None, label
            continue
        assert g.dtype == v.dtype and g.shape == v.shape, label
        assert _rel(g, v) <= (tol if label in ("y", "dx") else 1e-5), label


@pytest.mark.parametrize("name,shape,dim,affine_dim,transposed", CASES)
def test_plain_backward_is_the_forward_s_gradient(name, shape, dim, affine_dim, transposed):
    """The backward's formulas in float64 against float64 autograd through
    the plain forward, to 1e-12."""
    x, w, b, dy = _inputs(shape, affine_dim, transposed, torch.float64)
    if w is not None:
        w, b = w.double(), b.double()
    want = _grads(lambda *a: norm_reference(*a, LN_EPS)[0], x, w, b, dy, dim, affine_dim)
    _, mean, rstd = norm_reference(x, w, b, dim, affine_dim, LN_EPS)
    got = norm_bwd_reference(x, dy, w, mean, rstd, dim, affine_dim)
    for label, g, v in zip(("dx", "dw", "db"), got, want[1:]):
        if v is None:
            assert g is None, label
            continue
        assert (g - v).abs().max().item() <= 1e-12, label


def _geo(shape, stride, dim, affine_dim, itemsize=2):
    return norm_geometry(shape, stride, dim, affine_dim, itemsize)


def _contiguous_strides(shape):
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


@pytest.mark.parametrize("case", [
    # the encoder's LayerNorms: HuBERT / WavLM Base, Large (bf16; fp32 up to 1024)
    ((10, 780, 768), None, -1, -1, 2, N.Geometry("rows_warp", 7800, 1, 768, 1, 768, "column")),
    ((11, 780, 1024), None, 2, 2, 4, N.Geometry("rows_warp", 8580, 1, 1024, 1, 1024, "column")),
    # HuBERT's GroupNorm over time at the top rung: the affine per channel
    ((10, 512, 49983), None, 2, 1, 2,
     N.Geometry("rows_block", 5120, 1, 49983, 1, 49983, "row", 512, 1)),
    # Large's channel LayerNorms over dim 1
    ((11, 512, 49983), None, 1, 1, 2,
     N.Geometry("strided", 11, 49983, 512 * 49983, 49983, 512, "column")),
    # the feature projection's LayerNorm on the transposed extractor output
    ((10, 780, 512), (780 * 512, 1, 780), -1, -1, 2,
     N.Geometry("strided", 10, 780, 780 * 512, 780, 512, "column")),
    # the waveform's normalisation without lengths: a long row, no affine
    ((10, 249920), None, -1, None, 4, N.Geometry("rows_block", 10, 1, 249920, 1, 249920, "none")),
    # (B, T, C) laid out as (T, B, C), normalised over T: strided
    ((4, 6, 8), (8, 32, 1), 1, 1, 2, N.Geometry("strided", 4, 8, 8, 32, 6, "column")),
    # layouts with gaps, which neither geometry reads: a slice of every other row
    ((4, 3, 8), (48, 16, 1), -1, -1, 2, None),
    ((4, 6, 8), (8, 256, 1), 1, 1, 2, None),
])
def test_route_follows_shape_and_strides(case):
    shape, stride, dim, affine_dim, itemsize, want = case
    stride = stride or _contiguous_strides(shape)
    assert _geo(shape, stride, dim, affine_dim, itemsize) == want


def test_route_refuses_what_no_kernel_takes():
    """An affine along a row too long for a warp has no backward kernel."""
    with pytest.raises(ValueError, match="affine along a row"):
        _geo((4, 2048), (2048, 1), -1, -1, itemsize=4)
    assert _geo((4, 2048), (2048, 1), -1, None, itemsize=4).route == "rows_block"
    # a non-contiguous input is copied once and then takes a route
    x = torch.randn(4, 6, 8)[:, ::2]
    got, geo = N._geometry(x, -1, -1)
    assert got.is_contiguous() and geo.route == "rows_warp"


@pytest.mark.parametrize("case", [
    # the projection: x (B, L, C) through the strides of (B, C, L), dy
    # contiguous from its linear layer: the channels at unit stride
    ((10, 780, 512), (780 * 512, 1, 780), (780 * 512, 512, 1), -1, (780 * 512, 1, 512)),
    # dy with x's strides: the channel LayerNorm over dim 1
    ((11, 512, 999), None, None, 1, (512 * 999, 999, 1)),
    # an expanded dy (the gradient of a sum): every stride 0
    ((2, 9, 7), (63, 1, 9), (0, 0, 0), -1, (0, 0, 0)),
    # (B, T, C, F) normalised over C: a dy whose B and T do not read as one
    # index (T outermost) is copied to x's strides
    ((2, 3, 6, 8), None, (48, 96, 8, 1), 2, None),
])
def test_strided_backward_reads_dy_in_its_own_layout(case):
    """``dy_strides``: dy's strides along x's outer, reduced and
    unit-stride indices.  The strided kernel reads a dy whose reduced one is
    1 (the projection's) in place, with no copy to x's strides."""
    shape, x_stride, dy_stride, dim, want = case
    x = torch.empty_strided(shape, x_stride or _contiguous_strides(shape), dtype=torch.bfloat16)
    dy = torch.empty_strided(shape, dy_stride or x.stride(), dtype=torch.bfloat16)
    assert _geo(shape, x.stride(), dim, dim).route == "strided"
    assert dy_strides(x, dy, dim) == want


def test_kernel_wrappers_refuse_a_cpu_tensor():
    """``norm_fwd``, ``norm_bwd`` and ``layer_norm`` take CUDA tensors
    only, so the CPU has one path, ``_layer_norm``'s, and no launch is
    counted."""
    before = (norm_fwd.launches, norm_bwd.launches)
    x, w, b, dy = _inputs((3, 5, 37), -1, False, torch.float32)
    _, mean, rstd = norm_reference(x, w, b, -1, -1, LN_EPS)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        norm_fwd(x, w, b, -1, -1, LN_EPS)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        norm_bwd(x, dy, w, mean.reshape(-1), rstd.reshape(-1), -1, -1)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        layer_norm(x.requires_grad_(), w, b, -1, -1, LN_EPS)
    assert (norm_fwd.launches, norm_bwd.launches) == before


def test_cpu_tensor_takes_today_s_path():
    """On the CPU ``_layer_norm`` is today's code, bit for bit, forward and
    backward, and launches no kernel."""
    before = (norm_fwd.launches, norm_bwd.launches)
    for dtype in (torch.float32, torch.bfloat16):
        for _, shape, dim, affine_dim, transposed in CASES:
            x, w, b, dy = _inputs(shape, affine_dim, transposed, dtype, seed=3)
            got = _grads(_layer_norm, x, w, b, dy, dim, affine_dim)
            want = _grads(todays_layer_norm, x, w, b, dy, dim, affine_dim)
            for g, v in zip(got, want):
                assert (g is None and v is None) or torch.equal(g, v)
    assert (norm_fwd.launches, norm_bwd.launches) == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the norm kernels run there only")


# (name, shape, dim, affine_dim, transposed, dtype, offset): the cells'
# shapes at the top rung (B = 10 x 15.62 s Base, 11 Large), fp32 at smaller
# sizes (the card's float32 checks), views one element off 16-byte
# alignment (element by element), and small odd sizes
CARD_CASES = [
    ("encoder_base", (10, 780, 768), -1, -1, False, torch.bfloat16, 0),
    ("encoder_large", (11, 780, 1024), -1, -1, False, torch.bfloat16, 0),
    ("group_norm", (10, 512, 49983), 2, 1, False, torch.bfloat16, 0),
    ("channel_layer_norm", (11, 512, 49983), 1, 1, False, torch.bfloat16, 0),
    ("projection", (10, 780, 512), -1, -1, True, torch.bfloat16, 0),
    ("waveform", (10, 249920), -1, None, False, torch.float32, 0),
    ("encoder_fp32", (4, 99, 1024), -1, -1, False, torch.float32, 0),
    ("group_norm_fp32", (2, 512, 49983), 2, 1, False, torch.float32, 0),
    ("group_norm_fp32_cached", (2, 512, 6399), 2, 1, False, torch.float32, 0),
    ("channel_fp32", (2, 512, 3123), 1, 1, False, torch.float32, 0),
    ("encoder_unaligned", (4, 99, 768), -1, -1, False, torch.bfloat16, 1),
    ("group_norm_unaligned", (2, 512, 6399), 2, 1, False, torch.bfloat16, 1),
    ("odd_layer_norm", (3, 5, 37), -1, -1, False, torch.bfloat16, 0),
    ("odd_group_norm", (2, 7, 33), 2, 1, False, torch.bfloat16, 0),
    ("odd_channel", (2, 7, 33), 1, 1, False, torch.float32, 0),
    ("odd_projection", (2, 45, 7), -1, -1, True, torch.float32, 0),
]


def _card_inputs(shape, affine_dim, transposed, dtype, offset, seed=0):
    x, w, b, dy = _inputs(shape, affine_dim, transposed, dtype, "cuda", seed)
    if offset:  # the same values one element into a larger buffer
        buf = torch.empty(x.numel() + offset, dtype=dtype, device="cuda")
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        x = view
    return x, w, b, dy


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,dim,affine_dim,transposed,dtype,offset", CARD_CASES)
def test_norm_kernels_match_the_plain_versions_on_card(name, shape, dim, affine_dim, transposed,
                                                       dtype, offset):
    """y, mean and rstd of the forward, and dx, dweight and dbias of the
    backward, against the plain versions on the same card and inputs: y and
    dx within 1e-2 of their largest value in bf16 (a rounding of the
    output) and 1e-4 in float32, mean and rstd within 1e-5 relative, the
    affine's float32 sums within 1e-3 of their largest value."""
    _card()
    x, w, b, dy = _card_inputs(shape, affine_dim, transposed, dtype, offset)
    y, mean, rstd = norm_fwd(x, w, b, dim, affine_dim, LN_EPS)
    dx, dw, db = norm_bwd(x, dy, w, mean, rstd, dim, affine_dim)
    torch.cuda.synchronize()
    assert y.stride() == x.stride()
    want_y, want_mean, want_rstd = norm_reference(x, w, b, dim, affine_dim, LN_EPS)
    want = norm_bwd_reference(x, dy, w, want_mean, want_rstd, dim, affine_dim)
    # one statistic a row; the kernels' (outer, inner) order is the
    # reference's dimension order at these layouts
    want_mean, want_rstd = want_mean.reshape(-1), want_rstd.reshape(-1)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel(y, want_y) <= tol
    assert _rel(mean, want_mean) <= 1e-5 and _rel(rstd, want_rstd) <= 1e-5
    assert _rel(dx, want[0]) <= tol
    if w is None:
        assert dw is None and db is None
    else:
        assert _rel(dw, want[1]) <= 1e-3 and _rel(db, want[2]) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["encoder_base", "group_norm", "channel_layer_norm",
                                  "projection"])
def test_norm_backward_repeats_bit_for_bit(case):
    """The backward twice on the same inputs: dx, dweight and dbias equal
    bit for bit (a fixed grid, partial sums added in a fixed order)."""
    _card()
    _, shape, dim, affine_dim, transposed, dtype, offset = next(c for c in CARD_CASES
                                                                if c[0] == case)
    x, w, b, dy = _card_inputs(shape, affine_dim, transposed, dtype, offset)
    _, mean, rstd = norm_fwd(x, w, b, dim, affine_dim, LN_EPS)
    first = norm_bwd(x, dy, w, mean, rstd, dim, affine_dim)
    second = norm_bwd(x, dy, w, mean, rstd, dim, affine_dim)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.gpu
def test_norm_graph_replay_equals_the_eager_call():
    """Forward and backward through ``NormFn`` captured in a CUDA graph:
    two replays give the eager call's y and gradients bit for bit."""
    _card()
    for case in ("encoder_base", "group_norm", "channel_layer_norm", "projection"):
        _, shape, dim, affine_dim, transposed, dtype, _ = next(c for c in CARD_CASES
                                                               if c[0] == case)
        x, w, b, dy = _card_inputs(shape, affine_dim, transposed, dtype, 0, seed=5)
        leaves = [x.requires_grad_(), w.requires_grad_(), b.requires_grad_()]

        def run():
            y = NormFn.apply(*leaves, dim, affine_dim, LN_EPS)
            return (y.detach(), *torch.autograd.grad(y, leaves, dy))

        eager = run()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            run()  # warm on the side stream, as capture wants
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = run()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, s) for a, s in zip(eager, static)), case


@pytest.mark.gpu
def test_norm_kernels_are_all_the_card_runs():
    """A forward and backward of each geometry launch the norm kernels
    alone (no aten elementwise pass), each named with ``norm`` and with no
    marker of another kernel family of the benchmark's trace."""
    _card()
    forbidden = ("attention", "wavlm_", "conv", "cudnn", "fprop", "implicit", "gemm",
                 "cutlass", "nvjet")
    for case in ("encoder_base", "group_norm", "channel_layer_norm", "waveform"):
        _, shape, dim, affine_dim, transposed, dtype, _ = next(c for c in CARD_CASES
                                                               if c[0] == case)
        x, w, b, dy = _card_inputs(shape, affine_dim, transposed, dtype, 0)
        norm_bwd(x, dy, w, *norm_fwd(x, w, b, dim, affine_dim, LN_EPS)[1:], dim, affine_dim)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, mean, rstd = norm_fwd(x, w, b, dim, affine_dim, LN_EPS)
            norm_bwd(x, dy, w, mean, rstd, dim, affine_dim)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert kernels, case
        for k in kernels:
            assert "norm" in k and not any(f in k.lower() for f in forbidden), (case, k)


def _tiny(extractor_mode, layer_norm_first, normalize):
    return dict(
        extractor_mode=extractor_mode,
        extractor_conv_layer_config=[[32, 10, 5]] + [[32, 3, 2]] * 4 + [[32, 2, 2]] * 2,
        extractor_conv_bias=extractor_mode == "layer_norm", encoder_embed_dim=128,
        encoder_projection_dropout=0.0, encoder_pos_conv_kernel=16, encoder_pos_conv_groups=4,
        encoder_num_layers=3, encoder_use_attention=[True] * 3,
        encoder_use_feed_forward=[True] * 3, encoder_num_heads=[2] * 3, encoder_head_dim=64,
        encoder_attention_dropout=0.0, encoder_ff_interm_features=[256] * 3,
        encoder_ff_interm_dropout=0.0, encoder_dropout=0.0,
        encoder_layer_norm_first=layer_norm_first, encoder_layer_drop=0.0, aux_num_out=None,
        normalize_waveform=normalize)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["group_norm", "layer_norm"])
def test_tiny_model_on_card_matches_cpu(mode, monkeypatch):
    """A tiny HuBERT-like (GroupNorm, post-LN) and Large-like (LayerNorm
    extractor, pre-LN, waveform normalised) model in float32: every hidden
    state and every parameter's gradient on the card within 1e-4 of the
    largest of the CPU's (TF32 off), and one norm launch on the card for
    each ``_layer_norm`` call the CPU pass makes, forward and backward."""
    _card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = _tiny(mode, mode == "layer_norm", mode == "layer_norm")
    cpu = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(0), **cfg)
    card = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(0), **cfg)
    wave = torch.randn(2, 8000, generator=torch.Generator().manual_seed(1))
    calls = []
    plain = components._layer_norm

    def counted(x, *a, **kw):
        if x.device.type == "cpu":
            calls.append(1)
        return plain(x, *a, **kw)

    monkeypatch.setattr(components, "_layer_norm", counted)
    outs = {}
    for name, model, w in (("cpu", cpu, wave), ("card", card, wave.cuda())):
        before = (norm_fwd.launches, norm_bwd.launches)
        feats, _ = model.extract_features(w)
        loss = sum(f.float().square().mean() for f in feats)
        params = [p for p in model.parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        outs[name] = ([f.detach().cpu() for f in feats],
                      [None if g is None else g.cpu() for g in grads],
                      (norm_fwd.launches - before[0], norm_bwd.launches - before[1]))
    assert outs["card"][2] == (len(calls), len(calls) - int(cfg["normalize_waveform"]))
    for a, c in zip(outs["card"][0], outs["cpu"][0]):
        assert _rel(a, c) <= 1e-4
    for a, c in zip(outs["card"][1], outs["cpu"][1]):
        assert (a is None) == (c is None)
        if a is not None and c.abs().max() > 0:
            assert (a - c).abs().max().item() <= 1e-4 * max(c.abs().max().item(), 1e-3)
