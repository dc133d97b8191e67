"""LayerNorm and GroupNorm with fp32 statistics: the kernel pair of
``csrc/norm.cu``, its plain versions and its autograd function.

``layer_norm(x, weight, bias, dim, affine_dim, eps)`` normalises x over
``dim`` and applies the affine along ``affine_dim`` (default ``dim``);
GroupNorm with one group per channel is the (stats = time, affine =
channel) case.  It is ``models/components.py::_layer_norm`` on the card:

* ``norm_fwd`` launches the forward (``norm_fwd_*``): it reads x once,
  computes the mean and the variance in fp32 by two passes over the row on
  chip, and writes y once in x's dtype, with the per-row mean and rstd;
* ``norm_bwd`` launches the backward (``norm_bwd_*``, then
  ``norm_bwd_affine_sum`` for the affine's gradient): it reads x, dy and the
  saved statistics and writes dx, and sums dweight and dbias from per-block
  partials in a fixed order, with no float atomics;
* ``NormFn`` pairs them for autograd and saves x as it is (no fp32 copy),
  the weight and the per-row mean and rstd.

The plain versions, ``norm_reference`` and ``norm_bwd_reference``, compute
the kernels' own formulas on any device.  Each wrapper takes CUDA tensors
only: it launches its kernel or raises (a CPU tensor goes through
``_layer_norm``'s own code, never here), and counts its launches in a
``launches`` attribute (a CUDA graph's capture once, its replays not).

The kernel follows the input's shape and strides (``norm_geometry``),
never the module that calls it: the *rows* geometry where the reduced
dimension has unit stride and the other dimensions flatten to rows a fixed
stride apart (a row of at most ``WARP_MAX_N`` elements to a warp, a longer
one to a block), the *strided* geometry where the reduced dimension's elements lie
a fixed stride apart and another dimension has unit stride (tiles of all
channels x 32 consecutive frames; the backward reads a channel-major dy
in its own layout).  A layout that is neither (never one of the model's) is made
contiguous first.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ._build import bind
from .attention_common import DTYPE_CODES, acc_dtype, stream

# a row of at most this many elements goes to a warp, held in registers;
# the affine's gradient along a longer row (no caller of the model's) has no
# kernel
WARP_MAX_N = 1024
# a strided layout's reduced length times the item size at most: the
# backward's tiles of x and dy (32 frames each) then fit in shared memory
STRIDED_MAX_BYTES = 2048
STRIDED_TILE = 32  # frames a strided tile (csrc/norm.cu's kTile)
# blocks an SM of the backward's grids that stride over rows or tiles: the
# affine's partial sums are then a few MB at the cells' shapes
WARP_BWD_BLOCKS_PER_SM = 2
STRIDED_BWD_BLOCKS_PER_SM = 3

_ROUTES = {"rows_warp": 0, "rows_block": 1, "strided": 2}
_AFFINES = {"none": 0, "column": 1, "row": 2}


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Geometry:
    """Where the normalised rows of a tensor lie (``csrc/norm.cu``'s
    ``Geometry``): rows route: row r spans elements [r * so, r * so + n);
    strided: row (o, i) holds elements o * so + c * sn + i, c < n, i <
    inner.  ``affine``: "none", "column" (w[j] along the reduced dimension)
    or "row" (w[(row // div) % groups], e.g. GroupNorm's channels)."""

    route: str
    outer: int
    inner: int
    so: int
    sn: int
    n: int
    affine: str
    groups: int = 1
    div: int = 1

    @property
    def rows(self) -> int:
        """Normalised rows: the length of mean and rstd."""
        return self.outer * self.inner


def _collapse(dims: Sequence[Tuple[int, int]]) -> Optional[Tuple[int, int]]:
    """(size, stride) of dims (in order) read as one index, or None where
    their strides do not nest; size-1 dims are left out."""
    dims = [(s, st) for s, st in dims if s != 1]
    if not dims:
        return 1, 1
    for (_, outer), (size, inner) in zip(dims, dims[1:]):
        if outer != inner * size:
            return None
    return math.prod(s for s, _ in dims), dims[-1][1]


def _dense(shape: Sequence[int], stride: Sequence[int]) -> bool:
    """Whether the strides lay the elements out without gaps or overlaps."""
    expected = 1
    for st, size in sorted((st, s) for s, st in zip(shape, stride) if s != 1):
        if st != expected:
            return False
        expected *= size
    return True


def norm_geometry(shape: Sequence[int], stride: Sequence[int], dim: int,
                  affine_dim: Optional[int], itemsize: int) -> Optional[Geometry]:
    """The kernels' geometry for a tensor of ``shape`` and ``stride``
    normalised over ``dim``, the affine along ``affine_dim`` (None: no
    affine), or None where the layout fits neither geometry (the caller then
    makes the tensor contiguous).  Raises for what no kernel takes."""
    nd = len(shape)
    dim %= nd
    n = shape[dim]
    if not _dense(shape, stride):
        return None
    others = [d for d in range(nd) if d != dim]
    if affine_dim is None:
        affine = "none"
    else:
        affine_dim %= nd
        affine = "column" if affine_dim == dim else "row"
    if stride[dim] == 1 or n == 1:
        rows = _collapse([(shape[d], stride[d]) for d in others])
        if rows is not None:
            outer, so = rows
            route = "rows_warp" if n <= WARP_MAX_N else "rows_block"
            if affine == "column" and route == "rows_block":
                raise ValueError(f"no norm kernel for an affine along a row of {n} elements "
                                 f"(at most {WARP_MAX_N})")
            if affine == "row":
                div = math.prod(shape[d] for d in others if d > affine_dim)
                return Geometry(route, outer, 1, so, 1, n, affine, shape[affine_dim], div)
            return Geometry(route, outer, 1, so, 1, n, affine)
    if affine == "row" or n * itemsize > STRIDED_MAX_BYTES:
        return None
    inner = [d for d in others if stride[d] == 1 and shape[d] > 1]
    if not inner:
        return None
    outer = _collapse([(shape[d], stride[d]) for d in others if d != inner[0]])
    if outer is None:
        return None
    return Geometry("strided", outer[0], shape[inner[0]], outer[1], stride[dim], n, affine)


def _geometry(x: torch.Tensor, dim: int, affine_dim: Optional[int]):
    """(x, geometry): x made contiguous where its layout fits neither."""
    geo = norm_geometry(x.shape, x.stride(), dim, affine_dim, x.element_size())
    if geo is None:
        x = x.contiguous()
        geo = norm_geometry(x.shape, x.stride(), dim, affine_dim, x.element_size())
        if geo is None:
            raise ValueError(f"no norm kernel for shape {tuple(x.shape)} over dim {dim} "
                             f"with the affine along dim {affine_dim}")
    return x, geo


def dy_strides(x: torch.Tensor, dy: torch.Tensor, dim: int) -> Optional[Tuple[int, int, int]]:
    """dy's strides along the strided geometry of x (normalised over
    ``dim``): its outer, reduced and (for x) unit-stride indices, or None
    where dy's dimensions outside those two do not read as one index."""
    nd = x.ndim
    dim %= nd
    inner = next(d for d in range(nd) if d != dim and x.stride(d) == 1 and x.shape[d] > 1)
    outer = _collapse([(dy.shape[d], dy.stride(d)) for d in range(nd) if d not in (dim, inner)])
    if outer is None:
        return None
    return outer[1], dy.stride(dim), dy.stride(inner)


def _affine_shape(x: torch.Tensor, affine_dim: int):
    shape = [1] * x.ndim
    shape[affine_dim] = x.shape[affine_dim]
    return shape


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def norm_reference(x, weight, bias, dim: int = -1, affine_dim: Optional[int] = None,
                   eps: float = 1e-5):
    """Plain version of the forward, (y, mean, rstd): mean and variance in
    fp32 (float64 for float64 inputs) by two passes, the variance clamped at
    0, y = (x - mean) * rstd * w + b, rounded to x's dtype; mean and rstd
    keep the reduced dimension (size 1)."""
    if affine_dim is None:
        affine_dim = dim
    acc = acc_dtype(x.dtype)
    xf = x.to(acc)
    mean = xf.mean(dim=dim, keepdim=True)
    var = (xf - mean).square().mean(dim=dim, keepdim=True).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    if weight is not None:
        shape = _affine_shape(x, affine_dim)
        y = y * weight.to(acc).reshape(shape) + bias.to(acc).reshape(shape)
    return y.to(x.dtype), mean, rstd


def norm_bwd_reference(x, dy, weight, mean, rstd, dim: int = -1,
                       affine_dim: Optional[int] = None):
    """Plain version of the backward, (dx, dweight, dbias) from x, dy and
    the forward's mean and rstd (``norm_reference``'s), in fp32 (float64
    for float64 inputs): xh = (x - mean) * rstd, g = dy * w,
    dx = rstd * (g - mean(g) - xh * mean(g * xh)) in x's dtype;
    dweight = sum of dy * xh and dbias = sum of dy over every dimension but
    ``affine_dim`` (None without a weight)."""
    if affine_dim is None:
        affine_dim = dim
    acc = acc_dtype(x.dtype)
    dyf = dy.to(acc)
    xh = (x.to(acc) - mean) * rstd
    g = dyf if weight is None else dyf * weight.to(acc).reshape(_affine_shape(x, affine_dim))
    c1 = g.mean(dim=dim, keepdim=True)
    c2 = (g * xh).mean(dim=dim, keepdim=True)
    dx = (rstd * (g - c1 - xh * c2)).to(x.dtype)
    if weight is None:
        return dx, None, None
    others = [d for d in range(x.ndim) if d != affine_dim % x.ndim]
    return dx, (dyf * xh).sum(dim=others), dyf.sum(dim=others)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_GEO = [_I, _LL, _LL, _LL, _LL, _I, _I, _LL, _LL]


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    return bind("norm", "norm_fwd", [_P] * 6 + _GEO + [_F, _I, _P])


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    return bind("norm", "norm_bwd", [_P] * 10 + [_I] + _GEO + [_LL] * 3 + [_I, _P])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _geo_args(geo: Geometry):
    return (_ROUTES[geo.route], geo.outer, geo.inner, geo.so, geo.sn, geo.n,
            _AFFINES[geo.affine], geo.groups, geo.div)


def _on_card(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"norm kernel needs a CUDA tensor, got {x.device}")


def _check(x: torch.Tensor, weight, bias) -> None:
    _on_card(x)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("norm kernel needs a non-empty tensor")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if (weight is None) != (bias is None):
        raise ValueError("norm takes both weight and bias or neither")


def _affine_arg(t: Optional[torch.Tensor], size: int):
    """A weight or bias of ``size`` entries as the kernels read it: float32
    and contiguous (the model's are, so no copy), or None."""
    if t is None:
        return None
    t = t.reshape(-1).float().contiguous()
    if t.numel() != size:
        raise ValueError(f"affine of {t.numel()} entries, the norm needs {size}")
    return t


def norm_fwd(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
             dim: int = -1, affine_dim: Optional[int] = None, eps: float = 1e-5):
    """(y, mean, rstd): the forward on a CUDA tensor x, by the kernel of
    x's geometry, or raises: y with x's strides, mean and rstd float32, one
    per normalised row."""
    if affine_dim is None:
        affine_dim = dim
    _check(x, weight, bias)
    x, geo = _geometry(x, dim, affine_dim if weight is not None else None)
    size = geo.n if geo.affine == "column" else geo.groups
    w, b = _affine_arg(weight, size), _affine_arg(bias, size)
    y = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
    mean = torch.empty(geo.rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    rc = _fwd_kernel()(
        x.data_ptr(), y.data_ptr(), _ptr(w), _ptr(b), mean.data_ptr(), rstd.data_ptr(),
        *_geo_args(geo), float(eps), DTYPE_CODES[x.dtype], stream(x))
    if rc != 0:
        raise RuntimeError(f"norm_fwd launch failed: cudaError {rc}")
    norm_fwd.launches += 1
    return y, mean, rstd


norm_fwd.launches = 0


def _bwd_grid(geo: Geometry, device: torch.device) -> int:
    """Blocks of the backward: route rows_warp and strided stride over their
    rows or tiles with a few blocks an SM; rows_block takes a block a row."""
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    if geo.route == "rows_warp":
        return min(-(-geo.outer // 8), sms * WARP_BWD_BLOCKS_PER_SM)
    if geo.route == "strided":
        tiles = geo.outer * -(-geo.inner // STRIDED_TILE)
        return min(tiles, sms * STRIDED_BWD_BLOCKS_PER_SM)
    return 1


def norm_bwd(x: torch.Tensor, dy: torch.Tensor, weight: Optional[torch.Tensor],
             mean: torch.Tensor, rstd: torch.Tensor, dim: int = -1,
             affine_dim: Optional[int] = None, need_dx: bool = True, need_affine: bool = True):
    """(dx, dweight, dbias): the backward on CUDA tensors, from the x that
    ``norm_fwd`` took and its mean and rstd, by the kernels, or raises.  dx
    has the strides of the x the forward read (None unless ``need_dx``);
    dweight and dbias are float32 sums (None unless ``need_affine`` and a
    weight).  The kernels read dy with x's strides, or, on the strided
    route, channel-major in its own (``dy_strides``: the projection's); dy
    in another layout is copied to x's strides (never in the model)."""
    if affine_dim is None:
        affine_dim = dim
    _on_card(x)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {dy.dtype}/{tuple(dy.shape)} does not match x "
                         f"{x.dtype}/{tuple(x.shape)}")
    x, geo = _geometry(x, dim, affine_dim if weight is not None else None)
    dys = dy_strides(x, dy, dim) if geo.route == "strided" else None
    if dys is None or dys[1] != 1:  # read with x's strides
        if dy.stride() != x.stride():
            dy = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                     device=x.device).copy_(dy)
        dys = (geo.so, geo.sn, 1)
    size = geo.n if geo.affine == "column" else geo.groups
    w = _affine_arg(weight, size)
    dx = (torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
          if need_dx else None)
    dw = db = pw = pb = None
    grid = _bwd_grid(geo, x.device)
    if need_affine and w is not None:
        dw = torch.empty(size, dtype=torch.float32, device=x.device)
        db = torch.empty_like(dw)
        parts = grid * geo.n if geo.affine == "column" else geo.rows
        pw = torch.empty(parts, dtype=torch.float32, device=x.device)
        pb = torch.empty_like(pw)
    rc = _bwd_kernel()(
        x.data_ptr(), dy.data_ptr(), _ptr(dx), _ptr(w), mean.data_ptr(), rstd.data_ptr(),
        _ptr(dw), _ptr(db), _ptr(pw), _ptr(pb), grid, *_geo_args(geo), *dys,
        DTYPE_CODES[x.dtype], stream(x))
    if rc != 0:
        raise RuntimeError(f"norm_bwd launch failed: cudaError {rc}")
    norm_bwd.launches += 1
    return dx, dw, db


norm_bwd.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class NormFn(torch.autograd.Function):
    """Differentiable ``norm_fwd``: ``apply(x, weight, bias, dim,
    affine_dim, eps)``; saves x, the weight, mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, dim, affine_dim, eps):
        y, mean, rstd = norm_fwd(x, weight, bias, dim, affine_dim, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.norm = (dim, affine_dim)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dim, affine_dim = ctx.norm
        need_affine = weight is not None and any(ctx.needs_input_grad[1:3])
        dx, dw, db = norm_bwd(x, dy, weight, mean, rstd, dim, affine_dim,
                              need_dx=ctx.needs_input_grad[0], need_affine=need_affine)
        if dw is not None:
            dw, db = dw.to(weight.dtype), db.to(weight.dtype)
        return dx, dw, db, None, None, None


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               dim: int = -1, affine_dim: Optional[int] = None, eps: float = 1e-5):
    """Normalise x over ``dim`` with fp32 statistics and apply the affine
    along ``affine_dim`` (default ``dim``): through ``NormFn`` when autograd
    needs a gradient, else the forward alone."""
    tensors = [t for t in (x, weight, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return NormFn.apply(x, weight, bias, dim, affine_dim, eps)
    return norm_fwd(x, weight, bias, dim, affine_dim, eps)[0]
