"""The positional conv (a grouped conv1d, padding K//2, an even kernel's
last frame dropped) with its input gradient computed as a forward
convolution.

The input gradient of a stride-1 convolution is itself a convolution of the
output gradient, with each group's weight transposed (its in and out
channels swapped) and its taps reversed.  With padding K//2 an even
kernel's trim moves from the last frame to the first:

    dX = conv1d(dY, W~, padding=K//2, groups=G)[..., 1:]      # K even
    W~ = W.view(G, C/G, C/G, K).transpose(1, 2).flip(-1).reshape(C, C/G, K)

and for an odd K the same with no slice.  It is the same work in the same
precision.  That convolution has the forward's problem descriptor (the
input's shape and strides, the weight's shape, padding, groups), so cuDNN
runs it with the tensor-core kernel it picks for the forward.  On an H100
(bf16, 128 taps) at HuBERT Base's 48-channel groups that took 0.81-0.82 ms
where cuDNN's own backward-data kernel (``dgrad_engine``) took 141-151 ms;
at wav2vec 2.0 Large's 64-channel groups the forward conv took 1.05 ms
against cuDNN's 0.98, under 0.1% of a Large step, so every width takes the
one route.

``PosConvFn`` takes the weight and bias as they are computed (weight norm,
an FSDP gather) outside it.  Its forward is the module's
``F.conv1d`` call and trim as they were; it saves the input and the weight,
as the conv's own autograd node does, and its backward computes the weight
and bias gradients by ``aten.convolution_backward`` on the untrimmed
output gradient, as autograd did.  Each backward that computes the input
gradient counts one in ``PosConvFn.launches``, on any device (the kernel
wrappers count card launches only); as with theirs, a CUDA graph's capture
counts once and its replays not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def transposed_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """W~: each group's (out, in) channels swapped and its taps reversed,
    contiguous, (C, C/G, K)."""
    c, cg, k = weight.shape
    return (weight.view(groups, c // groups, cg, k).transpose(1, 2).flip(-1)
            .reshape(c, cg, k).contiguous())


class PosConvFn(torch.autograd.Function):
    """``conv1d(x, weight, bias, padding=K//2, groups)``, an even K's last
    frame dropped; x: (B, C, L), weight: (C, C/G, K), bias: (C,)."""

    launches = 0  # backwards that computed the input gradient

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int):
        k = weight.shape[-1]
        y = F.conv1d(x, weight, bias, padding=k // 2, groups=groups)
        ctx.save_for_backward(x, weight)
        ctx.groups = groups
        return y[..., :-1] if k % 2 == 0 else y

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        groups, k = ctx.groups, weight.shape[-1]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # the forward's layout, so that cuDNN sees the forward's descriptor
            g = dy if dy.stride() == x.stride() else torch.empty_like(x).copy_(dy)
            dx = F.conv1d(g, transposed_weight(weight, groups), None, padding=k // 2,
                          groups=groups)
            if k % 2 == 0:
                dx = dx[..., 1:]
            PosConvFn.launches += 1
        mask = [False, *ctx.needs_input_grad[1:3]]
        if any(mask):
            full = dy
            if k % 2 == 0:  # the trim's gradient, as autograd forms it
                full = dy.new_zeros(*dy.shape[:-1], dy.shape[-1] + 1)
                full[..., :-1] = dy
            _, dw, db = torch.ops.aten.convolution_backward(
                full, x, weight, [weight.shape[0]], [1], [k // 2], [1], False, [0], groups,
                mask)
        return dx, dw, db, None
