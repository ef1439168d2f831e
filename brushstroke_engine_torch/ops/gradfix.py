"""Convolutions whose derivatives of every order are convolutions of the
forward's shapes (StyleGAN2-ADA's ``conv2d_gradfix``).

Autograd's own second derivative of a convolution takes the weight's
gradient of an input gradient as a convolution with the batch and channels
swapped, whose filter is the whole output image, and takes it even for a
filter that needs no gradient (the FIRs' constant taps).  At 1024 px cuDNN
runs those through its slowest kernels: R1's double backward spent 30 s of
one step there on an H100.  Here the input's gradient is the transposed
op, the weight's is cuDNN's weight-gradient convolution and is taken only
where the weight needs one, and both are differentiable again through the
same ops.  Where no gradient is taken :func:`conv` is the plain op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _plain(x, w, transpose: bool, stride: int, out_pad, groups: int):
    if transpose:
        return F.conv_transpose2d(x, w, stride=stride, output_padding=out_pad,
                                  groups=groups)
    return F.conv2d(x, w, stride=stride, groups=groups)


class _Conv(torch.autograd.Function):
    """A VALID ``F.conv2d`` (``transpose`` False) or ``F.conv_transpose2d``
    at ``stride``, NCHW, no bias."""

    @staticmethod
    def forward(ctx, x, w, transpose: bool, stride: int, out_pad,
                groups: int):
        ctx.save_for_backward(x, w)
        ctx.conf = (transpose, stride, out_pad, groups)
        return _plain(x, w, transpose, stride, out_pad, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        transpose, stride, out_pad, groups = ctx.conf
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = conv(gy, w, not transpose, stride, groups, x.shape)
        if ctx.needs_input_grad[1]:
            gw = _ConvGradWeight.apply(gy, x, w, transpose, stride, out_pad,
                                       groups)
        return gx, gw, None, None, None, None


class _ConvGradWeight(torch.autograd.Function):
    """The weight's gradient of :class:`_Conv` (``w`` gives its shape):
    cuDNN's backward-weight convolution."""

    @staticmethod
    def forward(ctx, gy, x, w, transpose: bool, stride: int, out_pad,
                groups: int):
        ctx.save_for_backward(gy, x)
        ctx.conf = (transpose, stride, out_pad, groups)
        return torch.ops.aten.convolution_backward(
            gy, x, w, None, [stride] * 2, [0, 0], [1, 1], transpose,
            list(out_pad), groups, [False, True, False])[1]

    @staticmethod
    def backward(ctx, ggw):
        gy, x = ctx.saved_tensors
        transpose, stride, out_pad, groups = ctx.conf
        g_gy = g_x = None
        if ctx.needs_input_grad[0]:
            g_gy = _Conv.apply(x, ggw, transpose, stride, out_pad, groups)
        if ctx.needs_input_grad[1]:
            g_x = conv(gy, ggw, not transpose, stride, groups, x.shape)
        return g_gy, g_x, None, None, None, None, None


def conv(x, w, transpose: bool = False, stride: int = 1, groups: int = 1,
         out_shape=None):
    """``F.conv2d`` (or with ``transpose`` ``F.conv_transpose2d``) of NCHW
    ``x`` with ``w``, VALID, at ``stride``; a transposed op pads its output
    to ``out_shape`` (the input of the strided conv it inverts)."""
    out_pad = (0, 0)
    if transpose and out_shape is not None:
        out_pad = tuple(o - ((i - 1) * stride + k) for o, i, k in zip(
            out_shape[-2:], x.shape[-2:], w.shape[-2:]))
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv.apply(x, w, transpose, stride, out_pad, groups)
    return _plain(x, w, transpose, stride, out_pad, groups)
