"""One autograd node around the whole WDSR-B block stack, the wide
backward of each block on the hand-written ``wide_bwd`` kernel
(``--fused-stack flat``).

Port of ``probav_tpu/ops/pallas_block_stack.py``:

- forward: plain PyTorch per block (the matmul chain expand -> relu ->
  decay on flat ``[N, C]`` rows, then the k^3 SAME conv plus bias plus the
  residual), saving only each block's input x_i and decay output d_i, not
  the wide relu activation;
- backward: the blocks in reverse; per block the conv's input, weight and
  bias gradients from PyTorch's conv gradients (the JAX package leaves
  them to XLA), then ``wide_bwd`` for the expand -> relu -> decay segment,
  whose dx is added to the cotangent.

Weight norm stays outside: callers pass effective kernels
(``WDSRBlock.effective_params``), so the v / g gradients chain through
autograd.  Activations are the model's ``[B, H, W, T, C]``.

On a mesh's model axis (``mesh``, the blocks' expand / decay split over
its model group) each block's forward adds the group's partial decay
products (``parallel.mesh.model_sum``, in float32) and then the decay
bias; its backward runs ``wide_bwd`` on this rank's channels and adds the
group's partial ``dx`` before it joins the cotangent.  ``wide_bwd``'s
``db2``, the sum of the replicated cotangent, is whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from probav_tpu_torch.ops.wide_block import wide_bwd
from probav_tpu_torch.parallel.mesh import model_sum


def _conv_args(wc):
    """wc [kh, kw, kt, C_dec, C] -> (PyTorch weight [C, C_dec, kh, kw, kt],
    SAME padding of the odd kernel)."""
    return wc.permute(4, 3, 0, 1, 2), [k // 2 for k in wc.shape[:3]]


def _conv3d(d, wc, bc):
    w, pad = _conv_args(wc)
    return F.conv3d(d.movedim(-1, 1), w, padding=pad).movedim(1, -1) + bc


def _conv_vjp(g, d, wc):
    """(dd, dwc, dbc) of conv3d(d, wc) + bc at the cotangent g."""
    w, pad = _conv_args(wc)
    gc = g.movedim(-1, 1)
    dd = F.conv_transpose3d(gc, w, padding=pad).movedim(1, -1)
    dwc = torch.nn.grad.conv3d_weight(d.movedim(-1, 1), w.shape, gc,
                                      padding=pad)
    return dd, dwc.permute(2, 3, 4, 1, 0), g.sum(dim=tuple(range(g.dim() - 1)))


def block_fwd(x, w1, b1, w2, b2, wc, bc, mesh=None):
    """One block: (x + conv3d(d) + bc, d) with d = decay(relu(expand(x))),
    the decay output d being the conv's input, saved for the backward.
    With ``mesh`` the decay's product is the model group's sum."""
    c = x.shape[-1]
    d = torch.relu(x.reshape(-1, c) @ w1 + b1) @ w2
    if mesh is not None:
        d = model_sum(d, mesh)
    d = (d + b2).reshape(x.shape[:-1] + (w2.shape[1],))
    return x + _conv3d(d, wc, bc), d


class FusedBlockStack(torch.autograd.Function):
    """All blocks as one node (``pallas_block_stack.fused_block_stack``)."""

    @staticmethod
    def forward(ctx, x, mesh, *flat):
        h, xs, ds = x.contiguous(), [], []
        for i in range(0, len(flat), 6):
            xs.append(h)
            h, d = block_fwd(h, *flat[i:i + 6], mesh=mesh)
            ds.append(d)
        ctx.save_for_backward(*xs, *ds, *flat)
        ctx.nblk, ctx.mesh = len(xs), mesh
        return h

    @staticmethod
    def backward(ctx, g):
        n = ctx.nblk
        saved = ctx.saved_tensors
        xs, ds, flat = saved[:n], saved[n:2 * n], saved[2 * n:]
        grads = [None] * len(flat)
        for i in reversed(range(n)):
            w1, b1, w2, b2, wc, bc = flat[6 * i:6 * i + 6]
            dd, dwc, dbc = _conv_vjp(g, ds[i], wc)
            x_i = xs[i]
            dx, dw1, db1, dw2, db2 = wide_bwd(
                x_i.reshape(-1, x_i.shape[-1]), w1, b1, w2,
                dd.reshape(-1, dd.shape[-1]).contiguous())
            if ctx.mesh is not None:
                dx = model_sum(dx, ctx.mesh)
            g = g + dx.reshape(x_i.shape)
            # The casts of pallas_block_stack._stack_bwd.
            grads[6 * i:6 * i + 6] = (
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), dwc.to(wc.dtype), dbc.to(bc.dtype))
        return (g, None, *grads)


def fused_block_stack(x, blocks, mesh=None):
    """Apply the blocks to x [B, H, W, T, C].

    blocks: per-block effective params (w1 [C, C_mid], b1, w2 [C_mid,
    C_dec], b2, wc [kh, kw, kt, C_dec, C], bc) in the compute dtype; with
    ``mesh``, w1, b1 and w2 of this rank's C_mid channels of the model
    axis.  With grad enabled and any input requiring it the stack is one
    autograd node; otherwise (``torch.inference_mode``) the plain forward
    saves nothing.
    """
    flat = [t for blk in blocks for t in blk]
    if torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in flat)):
        return FusedBlockStack.apply(x, mesh, *flat)
    for blk in blocks:
        x, _ = block_fwd(x, *blk, mesh=mesh)
    return x
