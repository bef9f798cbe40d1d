"""The wide bottleneck (expand -> relu -> decay) on flat ``[N, C]`` rows,
with a hand-written CUDA backward.

Port of ``probav_tpu/ops/pallas_wide_block.py``.  The forward is plain
PyTorch (the JAX package leaves it to XLA); the backward is one entry point
of ``csrc/blk_bwd.cu``, ``probav_wide_bwd``, which recomputes the wide
activation z = x W1 + b1 row tile by row tile on chip and returns dx and
the four weight gradients (replaces ``pallas_wide_block._bwd``):

    dz = (dy W2^T) * (z > 0),  dx = dz W1^T,
    dW1 = x^T dz, db1 = sum dz, dW2 = relu(z)^T dy, db2 = sum dy.

dy, z, relu(z) and dz stay float32 at both dtypes, as in ``_bwd_kernel``;
dx is stored in x's dtype, the weight gradients are float32.  The TPU row
tiling (``_pick_tile``, ``_pad_rows``) is not ported: any N is taken, and
any C_in and C_out from 1 to 128 (``tstack.t_tier_refusal``).  The C entry
picks the kernel from the dtype and widths before any launch
(``wide_bwd_route``): at C_in, C_out <= 32 and C_mid <= 256 (the
flagship's 32/256/25) both dtypes run on the tensor cores, bf16 with dz
and relu(z) split three ways into bf16 pieces, float32 as 3xTF32; wider
widths on the CUDA cores.

Dispatch as in ``ops/tstack.py``: CPU tensors run ``wide_bwd_plain``; CUDA
tensors launch the kernel, count it in ``LAUNCHES``, or raise.

``fused_expand_decay(..., mesh=)`` runs on this rank's C_mid channels of a
mesh's model axis: the model group's partial products are added (in
float32), then b2; in the backward ``wide_bwd`` runs on the rank's
channels and the group's partial dx are added.
"""

from __future__ import annotations

import torch

from probav_tpu_torch.ops.tstack import (_DTYPE_CODE, _check_input,
                                         _check_widths, _stream,
                                         partial_slots, slot_stride)
from probav_tpu_torch.parallel.mesh import model_sum

# Kernel launches since the counts were last reset (plain runs not counted).
LAUNCHES = {"wide_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The kernels wide_bwd may launch, by the code that csrc/blk_bwd.cu's
# wide_bwd_route gives.
WIDE_BWD_ROUTES = ("seg_bwd_kernel (CUDA cores, WIDE)",
                   "wide_bwd_bf16_kernel (bf16 mma, 3-way split)",
                   "wide_bwd_tf32_kernel (3xTF32 mma)")


def wide_bwd_route(dtype, c: int, c_mid: int, c_dec: int) -> str:
    """The kernel that ``wide_bwd`` runs for these widths on the card, as
    its C entry chooses it (from the dtype and widths alone, before any
    launch): at C, C_dec <= 32 and C_mid <= 256 on the tensor cores (bf16
    and float32 each its own kernel), beyond on the CUDA cores.  Builds the
    kernels."""
    from probav_tpu_torch.ops import _build
    code = _build.library().probav_wide_bwd_route(_DTYPE_CODE[dtype], c,
                                                  c_mid, c_dec)
    return WIDE_BWD_ROUTES[code]


def wide_bwd_plain(x, w1, b1, w2, dy):
    """The body of ``_bwd_kernel`` in float32: x [N, C_in] and dy [N,
    C_out] -> (dx [N, C_in] in x's dtype, dw1, db1, dw2, db2 float32).
    Weights are taken in x's dtype, b1 widened to float32."""
    dt = x.dtype
    xf, dyf = x.float(), dy.float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    z = torch.matmul(xf, w1f) + b1.float()
    dz = torch.where(z > 0, torch.matmul(dyf, w2f.t()), 0.0)
    dx = torch.matmul(dz, w1f.t()).to(dt)
    return (dx, torch.matmul(xf.t(), dz), dz.sum(0),
            torch.matmul(torch.relu(z).t(), dyf), dyf.sum(0))


def wide_bwd(x, w1, b1, w2, dy):
    """The arguments and results of ``wide_bwd_plain``, on the kernel for
    CUDA tensors.  Weights are cast to x's dtype and b1 to float32, as the
    TPU kernel's caller passes them (``pallas_wide_block._vjp_bwd``)."""
    if x.device.type == "cpu":
        return wide_bwd_plain(x, w1, b1, w2, dy)
    from probav_tpu_torch.ops import _build
    _check_input("wide_bwd x", x)
    _check_input("wide_bwd dy", dy, x.dtype)
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    if w1.shape != (c_in, c_mid) or b1.shape != (c_mid,) or \
            dy.shape != (n, c_dec):
        raise ValueError(f"wide_bwd: shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} b1 {tuple(b1.shape)} w2 "
                         f"{tuple(w2.shape)} dy {tuple(dy.shape)}")
    _check_widths("wide_bwd", c_in, c_dec)
    w1 = w1.to(x.dtype).contiguous()
    w2 = w2.to(x.dtype).contiguous()
    b1 = b1.float().contiguous()
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("dy", dy)):
        if t.device != x.device:
            raise ValueError(f"wide_bwd {name} on {t.device}, x on "
                             f"{x.device}")
    dx = torch.empty_like(x)
    groups = partial_slots(x.device, c_in, c_dec)
    slot = c_in * c_mid + c_mid * c_dec + c_mid + c_dec
    part = torch.empty((groups, slot_stride(slot)), dtype=torch.float32,
                       device=x.device)
    out = torch.empty(slot, dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.probav_wide_bwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
        out.data_ptr(), groups, part.shape[1], n, c_in, c_mid, c_dec,
        _stream(x))
    _build.check(err, "wide_bwd")
    LAUNCHES["wide_bwd"] += 1
    dw1, dw2, db1, db2 = torch.split(
        out, [c_in * c_mid, c_mid * c_dec, c_mid, c_dec])
    return dx, dw1.view(c_in, c_mid), db1, dw2.view(c_mid, c_dec), db2


class FusedExpandDecay(torch.autograd.Function):
    """relu(x @ w1 + b1) @ w2 + b2 with ``wide_bwd`` as its backward
    (``pallas_wide_block.fused_expand_decay``).  The forward is plain
    PyTorch in the working dtype and saves only x and the weights.  With
    a mesh the product and dx are the model group's sums."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, mesh):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.mesh = mesh
        y = torch.relu(x @ w1 + b1) @ w2
        if mesh is not None:
            y = model_sum(y, mesh)
        return y + b2

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = wide_bwd(x.contiguous(), w1, b1, w2,
                                          dy.to(x.dtype).contiguous())
        if ctx.mesh is not None:
            dx = model_sum(dx, ctx.mesh)
        # The casts of pallas_wide_block._vjp_bwd.
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(dy.dtype), None)


def fused_expand_decay(x, w1, b1, w2, b2, mesh=None):
    """x [N, C_in], w1 [C_in, C_mid], w2 [C_mid, C_out] -> [N, C_out];
    with ``mesh``, w1, b1 and w2 of this rank's C_mid channels of its
    model axis."""
    return FusedExpandDecay.apply(x, w1, b1, w2, b2, mesh)
