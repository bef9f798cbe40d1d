"""The WDSR-B block stack, forward and backward, on hand-written CUDA kernels.

Port of ``probav_tpu/ops/pallas_tstack.py``.  Each block's forward is two
kernels (``csrc/tstack.cu``), its backward one entry point
(``csrc/blk_bwd.cu``):

- ``seg_fwd``:  x [N, C] -> d [N, C_dec], the 1x1x1 expand C -> C_mid, relu
  and 1x1x1 decay C_mid -> C_dec, without storing the wide activation
  (replaces ``pallas_tstack.seg_fwd``);
- ``conv_fwd``: the 3^3 SAME conv of d plus bias plus the residual x
  (replaces ``pallas_tstack.conv_fwd``);
- ``blk_bwd``: the whole block's backward, recomputing the wide
  activation: dx and every weight gradient (replaces
  ``pallas_tstack.blk_bwd``).  Its weight gradients are summed from
  per-block partial slots ``slot_stride`` floats apart by its last launch,
  ``reduce_partials_kernel`` (wide_bwd's too), which ``reduce_partials``
  also launches on its own, for the tests and timing.

With grad enabled, ``stack_apply_5d`` runs the blocks under one
``torch.autograd.Function`` (the counterpart of ``fused_stack_t``'s
custom VJP): its forward saves each block's input x_i and decay output d_i,
its backward runs ``blk_bwd`` for the blocks in reverse order.

``conv_fwd`` (and ``blk_bwd``'s dd conv, the same kernel) runs on the
tensor cores at both dtypes: bf16 products at bf16, float32 products as
3xTF32 (each operand split into two TF32 halves, three products summed in
float32: about 2**-22 relative error per product, within the float32
tolerance that plain TF32 misses).  ``seg_fwd`` runs on the tensor cores
at bf16 at every width (a kernel of its own where C, C_dec <= 32 and C_mid
<= 256), and at float32 as 3xTF32 within those widths (the flagship's;
``seg_fwd_route``).  ``blk_bwd``'s
expand/decay backward (``seg_bwd_route``) runs on the tensor cores within
the same widths: bf16 products at bf16, float32 as 3xTF32; so does its
``wgrad`` (dWc) at C, C_dec <= 32 where a row's halo fits shared memory
(``wgrad_route``; at float32 rows up to the flagship's 22 x 9).  Both also
run on the tensor cores at both dtypes up to C, C_dec <= 64 (and C_mid <=
512: the 64-filter model's 64/512/51), the expand/decay backward with C_mid
cut into chunks (256 at bf16, 128 at float32) whose float32 parts of dx a
second kernel sums (``blk_bwd_scratch``), the wgrad in 32 x 32 channel
tiles.  Beyond those widths and rows the float32 ``seg_fwd``, the
``wgrad`` and ``blk_bwd`` run on the CUDA cores with exact float32 products
(bf16 widened).  All round where the TPU kernels round.

``t_tier_refusal`` states the channel widths the kernels take, once: any C
and C_dec from 1 to 128 (``MAX_CHANNELS``), forward and backward.  The
wrappers raise with it, and a ``"t"`` model refuses to be built with it.
Within it the only limit left is the conv's depth T per width (``conv_fwd``),
which the kernels refuse before they launch.

The TPU kernels' transposed ``[C, ext]`` lane-shift layout (``Geom``, the
interior mask, halo margins, ``to_t``/``from_t``, the scan loop forms and
the 128-lane batch rule) is not ported: the stack takes and returns the
JAX boundary layout ``[B, H, W, T, C]``, contiguous channels-last, whose
rows are the kernels' ``[N, C]`` operands.

Dispatch: a wrapper given CPU tensors runs its ``*_plain`` twin; given CUDA
tensors it launches its kernel on the current stream, counts the launch in
``LAUNCHES``, and raises on any error.  There is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Kernel launches since the counts were last reset (plain runs not counted).
LAUNCHES = {"seg_fwd": 0, "conv_fwd": 0, "blk_bwd": 0, "reduce_partials": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The widest C and C_dec the kernels take (csrc/common.cuh, MAX_CH).
MAX_CHANNELS = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------- #
# plain PyTorch versions: the reference the kernels are held against      #
# ---------------------------------------------------------------------- #

def seg_fwd_plain(x, w1, b1, w2, b2):
    """x [N, C_in] -> d [N, C_dec] in x's dtype.

    Products in float32 (exact for bf16 operands), relu output rounded to
    the compute dtype before the decay product, as the TPU kernel does.
    """
    dt = x.dtype
    z = torch.matmul(x.float(), w1.to(dt).float()) + b1.float()
    h = torch.relu(z).to(dt).float()
    return (torch.matmul(h, w2.to(dt).float()) + b2.float()).to(dt)


def conv_fwd_plain(d, x, wc, bc):
    """d [B,H,W,T,C_dec], x [B,H,W,T,C], wc [3,3,3,C_dec,C] -> x + bc +
    SAME conv(d), summed in float32 and returned in x's dtype."""
    dt = x.dtype
    w = wc.to(dt).float().permute(4, 3, 0, 1, 2)          # [O, I, kh, kw, kt]
    y = F.conv3d(d.float().permute(0, 4, 1, 2, 3), w, padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    return (y + bc.float() + x.float()).to(dt)


def blk_bwd_plain(gy, x, d, w1, b1, w2, wc):
    """The backward of one block out = x + bc + conv(d, wc), d = seg(x).

    gy, x [B,H,W,T,C], d [B,H,W,T,C_dec] in the working dtype (x's).
    Returns (dx [B,H,W,T,C] in that dtype, dwc [3,3,3,C_dec,C], dw1
    [C,C_mid], db1, dw2 [C_mid,C_dec], db2, dbc), the weight grads in
    float32.  Sums in float32 with the rounding points of the TPU kernel
    (pallas_tstack.py:356-379): dd, dz and relu(z) are rounded to the
    working dtype, dx is stored in it.
    """
    dt = x.dtype
    c = x.shape[-1]
    c_dec = d.shape[-1]
    g5 = gy.to(dt).float()
    gc = g5.permute(0, 4, 1, 2, 3)                        # [B, C, H, W, T]
    w = wc.to(dt).float().permute(4, 3, 0, 1, 2)          # [C, C_dec, k^3]
    dd5 = F.conv_transpose3d(gc, w, padding=1).to(dt)
    dwc = torch.nn.grad.conv3d_weight(
        d.float().permute(0, 4, 1, 2, 3), w.shape, gc, padding=1)
    dwc = dwc.permute(2, 3, 4, 1, 0)                      # [k^3, C_dec, C]
    dx, *grads = seg_bwd_plain(
        x.reshape(-1, c), dd5.permute(0, 2, 3, 4, 1).reshape(-1, c_dec),
        gy.reshape(-1, c), w1, b1, w2)
    return (dx.reshape(x.shape), dwc, *grads)


def seg_bwd_plain(x, dd, gy, w1, b1, w2):
    """The expand/decay part of ``blk_bwd_plain`` on rows: x, gy [N, C] and
    dd [N, C_dec] in the working dtype (x's) -> (dx [N, C] in that dtype,
    dw1, db1, dw2, db2, dbc in float32): z = x W1 + b1 recomputed, dz =
    (W2 dd) where z > 0, rounded to the working dtype, and relu(z) rounded
    too; sums in float32."""
    dt = x.dtype
    x2, dd2, g2 = x.float(), dd.to(dt).float(), gy.to(dt).float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    z = torch.matmul(x2, w1f) + b1.float()
    dz = torch.where(z > 0, torch.matmul(dd2, w2f.t()), 0.0).to(dt).float()
    dx = (torch.matmul(dz, w1f.t()) + g2).to(dt)
    h = torch.relu(z).to(dt).float()
    return (dx, torch.matmul(x2.t(), dz), dz.sum(0), torch.matmul(h.t(), dd2),
            dd2.sum(0), g2.sum(0))


# ---------------------------------------------------------------------- #
# kernel wrappers                                                         #
# ---------------------------------------------------------------------- #

def t_tier_refusal(c: int, c_dec: int, backward: bool = False
                   ) -> str | None:
    """Why the kernels cannot run blocks of C channels that decay to C_dec,
    or None where they can: every kernel takes any C and C_dec from 1 to
    ``MAX_CHANNELS``.  ``backward`` (blk_bwd, wide_bwd) asks about the same
    envelope: the backward takes every width the forward takes."""
    del backward
    if not (1 <= c <= MAX_CHANNELS and 1 <= c_dec <= MAX_CHANNELS):
        return (f"channels from 1 to {MAX_CHANNELS}, got C = {c}, "
                f"C_dec = {c_dec}")
    return None


def _check_widths(name, c, c_dec):
    why = t_tier_refusal(c, c_dec)
    if why:
        raise ValueError(f"{name}: {why}")


# The kernels seg_fwd may launch, by the code that csrc/tstack.cu's
# seg_fwd_route gives.
SEG_FWD_ROUTES = ("seg_fwd_kernel (CUDA cores)",
                  "seg_fwd_mma_kernel (bf16 mma)",
                  "seg_fwd_tf32_kernel (3xTF32 mma)",
                  "seg_fwd_bf16_kernel (bf16 mma, ldmatrix)",
                  "seg_fwd_tf32_wide_kernel (3xTF32 mma, C_mid in chunks "
                  "of 128)",
                  "seg_fwd_bf16_wide_kernel (bf16 mma, ldmatrix, weights "
                  "staged once a block)")


def seg_fwd_route(dtype, c: int, c_mid: int, c_dec: int) -> str:
    """The kernel that ``seg_fwd`` runs for these widths on the card, as
    its C entry chooses it (from the dtype and widths alone, before any
    launch): at C, C_dec <= 32 and C_mid <= 256 ``seg_fwd_bf16_kernel`` at
    bf16 and 3xTF32 on the tensor cores at float32; beyond, up to C, C_dec
    <= 64 and C_mid <= 512, ``seg_fwd_bf16_wide_kernel`` at bf16 (the
    weights staged once a block) and 3xTF32 in ``seg_fwd_tf32_wide_kernel``
    at float32 (C_mid staged in chunks); past those, bf16 in
    ``seg_fwd_mma_kernel`` and float32 on the CUDA cores.  Builds the
    kernels."""
    from probav_tpu_torch.ops import _build
    code = _build.library().probav_seg_fwd_route(_DTYPE_CODE[dtype], c,
                                                 c_mid, c_dec)
    return SEG_FWD_ROUTES[code]


# The kernels blk_bwd's expand/decay backward may launch, by the code that
# csrc/blk_bwd.cu's seg_bwd_route gives.
SEG_BWD_ROUTES = ("seg_bwd_kernel (CUDA cores)",
                  "seg_bwd_bf16_kernel (bf16 mma)",
                  "seg_bwd_tf32_kernel (3xTF32 mma)",
                  "seg_bwd_split_kernel + dx_sum_kernel (bf16 mma, C_mid "
                  "in chunks of 256)",
                  "seg_bwd_tf32_split_kernel + dx_sum_kernel (3xTF32 mma, "
                  "C_mid in chunks of 128)")


def seg_bwd_route(dtype, c: int, c_mid: int, c_dec: int) -> str:
    """The kernel that ``blk_bwd`` runs for the expand/decay backward of a
    block of these widths on the card, as its C entry chooses it (from the
    dtype and widths alone, before any launch): at C, C_dec <= 32 and
    C_mid <= 256 ``seg_bwd_bf16_kernel`` at bf16 and 3xTF32 on the tensor
    cores at float32; beyond, up to C, C_dec <= 64 and C_mid <= 512, on
    the tensor cores with C_mid cut into chunks over the grid, whose
    parts of dx a second kernel sums with gy: bf16 in
    ``seg_bwd_split_kernel`` (chunks of 256) and ``dx_sum_kernel`` (dx
    rounded once), float32 as 3xTF32 in ``seg_bwd_tf32_split_kernel``
    (chunks of 128) and ``dx_sum_kernel``; elsewhere the CUDA cores.
    Builds the kernels."""
    from probav_tpu_torch.ops import _build
    code = _build.library().probav_seg_bwd_route(_DTYPE_CODE[dtype], c,
                                                 c_mid, c_dec)
    return SEG_BWD_ROUTES[code]


# The kernels blk_bwd's weight gradient of the conv (dWc) may launch, by
# the code that csrc/blk_bwd.cu's wgrad_route gives.
WGRAD_ROUTES = ("wgrad_kernel (CUDA cores)", "wgrad_ring_kernel (bf16 mma)",
                "wgrad_tf32_kernel (3xTF32 mma)",
                "wgrad_tiles_kernel (bf16 mma, 32 x 32 channel tiles)",
                "wgrad_tf32_tiles_kernel (3xTF32 mma, 32 x 32 channel "
                "tiles)")


def wgrad_route(dtype, c: int, c_dec: int, w: int, t: int) -> str:
    """The kernel that ``blk_bwd`` runs for dWc of a block of C channels
    decaying to C_dec on rows of W x T positions, as its C entry chooses it
    (from the dtype and shapes alone, before any launch): the tensor cores
    where the rows fit shared memory, at C, C_dec <= 32 (bf16 up to W = 48
    at T = 9 or T = 19 at W = 22; float32 up to 22 x 9) and up to C, C_dec
    <= 64 in 32 x 32 channel tiles over the grid (bf16
    ``wgrad_tiles_kernel``, staged by producer warps, float32
    ``wgrad_tf32_tiles_kernel``; rows up to 22 x 9 at 64/51); elsewhere the
    CUDA cores.  Builds the kernels."""
    from probav_tpu_torch.ops import _build
    code = _build.library().probav_wgrad_route(_DTYPE_CODE[dtype], c, c_dec,
                                               w, t)
    return WGRAD_ROUTES[code]


def blk_bwd_scratch(dtype, c: int, c_mid: int, c_dec: int, n: int) -> int:
    """Floats of the float32 scratch ``blk_bwd`` hands its C entry at n rows
    of these widths: the chunks' parts of dx where its seg_bwd route cuts
    C_mid (``seg_bwd_split_kernel``, ``seg_bwd_tf32_split_kernel``), else
    0.  Builds the kernels."""
    import ctypes

    from probav_tpu_torch.ops import _build
    out = ctypes.c_longlong()
    _build.check(_build.library().probav_blk_bwd_scratch(
        _DTYPE_CODE[dtype], c, c_mid, c_dec, n, ctypes.byref(out)),
        "blk_bwd scratch")
    return out.value


def partial_slots(device, c: int, c_dec: int) -> int:
    """How many float32 partial slots (one per block) blk_bwd and wide_bwd
    sum their weight gradients into: two per SM up to 64 channels; beyond,
    where a seg_bwd block holds an SM alone and a slot grows as C * C_mid
    (2.36 MB at 128/1024/102), one per SM, which halves the scratch and the
    reduce's reads."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms if max(c, c_dec) > 64 else 2 * sms


def slot_stride(length: int) -> int:
    """Floats from one partial slot of ``length`` floats to the next:
    ``length`` rounded up to 32, so that every slot starts on 128 bytes
    and ``reduce_partials_kernel`` reads it in 16-byte loads."""
    return -(-length // 32) * 32


def reduce_partials_plain(part, length: int):
    """The function of blk_bwd's and wide_bwd's last launch: part float32
    [G, stride] -> the sum over G of its first ``length`` columns."""
    return part[:, :length].sum(0)


def reduce_partials(part, length: int):
    """``reduce_partials_plain`` on the kernel for a CUDA tensor (csrc/
    blk_bwd.cu's ``probav_reduce_partials``, the reduce that
    ``probav_blk_bwd`` and ``probav_wide_bwd`` launch themselves): part
    float32 [G, stride], contiguous and 16-byte aligned, stride a multiple
    of 4 and at least ``length`` (``slot_stride``)."""
    if part.device.type == "cpu":
        return reduce_partials_plain(part, length)
    from probav_tpu_torch.ops import _build
    _check_input("reduce_partials part", part, torch.float32)
    if part.dim() != 2 or not 1 <= length <= part.shape[1] or \
            part.shape[1] % 4 or part.data_ptr() % 16:
        raise ValueError(f"reduce_partials: part {tuple(part.shape)} at "
                         f"{part.data_ptr() % 16} bytes past 16 and length "
                         f"{length}: need [G, stride], stride % 4 == 0, "
                         "1 <= length <= stride, 16-byte aligned")
    groups, stride = part.shape
    out = torch.empty(length, dtype=torch.float32, device=part.device)
    err = _build.library().probav_reduce_partials(
        part.data_ptr(), out.data_ptr(), groups, length, stride,
        _stream(part))
    _build.check(err, "reduce_partials")
    LAUNCHES["reduce_partials"] += 1
    return out


def reduce_plan(groups: int, length: int) -> tuple:
    """(column tiles, blocks a cluster, warps a block, clusters the card
    holds at once) of ``reduce_partials_kernel`` for ``groups`` slots of
    ``length`` floats on the current card, as its C entry plans it.
    Builds the kernels."""
    import ctypes

    from probav_tpu_torch.ops import _build
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().probav_reduce_partials_plan(
        groups, length, out), "reduce_partials plan")
    return tuple(out)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_input(name, t, dtype=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def seg_fwd(x, w1, b1, w2, b2):
    """x [N, C_in] -> d [N, C_dec]: relu(x @ w1 + b1) @ w2 + b2.

    Weights are cast to x's dtype, biases to float32, as the TPU kernel's
    caller does (pallas_tstack.py:265-266).  On the card the kernel is the
    one ``seg_fwd_route`` names for x's dtype and these widths.
    """
    if x.device.type == "cpu":
        return seg_fwd_plain(x, w1, b1, w2, b2)
    from probav_tpu_torch.ops import _build
    _check_input("seg_fwd x", x)
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    if w1.shape != (c_in, c_mid) or b1.shape != (c_mid,) or \
            b2.shape != (c_dec,):
        raise ValueError(f"seg_fwd: shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} b1 {tuple(b1.shape)} w2 "
                         f"{tuple(w2.shape)} b2 {tuple(b2.shape)}")
    _check_widths("seg_fwd", c_in, c_dec)
    w1 = w1.to(x.dtype).contiguous()
    w2 = w2.to(x.dtype).contiguous()
    b1 = b1.float().contiguous()
    b2 = b2.float().contiguous()
    for name, t in (("w1", w1), ("w2", w2), ("b1", b1), ("b2", b2)):
        if t.device != x.device:
            raise ValueError(f"seg_fwd {name} on {t.device}, x on {x.device}")
    d = torch.empty((n, c_dec), dtype=x.dtype, device=x.device)
    lib = _build.library()
    err = lib.probav_seg_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), d.data_ptr(), n, c_in, c_mid, c_dec,
        _stream(x))
    _build.check(err, "seg_fwd")
    LAUNCHES["seg_fwd"] += 1
    return d


def conv_fwd(d, x, wc, bc):
    """d [B,H,W,T,C_dec], x [B,H,W,T,C], wc [3,3,3,C_dec,C], bc [C] ->
    x + bc + SAME 3^3 conv(d) in x's dtype (wc cast to it, bc to float32).

    C_dec and C from 1 to 128, any B, H and W.  The kernel stages runs of
    columns of the volume's rows in shared memory (whole rows where they
    fit) and raises only where one column does not fit: T over 20 in
    float32 at 128 -> 128 channels (over 46 at 64 -> 64, over 99 at the
    flagship's 25 -> 32), over 46 in bf16 at 128 -> 128 (over 189 at
    25 -> 32); csrc/tstack.cu.
    """
    if x.device.type == "cpu":
        return conv_fwd_plain(d, x, wc, bc)
    from probav_tpu_torch.ops import _build
    _check_input("conv_fwd x", x)
    _check_input("conv_fwd d", d, x.dtype)
    b, h, w, t, c_out = x.shape
    c_dec = d.shape[-1]
    if d.shape[:4] != x.shape[:4] or wc.shape != (3, 3, 3, c_dec, c_out) \
            or bc.shape != (c_out,):
        raise ValueError(f"conv_fwd: shapes d {tuple(d.shape)} x "
                         f"{tuple(x.shape)} wc {tuple(wc.shape)} bc "
                         f"{tuple(bc.shape)}")
    _check_widths("conv_fwd", c_out, c_dec)
    wc = wc.to(x.dtype).contiguous()
    bc = bc.float().contiguous()
    for name, tt in (("wc", wc), ("bc", bc), ("d", d)):
        if tt.device != x.device:
            raise ValueError(f"conv_fwd {name} on {tt.device}, x on {x.device}")
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.probav_conv_fwd(
        _DTYPE_CODE[x.dtype], d.data_ptr(), x.data_ptr(), wc.data_ptr(),
        bc.data_ptr(), out.data_ptr(), b, h, w, t, c_dec, c_out, _stream(x))
    _build.check(err, "conv_fwd")
    LAUNCHES["conv_fwd"] += 1
    return out


def blk_bwd(gy, x, d, w1, b1, w2, wc):
    """Backward of one block; the arguments and results of
    ``blk_bwd_plain``.  Weights are cast to x's dtype and b1 to float32,
    as the TPU kernel's caller does (pallas_tstack.py:441-443)."""
    if x.device.type == "cpu":
        return blk_bwd_plain(gy, x, d, w1, b1, w2, wc)
    from probav_tpu_torch.ops import _build
    _check_input("blk_bwd x", x)
    _check_input("blk_bwd gy", gy, x.dtype)
    _check_input("blk_bwd d", d, x.dtype)
    b, h, w, t, c = x.shape
    c_mid, c_dec = w2.shape
    if gy.shape != x.shape or d.shape[:4] != x.shape[:4] or \
            w1.shape != (c, c_mid) or b1.shape != (c_mid,) or \
            d.shape[4] != c_dec or wc.shape != (3, 3, 3, c_dec, c):
        raise ValueError(f"blk_bwd: shapes gy {tuple(gy.shape)} x "
                         f"{tuple(x.shape)} d {tuple(d.shape)} w1 "
                         f"{tuple(w1.shape)} b1 {tuple(b1.shape)} w2 "
                         f"{tuple(w2.shape)} wc {tuple(wc.shape)}")
    _check_widths("blk_bwd", c, c_dec)
    w1 = w1.to(x.dtype).contiguous()
    w2 = w2.to(x.dtype).contiguous()
    b1 = b1.float().contiguous()
    # The conv transpose is the SAME conv of gy with the taps flipped and
    # the channel axes swapped (pallas_tstack._pack_wc_bwd).
    wflip = wc.to(x.dtype).flip(0, 1, 2).transpose(3, 4).contiguous()
    for name, tt in (("w1", w1), ("b1", b1), ("w2", w2), ("wc", wflip)):
        if tt.device != x.device:
            raise ValueError(f"blk_bwd {name} on {tt.device}, x on {x.device}")
    groups = partial_slots(x.device, c, c_dec)
    slot = 27 * c_dec * c + c * c_mid + c_mid * c_dec + c_mid + c_dec + c
    dd = torch.empty(d.shape, dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    part = torch.empty((groups, slot_stride(slot)), dtype=torch.float32,
                       device=x.device)
    out = torch.empty(slot, dtype=torch.float32, device=x.device)
    floats = blk_bwd_scratch(x.dtype, c, c_mid, c_dec, b * h * w * t)
    dxp = torch.empty(floats, dtype=torch.float32, device=x.device) \
        if floats else None
    lib = _build.library()
    err = lib.probav_blk_bwd(
        _DTYPE_CODE[x.dtype], gy.data_ptr(), x.data_ptr(), d.data_ptr(),
        wflip.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        dd.data_ptr(), dx.data_ptr(), part.data_ptr(), out.data_ptr(),
        dxp.data_ptr() if dxp is not None else None, groups, part.shape[1],
        b, h, w, t, c, c_mid, c_dec, _stream(x))
    _build.check(err, "blk_bwd")
    LAUNCHES["blk_bwd"] += 1
    dwc, dw1, dw2, db1, db2, dbc = torch.split(
        out, [27 * c_dec * c, c * c_mid, c_mid * c_dec, c_mid, c_dec, c])
    return (dx, dwc.view(3, 3, 3, c_dec, c), dw1.view(c, c_mid), db1,
            dw2.view(c_mid, c_dec), db2, dbc)


def stack_forward(x, blocks, keep):
    """(out, xs, ds): run the blocks on the kernels; with ``keep``, xs and
    ds hold each block's input x_i and decay output d_i (what the
    backward needs), else they are empty."""
    h = x.contiguous()
    xs, ds = [], []
    for w1, b1, w2, b2, wc, bc in blocks:
        d = seg_fwd(h.reshape(-1, h.shape[-1]), w1, b1, w2, b2)
        d = d.reshape(h.shape[:-1] + (w2.shape[1],))
        if keep:
            xs.append(h)
            ds.append(d)
        h = conv_fwd(d, h, wc, bc)
    return h, xs, ds


class _Stack(torch.autograd.Function):
    """All blocks as one autograd node (pallas_tstack.py:463-504): the
    forward saves x_i and d_i of each block, the backward runs blk_bwd for
    the blocks in reverse order and returns each weight gradient cast to
    that weight's dtype (pallas_tstack.py:498-500), so at bf16 they round
    there before autograd widens them to the float32 parameters."""

    @staticmethod
    def forward(ctx, x, *flat):
        blocks = [flat[i:i + 6] for i in range(0, len(flat), 6)]
        h, xs, ds = stack_forward(x, blocks, keep=True)
        ctx.save_for_backward(*xs, *ds, *flat)
        ctx.nblk = len(blocks)
        return h

    @staticmethod
    def backward(ctx, gy):
        n = ctx.nblk
        saved = ctx.saved_tensors
        xs, ds, flat = saved[:n], saved[n:2 * n], saved[2 * n:]
        gy = gy.to(xs[0].dtype).contiguous()
        grads = [None] * len(flat)
        for i in reversed(range(n)):
            w1, b1, w2, b2, wc, bc = flat[6 * i:6 * i + 6]
            gy, dwc, dw1, db1, dw2, db2, dbc = blk_bwd(
                gy, xs[i], ds[i], w1, b1, w2, wc)
            grads[6 * i:6 * i + 6] = (
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), dwc.to(wc.dtype), dbc.to(bc.dtype))
        return (gy, *grads)


def stack_apply_5d(x5d, blocks):
    """Apply the WDSR-B blocks to x [B, H, W, T, C] (pallas_tstack.py:618).

    blocks: per-block effective params (w1 [C, C_mid], b1, w2 [C_mid,
    C_dec], b2, wc [3,3,3,C_dec,C], bc), already in the compute dtype.
    With grad enabled and any input requiring it, the stack is one
    autograd node whose backward runs ``blk_bwd``; otherwise (serving,
    ``torch.inference_mode``) nothing is saved.
    """
    flat = [t for blk in blocks for t in blk]
    if torch.is_grad_enabled() and (
            x5d.requires_grad or any(t.requires_grad for t in flat)):
        return _Stack.apply(x5d, *flat)
    return stack_forward(x5d, blocks, keep=False)[0]
