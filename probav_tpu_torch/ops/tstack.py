"""The WDSR-B block stack forward, on hand-written CUDA kernels.

Port of the forward half of ``probav_tpu/ops/pallas_tstack.py``.  Each
block is two kernels (``csrc/tstack.cu``):

- ``seg_fwd``:  x [N, C] -> d [N, C_dec], the 1x1x1 expand C -> C_mid, relu
  and 1x1x1 decay C_mid -> C_dec, without storing the wide activation
  (replaces ``pallas_tstack.seg_fwd``);
- ``conv_fwd``: the 3^3 SAME conv of d plus bias plus the residual x
  (replaces ``pallas_tstack.conv_fwd``).

float32 runs on the CUDA cores with exact float32 products; bf16 runs on
the tensor cores (``mma.sync``) with float32 accumulation.  Both round
where the TPU kernels round.

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
LAUNCHES = {"seg_fwd": 0, "conv_fwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


# ---------------------------------------------------------------------- #
# kernel wrappers                                                         #
# ---------------------------------------------------------------------- #

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
    caller does (pallas_tstack.py:265-266).
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
    if c_in > 64 or c_dec > 64:
        raise ValueError(f"seg_fwd: channels up to 64, got {c_in}/{c_dec}")
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
    x + bc + SAME 3^3 conv(d) in x's dtype (wc cast to it, bc to float32)."""
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
    if c_out > 64:
        raise ValueError(f"conv_fwd: C_out up to 64, got {c_out}")
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


def stack_apply_5d(x5d, blocks):
    """Apply the WDSR-B blocks to x [B, H, W, T, C] (pallas_tstack.py:618).

    blocks: per-block effective params (w1 [C, C_mid], b1, w2 [C_mid,
    C_dec], b2, wc [3,3,3,C_dec,C], bc), already in the compute dtype.
    """
    h = x5d.contiguous()
    for w1, b1, w2, b2, wc, bc in blocks:
        d = seg_fwd(h.reshape(-1, h.shape[-1]), w1, b1, w2, b2)
        h = conv_fwd(d.reshape(h.shape[:-1] + (w2.shape[1],)), h, wc, bc)
    return h
