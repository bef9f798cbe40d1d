"""The 49-shift masked L1 / L2 loss table on hand-written CUDA kernels.

Port of ``probav_tpu/ops/pallas_shift_loss.py``.  For every sample and every
shift (i, j) of the ground truth within +-border, over the centre window:

    L_s     = (1/N_s) * sum |hr_s - (pred + b_s) * m_s|      (or squared)
    b_s     = (sum hr_s - sum pred*m_s) / N_s,   N_s = sum m_s

and its analytic gradient with respect to the prediction (the truth and
the mask are data and get none):

    dL_s/dp = (1/N_s) * (-phi * m_s + m_s * sum(phi * m_s) / N_s),

phi = sign(r) for L1 and 2r for L2; the second term is the bias's.  Two
kernels of ``csrc/shift_loss.cu``, float32 only as on the TPU:

- ``shift_table_fwd``: [B, H, W] planes -> the [B, S] table (replaces
  ``_pallas_table_2d``);
- ``shift_table_bwd``: the planes and the table's cotangent [B, S] ->
  d/dpred [B, H, W], zero on the border (replaces
  ``_pallas_table_bwd_2d``).

The TPU's 8-sample batch padding is not ported: any B is taken.  Dispatch
as in ``ops/tstack.py``: CPU tensors run the ``*_plain`` twins (the
formulas above, vectorised over the shifts; the backward is the formula,
not autograd of the forward); CUDA tensors launch the kernel, count it in
``LAUNCHES``, or raise.  One launch a call: a thread-block cluster per
sample splits the crop rows into bands, and each block stages its band's
rows (in tiles where a band does not fit) in shared memory
(``card_plan``), so every plane that ``supports`` lets
through launches, a 384x384 scene's among them, up to the int32 index
limit of a plane.  Only a border whose per-shift sums leave no shared
memory for one tile row (33 and beyond on an H100) is refused: a
``ValueError`` before any launch, never the plain twins in the kernel's
place.
"""

from __future__ import annotations

import torch

from probav_tpu_torch.ops.tstack import _check_input, _stream

# Kernel launches since the counts were last reset (plain runs not counted).
LAUNCHES = {"shift_table_fwd": 0, "shift_table_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supports(hr: torch.Tensor, border: int) -> bool:
    """The kernels cover grayscale square patches with full shift
    coverage (``pallas_shift_loss.supports``)."""
    return (hr.dim() == 4 and hr.shape[-1] == 1 and
            hr.shape[1] == hr.shape[2] and hr.shape[1] > 2 * border)


def card_plan(b: int, h: int, w: int, border: int):
    """The launch plan of [b, h, w] planes as the C entry computes it on
    this card for the forward L1 kernel (``plan_for`` in
    ``csrc/shift_loss.cu``), None where it refuses: blocks a sample's
    cluster (``nb``), crop rows a band (``R``), crop rows and columns a
    tile (``RT``, ``CT``), warps a block (``NW``), parts of the items
    (``P``), dynamic shared memory bytes a block (``smem``), and
    ``clusters``: how many of its clusters the card holds at once."""
    import ctypes

    from probav_tpu_torch.ops import _build
    out = (ctypes.c_int * 8)()
    err = _build.library().probav_shift_table_plan(b, h, w, border, out)
    if err == _REFUSED:
        return None
    _build.check(err, "shift_table plan")
    return dict(zip(("nb", "R", "RT", "CT", "NW", "P", "smem", "clusters"),
                    out))


def _windows(hr2, m2, p2, border):
    """(hr_s, m_s [B, S, ch, cw], p_c [B, 1, ch, cw], total, bias [B, S])
    with the kernel's order of terms for the bias."""
    b, h, w = hr2.shape
    ch, cw = h - 2 * border, w - 2 * border
    win = lambda a: a.unfold(1, ch, 1).unfold(2, cw, 1).reshape(b, -1, ch, cw)
    hr_s, m_s = win(hr2), win(m2)
    p_c = p2[:, None, border:border + ch, border:border + cw]
    total = m_s.sum(dim=(2, 3))
    bias = (hr_s.sum(dim=(2, 3)) - (p_c * m_s).sum(dim=(2, 3))) / total
    return hr_s, m_s, p_c, total, bias


def shift_table_fwd_plain(hr2, m2, p2, border: int, squared: bool):
    """float32 [B, H, W] planes -> the [B, S] table."""
    hr_s, m_s, p_c, total, bias = _windows(hr2, m2, p2, border)
    r = hr_s - (p_c + bias[..., None, None]) * m_s
    r = r.square() if squared else r.abs()
    return r.sum(dim=(2, 3)) / total


def shift_table_bwd_plain(hr2, m2, p2, g, border: int, squared: bool):
    """The planes and g [B, S] -> d(sum g * table)/dp [B, H, W]."""
    hr_s, m_s, p_c, total, bias = _windows(hr2, m2, p2, border)
    r = hr_s - (p_c + bias[..., None, None]) * m_s
    phi = 2.0 * r if squared else torch.sign(r)
    corr = ((phi * m_s).sum(dim=(2, 3)) / total)[..., None, None]
    term = (-phi * m_s + m_s * corr) / total[..., None, None]
    acc = (g[..., None, None] * term).sum(dim=1)
    dp = torch.zeros_like(p2)
    ch, cw = acc.shape[1:]
    dp[:, border:border + ch, border:border + cw] = acc
    return dp


def _check_planes(name, *planes):
    for t in planes:
        _check_input(name, t, torch.float32)
        if t.shape != planes[0].shape or t.device != planes[0].device:
            raise ValueError(f"{name}: planes {[tuple(p.shape) for p in planes]}"
                             f" on {[str(p.device) for p in planes]}")


# What the C entries return, before any launch, for planes their plan()
# (csrc/shift_loss.cu) refuses: REFUSED, a code apart from CUDA's errors.
_REFUSED = -1


def _check_launch(err: int, name: str, p2, border: int) -> None:
    from probav_tpu_torch.ops import _build
    if err == _REFUSED:
        raise ValueError(
            f"{name}: the kernel refuses planes {list(p2.shape)} at border "
            f"{border}: a plane beyond the int32 index limit, or per-shift "
            f"sums that leave one block's shared memory no room for a tile "
            f"row (plan() in csrc/shift_loss.cu); take the "
            f"plain path (use_kernel=False) for them")
    _build.check(err, name)


def shift_table_fwd(hr2, m2, p2, border: int, squared: bool):
    """The arguments and result of ``shift_table_fwd_plain``."""
    if p2.device.type == "cpu":
        return shift_table_fwd_plain(hr2, m2, p2, border, squared)
    from probav_tpu_torch.ops import _build
    _check_planes("shift_table_fwd", hr2, m2, p2)
    b, h, w = p2.shape
    out = torch.empty((b, (2 * border + 1) ** 2), dtype=torch.float32,
                      device=p2.device)
    err = _build.library().probav_shift_table_fwd(
        hr2.data_ptr(), m2.data_ptr(), p2.data_ptr(), out.data_ptr(), b, h, w,
        border, int(squared), _stream(p2))
    _check_launch(err, "shift_table_fwd", p2, border)
    LAUNCHES["shift_table_fwd"] += 1
    return out


def shift_table_bwd(hr2, m2, p2, g, border: int, squared: bool):
    """The arguments and result of ``shift_table_bwd_plain``."""
    if p2.device.type == "cpu":
        return shift_table_bwd_plain(hr2, m2, p2, g, border, squared)
    from probav_tpu_torch.ops import _build
    _check_planes("shift_table_bwd", hr2, m2, p2)
    _check_input("shift_table_bwd g", g, torch.float32)
    b, h, w = p2.shape
    if g.shape != (b, (2 * border + 1) ** 2) or g.device != p2.device:
        raise ValueError(f"shift_table_bwd: g {tuple(g.shape)} on "
                         f"{g.device}, planes {tuple(p2.shape)}")
    dp = torch.empty_like(p2)
    err = _build.library().probav_shift_table_bwd(
        hr2.data_ptr(), m2.data_ptr(), p2.data_ptr(), g.data_ptr(),
        dp.data_ptr(), b, h, w, border, int(squared), _stream(p2))
    _check_launch(err, "shift_table_bwd", p2, border)
    LAUNCHES["shift_table_bwd"] += 1
    return dp


class _Table(torch.autograd.Function):
    """The table with ``shift_table_bwd`` as its backward; hr and the mask
    get no gradient (``pallas_shift_loss._table``)."""

    @staticmethod
    def forward(ctx, squared, border, hr2, m2, p2):
        ctx.save_for_backward(hr2, m2, p2)
        ctx.squared, ctx.border = squared, border
        return shift_table_fwd(hr2, m2, p2, border, squared)

    @staticmethod
    def backward(ctx, g):
        hr2, m2, p2 = ctx.saved_tensors
        dp = shift_table_bwd(hr2, m2, p2, g.float().contiguous(),
                             ctx.border, ctx.squared)
        return None, None, None, None, dp


def per_shift_table(kind: str, hr, mask, pred, border: int = 3):
    """[B, H, W, 1] inputs -> the [S, B] per-shift L1 or L2 table."""
    plane = lambda a: a.float()[..., 0].contiguous()
    return _Table.apply(kind == "l2", border, plane(hr), plane(mask),
                        plane(pred)).t()
