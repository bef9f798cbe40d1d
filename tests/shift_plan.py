"""``plan()`` of ``probav_tpu_torch/csrc/shift_loss.cu`` restated in Python,
for the tests only: the CPU emulation of the shift-table kernels walks the
plan it gives (tests/test_torch_shift_table_bands.py), and a card test
holds it to the C entry's own plan (``shift_table.card_plan``,
tests/test_torch_kernels.py).  The package asks the C entry and keeps no
copy.  Imports neither JAX nor the JAX package.
"""

# The kernels' tiling: shift rows of a warp's group, crop rows of an item,
# warps of a block; a block's opt-in shared memory on an H100.
SR, QR, MAX_WARPS = 7, 8, 16
SMEM_OPTIN = 232_448
INT_MAX = 2 ** 31 - 1


def launch_plan(b: int, h: int, w: int, border: int, nb: int,
                optin: int = SMEM_OPTIN):
    """The launch of [b, h, w] planes in clusters of (up to) ``nb``
    blocks, with ``optin`` bytes of shared memory a block: blocks a
    sample's cluster (``nb``), crop rows a band (``R``), crop rows and
    columns a tile (``RT``, ``CT``), warps a block (``NW``), parts of the
    items (``P``), dynamic shared memory bytes (``smem``); None where the
    kernels refuse.  The launchers pick ``nb`` from the card's count of
    clusters it holds at once (``plan_for``)."""
    if (b < 1 or border < 0 or h <= 2 * border or w <= 2 * border or
            h * w > INT_MAX):
        return None
    n = 2 * border + 1
    s, ch, cw, halo = n * n, h - 2 * border, w - 2 * border, 2 * border
    g = -(-n // SR)
    p = max(1, MAX_WARPS // (n * g))
    nw = min(n * g * p, MAX_WARPS)
    nb = min(nb, ch)
    r = -(-ch // nb)
    nb = -(-ch // r)
    fixed = ((8 + 3 * p) * s + 3) & ~3
    avail = optin // 4 - fixed
    if nb * b > INT_MAX or avail <= 0:
        return None
    rows_fit = lambda cols: avail // (2 * ((cols + halo) | 1)) - halo
    ct = cw
    rows = rows_fit(ct)
    while rows < min(r, QR) and ct > 1:
        ct = -(-ct // 2)
        rows = rows_fit(ct)
    if rows < 1:
        return None
    rt = min(r, rows)
    stride = (ct + halo) | 1
    return dict(nb=nb, R=r, RT=rt, CT=ct, NW=nw, P=p,
                smem=4 * (fixed + 2 * (rt + halo) * stride))
