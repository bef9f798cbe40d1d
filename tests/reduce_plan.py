"""``reduce_plan()`` of ``probav_tpu_torch/csrc/blk_bwd.cu`` restated in
Python, for the tests only: the numpy twin of ``reduce_partials_kernel``
walks the plan it gives (tests/test_torch_reduce_partials_layout.py, which
also holds these constants to the source's), and a card test holds it to
the C entry's own plan (``tstack.reduce_plan``, tests/test_torch_kernels.py).
The package asks the C entry and keeps no copy.  Imports neither JAX nor
the JAX package.
"""

# Floats a column tile (32 lanes x float4), loads a thread issues before
# its adds, warps a block, blocks a cluster, warps an SM the plan aims at,
# fewest segments a tile and slots a warp where G allows.
RED_TILE, RED_AHEAD, RED_MAX_WARPS, RED_MAX_RANKS = 128, 8, 8, 8
RED_FILL, RED_MIN_WARPS, RED_MIN_SEG = 32, 4, 4
H100_SMS = 132


def plan(groups: int, length: int, sms: int = H100_SMS) -> tuple:
    """(column tiles, blocks a cluster, warps a block) of the reduce of
    ``groups`` slots of ``length`` floats on a card of ``sms`` SMs."""
    tiles = -(-length // RED_TILE)
    fill = -(-(sms * RED_FILL) // tiles)
    segs = min(max(fill, RED_MIN_WARPS), max(1, groups // RED_MIN_SEG))
    segs = min(segs, RED_MAX_WARPS * RED_MAX_RANKS)
    ranks = -(-segs // RED_MAX_WARPS)
    return tiles, ranks, segs // ranks
