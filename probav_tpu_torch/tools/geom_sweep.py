"""The 12-block kernel stack's forward and backward across ``--filters``
widths on one card (port of ``tools/geom_sweep.py``).

    python3 -m probav_tpu_torch.tools.geom_sweep [--filters 16,32,48,64,160] \\
        [--json OUT]

For each N of ``--filters`` and each of ``DTYPES``: 12 blocks of C = N
channels, C_mid = 8N (the cfg's exp_rate) and C_dec = int(0.8 N) (its
decay_rate), on ``BATCH`` patches of 22x22x9 with random weights
(``stack_case``: the seeds of chip_smoke's stack gradient).  N = 32 is the flagship, 64 the
width of the best-scoring model (0.9411).  It prints, for each width:

- the device ms of autograd through the kernel stack
  (``ops/tstack.stack_apply_5d``: seg_fwd and conv_fwd forward, blk_bwd
  backward), CUDA events over ``REPS`` calls back to back;
- the sum of the step's kernel bounds (12 x seg_fwd, conv_fwd and blk_bwd,
  ``tstack_roofline.kernel_costs``) and the share, bound / time;
- the routes the C entries take (``ops/tstack.seg_fwd_route``, and
  ``seg_bwd_route`` and ``wgrad_route`` of ``csrc/blk_bwd.cu``);
- the plain chain's ms (autograd through ``seg_fwd_plain`` and
  ``conv_fwd_plain``), and the worst leaf's norm-wise distance of the
  kernel gradients from the plain chain's.

A width that the kernels refuse (C or C_dec beyond 128: N = 160) prints
``FAIL`` with the refusal, as the JAX sweep does, and the sweep goes on.
The JAX sweep's TPU tile list ``(rows, ch)`` has no counterpart: the CUDA
kernels choose their own tiles.  Prints a JSON line of every width last;
``--json`` also writes it to a file.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

HW, T, BLOCKS = 22, 9, 12
FILTERS = (16, 32, 48, 64, 160)
DTYPES = ("float32", "bfloat16")
BATCH, REPS = 128, 5


def widths(filters: int):
    """(C, C_mid, C_dec) of the N-filter model: exp_rate 8, decay_rate
    0.8 (cfg/p16t9c85r12.cfg)."""
    return filters, 8 * filters, int(0.8 * filters)


def stack_inputs(torch, dev, dtype, n, c, cmid, cdec, seed):
    """(x [n, 22, 22, 9, C], (w1, b1, w2, b2, wc, bc)) in ``dtype``, drawn
    from a generator of ``seed`` on ``dev``: x normal, weights scaled by
    their fan-in, biases 0.1 normal."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale)

    x = rn(n, HW, HW, T, c).to(dtype)
    w1 = rn(c, cmid, scale=c ** -0.5).to(dtype)
    b1 = rn(cmid, scale=0.1).to(dtype)
    w2 = rn(cmid, cdec, scale=cmid ** -0.5).to(dtype)
    b2 = rn(cdec, scale=0.1).to(dtype)
    wc = rn(3, 3, 3, cdec, c, scale=(27 * cdec) ** -0.5).to(dtype)
    bc = rn(c, scale=0.1).to(dtype)
    return x, (w1, b1, w2, b2, wc, bc)


def stack_case(torch, dev, dtype, c, cmid, cdec, batch):
    """(x, blocks, gy) of a ``BLOCKS``-block stack: block i's weights from
    seed 10 + i, x from seed 9 and the cotangent gy from seed 8, x and the
    weights requiring grad."""
    blocks = []
    for i in range(BLOCKS):
        _, blk = stack_inputs(torch, dev, dtype, 1, c, cmid, cdec,
                              seed=10 + i)
        blocks.append(tuple(t.requires_grad_() for t in blk))
    x, _ = stack_inputs(torch, dev, dtype, batch, c, cmid, cdec, seed=9)
    x.requires_grad_()
    gy = torch.randn(x.shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(8)).to(dtype)
    return x, blocks, gy


def leaves(x, blocks):
    return [x] + [t for blk in blocks for t in blk]


def kernel_grads(torch, x, blocks, gy):
    """Gradients of every leaf through the kernel stack."""
    from probav_tpu_torch.ops import tstack as ts
    return torch.autograd.grad(ts.stack_apply_5d(x, blocks),
                               leaves(x, blocks), gy)


def plain_grads(torch, x, blocks, gy):
    """Gradients of every leaf through the plain twins, with their own
    forward."""
    from probav_tpu_torch.ops import tstack as ts
    h = x
    for w1, b1, w2, b2, wc, bc in blocks:
        d = ts.seg_fwd_plain(h.reshape(-1, h.shape[-1]), w1, b1, w2, b2)
        h = ts.conv_fwd_plain(d.reshape(h.shape[:-1] + (w2.shape[1],)), h,
                              wc, bc)
    return torch.autograd.grad(h, leaves(x, blocks), gy)


def rel_l2(got, ref):
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm())


def refusal(filters):
    """Why the kernels refuse the N-filter width
    (``ops/tstack.t_tier_refusal``), or None."""
    from probav_tpu_torch.ops import tstack as ts
    c, cmid, cdec = widths(filters)
    why = ts.t_tier_refusal(c, cdec)
    return f"the kernels refuse {c}/{cmid}/{cdec}: {why}" if why else None


def run_width(torch, dev, dtype, filters, batch=BATCH, reps=REPS):
    """The sweep's row of one width and dtype (module docstring); raises
    ValueError, before any work, where the kernels refuse the width
    (``refusal``)."""
    from probav_tpu_torch.ops import tstack as ts
    from probav_tpu_torch.tools.tstack_roofline import (back_to_back,
                                                        kernel_costs)

    c, cmid, cdec = widths(filters)
    why = refusal(filters)
    if why:
        raise ValueError(why)
    dn = str(dtype).split(".")[1]
    x, blocks, gy = stack_case(torch, dev, dtype, c, cmid, cdec, batch)
    got = kernel_grads(torch, x, blocks, gy)
    kms, = back_to_back(torch, lambda: kernel_grads(torch, x, blocks, gy),
                        n=reps)
    plain = plain_grads(torch, x, blocks, gy)
    pms, = back_to_back(torch, lambda: plain_grads(torch, x, blocks, gy),
                        n=reps)
    names = ["x"] + [f"{i}.{k}" for i in range(len(blocks))
                     for k in ("w1", "b1", "w2", "b2", "wc", "bc")]
    errs = {k: rel_l2(a, b) for k, a, b in zip(names, got, plain)}
    worst = max(errs, key=lambda k: errs[k])
    n = batch * HW * HW * T
    bounds = {k: kernel_costs(k, n, c, cmid, cdec, dn)["bound_ms"]
              for k in ("seg_fwd", "conv_fwd", "blk_bwd")}
    total = len(blocks) * sum(bounds.values())
    row = dict(filters=filters, c=c, cmid=cmid, cdec=cdec, dtype=dn,
               batch=batch, blocks=len(blocks), kernel_ms=kms, plain_ms=pms,
               bound_ms=total, share=total / kms, bounds_per_launch=bounds,
               routes=dict(seg_fwd=ts.seg_fwd_route(dtype, c, cmid, cdec),
                           seg_bwd=ts.seg_bwd_route(dtype, c, cmid, cdec),
                           wgrad=ts.wgrad_route(dtype, c, cdec, HW, T)),
               worst_grad=(worst, errs[worst]))
    return row


def row_line(row):
    return (f"filters={row['filters']} ({row['c']}/{row['cmid']}/"
            f"{row['cdec']}) {row['dtype']}: kernel stack fwd+bwd "
            f"{row['kernel_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
            f"(share {row['share']:.3f}), plain chain {row['plain_ms']:.3f} "
            f"ms; routes {row['routes']}; worst gradient ||k-p||/||p|| "
            f"{row['worst_grad'][0]} {row['worst_grad'][1]:.3e}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--filters", default=",".join(map(str, FILTERS)))
    p.add_argument("--json")
    opt = p.parse_args(argv)
    import torch

    from probav_tpu_torch.tools.tstack_roofline import card_line
    if not torch.cuda.is_available():
        raise SystemExit("geom_sweep needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    rows = []
    for filters in map(int, opt.filters.split(",")):
        for dn in DTYPES:
            why = refusal(filters)
            if why:
                c, cmid, cdec = widths(filters)
                print(f"filters={filters} ({c}/{cmid}/{cdec}) {dn}: FAIL "
                      f"{why}", flush=True)
                rows.append(dict(filters=filters, dtype=dn, refused=why))
                continue
            row = run_width(torch, dev, getattr(torch, dn), filters)
            torch.cuda.empty_cache()
            print(f"{row_line(row)} [{card}]", flush=True)
            rows.append(row)
    line = json.dumps(dict(card=card, kind=torch.cuda.get_device_name(0),
                           rows=rows))
    print(line, flush=True)
    if opt.json:
        with open(opt.json, "w") as f:
            f.write(line + "\n")
    return rows


if __name__ == "__main__":
    main()
