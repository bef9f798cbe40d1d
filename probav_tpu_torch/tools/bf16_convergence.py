"""bf16-vs-f32 convergence gate on a synthetic multi-frame SR task (port
of ``tools/bf16_convergence.py``, which it does not import).

    python3 -m probav_tpu_torch.tools.bf16_convergence [steps] [--fused]
        [--filters N] [--isolate-kernel] [--json PATH]
        [--device {cuda,cpu}]

Trains the flagship topology (12 blocks, ``--filters`` wide, default 32;
64 is the reference's best-scoring 64/512/51 model) from one seeded
init on one synthetic dataset, once in float32 and once with bfloat16
compute (parameters and loss in float32), and compares the final
validation cPSNR: the gate passes within 0.1 dB.  The task is learnable
and SR-shaped: LR frames are sub-shifted noisy copies of a base field,
HR is the 3x upsampled base.

Arms, each ``steps`` rounded up to whole epochs (400 -> 402: 480
training patches, 3 steps of 128 an epoch), with the device-resident
loop (``ModelTrainer.fit_device``, one readback an epoch):
- f32 on the plain ``"off"`` stack tier, cuDNN's and cuBLAS's TF32 off;
- bf16 on the kernel tier ``"t"`` with ``--fused``, else on ``"off"``;
- with ``--fused --isolate-kernel``, bf16 on ``"off"``, which separates
  the kernels' drift (``kernel_delta_db``) from the dtype's.

Prints one line a arm (its dtype and tier), then one JSON object with the
JAX tool's keys (``f32``, ``bf16``, ``delta_db``, ``pass_0.1db``,
``filters``; ``bf16_plain`` and ``kernel_delta_db`` with a third arm),
``"tf32": false`` and the card's ``nvidia-smi`` name and power limit
(``card``; null on the CPU); ``--json`` writes it to a file too.

Where it differs from the JAX tool:
- it exits 1 when the gate fails (``delta_db``, or ``kernel_delta_db``
  where there is one, above 0.1 dB); the JAX tool exits 0 either way;
- it starts no watchdog thread (the JAX tool starts one when imported);
- the tiers are named: the port's ``WDSRConv3D`` defaults to ``"t"``, and
  its ``fused_stack=True`` is ``"t"`` where the JAX package's is flat;
- the trainer gets the weighted L1 (``losses.weighted("l1")``), so a
  ragged validation batch that the ``"t"`` tier pads with weight-0 rows
  leaves the loss exact, as it leaves the cPSNR; the JAX tool sent that
  batch down its plain path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from probav_tpu_torch.data.loader import Batcher
from probav_tpu_torch.models.wdsr import WDSRConv3D
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
from probav_tpu_torch.train.optim import build_optimizer
from probav_tpu_torch.train.trainer import ModelTrainer

GATE_DB = 0.1
SEED = 11


def make_dataset(rng, n_scenes=600, patch=16, shift=6, t=9, scale=3,
                 mean=8075.2045, std=3160.7272):
    """Synthetic multi-frame SR patches in the flagship geometry.

    LR [N, p+shift, p+shift, T, 1]; HR [N, 3p, 3p, 1]; mask [N, 3p, 3p, 1].
    """
    lr_size = patch + shift
    hr_size = patch * scale
    big = lr_size + 4
    lrs = np.empty((n_scenes, lr_size, lr_size, t, 1), np.float32)
    hrs = np.empty((n_scenes, hr_size, hr_size, 1), np.float32)
    for s in range(n_scenes):
        field = rng.uniform(0, 1, (big, big))
        k = np.ones((3, 3)) / 9.0
        pad = np.pad(field, 1, mode="wrap")
        field = sum(pad[i:i + big, j:j + big] * k[i, j]
                    for i in range(3) for j in range(3))
        field = (field - field.min()) / (field.max() - field.min() + 1e-9)
        field = field * 4 * std / 3 + mean - std / 2
        for f in range(t):
            dy, dx = rng.integers(0, 3, size=2)
            frame = field[dy:dy + lr_size, dx:dx + lr_size]
            lrs[s, :, :, f, 0] = frame + rng.normal(0, std / 60, frame.shape)
        base = field[1:1 + lr_size, 1:1 + lr_size]
        crop = base[shift // 2: shift // 2 + patch,
                    shift // 2: shift // 2 + patch]
        hrs[s, :, :, 0] = np.kron(crop, np.ones((scale, scale)))
    masks = (rng.uniform(size=hrs.shape) > 0.05).astype(np.float32)
    return lrs, np.clip(hrs, 0, 65535), masks


def net(num_filters=32, num_res_blocks=12) -> dict:
    """The JAX tool's WDSRConv3D arguments."""
    return dict(scale=3, num_filters=num_filters,
                num_res_blocks=num_res_blocks, exp_rate=8, decay_rate=0.8,
                num_img_lr=9, patch_size_lr=16, mean=8075.2045,
                std=3160.7272)


def seeded_init(num_filters=32, seed=SEED, num_res_blocks=12) -> dict:
    """The model's init from ``torch.Generator`` seed ``seed``, as a
    state_dict on the CPU (float32 whatever the arm's compute dtype)."""
    model = WDSRConv3D(**net(num_filters, num_res_blocks), fused_stack="off",
                       generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_one(dtype_name, data, steps, seed=SEED, fused_stack="off",
            num_filters=32, *, device="cuda", init=None, num_res_blocks=12,
            batch=128) -> dict:
    """Train one arm from ``init`` (``seeded_init(num_filters, seed)``
    where None) for ``steps`` rounded up to whole epochs; the first fifth
    of ``data`` is the validation set.  Returns the JAX tool's keys:
    dtype, steps, val_loss, val_cpsnr and seconds (of ``fit_device``,
    its final validation included)."""
    lrs, hrs, masks = data
    n_val = len(lrs) // 5
    xt, xv = lrs[n_val:], lrs[:n_val]
    yt, yv = hrs[n_val:], hrs[:n_val]
    mt, mv = masks[n_val:], masks[:n_val]

    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    model = WDSRConv3D(**net(num_filters, num_res_blocks), dtype=dtype,
                       fused_stack=fused_stack)
    model.load_state_dict(init if init is not None else
                          seeded_init(num_filters, seed, num_res_blocks))
    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1))
    with tempfile.TemporaryDirectory(prefix=f"bf16conv_{dtype_name}_") as tmp:
        trainer = ModelTrainer(model, losses.l1, losses.cpsnr,
                               build_optimizer("nadam", 5e-4),
                               os.path.join(tmp, "ckpt"),
                               os.path.join(tmp, "logs"),
                               eval_step=10 ** 9, log_every=10 ** 9,
                               loss_weighted_fn=losses.weighted("l1"),
                               device=device)
        trainer.init_state()
        steps_per_epoch = max(1, len(xt) // batch)
        epochs = max(1, -(-steps // steps_per_epoch))
        t0 = time.perf_counter()
        trainer.fit_device(xt, [yt, mt], batch_size=batch, epochs=epochs,
                           val_data=[xv, yv, mv], val_steps=10 ** 9,
                           save_best_only=False, seed=seed)
        dt = time.perf_counter() - t0
        vb = Batcher((xv, yv, mv), batch, seed=1, drop_remainder=False)
        val_loss, val_psnr = trainer.evaluate(vb, val_steps=10 ** 9)
        trainer.logger_.close()
    print(f"[{dtype_name} {model.fused_stack}] steps={trainer.step} "
          f"val_loss={val_loss:.4f} val_cPSNR={val_psnr:.4f} dB "
          f"({dt:.1f}s)", flush=True)
    return {"dtype": dtype_name, "steps": int(trainer.step),
            "val_loss": float(val_loss), "val_cpsnr": float(val_psnr),
            "seconds": round(dt, 1)}


def gate(f32: dict, bf16: dict, filters: int,
         bf16_plain: dict = None) -> dict:
    """The JAX tool's result object from its arms' results."""
    delta = abs(f32["val_cpsnr"] - bf16["val_cpsnr"])
    result = {"f32": f32, "bf16": bf16, "delta_db": round(delta, 4),
              "pass_0.1db": delta <= GATE_DB, "filters": filters}
    if bf16_plain is not None:
        result["bf16_plain"] = bf16_plain
        result["kernel_delta_db"] = round(
            abs(bf16_plain["val_cpsnr"] - bf16["val_cpsnr"]), 4)
    return result


def passed(result: dict) -> bool:
    """Whether both drifts of ``gate``'s result are within GATE_DB."""
    return result["pass_0.1db"] and \
        result.get("kernel_delta_db", 0.0) <= GATE_DB


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("steps", nargs="?", type=int, default=400)
    p.add_argument("--fused", action="store_true",
                   help="the bf16 arm on the kernel tier 't'")
    p.add_argument("--filters", type=int, default=32)
    p.add_argument("--isolate-kernel", action="store_true",
                   help="with --fused, a third arm: bf16 on 'off'")
    p.add_argument("--json", default=None, help="also write the result here")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    opt = parse_args(argv)
    if opt.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("building dataset...", flush=True)
    data = make_dataset(np.random.default_rng(123))
    init = seeded_init(opt.filters)

    def arm(dtype_name, tier):
        return run_one(dtype_name, data, opt.steps, fused_stack=tier,
                       num_filters=opt.filters, device=opt.device, init=init)

    f32 = arm("f32", "off")
    bf16 = arm("bf16", "t" if opt.fused else "off")
    plain = arm("bf16", "off") if opt.fused and opt.isolate_kernel else None
    result = gate(f32, bf16, opt.filters, plain)
    result["tf32"] = False
    if opt.device == "cuda":
        from probav_tpu_torch.tools.tstack_roofline import card_line
        result["card"] = card_line()
    else:
        result["card"] = None
    print(json.dumps(result), flush=True)
    if opt.json:
        with open(opt.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if passed(result) else 1


if __name__ == "__main__":
    sys.exit(main())
