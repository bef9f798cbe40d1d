"""Full-scale rehearsal of the port: the four CLIs as subprocesses over a
synthetic raw tree at the ESA geometry and scene counts.

    python3 -m probav_tpu_torch.tools.full_rehearsal [--workdir DIR] \\
        [--epochs 100] [--scale 1.0] [--skip-gen] [--skip-preprocess] \\
        [--skip-train] [--reg-diff] [--fused {off,t}] [--device cuda] \\
        [--tiny-net]

Writes a raw PROBA-V tree (128x128 16-bit LR frames and QM masks, ragged
9-19 frames a scene, 384x384 HR and SM) with the ESA scene counts (RED
594 train and 146 test scenes, NIR 712 and 144; ``max(2, round(n *
scale))`` at ``--scale``), then runs, each as its own process and in this
order:

1. ``python3 -m probav_tpu_torch.preprocess`` for NIR, then RED
   (registration with the torch backend on ``--device``);
2. ``python3 -m probav_tpu_torch.train --band BOTH --eval-step 2000
   --fused-stack <--fused>``, on the card with ``--bf16 --device-data``;
3. ``python3 -m probav_tpu_torch.serve`` with ``--totest TEST`` for each
   band, then ``--totest TRAIN`` for each band (on the card ``--bf16``;
   ``--plain`` when ``--fused off``);
4. ``python3 -m probav_tpu_torch.evaluate`` on the TRAIN outputs, with a
   synthetic ``norm.csv`` (NIR ids start at the RED train count) and
   ``--red-count`` that count.

For each stage ``<workdir>/rehearsal_report.json`` gets the wall time,
the peak RSS (the child's VmHWM, polled every 0.5 s; the most VmRSS
read where /proc has no VmHWM, named in ``rss_field``), the exit code and,
on the card, the peak device memory: the most that ``nvidia-smi
--query-gpu=memory.used`` reads while the stage runs, polled every 0.5 s,
less what it read before the stage started (null with ``--device cpu``;
nvidia-smi's per-process rows can carry pids of another namespace than
the child's, so the card's total is read instead).  The report is
written after every stage; a later run at the same ``--scale`` keeps the
earlier steps.  A failed stage names itself under ``failed`` and the tool
exits non-zero.

``--reg-diff`` re-runs NIR stages 1 and 2 into a second output tree with
``--reg-backend numpy`` (float64 on the host; the main run registers
with torch, float32 on ``--device``) and compares the SHA-256 digests of
``TRAINimgLR_NIR.npy``, ``TRAINimgHR_NIR.npy`` and ``TESTimgLR_NIR.npy``,
with the number of scenes that differ where a digest does.

The cfg is the flagship's (``cfg/p16t9c85r12.cfg``'s values) with
``epochs`` overridden; ``--tiny-net`` swaps in a 4-filter, 1-block net at
batch 4 for a smoke run on the CPU.  Each (band, split) tree has a fixed
seed (``SEEDS``, in the report), so a tree is the same in every run.
The kernels build once per source hash into ``probav_tpu_torch/_build/``,
which every stage shares; ``kernel_build`` in the report names the stage
that built them and that stage's seconds.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np

from probav_tpu_torch.config import Config
from probav_tpu_torch.ops import _build
from probav_tpu_torch.utils.png import write_png

REPO = Path(__file__).resolve().parents[2]

CFG_TEMPLATE = """
[Directories]
raw_data={raw}
preprocessing_out={out}
model_out={out}/modelInfo
train_out={out}/trainout
test_out={out}/testout

[Train]
batch_size=128
epochs=100
learning_rate=0.0005
optimizer=nadam
loss=l1
split=0.2

[Net]
num_res_blocks=12
num_low_res_imgs=9
scale=3
num_filters=32
kernel_size=3
exp_rate=8
decay_rate=0.8
is_grayscale=1

[Preprocessing]
max_shift=6
patch_size=16
patch_stride=16
num_low_res_imgs_pre=9
low_res_patch_thresholds=0.85
low_res_threshold=0.3
high_res_threshold=0.85
num_low_res_permute=0
to_flip=0
to_rotate=0
ckpt=1,2,3,4,5
"""
TINY_NET = (("num_filters=32", "num_filters=4"),
            ("num_res_blocks=12", "num_res_blocks=1"),
            ("batch_size=128", "batch_size=4"),
            ("exp_rate=8", "exp_rate=2"))

LR = 128
SCALE = 3
COUNTS = {  # (band, split) -> scene count at --scale 1.0
    ("RED", "train"): 594, ("NIR", "train"): 712,
    ("RED", "test"): 146, ("NIR", "test"): 144,
}
# The dataset's ragged frame counts: most scenes have 9-13 frames, a tail
# reaches 19.
FRAME_CYCLE = (9, 9, 11, 13, 9, 13, 19, 9, 11, 9)
SEEDS = {key: zlib.crc32(f"{key[0]}/{key[1]}".encode()) % 2 ** 31
         for key in COUNTS}
REG_DIFF_FILES = ("TRAINimgLR_NIR.npy", "TRAINimgHR_NIR.npy",
                  "TESTimgLR_NIR.npy")
POLL_S = 0.5


def _smooth_field(rng, size):
    x = rng.uniform(0, 1, (size, size)).astype(np.float64)
    k = np.ones((3, 3)) / 9.0
    for _ in range(2):
        pad = np.pad(x, 1, mode="wrap")
        x = sum(pad[i:i + size, j:j + size] * k[i, j]
                for i in range(3) for j in range(3))
    x = (x - x.min()) / (x.max() - x.min() + 1e-9)
    return (x * 40000 + 5000).astype(np.uint16)


def make_band_tree(root, band, split, n_scenes, seed, progress_every=100):
    """``n_scenes`` scenes of ``<root>/<split>/<band>``: integer-shifted
    noisy copies of a smooth field, every third frame from the second with
    a 24^2 block occluded, HR the field upscaled 3x (train only).  A scene
    whose ``LR000.png`` exists is skipped."""
    rng = np.random.default_rng(seed)
    with_hr = split == "train"
    t0 = time.perf_counter()
    for s in range(n_scenes):
        d = os.path.join(root, split, band, f"imgset{s:04d}")
        if os.path.exists(os.path.join(d, "LR000.png")):
            continue
        os.makedirs(d, exist_ok=True)
        base = _smooth_field(rng, LR)
        for f in range(FRAME_CYCLE[s % len(FRAME_CYCLE)]):
            dy, dx = rng.integers(-3, 4, size=2)
            frame = np.roll(base, (dy, dx), axis=(0, 1))
            noise = rng.normal(0, 50, frame.shape)
            img = np.clip(frame.astype(np.int64) + noise, 0, 65535)
            write_png(os.path.join(d, f"LR{f:03d}.png"),
                      img.astype(np.uint16))
            qm = np.full(frame.shape, 255, np.uint16)
            if f % 3 == 1:
                y0, x0 = rng.integers(0, LR - 24, size=2)
                qm[y0:y0 + 24, x0:x0 + 24] = 0
            write_png(os.path.join(d, f"QM{f:03d}.png"), qm)
        if with_hr:
            hr = np.kron(base, np.ones((SCALE, SCALE), np.uint16))
            write_png(os.path.join(d, "HR.png"), hr)
            sm = np.full(hr.shape, 255, np.uint16)
            sm[:8, :8] = 0
            write_png(os.path.join(d, "SM.png"), sm)
        if (s + 1) % progress_every == 0:
            rate = (s + 1) / (time.perf_counter() - t0)
            print(f"[gen] {band}/{split}: {s + 1}/{n_scenes} "
                  f"({rate:.1f} scenes/s)", flush=True)


def card_used_mib():
    """MiB in use on the cards, from nvidia-smi (which only reads)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=30)
    return sum(int(x) for x in r.stdout.split() if x.isdigit())


class StageWatcher(threading.Thread):
    """Polls a running stage every ``POLL_S``: the child's VmHWM (its
    VmRSS where /proc has no VmHWM, as in the card's sandbox) and, on the
    card, the card's memory in use."""

    def __init__(self, pid, card):
        super().__init__(daemon=True)
        self.pid, self.card = pid, card
        self.peak_kb, self.field = 0, None
        self.card_mib = 0
        self._done = threading.Event()

    def poll(self):
        try:
            with open(f"/proc/{self.pid}/status") as f:
                kb = dict(line.split(":", 1) for line in f if ":" in line)
        except OSError:
            kb = {}
        for field in ("VmHWM", "VmRSS"):
            if field in kb:
                self.field = field
                self.peak_kb = max(self.peak_kb, int(kb[field].split()[0]))
                break
        if self.card:
            self.card_mib = max(self.card_mib, card_used_mib())

    def run(self):
        while True:
            self.poll()
            if self._done.wait(POLL_S):
                return

    def stop(self):
        self._done.set()
        self.join()


class Rehearsal:
    """The report and the stages that write into it."""

    def __init__(self, path, args):
        self.path = path
        self.results = {"args": args, "steps": {}}
        if os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
            if prev.get("args", {}).get("scale") == args["scale"]:
                self.results["steps"].update(prev.get("steps", {}))
                for key in ("kernel_build", "reg_diff"):
                    if key in prev:
                        self.results[key] = prev[key]

    def save(self):
        with open(self.path, "w") as f:
            json.dump(self.results, f, indent=1)

    def run_step(self, name, argv, card, env, cwd):
        built = _build.library_path().exists()
        print(f"[rehearsal] ==> {name}: {' '.join(argv)}", flush=True)
        base_mib = card_used_mib() if card else 0
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, env=env, cwd=cwd)
        watch = StageWatcher(proc.pid, card)
        watch.start()
        code = proc.wait()
        wall = time.perf_counter() - t0
        watch.stop()
        entry = {"wall_s": round(wall, 3),
                 "peak_rss_gb": round(watch.peak_kb * 1024 / 1e9, 3),
                 "rss_field": watch.field,
                 "device_peak_gb": (
                     round((watch.card_mib - base_mib) * 2 ** 20 / 1e9, 3)
                     if card else None),
                 "exit": code}
        self.results["steps"][name] = entry
        if not built and _build.library_path().exists():
            self.results["kernel_build"] = {"stage": name,
                                            "stage_wall_s": entry["wall_s"]}
        print(f"[rehearsal] <== {name}: {wall:.1f} s, peak RSS "
              f"{entry['peak_rss_gb']} GB, device peak "
              f"{entry['device_peak_gb']} GB, exit {code}", flush=True)
        if code != 0:
            self.results["failed"] = name
            self.save()
            sys.exit(f"step {name} failed (exit {code})")
        self.save()
        return entry


def file_digest(path, chunk=1 << 22):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()[:16]


def differing_scenes(a_path, b_path):
    """Scenes (rows of the first axis) whose data or mask differ between
    two stage artifacts; a length mismatch counts the extra rows."""
    a = np.load(a_path, allow_pickle=True)
    b = np.load(b_path, allow_pickle=True)
    n = 0
    for x, y in zip(a, b):
        if not (np.shape(x) == np.shape(y) and
                np.array_equal(np.ma.getdata(x), np.ma.getdata(y)) and
                np.array_equal(np.ma.getmaskarray(x),
                               np.ma.getmaskarray(y))):
            n += 1
    return n + abs(len(a) - len(b))


def write_cfg(path, raw, out, epochs, tiny_net):
    text = (CFG_TEMPLATE.format(raw=raw, out=out)
            .replace("epochs=100", f"epochs={epochs}"))
    if tiny_net:
        for old, new in TINY_NET:
            text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=str(REPO / ".rehearsal"))
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scene-count multiplier (0.01 = a smoke run)")
    ap.add_argument("--skip-gen", action="store_true")
    ap.add_argument("--skip-preprocess", action="store_true")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--reg-diff", action="store_true",
                    help="re-run NIR stages 1-2 with --reg-backend numpy "
                         "into a second tree and compare the digests")
    ap.add_argument("--fused", default="t", choices=["off", "t"],
                    help="block-stack tier of train and serve")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny-net", action="store_true",
                    help="a 4-filter 1-block net at batch 4 (CPU smoke)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    ws = os.path.abspath(args.workdir)
    os.makedirs(ws, exist_ok=True)
    reh = Rehearsal(os.path.join(ws, "rehearsal_report.json"), vars(args))
    results = reh.results
    card = args.device == "cuda"

    raw, out = os.path.join(ws, "raw"), os.path.join(ws, "out")
    cfg = write_cfg(os.path.join(ws, "rehearsal.cfg"), raw, out,
                    args.epochs, args.tiny_net)
    counts = {k: max(2, int(round(v * args.scale)))
              for k, v in COUNTS.items()}
    results["counts"] = {f"{b}_{s}": n for (b, s), n in counts.items()}
    results["seeds"] = {f"{b}_{s}": SEEDS[b, s] for b, s in counts}

    if not args.skip_gen:
        t0 = time.perf_counter()
        for (band, split), n in counts.items():
            make_band_tree(raw, band, split, n, seed=SEEDS[band, split])
        results["steps"]["generate"] = {
            "wall_s": round(time.perf_counter() - t0, 3),
            "scenes": sum(counts.values())}
        reh.save()

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    py = [sys.executable, "-m"]
    dev = ["--device", args.device]

    def step(name, module, *flags):
        return reh.run_step(name, py + [f"probav_tpu_torch.{module}", *flags,
                                        *dev], card, env=env, cwd=ws)

    if not args.skip_preprocess:
        for band in ("NIR", "RED"):
            step(f"preprocess_{band}", "preprocess", "--cfg", cfg,
                 "--band", band)

    if args.reg_diff:
        out2 = os.path.join(ws, "out_numpyreg")
        cfg2 = write_cfg(os.path.join(ws, "rehearsal_numpyreg.cfg"), raw,
                         out2, args.epochs, args.tiny_net)
        step("preprocess_numpyreg_NIR", "preprocess", "--cfg", cfg2,
             "--band", "NIR", "--ckpt", "1,2", "--reg-backend", "numpy")
        diffs = {}
        for name in REG_DIFF_FILES:
            a = os.path.join(out, "trimmedArrayDir", name)
            b = os.path.join(out2, "trimmedArrayDir", name)
            da, db = file_digest(a), file_digest(b)
            diffs[name] = {"torch": da, "numpy": db, "equal": da == db}
            if da != db:
                diffs[name]["differing_scenes"] = differing_scenes(a, b)
        results["reg_diff"] = diffs
        reh.save()

    tier = ["--fused-stack", args.fused]
    if not args.skip_train:
        step(f"train_BOTH_{args.epochs}ep", "train", "--cfg", cfg,
             "--band", "BOTH", "--eval-step", "2000", *tier,
             *(["--bf16", "--device-data"] if card else []))

    serve_flags = (["--bf16"] if card else []) + \
        (["--plain"] if args.fused == "off" else [])
    for totest in ("TEST", "TRAIN"):
        for band in ("NIR", "RED"):
            step(f"serve_{totest}_{band}", "serve", "--cfg", cfg, "--band",
                 band, "--totest", totest, *serve_flags)

    n_red = counts["RED", "train"]
    norm_csv = os.path.join(ws, "norm.csv")
    with open(norm_csv, "w") as f:
        # evaluate numbers the candidates RED then NIR, so NIR ids start at
        # n_red (594 at --scale 1.0, the real dataset's boundary).
        f.write("scene,norm\n")
        for i in range(n_red + counts["NIR", "train"]):
            f.write(f"imgset{i:04d},45.0\n")
    train_out = Config.from_file(cfg).out_dir("TRAIN")
    score = os.path.join(ws, "score.json")
    step("evaluate", "evaluate", "--cfg", cfg, "--toCompare", train_out,
         "--benchmark", train_out, "--red-count", str(n_red),
         "--norm-csv", norm_csv, "--score-json", score,
         "--out", os.path.join(ws, "comparison.png"))
    with open(score) as f:
        results["score"] = json.load(f)
    reh.save()

    print(json.dumps(results, indent=1))
    print(f"[rehearsal] report: {reh.path}")
    return results


if __name__ == "__main__":
    main()
