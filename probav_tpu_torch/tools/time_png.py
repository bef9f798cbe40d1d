"""Host times of reading 384x384 uint16 PNGs by the filters of their rows,
and of scoring a submission of such PNGs.

    python3 -m probav_tpu_torch.tools.time_png [--scenes 16] [--reps 5] \\
        [--device cuda] [--out chiprun_out]

The port writes every scanline unfiltered (type 0).  Other writers filter
them: imageio, which the JAX package writes with, takes for each row the
filter among None, Sub, Up and Paeth whose bytes, read as signed, have the
least sum of magnitudes (``imageio_kinds``; tests/test_torch_evaluation.py
holds it to imageio's rows).  On a smooth scene most rows come out Paeth,
which ``read_png`` decodes by diagonals instead of whole rows.

Makes ``--scenes`` seeded synthetic NIR scenes (a Gaussian-smoothed field
at three scales plus sensor noise, 10% of the truth masked with its data
kept), and writes the benchmark and candidate stacks twice, as the port
writes them and as imageio would (``encode``).  For each layout it counts
the rows per filter type, times ``read_png`` on one scene (median of
``--reps``), and times ``compare_runs`` over the stacks on ``--device``
(the first run, then the median of ``--reps``).  Prints one JSON line and
appends it to ``<out>/time_png.jsonl``.  Needs no card with
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time
import zlib

import numpy as np

SIZE = 384


def predictors(raw: np.ndarray) -> list:
    """The five filters' predictions of each byte of [h, stride] raw
    scanline bytes, as int32: None, Sub (the byte a pixel to the left),
    Up, Average and Paeth (PNG specification, section 9)."""
    raw = raw.astype(np.int32)
    a, b, c = (np.zeros_like(raw) for _ in range(3))
    a[:, 2:], b[1:], c[1:, 2:] = raw[:, :-2], raw[:-1], raw[:-1, :-2]
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return [0 * raw, a, b, (a + b) // 2, paeth]


def _scanlines(img) -> np.ndarray:
    return np.asarray(img, ">u2").view(np.uint8).reshape(len(img), -1)


def imageio_kinds(img) -> np.ndarray:
    """imageio's filter type for each row of a uint16 image: of None, Sub,
    Up and Paeth, the one whose filtered bytes as int8 have the least sum
    of magnitudes, the lowest type on a tie."""
    raw = _scanlines(img)
    cost = [np.abs(((raw - p) % 256).astype(np.uint8).view(np.int8)
                   .astype(np.int64)).sum(axis=1)
            for p in predictors(raw)]
    cost[3] = np.full(len(raw), np.iinfo(np.int64).max)     # never Average
    return np.argmin(np.stack(cost), axis=0)


def encode(img, kinds) -> bytes:
    """A 16-bit grayscale PNG of img whose row y is filtered with type
    kinds[y] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    from probav_tpu_torch.utils import png

    raw = _scanlines(img)
    pred = predictors(raw)
    rows = b"".join(bytes([k]) + ((raw[y] - pred[k][y]) % 256).astype(
        np.uint8).tobytes() for y, k in enumerate(kinds))
    h, w = np.shape(img)
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([16, 0, 0, 0, 0])
    return (png._SIG + png._chunk(b"IHDR", ihdr) +
            png._chunk(b"IDAT", zlib.compress(rows, 6)) +
            png._chunk(b"IEND", b""))


def scenes(n: int, seed: int = 0) -> np.ndarray:
    """n smooth uint16 [SIZE, SIZE] scenes: a normal field smoothed at
    1, 3 or 8 pixels, scaled to 8000 +- 4000 counts, plus noise of 30."""
    from scipy import ndimage

    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = ndimage.gaussian_filter(r.normal(size=(SIZE, SIZE)),
                                    (1, 3, 8)[i % 3])
        f = 8000 + 4000 * f / f.std() + r.normal(0, 30, f.shape)
        out.append(np.clip(f, 0, 65535).astype(np.uint16))
    return np.stack(out)


def write_tree(base: str, bench: np.ndarray, cand: np.ndarray,
               truth: np.ndarray, hidden: np.ndarray) -> str:
    """base/data/resolverDir/TRAINimgHR_NIR.npy and a directory per stack
    and layout, scenes named by NIR's TRAIN ids; returns base/data."""
    from probav_tpu_torch.config import BAND_OFFSETS
    from probav_tpu_torch.utils.png import write_png

    resolver = os.path.join(base, "data", "resolverDir")
    os.makedirs(resolver)
    np.ma.masked_array(truth[:, None, None], mask=hidden[:, None, None]
                       ).dump(os.path.join(resolver, "TRAINimgHR_NIR.npy"),
                              protocol=4)
    off = BAND_OFFSETS[("TRAIN", "NIR")]
    for layout in ("port", "imageio"):
        for stack, imgs in (("bench", bench), ("cand", cand)):
            d = os.path.join(base, layout, stack)
            os.makedirs(d)
            for i, img in enumerate(imgs):
                path = os.path.join(d, f"imgset{off + i:04d}.png")
                if layout == "port":
                    write_png(path, img)
                else:
                    with open(path, "wb") as f:
                        f.write(encode(img, imageio_kinds(img)))
    return os.path.join(base, "data")


def filter_types(data: bytes) -> np.ndarray:
    """The filter type of each scanline of a 16-bit grayscale PNG."""
    w, h = np.frombuffer(data[16:24], ">u4")
    pos, idat = 8, b""
    while pos < len(data):
        n = int(np.frombuffer(data[pos:pos + 4], ">u4")[0])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(h, 1 + 2 * w)[:, 0]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def main(argv=None) -> dict:
    from probav_tpu_torch.evaluation import compare
    from probav_tpu_torch.utils.png import read_png

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)

    r = np.random.default_rng(1)
    bench = scenes(args.scenes, seed=2)
    noisy = lambda a, s: np.clip(a + r.normal(0, s, a.shape), 0, 65535)
    cand = noisy(bench, 100).astype(np.uint16)
    truth = noisy(bench, 300).astype(np.float32)
    hidden = r.uniform(size=truth.shape) < 0.1
    result = {"scenes": args.scenes, "size": SIZE, "device": args.device,
              "card": card(), "layouts": {}}
    with tempfile.TemporaryDirectory() as tmp:
        pre = write_tree(tmp, bench, cand, truth, hidden)
        scores = {}
        for layout in ("port", "imageio"):
            d = os.path.join(tmp, layout)
            names = sorted(os.listdir(os.path.join(d, "bench")))
            kinds = np.zeros(5, np.int64)
            for name in names:
                with open(os.path.join(d, "bench", name), "rb") as f:
                    kinds += np.bincount(filter_types(f.read()), minlength=5)
            first = os.path.join(d, "bench", names[0])
            decode = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                img = read_png(first)
                decode.append(time.perf_counter() - t0)
            if not np.array_equal(img, bench[0]):
                raise AssertionError(f"read_png, {layout}: pixels differ")
            walls = []
            for _ in range(1 + args.reps):
                t0 = time.perf_counter()
                got = compare.compare_runs(
                    pre, os.path.join(d, "bench"), os.path.join(d, "cand"),
                    red_count=0, bands=("NIR",), device=args.device)["NIR"]
                walls.append(time.perf_counter() - t0)
            scores[layout] = got
            n = len(got["benchmark"])
            result["layouts"][layout] = {
                "rows_by_filter_type": kinds.tolist(),
                "read_png_ms": statistics.median(decode) * 1e3,
                "compare_runs_first_s": walls[0],
                "compare_runs_median_s": statistics.median(walls[1:]),
                "scenes_per_s_first": n / walls[0],
                "scenes_per_s_median": n / statistics.median(walls[1:])}
        for k in ("benchmark", "candidate"):
            if not np.array_equal(scores["port"][k], scores["imageio"][k]):
                raise AssertionError(f"{k}: scores differ by layout")
    line = json.dumps(result)
    print(line)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "time_png.jsonl"), "a") as f:
        f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
