"""Frame registration: FFT phase correlation + integer shift (port of
``probav_tpu/ops/registration.py``).

Rebuild of the reference registration stage (utils/dataGenerator.py:599-678),
which aligns every LR frame of a scene to its clearest frame:

- ``tech='freq'``: skimage ``register_translation`` (default upsample_factor=1
  => integer shifts) followed by ``scipy.ndimage.fourier_shift`` round-trips.
  An integer-shift Fourier translation is exactly a circular roll, so the
  shift is the argmax of the FFT cross-correlation and the resample a roll.
- ``tech='time'``: masked normalized cross-correlation (Padfield) as in
  skimage ``masked_register_translation``, then a reflect-mode spatial shift.

Two paths, as in the JAX package:

- the host path (``register_image_set``, ``register_images(backend=
  'numpy')``) in numpy, float64, with ``scipy.ndimage.shift`` for 'time';
- the device path (``register_scenes_torch``, ``register_images(backend=
  'torch')``) in torch, float32, on ``device``: scenes bucketed by frame
  count, one chunk of scenes at a time on the device, the FFTs on
  ``torch.fft`` (cuFFT on the card), the argmax and the shift as gathers.
  It counts its device calls in ``CHUNKS`` by device type.

Both paths take the frame order (the clearest frame first: the reference
frame) from numpy's ``argsort`` on the host.  Fully clear frames tie, and
``torch.argsort`` breaks ties in another order, which would elect another
reference frame.

Masks follow the reference convention INTO this module as QM arrays
(nonzero == clear); the outputs are masked arrays with mask=True == occluded.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

logger = logging.getLogger("probav_tpu_torch.data")

# Device calls of the device path, by device type ("cuda", "cpu").
CHUNKS: dict = {}


def reset_chunks() -> None:
    CHUNKS.clear()


# --------------------------------------------------------------------- #
# shift estimation (host)                                                #
# --------------------------------------------------------------------- #

def phase_correlation_shift(reference: np.ndarray, moving: np.ndarray) -> np.ndarray:
    """Integer shift (per axis) aligning ``moving`` to ``reference``.

    Equivalent to skimage register_translation(reference, moving) with
    upsample_factor=1: argmax of |ifftn(F_ref * conj(F_mov))| with wrap-around
    indices mapped to negative shifts.
    """
    f_ref = np.fft.fftn(reference)
    f_mov = np.fft.fftn(moving)
    cc = np.fft.ifftn(f_ref * f_mov.conj())
    shape = np.array(reference.shape)
    maxima = np.unravel_index(np.argmax(np.abs(cc)), reference.shape)
    shifts = np.array(maxima, dtype=np.float64)
    midpoints = np.fix(shape / 2)
    shifts[shifts > midpoints] -= shape[shifts > midpoints]
    return shifts


def masked_phase_correlation_shift(reference: np.ndarray, moving: np.ndarray,
                                   reference_mask: np.ndarray,
                                   moving_mask: np.ndarray,
                                   overlap_ratio: float = 3.0 / 10.0) -> np.ndarray:
    """Masked normalized cross-correlation shift (Padfield 2012).

    Port of the algorithm behind skimage masked_register_translation: compute
    the masked NCC surface entirely via FFTs, suppress translations with too
    little mask overlap, return the argmax as an integer shift.
    """
    eps = np.finfo(np.float64).eps
    fixed = np.where(reference_mask, reference.astype(np.float64), 0.0)
    moving_img = np.where(moving_mask, moving.astype(np.float64), 0.0)
    m1 = reference_mask.astype(np.float64)
    m2 = moving_mask.astype(np.float64)

    # Zero-pad to the 'full' linear-correlation size (2N-1 per axis) as the
    # Padfield formulation requires: with unpadded circular FFTs, overlap
    # counts and the NCC surface wrap around the borders and can elect a
    # spurious wrapped translation.
    pad_shape = tuple(2 * s - 1 for s in reference.shape)
    axes = tuple(range(reference.ndim))
    fft = lambda x: np.fft.fftn(x, s=pad_shape, axes=axes)
    ifft = lambda x: np.real(np.fft.ifftn(x))
    f1, f2 = fft(fixed), fft(moving_img)
    fm1, fm2 = fft(m1), fft(m2)

    overlap = ifft(fm1 * fm2.conj())
    overlap = np.maximum(np.round(overlap), 0.0)
    s1 = ifft(f1 * fm2.conj())
    s2 = ifft(fm1 * f2.conj())
    sq1 = ifft(fft(fixed ** 2) * fm2.conj())
    sq2 = ifft(fm1 * fft(moving_img ** 2).conj())
    cross = ifft(f1 * f2.conj())

    with np.errstate(divide="ignore", invalid="ignore"):
        num = cross - s1 * s2 / np.maximum(overlap, eps)
        var1 = np.maximum(sq1 - s1 ** 2 / np.maximum(overlap, eps), 0.0)
        var2 = np.maximum(sq2 - s2 ** 2 / np.maximum(overlap, eps), 0.0)
        ncc = num / np.sqrt(var1 * var2 + eps)

    ncc[overlap < overlap_ratio * overlap.max()] = -np.inf
    maxima = np.unravel_index(np.argmax(ncc), pad_shape)
    # Padded 'full' correlation: index k maps to displacement k for
    # k < n, else k - (2n - 1).
    shifts = np.array([
        float(k) if k < n else float(k - p)
        for k, n, p in zip(maxima, reference.shape, pad_shape)
    ])
    return shifts


# --------------------------------------------------------------------- #
# frame / set registration (host pipeline entry points)                  #
# --------------------------------------------------------------------- #

def frame_shift(img: np.ndarray, msk: np.ndarray, reference_img: np.ndarray,
                reference_msk: np.ndarray, tech: str = "freq") -> np.ndarray:
    """The shift (per axis of [C, H, W]) that ``register_frame`` applies."""
    if tech == "freq":
        return phase_correlation_shift(reference_img, img)
    if tech == "time":
        return masked_phase_correlation_shift(reference_img, img,
                                              reference_msk, msk)
    raise ValueError(f"unknown registration technique {tech!r}")


def register_frame(img: np.ndarray, msk: np.ndarray,
                   reference_img: np.ndarray, reference_msk: np.ndarray,
                   tech: str = "freq") -> Tuple[np.ndarray, np.ndarray]:
    """Align one frame (+ boolean clear-mask) to the reference frame.

    Mirrors registerFrame (dataGenerator.py:649-678).  Shapes [C, H, W].
    """
    return _resample(img, msk,
                     frame_shift(img, msk, reference_img, reference_msk,
                                 tech), tech)


def _resample(img: np.ndarray, msk: np.ndarray, shift: np.ndarray,
              tech: str) -> Tuple[np.ndarray, np.ndarray]:
    """Apply ``frame_shift``'s shift: a roll ('freq'), or scipy's
    reflect-mode shift of the image and constant-0 shift of the mask
    ('time')."""
    if tech == "freq":
        shift = shift.astype(np.int64)
        reg_img = np.roll(img.astype(np.float64), shift, axis=range(img.ndim))
        reg_msk = np.roll(msk.astype(bool), shift, axis=range(msk.ndim))
        return reg_img, reg_msk
    from scipy import ndimage
    reg_img = ndimage.shift(img.astype(np.float64), shift, mode="reflect")
    reg_msk = ndimage.shift(msk.astype(np.float64), shift,
                            mode="constant", cval=0.0) > 0.5
    return reg_img, reg_msk


def _clearness_order(msk_lr) -> np.ndarray:
    """Clearest-first frame order (descending count of nonzero QM pixels):
    the reference contract that the clearest frame is the unregistered
    reference frame (dataGenerator.py:632-636).  numpy's default sort, as
    the JAX package's: both backends take their order from this call, so
    frames that tie elect the same reference frame in both packages."""
    return np.argsort([-np.count_nonzero(m) for m in msk_lr])


def register_image_set(img_lr: np.ndarray, msk_lr: np.ndarray,
                       tech: str = "freq", return_shifts: bool = False):
    """Register all frames of one scene to its clearest frame.

    Mirrors registerImagesInSet (dataGenerator.py:616-646): sort frames by
    clearness (descending count of nonzero QM pixels), use the clearest as the
    reference (left unregistered), register the rest, and return a masked
    array whose mask is True at OCCLUDED pixels (~QM).

    img_lr/msk_lr: [numFrames, C, H, W] raw image + QM arrays.  With
    ``return_shifts`` also the shift applied to each output frame, [T, 3]
    over (C, H, W), zeros for the reference frame.
    """
    if img_lr.shape != msk_lr.shape:
        raise ValueError(f"image {img_lr.shape} and mask {msk_lr.shape} "
                         f"shapes differ")
    order = _clearness_order(msk_lr)
    imgs = img_lr[order]
    msks = msk_lr[order]
    ref_img, ref_msk = imgs[0], msks[0] > 0

    out_img = np.empty(imgs.shape, dtype=np.float64)
    out_occluded = np.empty(imgs.shape, dtype=bool)
    shifts = np.zeros((len(imgs), imgs.ndim - 1))
    out_img[0] = imgs[0]
    out_occluded[0] = ~(msks[0] > 0)
    for i in range(1, len(imgs)):
        shifts[i] = frame_shift(imgs[i], msks[i] > 0, ref_img, ref_msk, tech)
        reg_img, reg_msk = _resample(imgs[i], msks[i] > 0, shifts[i], tech)
        out_img[i] = reg_img
        out_occluded[i] = ~reg_msk
    out = np.ma.masked_array(out_img, mask=out_occluded)
    return (out, shifts) if return_shifts else out


def register_images(all_img_lr, all_msk_lr, tech: str = "freq",
                    progress: bool = False, backend: str = "numpy",
                    device="cuda") -> np.ma.masked_array:
    """Register every scene (dataGenerator.py:599-613).

    [numImgSet, numFrames, C, H, W] -> masked array of the same shape (an
    object array of per-scene masked arrays where frame counts are
    ragged).  ``backend='torch'`` runs the shift estimation and the
    resample on ``device`` for both techniques (``register_scenes_torch``);
    ``backend='numpy'`` registers on the host.
    """
    if backend == "torch":
        registered = register_scenes_torch(all_img_lr, all_msk_lr, device,
                                           progress=progress, tech=tech)
    elif backend == "numpy":
        registered = []
        for i in range(len(all_img_lr)):
            registered.append(register_image_set(all_img_lr[i],
                                                 all_msk_lr[i], tech=tech))
            if progress and ((i + 1) % 100 == 0 or i + 1 == len(all_img_lr)):
                logger.info("[ INFO ] Registered %d/%d scenes on the host",
                            i + 1, len(all_img_lr))
    else:
        raise ValueError(f"unknown registration backend {backend!r} "
                         f"(torch or numpy)")
    try:
        return np.ma.stack(registered)
    except ValueError:
        # Ragged frame counts across scenes (the raw PROBA-V layout: 9-19
        # LR frames per scene): keep an object array of per-scene masked
        # arrays, as the reference does pre-top-k.
        out = np.empty(len(registered), dtype=object)
        for i, r in enumerate(registered):
            out[i] = r
        return out


# --------------------------------------------------------------------- #
# device path: many scenes a call, a leading scene axis                  #
# --------------------------------------------------------------------- #

def _gather_hw(x: torch.Tensor, ry: torch.Tensor,
               rx: torch.Tensor) -> torch.Tensor:
    """x [S, N, C, H, W] -> x[s, n, c, ry[s, n, y], rx[s, n, x]]."""
    s, n, c, h, w = x.shape
    x = torch.gather(x, 3, ry[:, :, None, :, None].expand(s, n, c, h, w))
    return torch.gather(x, 4, rx[:, :, None, None, :].expand(s, n, c, h, w))


def _align_core(ref: torch.Tensor, frames: torch.Tensor,
                frame_msks: torch.Tensor):
    """tech='freq', every scene of a chunk: align every frame (+ mask) to
    its scene's reference frame by a circular roll.

    ref [S,C,H,W]; frames/frame_msks [S,N,C,H,W].  Returns the rolled
    frames and masks and the shifts (sy, sx) [S,N].
    """
    s, n, c, h, w = frames.shape
    f_ref = torch.fft.fft2(ref)                         # [S,C,H,W] complex
    f_mov = torch.fft.fft2(frames)                      # [S,N,C,H,W]
    cc = torch.fft.ifft2(f_ref[:, None] * f_mov.conj()).abs()
    idx = torch.argmax(cc.reshape(s, n, c * h * w), dim=2)
    iy = (idx % (h * w)) // w
    ix = idx % w
    sy = torch.where(iy > h // 2, iy - h, iy)
    sx = torch.where(ix > w // 2, ix - w, ix)
    # jnp.roll by (dy, dx): out[y, x] = in[(y - dy) % h, (x - dx) % w].
    ry = (torch.arange(h, device=ref.device) - sy[..., None]) % h
    rx = (torch.arange(w, device=ref.device) - sx[..., None]) % w
    return (_gather_hw(frames, ry, rx), _gather_hw(frame_msks, ry, rx),
            sy, sx)


def _align_time_core(ref: torch.Tensor, ref_msk: torch.Tensor,
                     frames: torch.Tensor, frame_msks: torch.Tensor,
                     overlap_ratio: float = 3.0 / 10.0):
    """tech='time', every scene of a chunk: masked-NCC shifts + reflect
    resample.

    Device-side mirror of masked_phase_correlation_shift +
    register_frame(tech='time'): the NCC surface lives on the zero-padded
    full-correlation grid (2H-1, 2W-1), translations with too little mask
    overlap are suppressed, and the winning integer shift is applied by
    gather, which is what scipy.ndimage.shift computes at integer offsets
    ('reflect' for the image, 'constant' cval=0 for the mask).
    ref/ref_msk [S,C,H,W]; frames/frame_msks [S,N,C,H,W].  Channels ride
    the batch axis (the dataset is C=1).  Compute is float32, as the JAX
    device path's; the host path runs float64.
    """
    s, n, c, h, w = frames.shape
    ph, pw = 2 * h - 1, 2 * w - 1
    eps = torch.finfo(torch.float32).eps

    fixed = torch.where(ref_msk, ref, 0.0)
    moving = torch.where(frame_msks, frames, 0.0)
    m1 = ref_msk.to(torch.float32)
    m2 = frame_msks.to(torch.float32)

    fft = lambda x: torch.fft.fft2(x, s=(ph, pw))
    ifft = lambda x: torch.fft.ifft2(x).real

    f1, fm1, fs1 = (fft(x)[:, None] for x in (fixed, m1, fixed ** 2))
    f2, fm2, fs2 = fft(moving), fft(m2), fft(moving ** 2)   # [S,N,C,ph,pw]

    overlap = torch.round(ifft(fm1 * fm2.conj())).clamp_min(0.0)
    s1 = ifft(f1 * fm2.conj())
    s2 = ifft(fm1 * f2.conj())
    sq1 = ifft(fs1 * fm2.conj())
    sq2 = ifft(fm1 * fs2.conj())
    cross = ifft(f1 * f2.conj())

    ovl = overlap.clamp_min(eps)
    num = cross - s1 * s2 / ovl
    var1 = (sq1 - s1 ** 2 / ovl).clamp_min(0.0)
    var2 = (sq2 - s2 ** 2 / ovl).clamp_min(0.0)
    ncc = num / torch.sqrt(var1 * var2 + eps)

    omax = overlap.reshape(s, n, -1).amax(dim=2)            # per frame
    ncc = torch.where(overlap < overlap_ratio * omax[..., None, None, None],
                      -torch.inf, ncc)
    idx = torch.argmax(ncc.reshape(s, n, c * ph * pw), dim=2)
    iy = (idx % (ph * pw)) // pw
    ix = idx % pw
    # Full-correlation index k maps to displacement k for k < n, else
    # k - (2n - 1) (masked_phase_correlation_shift's decode).
    sy = torch.where(iy < h, iy, iy - ph)
    sx = torch.where(ix < w, ix, ix - pw)

    jy = torch.arange(h, device=ref.device) - sy[..., None]     # [S,N,H]
    jx = torch.arange(w, device=ref.device) - sx[..., None]
    ry = torch.where(jy < 0, -jy - 1, jy)           # scipy 'reflect':
    ry = torch.where(ry >= h, 2 * h - 1 - ry, ry)   # (dcba|abcd|dcba)
    rx = torch.where(jx < 0, -jx - 1, jx)
    rx = torch.where(rx >= w, 2 * w - 1 - rx, rx)
    reg = _gather_hw(frames, ry, rx)
    gm = _gather_hw(frame_msks, jy.clamp(0, h - 1), jx.clamp(0, w - 1))
    vy = (jy >= 0) & (jy < h)
    vx = (jx >= 0) & (jx < w)
    gm = gm & vy[:, :, None, :, None] & vx[:, :, None, None, :]
    return reg, gm, sy, sx


def _stage_chunk(all_img_lr, all_msk_lr, idxs, shape):
    """One chunk of scenes, clearest frame first, as float32 frames and
    boolean clear masks [take, T, C, H, W] on the host."""
    raw_i = np.empty((len(idxs),) + shape, np.float32)
    raw_m = np.empty((len(idxs),) + shape, bool)
    for j, i in enumerate(idxs):
        order = _clearness_order(np.asarray(all_msk_lr[i]))
        raw_i[j] = np.asarray(all_img_lr[i])[order]
        raw_m[j] = np.asarray(all_msk_lr[i])[order] > 0
    return raw_i, raw_m


def register_scenes_torch(all_img_lr, all_msk_lr, device, chunk: int = None,
                          tech: str = "freq", progress: bool = False,
                          return_shifts: bool = False) -> list:
    """Register MANY scenes with a handful of device calls (the counterpart
    of ``register_scenes_jax``).

    Scenes are bucketed by frame count (the raw PROBA-V layout is ragged,
    9-19 LR frames per scene) and each bucket runs through one call per
    ``chunk`` scenes (default 64 for 'freq', 16 for 'time', whose padded
    surfaces are ~4x the frame area and ~10 deep).  Only one chunk is on
    the device at a time.  Results keep the input scene order: a list of
    per-scene masked arrays [T, C, H, W] (float64 data, mask True where
    occluded).  With ``return_shifts`` also each scene's [T, 2] (dy, dx)
    applied to its output frames, zeros for the reference frame.

    Frames with more than one channel raise: the device path decodes only
    (dy, dx), and the host path (``--reg-backend numpy``) registers them.
    """
    if tech not in ("freq", "time"):
        raise ValueError(f"unknown registration technique {tech!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("registration on cuda but no CUDA device is "
                           "available (pass --device cpu, or --reg-backend "
                           "numpy to register on the host)")
    if chunk is None:
        chunk = 64 if tech == "freq" else 16
    n_scenes = len(all_img_lr)
    buckets: dict = {}
    for i in range(n_scenes):
        shape = np.shape(all_img_lr[i])
        if len(shape) != 4 or shape[1] != 1:
            raise ValueError(
                f"scene {i}: frames of shape {shape}; the torch backend "
                f"registers single-channel [T, 1, H, W] frames only "
                f"(use --reg-backend numpy)")
        buckets.setdefault(shape, []).append(i)

    out: list = [None] * n_scenes
    shifts: list = [None] * n_scenes
    done = 0
    for shape, idxs in buckets.items():
        n_frames = shape[0]
        for s0 in range(0, len(idxs), chunk):
            chunk_idxs = idxs[s0:s0 + chunk]
            take = len(chunk_idxs)
            raw_i, raw_m = _stage_chunk(all_img_lr, all_msk_lr, chunk_idxs,
                                        shape)
            if n_frames > 1:
                ib = torch.from_numpy(raw_i).to(device)
                mb = torch.from_numpy(raw_m).to(device)
                if tech == "freq":
                    got = _align_core(ib[:, 0], ib[:, 1:], mb[:, 1:])
                else:
                    got = _align_time_core(ib[:, 0], mb[:, 0], ib[:, 1:],
                                           mb[:, 1:])
                CHUNKS[device.type] = CHUNKS.get(device.type, 0) + 1
                reg_i, reg_m, sy, sx = (t.cpu().numpy() for t in got)
            else:
                reg_i = np.empty((take, 0) + shape[1:], np.float32)
                reg_m = np.empty((take, 0) + shape[1:], bool)
                sy = sx = np.empty((take, 0), np.int64)
            for j, i in enumerate(chunk_idxs):
                oi = np.concatenate([raw_i[j][:1], reg_i[j]], axis=0)
                om = np.concatenate([raw_m[j][:1], reg_m[j]], axis=0)
                out[i] = np.ma.masked_array(oi.astype(np.float64), mask=~om)
                shifts[i] = np.concatenate(
                    [np.zeros((1, 2), np.int64),
                     np.stack([sy[j], sx[j]], axis=-1)])
            done += take
            if progress:
                logger.info("[ INFO ] Registered %d/%d scenes on %s", done,
                            n_scenes, device)
    return (out, shifts) if return_shifts else out


def register_image_set_torch(img_lr: np.ndarray, msk_lr: np.ndarray,
                             device, tech: str = "freq") -> np.ma.masked_array:
    """Same contract as register_image_set, on ``device`` (the counterpart
    of ``register_image_set_jax``, which takes 'freq' only)."""
    return register_scenes_torch([img_lr], [msk_lr], device, tech=tech)[0]
