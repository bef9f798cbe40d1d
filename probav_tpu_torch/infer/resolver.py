"""Full-scene inference and ESA submission writer (port of
``probav_tpu/infer/resolver.py``).

``Resolver.resolve_all`` groups scenes so that one group holds at least
``patches_per_call`` model inputs, runs the model over the group in chunks
of ``MODEL_CHUNK`` patches, clips to 2**16, rounds, and pastes the tiles
row-major into whole scenes on the device.  With TTA, every scene's
patches are permuted in time by one shared ``[R, T]`` table on the device,
each prediction is rounded before the mean over the R permutations.
``resolve_scene`` and ``resolve_scene_tta`` are one scene of the same
path (``_resolve_group``), so each equals ``resolve_all`` of that scene
alone.

Not ported: the JAX resolver's 128-lane grouping rule (``_auto_group``) and
its ``lax.map`` chunking inside one jitted call exist for the TPU kernels'
batch-minor layout and VMEM.  The CUDA kernels take any batch, and PyTorch
runs eagerly, so grouping only amortizes per-call overhead and chunking
only bounds memory.

With a ``mesh`` (``probav_tpu_torch.parallel``; one rank a device), as the
JAX resolver shards each group's patch rows over 'data', every rank
predicts its ``batch_share`` of each group's model inputs (TTA repeats
included), the rounded predictions are gathered on every rank
(``gather_rows``), and the paste and the TTA mean run as on one device;
the scene's patch count must divide by the data size, as in JAX.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from probav_tpu_torch.config import BAND_OFFSETS
from probav_tpu_torch.ops.patches import reconstruct_from_patches
from probav_tpu_torch.parallel.mesh import (batch_share, check_divisible,
                                            gather_rows)
from probav_tpu_torch.utils.png import write_png

# Patches per model call: bounds the live activations (the plain stack's
# wide [*, 256] expand output is 4.4 MB per flagship patch in float32) and
# is the batch at which the stack kernels are measured.
MODEL_CHUNK = 128
# Predictions are clipped to 2**16 (not 65535) before rounding, as the
# reference does (test.py:118); the PNG writer clamps to 65535.
CLIP_MAX = float(2 ** 16)


def load_removed_sets(band: str, search_dirs=(".",)) -> List[int]:
    """Scene ids to skip when numbering outputs: the first
    ``removedTrainSets<BAND>.txt`` found in ``search_dirs``."""
    if isinstance(search_dirs, str):
        search_dirs = (search_dirs,)
    for d in search_dirs:
        path = os.path.join(d, f"removedTrainSets{band.upper()}.txt")
        if os.path.exists(path):
            with open(path) as f:
                return [int(float(line.strip()))
                        for line in f if line.strip()]
    return []


class Resolver:
    """Scene super-resolution with a grouped, chunked forward.

    ``state`` (a state_dict, or None to keep the model's weights) is loaded
    into ``model``, which is moved to ``device`` (``mesh.device`` under a
    ``mesh``) and put in eval mode.
    """

    def __init__(self, model: torch.nn.Module,
                 state: Optional[Mapping[str, torch.Tensor]] = None,
                 scene_size: int = 384, device="cuda",
                 patches_per_call: int = 512, mesh=None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            torch.device(device)
        if state is not None:
            model.load_state_dict(state)
        self.model = model.to(self.device).eval()
        self.scene_size = scene_size
        self.patches_per_call = patches_per_call
        # Band statistics as data, as the JAX resolver passes them.
        self.norm = torch.tensor([getattr(model, "mean", 0.0),
                                  getattr(model, "std", 1.0)],
                                 dtype=torch.float32, device=self.device)

    def _predict(self, x: torch.Tensor) -> torch.Tensor:
        """[N, h, w, T, C] -> rounded, clipped [N, p, p, C], chunked; under
        a mesh this rank predicts its share of the rows, then the rows of
        every rank are gathered."""
        n = len(x)
        if self.mesh is not None:
            x = x[batch_share(self.mesh, n)]
        preds = [self.model(x[i:i + MODEL_CHUNK], self.norm)
                 for i in range(0, len(x), MODEL_CHUNK)]
        pred = torch.round(torch.clamp(torch.cat(preds), 0.0, CLIP_MAX))
        if self.mesh is not None:
            pred = gather_rows(pred, n, self.mesh)
        return pred

    def _paste(self, pred: torch.Tensor, group: int) -> torch.Tensor:
        """[G*P, p, p, C] -> [G, S, S, C], row-major tile paste."""
        return reconstruct_from_patches(
            pred.reshape((group, -1) + pred.shape[1:]), self.scene_size)

    @staticmethod
    def _tta_perms(t: int, repeats: int, seed: int) -> np.ndarray:
        """[R, T] int32 temporal permutations, one shared table per run.

        Every scene draws the SAME R permutations (the per-scene RNG was
        always seeded with the run's seed, independent of grouping), so
        the table is computed once and gathered in-graph — results are
        bit-identical to permuting each scene's stack on the host."""
        rng = np.random.default_rng(seed)
        return np.stack([rng.permutation(t)
                         for _ in range(repeats)]).astype(np.int32)

    def _tta_table(self, t: int, repeats: int, seed: int) -> torch.Tensor:
        """``_tta_perms`` flattened to [R*T] indices on the device."""
        return torch.as_tensor(self._tta_perms(t, repeats, seed).reshape(-1),
                               dtype=torch.long, device=self.device)

    def _resolve_group(self, chunk: np.ndarray,
                       perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[G, P, h, w, T, C] float32 scenes -> [G, S, S, C] on the device.

        With ``perm`` (``_tta_table``'s R permutations) each scene's
        patches are permuted in time R ways, the G*R*P rows go through
        ``_predict`` (chunked, rounded, clipped; this rank's share under a
        mesh), and the R predictions of each patch are averaged before
        the paste.  Every resolve method goes through here."""
        g, num_patches = chunk.shape[:2]
        if self.mesh is not None:
            check_divisible("patches per scene", num_patches,
                            self.mesh.data_size)
        x = torch.as_tensor(chunk.reshape((-1,) + chunk.shape[2:]),
                            device=self.device)       # [G*P, h, w, T, C]
        if perm is not None:
            h, w, t, c = x.shape[1:]
            repeats = len(perm) // t
            x = x.index_select(3, perm)               # [G*P, h, w, R*T, C]
            x = x.reshape(g, num_patches, h, w, repeats, t, c)
            x = x.permute(0, 4, 1, 2, 3, 5, 6)        # [G, R, P, h, w, T, C]
            x = x.reshape(g * repeats * num_patches, h, w, t, c)
        pred = self._predict(x)
        if perm is not None:
            pred = pred.reshape((g, repeats, num_patches) +
                                pred.shape[1:]).mean(dim=1)
            pred = pred.reshape((g * num_patches,) + pred.shape[2:])
        return self._paste(pred, g)

    @torch.inference_mode()
    def resolve_scene(self, patches: np.ndarray) -> np.ndarray:
        """[P, h, w, T, C] patches -> [scene, scene, C] rounded floats."""
        chunk = np.asarray(patches, np.float32)[None]
        return self._resolve_group(chunk)[0].cpu().numpy()

    @torch.inference_mode()
    def resolve_scene_tta(self, patches: np.ndarray, repeats: int = 20,
                          seed: int = 0) -> np.ndarray:
        """Temporal-permutation TTA of one scene (test.py:137-146):
        [P, h, w, T, C] -> [scene, scene, C], the permutation, forward,
        clip and round, mean over the ``repeats`` permutations and paste
        on the device; equal to ``resolve_all([patches], tta=True,
        tta_repeats=repeats, tta_seed=seed)[0]``."""
        chunk = np.asarray(patches, np.float32)[None]
        perm = self._tta_table(chunk.shape[4], repeats, seed)
        return self._resolve_group(chunk, perm)[0].cpu().numpy()

    @torch.inference_mode()
    def resolve_all(self, all_patches, tta: bool = False,
                    tta_repeats: int = 20,
                    tta_seed: int = 0) -> List[np.ndarray]:
        """[S, P, h, w, T, C] -> list of S [scene, scene, C] arrays."""
        n = len(all_patches)
        num_patches = len(all_patches[0])
        repeats = tta_repeats if tta else 1
        group = max(1, -(-self.patches_per_call // (num_patches * repeats)))
        perm = self._tta_table(np.shape(all_patches[0])[3], repeats,
                               tta_seed) if tta else None
        out: List[np.ndarray] = []
        for i in range(0, n, group):
            chunk = np.asarray(all_patches[i:i + group], dtype=np.float32)
            out.extend(self._resolve_group(chunk, perm).cpu().numpy())
        return out


def write_submission(scenes: Sequence[np.ndarray], out_dir: str, band: str,
                     totest: str = "TEST",
                     removed: Optional[Iterable[int]] = None,
                     start_id: Optional[int] = None) -> List[str]:
    """Write uint16 ``imgset%04d.png`` files with the reference numbering:
    ids start at the band/split offset and skip the removed scenes."""
    os.makedirs(out_dir, exist_ok=True)
    skip = set(removed if removed is not None else load_removed_sets(band))
    i = start_id if start_id is not None else \
        BAND_OFFSETS[(totest.upper(), band.upper())]
    written = []
    for scene in scenes:
        while i in skip:
            i += 1
        path = os.path.join(out_dir, f"imgset{i:04d}.png")
        write_png(path, scene[:, :, 0])
        written.append(path)
        i += 1
    return written
