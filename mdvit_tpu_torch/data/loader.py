"""The train step's batch assembly, the port's own copies of
``mdvit_tpu/data/loader.py:gather_batch`` and
``mdvit_tpu/data/augment.py:eval_transform``.

Augmentation on the device comes with the data-path slice; the train step
runs on the eval transform (normalisation only) until then.
"""
from __future__ import annotations

from typing import Sequence

import torch

from mdvit_tpu_torch.data.preprocess import normalize


def gather_batch(store_images: Sequence[torch.Tensor],
                 store_masks: Sequence[torch.Tensor], indices: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack D per-domain batches from uint8 stores into one domain-contiguous
    (D·B, S, S, ·) fp32 batch plus its (D·B, D) one-hot. ``store_images[d]``
    is (N_d, S, S, 3), ``store_masks[d]`` (N_d, S, S), ``indices`` (D, B)."""
    d, b = indices.shape
    imgs = torch.cat([store_images[i][indices[i]] for i in range(d)]).float()
    masks = torch.cat([store_masks[i][indices[i]] for i in range(d)]).float()
    eye = torch.eye(d, dtype=torch.float32, device=imgs.device)
    return imgs, masks, eye.repeat_interleave(b, dim=0)


def eval_transform(images: torch.Tensor, masks: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalised images and (B, S, S, 1) labels ``mask > 0.5``."""
    return normalize(images), (masks > 0.5).float()[..., None]
