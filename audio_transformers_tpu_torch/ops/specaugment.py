"""SpecAugment: time and frequency masking of log-mel features.

The reference's `audio_transformers_tpu/ops/specaugment.py` on PyTorch,
split in two: `spec_augment_masks` draws the masks from a
`torch.Generator` (the reference draws them from `jax.random`, which no
generator reproduces), `apply_spec_augment` fills the masked cells with
each sample's mean. A `nn.RowShard` in place of the generator draws
a data-parallel rank's rows of the global batch's masks. Tests hold
`apply_spec_augment` to the reference by feeding it the reference's own
masks. Each mask is a few bands per
sample, a band starting anywhere on its axis and covering 0 to its
maximum length in cells; the masks are independent per sample. The sizes
are the reference's defaults, the only ones its trainers use.
"""

from __future__ import annotations

from typing import Tuple

import torch

from audio_transformers_tpu_torch.ops.nn import draw

NUM_TIME_MASKS = 2
MAX_TIME_FRAC = 0.05      # of the frames, at least one frame
NUM_FREQ_MASKS = 2
MAX_FREQ = 8              # bins


def _axis_mask(generator, b: int, num_masks: int,
               size: int, max_len: int) -> torch.Tensor:
    """(b, size) bool: the union of `num_masks` bands per row."""
    device = generator.device
    starts = draw(torch.randint, generator, 0, size, shape=(b, num_masks),
                  device=device)
    lens = draw(torch.randint, generator, 0, max_len + 1,
                shape=(b, num_masks), device=device)
    pos = torch.arange(size, device=device)[None, None, :]
    m = (pos >= starts[:, :, None]) & (pos < (starts + lens)[:, :, None])
    return m.any(dim=1)


def spec_augment_masks(generator: torch.Generator, b: int, t: int, f: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(time mask (B, T), frequency mask (B, F)), bool, on the generator's
    device: bands of up to max(1, int(t * MAX_TIME_FRAC)) frames and up to
    MAX_FREQ bins."""
    max_t = max(1, int(t * MAX_TIME_FRAC))
    tmask = _axis_mask(generator, b, NUM_TIME_MASKS, t, max_t)
    fmask = _axis_mask(generator, b, NUM_FREQ_MASKS, f, MAX_FREQ)
    return tmask, fmask


def apply_spec_augment(mel: torch.Tensor, tmask: torch.Tensor,
                       fmask: torch.Tensor) -> torch.Tensor:
    """mel (B, T, F) with every cell whose frame or bin is masked replaced
    by the sample's mean over (T, F), which keeps the features' scale."""
    fill = mel.mean(dim=(1, 2), keepdim=True)
    full = tmask[:, :, None] | fmask[:, None, :]
    return torch.where(full, fill, mel)


def spec_augment(generator: torch.Generator, mel: torch.Tensor
                 ) -> torch.Tensor:
    """mel (B, T, F) masked with masks drawn from `generator` (on mel's
    device) and filled with each sample's mean: the trainers'
    SpecAugment."""
    tmask, fmask = spec_augment_masks(generator, *mel.shape)
    return apply_spec_augment(mel, tmask, fmask)
