'''Bilinear grid sampling (counterpart of `animeface_tpu/ops/grid_sample.py`).

The JAX op gathers the four taps of each sample point with bilinear
weights and zeros outside the image, the semantics of
`F.grid_sample(x, grid, 'bilinear', 'zeros', align_corners=False)`, which
this is, over NCHW. x [N, C, H, W], grid [N, Ho, Wo, 2] with (x, y) in
[-1, 1]. PyTorch's grid_sample has no double backward; the port's callers
(SCFT's TPS warp of the reference image) differentiate through neither.
'''

from __future__ import annotations

import torch.nn.functional as F


def grid_sample(x, grid):
    '''x [N, C, H, W] sampled at grid [N, Ho, Wo, 2] -> [N, C, Ho, Wo].'''
    return F.grid_sample(x, grid.to(x.dtype), mode='bilinear', padding_mode='zeros',
                         align_corners=False)
