'''VGG perceptual losses (counterpart of `animeface_tpu/nnutils/loss/vgg.py`;
the reference's `nnutils/loss/vgg.py`: VGG :15, gram_matrix :63, VGGLoss :69
with style/content/vgg_loss methods).

An NCHW VGG16/19 feature trunk cut into the same 5 relu slices, with the
JAX module names (`conv{block}_{i}`). Pretrained weights load from
$ANIMEFACE_VGG_WEIGHTS or the `weights_path` argument: a `.npz` written by
`tools/convert_vgg_weights.py` (or `python -m
animeface_tpu_torch.convert_weights vgg`), or a torchvision state-dict
`.pth`. Without them the trunk takes fixed-seed random weights of the kind
the JAX package's fallback has: flax's default conv init (lecun_normal, a
normal truncated at 2 std with variance 1/fan_in, zero bias) drawn from a
`torch.Generator` seeded 20260816 (the same distribution, not the same
numbers: threefry and Philox differ). Either way a loud provenance line is
printed once per provenance per process. The losses always run in float32
(the reference forces autocast off for the style path, vgg.py:141); the
trunk is frozen and gradients reach the inputs.
'''

from __future__ import annotations

import math
import os
import sys
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.nnutils.loss._base import Loss

# conv layout per block: VGG16 [2,2,3,3,3], VGG19 [2,2,4,4,4]
_CFG = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}
_CHANNELS = (64, 128, 256, 512, 512)

# ImageNet normalization (torchvision), applied to [0,1] inputs
_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

FALLBACK_SEED = 20260816
# flax's variance_scaling: the std of a unit normal truncated at +-2
_TRUNCATED_STD = 0.87962566103423978


class VGGFeatures(nn.Module):
    '''Feature trunk returning the 5 post-relu block activations (NCHW).'''

    def __init__(self, layers: int = 16):
        super().__init__()
        self.blocks = []              # the conv names of each block
        in_ch = 3
        for block, (n_convs, ch) in enumerate(zip(_CFG[layers], _CHANNELS)):
            names = [f'conv{block}_{i}' for i in range(n_convs)]
            for name in names:
                self.add_module(name, nn.Conv2d(in_ch, ch, 3, padding=1))
                in_ch = ch
            self.blocks.append(names)

    def forward(self, x):
        feats = []
        for block, names in enumerate(self.blocks):
            for name in names:
                x = F.relu(getattr(self, name)(x))
            feats.append(x)
            if block < 4:
                x = F.max_pool2d(x, 2, 2)
        return tuple(feats)


def random_vgg_state(layers: int = 16, seed: int = FALLBACK_SEED) -> dict:
    '''The fallback weights: lecun_normal conv kernels (flax's default),
    zero biases, drawn from `torch.Generator().manual_seed(seed)`.'''
    g = torch.Generator().manual_seed(seed)
    out = {}
    in_ch = 3
    for block, (n_convs, ch) in enumerate(zip(_CFG[layers], _CHANNELS)):
        for i in range(n_convs):
            std = math.sqrt(1.0 / (in_ch * 9)) / _TRUNCATED_STD
            w = torch.empty((ch, in_ch, 3, 3))
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
            out[f'conv{block}_{i}.weight'] = w
            out[f'conv{block}_{i}.bias'] = torch.zeros(ch)
            in_ch = ch
    return out


def _load_torch_weights(path: str, layers: int) -> dict:
    '''torchvision vgg state dict (features.N.weight OIHW) -> the port's.'''
    sd = torch.load(path, map_location='cpu', weights_only=True)
    conv_idx = [k for k in sd if k.startswith('features') and k.endswith('.weight')
                and sd[k].ndim == 4]
    conv_idx.sort(key=lambda k: int(k.split('.')[1]))
    it = iter(conv_idx)
    out = {}
    for block, n_convs in enumerate(_CFG[layers]):
        for i in range(n_convs):
            wk = next(it)
            out[f'conv{block}_{i}.weight'] = sd[wk].float()
            out[f'conv{block}_{i}.bias'] = sd[wk.replace('.weight', '.bias')].float()
    return out


def _load_npz_weights(path: str, layers: int) -> dict:
    '''`tools/convert_vgg_weights.py` artifact -> the port's state dict.'''
    from animeface_tpu_torch.convert import convert_vgg

    with np.load(path) as flat:
        if '__layers__' in flat and int(flat['__layers__']) != layers:
            raise ValueError(
                f'{path} holds VGG{int(flat["__layers__"])} weights but '
                f'VGG{layers} was requested')
        params = {}
        for block, n_convs in enumerate(_CFG[layers]):
            for i in range(n_convs):
                for leaf in ('kernel', 'bias'):
                    if f'conv{block}_{i}/{leaf}' not in flat:
                        raise ValueError(
                            f'{path} is missing "conv{block}_{i}/{leaf}" — '
                            f'truncated or not a VGG{layers} artifact; regenerate '
                            'with tools/convert_vgg_weights.py')
                params[f'conv{block}_{i}'] = {'kernel': flat[f'conv{block}_{i}/kernel'],
                                              'bias': flat[f'conv{block}_{i}/bias']}
    return convert_vgg(params)


def gram_matrix(x):
    '''[B,C,H,W] -> [B,C,C] / (C*H*W) (reference gram_matrix :63).'''
    B, C, H, W = x.shape
    feat = x.reshape(B, C, H * W)
    return torch.bmm(feat, feat.transpose(1, 2)) / (C * H * W)


_ANNOUNCED: set = set()


def frozen_vgg(layers: int, state_dict: dict, device) -> VGGFeatures:
    '''A `VGGFeatures` on `device` holding `state_dict`, in eval mode and
    without gradients of its own.'''
    model = VGGFeatures(layers)
    model.load_state_dict(state_dict)
    return model.to(device).eval().requires_grad_(False)


def normalize_imagenet(x, device):
    '''[0, 1] NCHW images -> ImageNet-normalized (torchvision's statistics).'''
    mean = torch.as_tensor(_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.as_tensor(_STD, device=device).view(1, 3, 1, 1)
    return (x - mean) / std


class VGGLoss(Loss):
    '''style_loss / content_loss / vgg_loss on frozen VGG features (ref :69),
    on `device` (default `cuda`).'''

    def __init__(self, device=None, vgg: int = 16, p: int = 2,
                 normalized: bool = True, return_all: bool = False,
                 weights_path: Optional[str] = None) -> None:
        super().__init__(return_all)
        if p not in (1, 2) or vgg not in (16, 19):
            raise ValueError(f'p must be 1 or 2 and vgg 16 or 19, got p={p}, vgg={vgg}')
        self.p = p
        self.normalized = normalized
        self.device = resolve_device(device)

        weights_path = weights_path or os.environ.get('ANIMEFACE_VGG_WEIGHTS')
        if weights_path and os.path.exists(weights_path):
            if weights_path.endswith('.npz'):
                state = _load_npz_weights(weights_path, vgg)
            else:
                state = _load_torch_weights(weights_path, vgg)
            self.provenance = f'pretrained:{weights_path}'
        else:
            warnings.warn(
                'no pretrained VGG weights found (set ANIMEFACE_VGG_WEIGHTS); '
                'using fixed-seed random features')
            state = random_vgg_state(vgg)
            self.provenance = 'RANDOM-INIT (fixed seed; NOT ImageNet features)'
        # loud provenance line in the training log (once per provenance per
        # process — per-eval construction must not spam stderr): perceptual
        # recipes trained on random features are a silent quality gap
        if self.provenance not in _ANNOUNCED:
            _ANNOUNCED.add(self.provenance)
            print(f'[VGG{vgg} perceptual loss] weights: {self.provenance}'
                  + ('' if 'pretrained' in self.provenance else
                     ' — convert real weights with tools/convert_vgg_weights.py '
                     'and set ANIMEFACE_VGG_WEIGHTS for reference parity'),
                  file=sys.stderr, flush=True)
        # frozen: gradients never flow into the trunk
        self.model = frozen_vgg(vgg, state, self.device)

    def _features(self, x):
        # x in [-1,1] (normalized=True semantics) -> [0,1] -> imagenet norm
        x = x.float()
        if self.normalized:
            x = x * 0.5 + 0.5
        return self.model(normalize_imagenet(x, x.device))

    def loss_fn(self, x, y, p: Optional[int] = None):
        p_ = p if p is not None else self.p
        if p_ == 1:
            return torch.mean(torch.abs(x - y))
        return torch.mean((x - y) ** 2)

    def style_loss(self, real, fake, block_indices: Sequence[int] = (0, 1, 2, 3),
                   p: Optional[int] = None):
        real_acts = self._features(real)
        fake_acts = self._features(fake)
        loss = 0.0
        for i in block_indices:
            loss = loss + self.loss_fn(gram_matrix(fake_acts[i]),
                                       gram_matrix(real_acts[i]), p)
        return loss

    def content_loss(self, real, fake, block_index: int = 2,
                     p: Optional[int] = None):
        real_acts = self._features(real)
        fake_acts = self._features(fake)
        return self.loss_fn(fake_acts[block_index], real_acts[block_index], p)

    def vgg_loss(self, real, fake, block_indices: Sequence[int] = (0, 1, 2, 3, 4),
                 p: Optional[int] = None):
        real_acts = self._features(real)
        fake_acts = self._features(fake)
        loss = 0.0
        for i in block_indices:
            loss = loss + self.loss_fn(real_acts[i], fake_acts[i], p)
        return loss
