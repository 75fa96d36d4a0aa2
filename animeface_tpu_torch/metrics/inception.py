'''InceptionV3 feature extractor for FID (pytorch-fid pool3 variant).

Counterpart of `animeface_tpu/metrics/inception.py`, NCHW: torchvision's
`inception_v3` trunk as pytorch-fid modifies it, with the module names of
both (`Conv2d_1a_3x3` ... `Mixed_7c`, each `BasicConv2d` a `.conv` without
bias and a `.bn` with eps 1e-3 and running statistics). It follows the JAX
package in two places where that differs from pytorch-fid:
  - the branch pool of InceptionE is a 3x3/1 average pool with
    count_include_pad=False in both Mixed_7b and Mixed_7c (pytorch-fid's
    `FIDInceptionE_2`, Mixed_7c, takes a max pool);
  - the input is resized to 299x299 as `jax.image.resize(..., 'bilinear')`
    resizes, which antialiases an axis that it shrinks (pytorch-fid's
    `F.interpolate` does not).
Both change the features only once real weights are loaded.

Weights: the `.npz` that `tools/convert_inception_weights.py` (or
`python -m animeface_tpu_torch.convert_weights inception`) writes from the
pytorch-fid checkpoint, named by `ANIMEFACE_INCEPTION_WEIGHTS`; the same
file serves both packages.
'''

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch import resolve_device

WEIGHTS_ENV = 'ANIMEFACE_INCEPTION_WEIGHTS'
INPUT_SIZE = 299


class FrozenBatchNorm(nn.Module):
    '''BatchNorm with running statistics only (flax `use_running_average`).'''

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


class BasicConv2d(nn.Module):
    '''conv -> batchnorm(eps 1e-3) -> relu (torchvision BasicConv2d).'''

    def __init__(self, in_ch, features, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, padding, bias=False)
        self.bn = FrozenBatchNorm(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_cip_false(x):
    '''3x3/1 avg pool, pad 1, count_include_pad=False (pytorch-fid).'''
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, in_ch, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_cip_false(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_cip_false(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avg_pool_cip_false(x))   # avg in BOTH 7b and 7c, as in JAX
        return torch.cat([b1, b3, bd, bp], dim=1)


def resize_bilinear(x, size: int = INPUT_SIZE):
    '''NCHW `x` resized to size x size as `jax.image.resize(..., 'bilinear')`
    does: half-pixel centres, and the triangle kernel widened (antialiased)
    on an axis that shrinks. `F.interpolate` takes one antialias flag for
    both axes, so an input that grows on one axis and shrinks on the
    other is resized one axis at a time.'''
    H, W = x.shape[-2:]
    if (H, W) == (size, size):
        return x

    def resize(t, hw, antialias):
        return F.interpolate(t, size=hw, mode='bilinear', align_corners=False,
                             antialias=antialias)

    if (H < size < W) or (W < size < H):
        return resize(resize(x, (size, W), H > size), (size, size), W > size)
    return resize(x, (size, size), H > size or W > size)


class InceptionV3Features(nn.Module):
    '''images NCHW in [-1, 1] -> pool3 features [B, 2048] in f32.

    The input is resized to 299x299 (`resize_bilinear`) unless
    `resize_input` is False; [-1, 1] is pytorch-fid's normalized input.
    '''

    def __init__(self, resize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = x.float()
        if self.resize_input:
            x = resize_bilinear(x)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))            # adaptive avg pool -> [B, 2048]


def inception_weights_path() -> str | None:
    p = os.environ.get(WEIGHTS_ENV)
    return p if p and os.path.exists(p) else None


def inception_available() -> bool:
    return inception_weights_path() is not None


def _nest(flat: dict) -> dict:
    '''{'params/a/b/kernel': v, 'batch_stats/a/b/mean': v} -> the flax
    variables tree {'params': {'a': {'b': {...}}}, 'batch_stats': ...}.'''
    tree: dict = {'params': {}, 'batch_stats': {}}
    for key, val in flat.items():
        coll, _, rest = key.partition('/')
        parts = rest.split('/')
        node = tree[coll]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return tree


def load_inception_params(path: str | None = None) -> dict:
    '''The port's `state_dict` for `InceptionV3Features` from the converted
    `.npz` (see `tools/convert_inception_weights.py`), `path` or
    `$ANIMEFACE_INCEPTION_WEIGHTS`.'''
    from animeface_tpu_torch.convert import convert_inception

    path = path or inception_weights_path()
    if path is None:
        raise FileNotFoundError(
            f'InceptionV3 weights not found. Convert the pytorch-fid '
            f'checkpoint with tools/convert_inception_weights.py and set '
            f'{WEIGHTS_ENV}=<path to .npz>.')
    with np.load(path) as flat:
        return convert_inception(_nest(dict(flat)))


def make_extractor(variables=None, device=None):
    '''Returns `extract(images NCHW in [-1, 1]) -> [B, 2048]` (f32, on
    `device`, default `cuda`). `variables` is the port's state dict (see
    `load_inception_params`, which gives the default).'''
    device = resolve_device(device)
    if variables is None:
        variables = load_inception_params()
    model = InceptionV3Features()
    model.load_state_dict(variables)
    model = model.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def extract(images):
        return model(torch.as_tensor(images).to(device))

    return extract
