'''The vanilla MLP GAN in PyTorch.

Counterpart of `animeface_tpu/implementations/GAN/model.py`: G dense
layers of 128, 256, 512 and 1024 features, flax BatchNorm with eps 0.8 on
the last three (the reference's `BatchNorm1d(out_feat, 0.8)`;
`nnutils/batchnorm.py`), leaky ReLU 0.2 with `jax.nn.leaky_relu`'s gradient
at 0, then a dense layer to the image through tanh; D dense layers of 512
and 256 features with leaky ReLU and one logit, no BatchNorm. Dense layers
are flax's: lecun-normal kernels, zero biases, run in the compute `dtype`;
the images and the logits come back in float32.

`image_shape` is (C, H, W): G writes and D flattens an NCHW image, where
the JAX package's G writes and its D flattens NHWC; the converter permutes
G's last and D's first dense weights (`convert.convert_gan_generator`,
`convert_gan_discriminator`).
'''

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.batchnorm import BatchNorm
from animeface_tpu_torch.ops.activations import leaky_relu


class Dense(nn.Module):
    '''flax `nn.Dense` in the compute dtype; weight [out, in].'''

    def __init__(self, in_features, features, dtype=torch.float32, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn((features, in_features), generator=generator)
                                   / math.sqrt(in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class Generator(nn.Module):
    '''z [B, latent] -> images [B, *image_shape] float32 in [-1, 1].'''

    def __init__(self, latent_dim=100, image_shape=(3, 64, 64), dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.latent_dim, self.image_shape = latent_dim, tuple(image_shape)
        feats = [latent_dim, 128, 256, 512, 1024, math.prod(self.image_shape)]
        self.layers = nn.ModuleList(Dense(i, o, dtype, generator)
                                    for i, o in zip(feats[:-1], feats[1:]))
        self.norms = nn.ModuleList(BatchNorm(f, eps=0.8, dtype=dtype) for f in feats[2:5])

    def forward(self, z, train: bool = True):
        x = leaky_relu(self.layers[0](z), 0.2)
        for layer, norm in zip(self.layers[1:-1], self.norms):
            x = leaky_relu(norm(layer(x), train), 0.2)
        x = torch.tanh(self.layers[-1](x))
        return x.reshape((x.shape[0],) + self.image_shape).float()


class Discriminator(nn.Module):
    '''images [B, *image_shape] -> logits [B, 1] float32.'''

    def __init__(self, image_shape=(3, 64, 64), dtype=torch.float32, generator=None):
        super().__init__()
        feats = [math.prod(image_shape), 512, 256, 1]
        self.layers = nn.ModuleList(Dense(i, o, dtype, generator)
                                    for i, o in zip(feats[:-1], feats[1:]))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for layer in self.layers[:-1]:
            x = leaky_relu(layer(x), 0.2)
        return self.layers[-1](x).float()
