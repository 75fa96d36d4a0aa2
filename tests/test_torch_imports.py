'''The port imports nothing of JAX or of the JAX package, nor sklearn or
PIL at module level (the card machine may lack them: the label encoders
and the hue jitter are numpy, PIL decodes only on demand), and its entry
points refuse a missing card instead of falling back to the CPU.'''

import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

GUARD = '''
import importlib, pkgutil, sys
for name in ('jax', 'jaxlib', 'flax', 'optax', 'animeface_tpu', 'sklearn', 'PIL'):
    sys.modules[name] = None          # any import of these now raises
import animeface_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(animeface_tpu_torch.__path__,
                                              'animeface_tpu_torch.')]
for name in mods:
    importlib.import_module(name)
import chip_smoke, time_line_kernels, time_flrelu_kernel, time_bias_act_kernel
import time_progressive_blur, time_chip_smoke_parts
print(' '.join(mods))
'''

#: modules that must be among those the guard imported
REQUIRED = (
    'animeface_tpu_torch.nnutils.ada_geometry_cuda',
    'animeface_tpu_torch.nnutils.diffaugment',
    'animeface_tpu_torch.ops.activations',
    'animeface_tpu_torch.ops.bias_act',
    'animeface_tpu_torch.ops.conv2d_resample',
    'animeface_tpu_torch.ops.filtered_lrelu',
    'animeface_tpu_torch.ops.registry',
    'animeface_tpu_torch.ops.cuda_kernels',
    'animeface_tpu_torch.implementations.CIPS.model',
    'animeface_tpu_torch.implementations.CIPS.utils',
    'animeface_tpu_torch.implementations.StyleGAN2.utils',
    'animeface_tpu_torch.implementations.StyleGAN3.model',
    'animeface_tpu_torch.implementations.StyleGAN3.utils',
    'animeface_tpu_torch.implementations.ADA.utils',
    'animeface_tpu_torch.implementations.FastGAN.model',
    'animeface_tpu_torch.implementations.FastGAN.utils',
    'animeface_tpu_torch.implementations.DCGAN.model',
    'animeface_tpu_torch.implementations.DCGAN.utils',
    'animeface_tpu_torch.implementations.GAN.model',
    'animeface_tpu_torch.implementations.GAN.utils',
    'animeface_tpu_torch.implementations.WGAN.utils',
    'animeface_tpu_torch.implementations.WGAN_gp.utils',
    'animeface_tpu_torch.implementations.PGGAN.config',
    'animeface_tpu_torch.implementations.PGGAN.model',
    'animeface_tpu_torch.implementations.PGGAN.utils',
    'animeface_tpu_torch.implementations.StyleGAN.model',
    'animeface_tpu_torch.implementations.StyleGAN.utils',
    'animeface_tpu_torch.nnutils.loss.penalty',
    'animeface_tpu_torch.nnutils.initialize',
    'animeface_tpu_torch.nnutils.module',
    'animeface_tpu_torch.nnutils.module.layers',
    'animeface_tpu_torch.nnutils.spectral_norm',
    'animeface_tpu_torch.implementations.BigGAN.model',
    'animeface_tpu_torch.implementations.BigGAN.utils',
    'animeface_tpu_torch.implementations.SEBigGAN.model',
    'animeface_tpu_torch.implementations.SEBigGAN.utils',
    'animeface_tpu_torch.nnutils.batchnorm',
    'animeface_tpu_torch.nnutils.optim',
    'animeface_tpu_torch.__main__',
    'animeface_tpu_torch.checkpoint',
    'animeface_tpu_torch.dataset',
    'animeface_tpu_torch.dataset._base',
    'animeface_tpu_torch.dataset.animeface',
    'animeface_tpu_torch.dataset.native',
    'animeface_tpu_torch.dataset.synthetic',
    'animeface_tpu_torch.nnutils.accelerate',
    'animeface_tpu_torch.nnutils.trainer',
    'animeface_tpu_torch.utils',
    'animeface_tpu_torch.utils.argument',
    'animeface_tpu_torch.utils.misc',
    'animeface_tpu_torch.utils.status',
    'animeface_tpu_torch.convert_weights',
    'animeface_tpu_torch.metrics',
    'animeface_tpu_torch.metrics.fid',
    'animeface_tpu_torch.metrics.inception',
    'animeface_tpu_torch.metrics.trend',
    'animeface_tpu_torch.metrics.fid_cli',
    'animeface_tpu_torch.metrics.fid_trend',
    'animeface_tpu_torch.nnutils.loss.vgg',
    'animeface_tpu_torch.generate',
    'animeface_tpu_torch.nnutils.simple_gan',
    'animeface_tpu_torch.nnutils.module.linen',
    'animeface_tpu_torch.implementations.TransGAN.model',
    'animeface_tpu_torch.implementations.TransGAN.utils',
    'animeface_tpu_torch.implementations.HiT.model',
    'animeface_tpu_torch.implementations.HiT.utils',
    'animeface_tpu_torch.implementations.ConvNeXt.model',
    'animeface_tpu_torch.implementations.ConvNeXt.utils',
    'animeface_tpu_torch.implementations.VAN.model',
    'animeface_tpu_torch.implementations.VAN.utils',
    'animeface_tpu_torch.dataset.portrait',
    'animeface_tpu_torch.dataset.danbooru',
    'animeface_tpu_torch.dataset.aahq',
    'animeface_tpu_torch.nnutils.paired',
    'animeface_tpu_torch.implementations.pix2pix.model',
    'animeface_tpu_torch.implementations.pix2pix.utils',
    'animeface_tpu_torch.implementations.SRGAN.model',
    'animeface_tpu_torch.implementations.SRGAN.utils',
    'animeface_tpu_torch.implementations.ESRGAN.model',
    'animeface_tpu_torch.implementations.ESRGAN.utils',
    'animeface_tpu_torch.implementations.NAFNet.model',
    'animeface_tpu_torch.implementations.NAFNet.utils',
    'animeface_tpu_torch.implementations.Restormer.model',
    'animeface_tpu_torch.implementations.Restormer.utils',
    'animeface_tpu_torch.implementations.pix2pixHD.model',
    'animeface_tpu_torch.implementations.pix2pixHD.utils',
    'animeface_tpu_torch.implementations.CycleGAN.model',
    'animeface_tpu_torch.implementations.CycleGAN.utils',
    'animeface_tpu_torch.utils.branches',
    'animeface_tpu_torch.ops.grid_sample',
    'animeface_tpu_torch.implementations.normalizations.model',
    'animeface_tpu_torch.implementations.normalizations.utils',
    'animeface_tpu_torch.implementations.SPADE.model',
    'animeface_tpu_torch.implementations.SPADE.utils',
    'animeface_tpu_torch.implementations.SCFT.model',
    'animeface_tpu_torch.implementations.SCFT.tps',
    'animeface_tpu_torch.implementations.SCFT.utils',
)


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, '-c', GUARD], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 23 and not set(REQUIRED) - mods, sorted(set(REQUIRED) - mods)


def test_cuda_request_without_card_raises(monkeypatch):
    from animeface_tpu_torch import resolve_device
    from animeface_tpu_torch.implementations.ADA.utils import build_training, default_args
    from animeface_tpu_torch.nnutils.ada import ada_init_state
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        ada_init_state(8)
    with pytest.raises(RuntimeError):
        build_training(default_args())
    assert resolve_device('cpu') == torch.device('cpu')
    assert ada_init_state(8, device='cpu')['p'].device == torch.device('cpu')
