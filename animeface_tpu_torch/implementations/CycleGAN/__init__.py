'''CycleGAN in PyTorch: two ResNet Gs, two PatchGAN Ds, the cycle step and its CLI.'''

from animeface_tpu_torch.implementations.CycleGAN.utils import main  # noqa: F401
