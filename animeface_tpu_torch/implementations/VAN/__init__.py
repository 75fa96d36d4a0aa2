'''VAN GAN in PyTorch: the large-kernel-attention G and D, the recipe on the
simple-GAN trunk and its CLI.'''

from animeface_tpu_torch.implementations.VAN.utils import main  # noqa: F401
