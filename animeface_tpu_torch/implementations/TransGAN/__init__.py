'''TransGAN in PyTorch: the transformer G and ViT D, the recipe on the simple-GAN
trunk and its CLI.'''

from animeface_tpu_torch.implementations.TransGAN.utils import main  # noqa: F401
