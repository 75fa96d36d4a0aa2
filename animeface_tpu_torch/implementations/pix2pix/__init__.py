'''pix2pix in PyTorch: the UNet G, the conditional patch D, the recipe's step and its CLI.'''

from animeface_tpu_torch.implementations.pix2pix.utils import main  # noqa: F401
