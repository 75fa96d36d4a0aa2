'''BigGAN in PyTorch: the unconditional BigGAN and BigGAN-deep models, the recipe's step and its CLI.'''

from animeface_tpu_torch.implementations.BigGAN.utils import main  # noqa: F401
