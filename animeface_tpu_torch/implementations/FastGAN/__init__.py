'''FastGAN in PyTorch: the SLE generator, the self-supervised D, the recipe's step and its CLI.'''

from animeface_tpu_torch.implementations.FastGAN.utils import main  # noqa: F401
