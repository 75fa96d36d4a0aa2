'''WGAN-gp in PyTorch (DCGAN's models): its steps and the recipe's CLI.'''

from animeface_tpu_torch.implementations.WGAN_gp.utils import main  # noqa: F401
