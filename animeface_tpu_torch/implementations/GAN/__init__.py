'''The vanilla MLP GAN in PyTorch: model, training step and the recipe's CLI.'''

from animeface_tpu_torch.implementations.GAN.utils import main  # noqa: F401
