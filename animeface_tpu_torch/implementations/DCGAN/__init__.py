'''DCGAN in PyTorch: model, training step and the recipe's CLI.'''

from animeface_tpu_torch.implementations.DCGAN.utils import main  # noqa: F401
