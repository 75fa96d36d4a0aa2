'''StyleGAN2 in PyTorch: model, training step, optimizers and the recipe's CLI.'''

from animeface_tpu_torch.implementations.StyleGAN2.utils import main  # noqa: F401
