'''StyleGAN3 in PyTorch: model, training step, optimizers and the recipe's CLI.'''

from animeface_tpu_torch.implementations.StyleGAN3.utils import main  # noqa: F401
