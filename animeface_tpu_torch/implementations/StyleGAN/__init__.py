'''StyleGAN (v1) in PyTorch: the style-based progressive-growing model, its
training step on PGGAN's phase machine, and the recipe's CLI.'''

from animeface_tpu_torch.implementations.StyleGAN.utils import main  # noqa: F401
