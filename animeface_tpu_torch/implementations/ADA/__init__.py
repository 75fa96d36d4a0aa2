'''The ADA recipe (StyleGAN3 + AugmentPipe) in PyTorch: its training step and CLI.'''

from animeface_tpu_torch.implementations.ADA.utils import main  # noqa: F401
