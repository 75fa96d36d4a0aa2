'''HiT in PyTorch: the multi-axis-attention G and the residual D, the recipe on
the simple-GAN trunk and its CLI.'''

from animeface_tpu_torch.implementations.HiT.utils import main  # noqa: F401
