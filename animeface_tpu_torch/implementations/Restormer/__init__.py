'''Restormer in PyTorch: the transposed-attention UNet G on NAFNet's D, step and CLI.'''

from animeface_tpu_torch.implementations.Restormer.utils import main  # noqa: F401
