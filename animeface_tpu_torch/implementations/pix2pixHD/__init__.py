'''pix2pixHD in PyTorch: the coarse-to-fine G, the multi-scale D, the two-phase step and its CLI.'''

from animeface_tpu_torch.implementations.pix2pixHD.utils import main  # noqa: F401
