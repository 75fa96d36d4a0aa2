'''SCFT in PyTorch: the sketch and reference encoders, the SCFT attention,
the zip decoder, the patch D, the TPS warp, the triplet step and its CLI.'''

from animeface_tpu_torch.implementations.SCFT.utils import main  # noqa: F401
