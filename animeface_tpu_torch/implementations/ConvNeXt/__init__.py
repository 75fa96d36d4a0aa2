'''ConvNeXt GAN in PyTorch: the ConvNeXt-block G and ConvNeXt-T D, the recipe on
the simple-GAN trunk and its CLI.'''

from animeface_tpu_torch.implementations.ConvNeXt.utils import main  # noqa: F401
