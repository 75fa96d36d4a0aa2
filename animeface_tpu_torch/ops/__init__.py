'''Ops of the PyTorch port (counterpart of animeface_tpu.ops).'''

from animeface_tpu_torch.ops.upfirdn2d import (  # noqa: F401
    setup_filter, upfirdn2d, filter2d, upsample2d, downsample2d)
