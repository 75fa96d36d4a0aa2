'''Layer helpers of the port (counterpart of animeface_tpu.nnutils.module).'''
from animeface_tpu_torch.nnutils.module.layers import (  # noqa: F401
    PReLU, get_activation, get_normalization)
