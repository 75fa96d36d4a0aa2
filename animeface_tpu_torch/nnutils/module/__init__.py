'''Layer helpers of the port (counterpart of animeface_tpu.nnutils.module).'''
from animeface_tpu_torch.nnutils.module.layers import PReLU, get_activation  # noqa: F401
