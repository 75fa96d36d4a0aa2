'''Ops of the PyTorch port (counterpart of animeface_tpu.ops).'''

from animeface_tpu_torch.ops.registry import (  # noqa: F401
    set_default_impl, get_default_impl, resolve_impl)
from animeface_tpu_torch.ops.upfirdn2d import (  # noqa: F401
    setup_filter, upfirdn2d, filter2d, upsample2d, downsample2d)
from animeface_tpu_torch.ops.bias_act import activation_funcs, bias_act  # noqa: F401
from animeface_tpu_torch.ops.conv2d_resample import conv2d_resample  # noqa: F401
from animeface_tpu_torch.ops.filtered_lrelu import filtered_lrelu  # noqa: F401
