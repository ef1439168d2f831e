from brushstroke_engine_torch.ops.filters import setup_filter
from brushstroke_engine_torch.ops.upfirdn import (
    upfirdn2d,
    filter2d,
    upsample2d,
    downsample2d,
)
from brushstroke_engine_torch.ops.biasact import bias_act, activation_gain, ACTIVATIONS
from brushstroke_engine_torch.ops.conv import conv2d_resample, modulated_conv2d
from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
from brushstroke_engine_torch.ops.noise import wrapped_const_noise
