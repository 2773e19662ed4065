from occuseg_tpu_torch.nn.modules import (  # noqa: F401
    AveragePooling,
    BatchNormalization,
    BatchNormLeakyReLU,
    BatchNormReLU,
    BLInputLayer,
    BLOutputLayer,
    Convolution,
    Deconvolution,
    InputLayer,
    MaxPooling,
    NetworkInNetwork,
    OutputLayer,
    SubmanifoldConvolution,
    UnPooling,
)
from occuseg_tpu_torch.nn.unet import (  # noqa: F401
    FullyConvolutionalNet,
    SparseResNet,
    SparseVggNet,
    UNet,
)
