from occuseg_tpu_torch.models.occuseg import (  # noqa: F401
    ClusterSegNet,
    DenseUNet_BN,
    InstanceDenseUNet,
    LearningBWDenseUNet,
    OccuSegOutputs,
    ThreeVoxelKernel,
)
from occuseg_tpu_torch.models.minkunet import (  # noqa: F401
    MinkUNet,
    MinkUNet34C,
    SemanticOutputs,
)
