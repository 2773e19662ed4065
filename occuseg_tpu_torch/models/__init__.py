from occuseg_tpu_torch.models.occuseg import (  # noqa: F401
    ClusterSegNet,
    DenseUNet_BN,
    InstanceDenseUNet,
    LearningBWDenseUNet,
    OccuSegOutputs,
    ThreeVoxelKernel,
)
