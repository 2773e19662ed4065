"""Instance clustering (counterpart of `occuseg_tpu/cluster/`): supervoxel
aggregation, cross-modal mean-shift, occupancy merge, joint refinement,
proposal filtering and the instance metrics."""

from occuseg_tpu_torch.cluster.supervoxel import (
    RegionFeatures,
    aggregate_regions,
)
from occuseg_tpu_torch.cluster.meanshift import meanshift_cluster
from occuseg_tpu_torch.cluster.merge import occupancy_merge
from occuseg_tpu_torch.cluster.refine import (
    joint_refine,
    region_semantic_probability,
)
from occuseg_tpu_torch.cluster.evaluator import (
    instance_average_precision,
    filter_proposals,
    instance_precision_recall,
)
