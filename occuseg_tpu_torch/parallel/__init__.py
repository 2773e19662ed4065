"""Parallel training and inference (counterpart of
`occuseg_tpu/parallel/`): data parallelism over ranks
(`data_parallel.py`) and spatial sharding, one scene's voxels split over
ranks (`spatial.py` the shard planner, `comm.py` the exchanges and sums,
`spatial_model.py` the sharded forward, inference and step). Multi-host
runs join torchrun's process group (`train/cli.py`) in place of
`occuseg_tpu/parallel/multihost.py`."""

from occuseg_tpu_torch.parallel.comm import (  # noqa: F401
    all_max,
    all_sum,
    extend_features,
    halo_exchange,
)
from occuseg_tpu_torch.parallel.data_parallel import (  # noqa: F401
    allreduce_step,
    dp_groups,
    spawn,
)
from occuseg_tpu_torch.parallel.spatial import (  # noqa: F401
    ShardedPlan,
    shard_level,
    shard_plan,
    sharded_gather_conv,
)
from occuseg_tpu_torch.parallel.spatial_model import (  # noqa: F401
    ShardArgs,
    build_spatial_topology,
    prepare_shard_args,
    sharded_infer,
    sharded_train_forward,
)
