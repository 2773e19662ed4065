"""occuseg_tpu_torch — OccuSeg inference and training in PyTorch and CUDA.

A port of `occuseg_tpu` (JAX on a TPU) to PyTorch on an NVIDIA Hopper card.
The module layout mirrors the JAX package so each counterpart is easy to
find: `native/` (ctypes binding to the shared C++ host planner,
`csrc/native.cpp`), `core/` (host plan types, sorted point layout, sparse
tensor), `data/` (synthetic scenes), `ops/` (BN, NIN, pooling and the
hand-written CUDA kernels under `ops/kernels/`), `nn/` (sparse modules and
the UNet), `models/` (the OccuSeg model family), `losses/` (the 6-term
training loss), `train/` (optimizer, host batch preparation, the training
step, the loop, checkpoints and the CLI), `utils/` (metrics, counters),
`cluster/` (supervoxel aggregation, mean-shift, occupancy merge, joint
refinement, proposals and the instance metrics), `parallel/` (data
parallelism over ranks), `convert.py` (flax weights to a state_dict),
`infer.py` (host preparation and the predictor), `evaluate_instance.py`
(the instance-evaluation entry point), `legacy.py` (the
sparseconvnet-compatible facade) and `scripts/` (semantic training and
test, the offline judge, the checkpoint-parity gate).

This package imports torch and numpy only — never jax, flax or
`occuseg_tpu`, whose import turns on jax's x64 mode.
"""

__version__ = "0.1.0"
