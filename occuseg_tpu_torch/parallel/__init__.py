"""Parallel training (counterpart of `occuseg_tpu/parallel/`): data
parallelism over ranks (`data_parallel.py`). Spatial sharding and
multi-host are not ported yet (ROADMAP A item 5)."""
