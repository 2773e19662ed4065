"""Metrics and counters (counterpart of `occuseg_tpu/utils/`)."""
