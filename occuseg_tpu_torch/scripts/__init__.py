"""Entry-point scripts (counterparts of the JAX repo's `scripts/`), each
run as `python -m occuseg_tpu_torch.scripts.<name>`: `train_semantic`,
`test_semantic`, `fake_judge` and `checkpoint_parity`."""
