"""The benchmark's plain reference: voxels, neighbours and rulebooks
worked out again from the coordinates (`sparse.py`), the sparse UNet and
its heads (`model.py`), the six-term loss (`loss.py`) and the training
step (`train.py`), in plain PyTorch. Nothing here imports the program."""
