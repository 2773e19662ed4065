"""Semantic test-split inference and ScanNet benchmark submission files
(counterpart of `scripts/test_semantic.py`).

    python -m occuseg_tpu_torch.scripts.test_semantic --m 32 \
        --data_dir DIR --checkpoint_file CKPT_DIR --val_reps 3 \
        --out_dir submission_semantic

Runs the semantic model on each scene of the validation split: the
eval-mode logits of `val_reps` views are summed, the 20 class indices are
mapped back to NYU40 label ids (`SELECTED_LABEL_IDS`), and one
`scene<NNNN>.txt` per scene holds each real point's label id, the
benchmark's upload format. `--checkpoint_file` restores a checkpoint of
the port (`train/checkpoint.py`: a step_<N>.pth file or a directory of
them). As in the JAX script, the model sees no normals.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from occuseg_tpu_torch.infer import Predictor, prepare_scene
from occuseg_tpu_torch.train import checkpoint as ckpt
from occuseg_tpu_torch.train.config import args_to_config, get_parser
from occuseg_tpu_torch.train.loop import (
    _device,
    build_model,
    build_spec,
    checkpoint_path,
    get_dataset,
)

log = logging.getLogger("occuseg_tpu_torch")

# 20-class index -> NYU40 label id (the reference's test.py)
SELECTED_LABEL_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24,
                      28, 33, 34, 36, 39]


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> List[str]:
    """Parse `argv` (default: the command line) and write the files;
    returns their paths."""
    logging.basicConfig(level=logging.INFO)
    parser = get_parser()
    parser.add_argument("--out_dir", default="submission_semantic")
    args = parser.parse_args(argv)
    config = args_to_config(args)
    dev = _device(device)

    model = build_model(config, torch.Generator().manual_seed(0))
    spec = build_spec(config)
    dataset = get_dataset(config)
    p_cap, i_cap = config["point_cap"], config["instance_cap"]
    reps = max(int(config.get("val_reps", 1)), 1)
    if config.get("load"):
        path = checkpoint_path(str(config["load"]))
        model.load_state_dict(ckpt.restore_checkpoint(
            path, map_location="cpu")["model"])
        log.info("restored %s", path)
    predictor = Predictor(model, dev)
    chunks = bool(config.get("chunk_conv", 1))

    os.makedirs(args.out_dir, exist_ok=True)
    ids = np.asarray(SELECTED_LABEL_IDS, np.int64)
    written = []
    per_rep = [dataset.val_batches(p_cap, i_cap, 1, val_rep=r)
               for r in range(reps)]
    for si, raws in enumerate(zip(*per_rep)):
        store = None
        for raw in raws:
            scene = prepare_scene(raw["coords"], raw["features"], spec,
                                  chunks=chunks)
            logits = predictor(scene).semantics.float()
            store = logits if store is None else store + logits
        valid = np.asarray(raws[-1]["coords"])[:, 0] >= 0
        labels = ids[store.argmax(-1).cpu().numpy()]
        fn = os.path.join(args.out_dir, f"scene{si:04d}.txt")
        np.savetxt(fn, labels[valid], fmt="%d")
        log.info("wrote %s (%d points)", fn, int(valid.sum()))
        written.append(fn)
    return written


if __name__ == "__main__":
    main()
