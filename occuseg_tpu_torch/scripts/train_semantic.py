"""Semantic-only training (counterpart of `scripts/train_semantic.py`).

    python -m occuseg_tpu_torch.scripts.train_semantic --m 32 \
        --data_dir DIR [the training CLI's flags]

Trains the `InstanceDenseUNet` (no bw or occupancy heads) with the
training CLI's loop (`train.cli.run`, every flag of `train.cli` included,
--num_devices too), then logs the semantic eval's mean IoU.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

from occuseg_tpu_torch.train import cli
from occuseg_tpu_torch.train.config import args_to_config, get_parser


def main(argv: Optional[Sequence[str]] = None, device="cuda",
         max_steps: Optional[int] = None) -> Dict:
    """Parse `argv` (default: the command line), train (at most
    `max_steps` steps; data-parallel over --num_devices ranks as
    `train.cli.run`), evaluate; returns the `train` result with the eval
    metrics under "metrics"."""
    logging.basicConfig(level=logging.INFO)
    config = args_to_config(get_parser().parse_args(argv))
    config["use_dense_model"] = False   # InstanceDenseUNet, no bw heads
    return cli.run(config, device, max_steps)


if __name__ == "__main__":
    main()
