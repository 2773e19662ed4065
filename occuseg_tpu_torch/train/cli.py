"""Training CLI (counterpart of `scripts/train_instance.py`).

    python -m occuseg_tpu_torch.train.cli --m 64 --batch_size 4 \
        --residual_blocks --use_dense_model --plan_workers 4 \
        --lr 1e-3 --gamma 1e-2 --step_size 48000 --taskname instance_m64

Trains on one CUDA card (`train.loop.train`), then reports the semantic
eval's mean IoU. The flags are the JAX package's (`train/config.py`).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

from occuseg_tpu_torch.train.config import args_to_config, get_parser
from occuseg_tpu_torch.train.loop import evaluate_semantic, train


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Dict:
    """Parse `argv` (default: the command line), train, evaluate; returns
    the `train` result with the eval metrics under "metrics"."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    config = args_to_config(get_parser().parse_args(argv))
    if config["evaluate"]:
        raise SystemExit("use python -m occuseg_tpu_torch.evaluate_instance "
                         "for instance evaluation")
    result = train(config, device=device)
    result["metrics"] = evaluate_semantic(config, result["trainer"],
                                          result["spec"])
    logging.getLogger("occuseg_tpu_torch").info(
        "val mean IoU: %.4f", result["metrics"]["mean_iou"])
    return result


if __name__ == "__main__":
    main()
