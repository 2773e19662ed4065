"""Training CLI (counterpart of `scripts/train_instance.py`).

    python -m occuseg_tpu_torch.train.cli --m 64 --batch_size 4 \
        --residual_blocks --use_dense_model --plan_workers 4 \
        --lr 1e-3 --gamma 1e-2 --step_size 48000 --taskname instance_m64

Trains (`train.loop.train`), then reports the semantic eval's mean IoU.
The flags are the JAX package's (`train/config.py`). `--num_devices` n
(default: every visible card, at most that many; one on a named card,
device="cuda:N") trains data-parallel: the CLI spawns n ranks, one
process per card, joined over NCCL (gloo on the CPU), each taking
batch_size / n scenes a step. Launched by torchrun
(WORLD_SIZE set), each process is one rank of torchrun's group instead:

    torchrun --nproc_per_node 4 -m occuseg_tpu_torch.train.cli --m 64 ...
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import torch.distributed as dist

from occuseg_tpu_torch.parallel import data_parallel
from occuseg_tpu_torch.train.config import args_to_config, get_parser
from occuseg_tpu_torch.train.loop import evaluate_semantic, train

log = logging.getLogger("occuseg_tpu_torch")


def _logging() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")


def _run(config: Dict, device, max_steps: Optional[int]) -> Dict:
    """Train, then (on rank 0) evaluate: the `train` result with the eval
    metrics under "metrics" (None on the other ranks)."""
    result = train(config, max_steps=max_steps, device=device)
    result["metrics"] = None
    if not dist.is_initialized() or dist.get_rank() == 0:
        result["metrics"] = evaluate_semantic(config, result["trainer"],
                                              result["spec"])
        log.info("val mean IoU: %.4f", result["metrics"]["mean_iou"])
    return result


def _rank(rank: int, world_size: int, config: Dict, device,
          max_steps: Optional[int]) -> Optional[Dict]:
    """One spawned rank: what rank 0's run returns that pickles."""
    _logging()
    result = _run(config, device, max_steps)
    if rank != 0:
        return None
    return {k: result[k] for k in ("steps", "losses", "timings", "ckpt_dir",
                                   "metrics")}


def run(config: Dict, device="cuda", max_steps: Optional[int] = None
        ) -> Dict:
    """Train `config` (at most `max_steps` steps), then evaluate, as
    --num_devices asks: under torchrun (WORLD_SIZE set) as this process's
    rank of torchrun's group; otherwise n = `data_parallel.num_devices`
    ranks, spawned when n > 1 (on "cuda" every visible card by default,
    on a named card one rank). Returns the `train` result with the eval
    metrics under "metrics"; with spawned ranks, rank 0's steps, losses,
    timings, ckpt_dir and metrics."""
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        config = dict(config, num_devices=n)
        data_parallel.init(rank, n, "env://", device)
        try:
            return _run(config, device, max_steps)
        finally:
            dist.destroy_process_group()
    n = data_parallel.num_devices(config.get("num_devices"), device)
    if n != int(config.get("num_devices") or n):
        log.warning("--num_devices %s on %s: %d rank(s)",
                    config["num_devices"], device, n)
    config = dict(config, num_devices=n)
    if n > 1 and not dist.is_initialized():
        return data_parallel.spawn(_rank, n, device, config, device,
                                   max_steps)[0]
    return _run(config, device, max_steps)


def main(argv: Optional[Sequence[str]] = None, device="cuda",
         max_steps: Optional[int] = None) -> Dict:
    """Parse `argv` (default: the command line), then `run`."""
    _logging()
    config = args_to_config(get_parser().parse_args(argv))
    if config["evaluate"]:
        raise SystemExit("use python -m occuseg_tpu_torch.evaluate_instance "
                         "for instance evaluation")
    return run(config, device, max_steps)


if __name__ == "__main__":
    main()
