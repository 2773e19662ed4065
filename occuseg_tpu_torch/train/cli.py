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

`--spatial_shards` D > 1 splits every batch's voxels over D ranks
(`parallel/spatial_model.py`, `--spatial_halo` / `--spatial_pool` rows
of halo and pool a shard, 4096 each by default): the CLI spawns D ranks,
or joins torchrun's group when WORLD_SIZE is D (across hosts:
`torchrun --nnodes N --nproc_per_node D/N ...`). Ranks that share a card
(D ranks on one card, or a named card) join over gloo, as NCCL refuses
two ranks on one device. It does not combine with --num_devices > 1.
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
    on a named card one rank); with --spatial_shards D > 1, D shard
    ranks, spawned unless this process is in a group already. Returns the
    `train` result with the eval metrics under "metrics"; with spawned
    ranks, rank 0's steps, losses, timings, ckpt_dir and metrics."""
    shards = int(config.get("spatial_shards") or 0)
    if shards > 1 and int(config.get("num_devices") or 0) > 1:
        raise ValueError("--spatial_shards with --num_devices > 1: spatial "
                         "sharding and data parallelism do not combine")
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if shards <= 1:
            config = dict(config, num_devices=n)
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        data_parallel.init(rank, n, "env://", device,
                           data_parallel.shared_card_backend(device,
                                                             per_host))
        try:
            return _run(config, device, max_steps)
        finally:
            dist.destroy_process_group()
    if shards > 1:
        if dist.is_initialized():
            return _run(config, device, max_steps)
        return data_parallel.spawn(
            _rank, shards, device, config, device, max_steps,
            backend=data_parallel.shared_card_backend(device, shards))[0]
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
