"""Training CLI of the port, the counterpart of ``mdvit_tpu/cli.py``::

    python -m mdvit_tpu_torch.cli --exp_name mdvit_f4 --model MDViT \\
        --batch_size 4 --dataset isic2018 PH2 DMF SKD --k_fold 4

Synthetic smoke run (no data on disk)::

    python -m mdvit_tpu_torch.cli --exp_name smoke --model MDViT --synthetic --debug

``--model`` takes the paper's model family: BASE, BASE_DSN, BASE_DASE,
BASE_USE (single objective), MDViT and MDViT_DSN (MKD); ``--adapt_method
False`` drops the Sup gate, and ``model_kwargs: {decoder_name: MLP |
DeepLabV3 | Transformer}`` in the config picks MDViT's debranch::

    python -m mdvit_tpu_torch.cli --exp_name dsn --model BASE_DSN --synthetic --debug

It trains on the card (``device: cuda``, the default); a config file with
``device: cpu`` runs it on the CPU through the kernels' plain versions.
``--exp_dir`` names a fixed experiment dir, which a second run resumes from
its ``last.pt``; ``test.only_test`` only evaluates.

Data parallelism: under torchrun each process joins the process group its
environment describes (NCCL on ``cuda:{LOCAL_RANK}``, gloo with ``device:
cpu``) and the Trainer splits every batch over the first n ranks
(``tpu.mesh.data`` caps n)::

    torchrun --nproc_per_node=8 -m mdvit_tpu_torch.cli --exp_name dp --model MDViT

``--distributed`` (``tpu.distributed``) asks for torchrun's multi-node
rendezvous and fails without it.
"""
from __future__ import annotations

import os
import time

import torch.distributed as dist

from mdvit_tpu_torch.config import build_argparser, check_supported, config_from_args
from mdvit_tpu_torch.parallel.mesh import init_distributed
from mdvit_tpu_torch.train.trainer import Trainer, data_parallel_mesh


def main(argv: list[str] | None = None) -> Trainer | None:
    """Train and test as the arguments say; returns the Trainer, or None on a
    rank outside the data-parallel group."""
    args = build_argparser().parse_args(argv)
    config = config_from_args(args)
    # num_domains follows the dataset list
    config.model_adapt.num_domains = len(config.data.name)
    check_supported(config)
    init_distributed(config.get("device"))
    if args.exp_dir:
        exp_dir = args.exp_dir
    else:
        stamp = [time.strftime("%Y%m%d_%H%M")]
        if dist.is_initialized():  # one dir for all ranks: rank 0's clock
            dist.broadcast_object_list(stamp, src=0)
        exp_dir = os.path.join(
            args.results_dir, f"{args.exp_name}_{config.model}_{stamp[0]}_fold{config.data.k_fold}")
    mesh = data_parallel_mesh(config)
    if not mesh.member:
        print(f"rank {mesh.rank}: the data-parallel group is ranks 0..{mesh.size - 1} "
              "(the largest divisor of D·B within the world and tpu.mesh.data); "
              "this rank takes no part")
        return None
    trainer = Trainer(config, exp_dir, mesh)
    if config.test.only_test:
        trainer.test(config.test.test_model_dir or None)
        return trainer
    trainer.maybe_resume()
    trainer.fit()
    trainer.test()
    return trainer


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
