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
"""
from __future__ import annotations

import os
import time

from mdvit_tpu_torch.config import build_argparser, config_from_args
from mdvit_tpu_torch.train.trainer import Trainer


def main(argv: list[str] | None = None) -> Trainer:
    args = build_argparser().parse_args(argv)
    config = config_from_args(args)
    # num_domains follows the dataset list
    config.model_adapt.num_domains = len(config.data.name)
    if args.exp_dir:
        exp_dir = args.exp_dir
    else:
        stamp = time.strftime("%Y%m%d_%H%M")
        exp_dir = os.path.join(
            args.results_dir, f"{args.exp_name}_{config.model}_{stamp}_fold{config.data.k_fold}")
    trainer = Trainer(config, exp_dir)
    if config.test.only_test:
        trainer.test(config.test.test_model_dir or None)
        return trainer
    trainer.maybe_resume()
    trainer.fit()
    trainer.test()
    return trainer


if __name__ == "__main__":
    main()
