"""Resume CLI: ``python -m audio_fewshot_tpu_torch.run_trainer_resume
<result_dir>``, with ``--key value`` config overrides (e.g. ``--epoch 40``
to train further).

Reads the run's merged ``config.yaml`` and its
``checkpoints/model_last.pth`` (weights, optimizer and scheduler state, best
accuracies) and continues at the epoch after the saved one, on the card;
``--device cpu`` runs on the CPU instead.
"""

import argparse
import os

from .config import Config
from .train import Trainer


def build_trainer(argv=None) -> Trainer:
    """The resumed ``Trainer``, before its loop runs."""
    parser = argparse.ArgumentParser()
    parser.add_argument("result_path", help="result dir of the run to resume")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; raises without a GPU)")
    args, rest = parser.parse_known_args(argv)
    config = Config(os.path.join(args.result_path, "config.yaml"), is_resume=True,
                    cli_args=rest).get_config_dict()
    config["resume_path"] = args.result_path
    return Trainer(0, config, device=args.device)


def main(argv=None) -> Trainer:
    trainer = build_trainer(argv)
    trainer.train_loop()
    return trainer


if __name__ == "__main__":
    main()
