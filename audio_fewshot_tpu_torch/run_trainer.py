"""Train CLI: ``python -m audio_fewshot_tpu_torch.run_trainer --yaml_path
<leaf config.yaml>``, with ``--key value`` config overrides (dotted keys
such as ``--optimizer.kwargs.lr 0.01``).

Runs ``Trainer.train_loop`` on the card; ``--device cpu`` runs on the CPU
instead.  Results go to ``<result_root>/<Classifier-data-backbone-way-shot>``.
"""

import argparse

from .config import Config
from .train import Trainer


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--yaml_path", "-y", type=str, default=None,
                        help="path to the leaf config yaml")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; raises without a GPU)")
    args, rest = parser.parse_known_args(argv)
    config = Config(args.yaml_path, cli_args=rest).get_config_dict()
    trainer = Trainer(0, config, device=args.device)
    trainer.train_loop()
    return trainer


if __name__ == "__main__":
    main()
