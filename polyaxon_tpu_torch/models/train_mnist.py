"""MNIST trainer, the BASELINE's configuration 1 entry point:
``python -m polyaxon_tpu_torch.models.train_mnist``.

Port of ``polyaxon_tpu/models/train_mnist.py``: a preset over the generic
trainer (``polyaxon_tpu_torch.train``) — the MLP classifier trained on
real data by default, the offline ``digits`` image set with its held-out
eval split, evaluated every 40 steps, 8 epochs (MNIST itself plugs in
through ``--data-dir``).  Every flag of the trainer is accepted.
"""

from __future__ import annotations

import sys

from ..train import build_argparser
from ..train import main as train_main


def main(argv=None) -> int:
    parser = build_argparser()
    parser.set_defaults(model="mlp", optimizer="adamw", log_every=10,
                        dataset="digits", epochs=8, eval_every=40)
    args = parser.parse_args(argv)
    forwarded = []
    for key, value in vars(args).items():
        flag = "--" + key.replace("_", "-")
        if isinstance(value, bool):
            if key == "resume" and not value:
                forwarded.append("--no-resume")
            elif value and key != "resume":
                forwarded.append(flag)
        elif value is not None:
            forwarded.extend([flag, str(value)])
    return train_main(forwarded)


if __name__ == "__main__":
    sys.exit(main())
