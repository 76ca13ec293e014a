"""End-to-end training example on the PyTorch port: trains a reduced
qwen3-family model on the synthetic LM pipeline with the full train step
(AdamW, grad clip, cosine schedule, checkpointing) (the port of
``examples/train_small.py``).

    PYTHONPATH=src python examples/train_small_torch.py [--device cpu] [--steps 40] [--ckpt DIR]

Without ``--arch`` it trains qwen3-4b's tiny preset for 40 steps of 4 x
128 tokens; every other flag goes to ``repro_torch.launch.train``, which
runs on ``cuda`` unless ``--device cpu`` is given (``--preset full``
trains qwen3-4b at its published widths, ~50 GiB of weights, gradients and
fp32 moments on one card).
"""
from __future__ import annotations

import sys

from repro_torch.launch import train

DEFAULTS = ["--arch", "qwen3-4b", "--preset", "tiny", "--steps", "40",
            "--seq-len", "128", "--batch", "4", "--log-every", "5"]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--arch") for a in argv):
        argv = DEFAULTS + argv
    return train.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
