"""End-to-end serving example on the PyTorch port: the dense ``Engine`` (or
with ``--paged`` the ``PagedEngine``) with continuous batching, ISO
prefill and batched decode over several synthetic requests (the port of
``examples/serve_batch.py``).

    PYTHONPATH=src python examples/serve_batch_torch.py [--device cpu] [--paged] [--iso-off] [--preset full] [--arch hymba-1.5b]

Without ``--arch`` it serves qwen3-4b (the tiny preset unless ``--preset
full``) with 5 requests of 48-95 prompt tokens and 12 new tokens each;
every other flag goes to ``repro_torch.launch.serve``, which runs on
``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import sys

from repro_torch.launch import serve

DEFAULTS = ["--arch", "qwen3-4b", "--requests", "5", "--prompt-len", "96",
            "--max-new", "12"]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--arch") for a in argv):
        argv = DEFAULTS + argv
    return serve.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
