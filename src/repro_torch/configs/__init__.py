"""Architecture registry of the port: importing this package registers every
config the port serves.

The six dense ``attn_mlp`` configs of the reference's registry, copied field
for field: four public ones and the paper's own two evaluation models (Table
1), the three ladder-residual twins (``configs/ladder.py``, ``LADDER``), the
encoder-decoder whisper-medium (``ENCDEC``), which the dense ``Engine``
serves, the two ``attn_moe`` configs (``MOE``) and the two recurrent ones
(``RECURRENT``: the ``hybrid`` hymba-1.5b and the mLSTM/sLSTM xlstm-350m)
and the vision-language internvl2-2b (``VLM``): every config the reference
registers.  A name registered by the reference but not yet by the port
would raise ``NotImplementedError`` from ``config.get_model_config``,
naming the ROADMAP queue A item that ports it (``UNPORTED``, empty now).
"""
from repro_torch.configs import (  # noqa: F401
    codeqwen1_5_7b,
    granite_moe_3b_a800m,
    hymba_1_5b,
    internvl2_2b,
    kimi_k2_1t_a32b,
    ladder,
    paper_30b,
    paper_70b,
    qwen3_32b,
    qwen3_4b,
    qwen3_8b,
    whisper_medium,
    xlstm_350m,
)

DENSE = ["qwen3-4b", "qwen3-8b", "qwen3-32b", "codeqwen1.5-7b", "paper-30b",
         "paper-70b"]
PAPER = ["paper-30b", "paper-70b"]
LADDER = ["ladder-qwen3-4b", "ladder-qwen3-8b", "ladder-paper-30b"]
ENCDEC = ["whisper-medium"]
MOE = ["granite-moe-3b-a800m", "kimi-k2-1t-a32b"]
RECURRENT = ["hymba-1.5b", "xlstm-350m"]
VLM = ["internvl2-2b"]
# the reference's assigned architectures, in its order: the dry run's
# ``--all`` sweep
ASSIGNED = [
    "granite-moe-3b-a800m", "qwen3-4b", "hymba-1.5b", "kimi-k2-1t-a32b",
    "xlstm-350m", "qwen3-8b", "whisper-medium", "qwen3-32b", "internvl2-2b",
    "codeqwen1.5-7b",
]

# the reference's registered names the port does not serve yet -> the
# ROADMAP queue A item that ports them (none left)
UNPORTED: dict = {}
