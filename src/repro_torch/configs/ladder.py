"""Ladder-residual twins of registered dense configs (copy of
``repro/configs/ladder.py``; PAPERS.md, arXiv 2501.06589).

Same shapes, parameter layout and head counts as the base config; only the
residual-stream wiring differs (``ModelConfig.residual_wiring="ladder"``):
stage k reads the residual as of stage k-2, so stage k-1's TP all-reduce
completes behind stage k's compute (``core/iso.run_layer(ladder=True)`` in
prefill, ``run_stack_decode_ladder`` in decode).  A ladder config is a
DIFFERENT model function from its base, so the tests hold deferred against
immediate collectives of the same ladder function, and the port against
the reference, never ladder against standard.  ``ladder-<name>``'s twin is
``<name>``; its weights have the twin's layout.
"""
from repro_torch.config import ladder_variant, register
from repro_torch.configs import paper_30b, qwen3_4b, qwen3_8b


@register("ladder-qwen3-4b")
def config_ladder_qwen3_4b():
    return ladder_variant(qwen3_4b.config())


@register("ladder-qwen3-8b")
def config_ladder_qwen3_8b():
    return ladder_variant(qwen3_8b.config())


@register("ladder-paper-30b")
def config_ladder_paper_30b():
    return ladder_variant(paper_30b.config())
