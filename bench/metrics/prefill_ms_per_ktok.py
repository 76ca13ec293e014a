"""Fenced prefill time per thousand real prompt tokens over the window:
the engine's ``prefill_s`` (each call waits for the card) over its
``prefill_tokens``."""

SOURCE = "program_counter"


def read(run):
    toks = run.delta("prefill_tokens")
    if toks <= 0:
        return None
    return 1e6 * run.delta("prefill_s") / toks
