"""Share of the prefill calls' token rows that were padding (grant
bucketing and pack rows), over the window: the engine's counters
``prefill_pad_tokens / (prefill_tokens + prefill_pad_tokens)``."""

SOURCE = "program_counter"


def read(run):
    pad, real = run.delta("prefill_pad_tokens"), run.delta("prefill_tokens")
    if pad + real <= 0:
        return None
    return 100.0 * pad / (pad + real)
