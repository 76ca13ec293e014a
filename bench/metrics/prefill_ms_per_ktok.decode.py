"""``prefill_ms_per_ktok`` in a cell measured by its decode throughput:
the fenced prefill time per thousand real prompt tokens over the window
(the engine's ``prefill_s`` over its ``prefill_tokens``).  Where grant
calls share the steps with decode, as in trinity-mini.mixed-chat (a
1,024-token grant streams every expert of every MoE layer), each grant
call's time holds up every decoding request, so this moves
``output_tokens_per_s``."""

SOURCE = "program_counter"


def read(run):
    toks = run.delta("prefill_tokens")
    if toks <= 0:
        return None
    return 1e6 * run.delta("prefill_s") / toks
