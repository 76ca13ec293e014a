"""The decode call's grouped expert kernels' share of their roofline over
the traced slice (an afmoe configuration): the least time the card could
take for what the routed experts of every MoE layer must move and compute
in the slice's decode steps (``counts_afmoe``: per layer call of T tokens,
the weights of the E (1 - (1 - k/E)^T) experts uniform routing reaches and
the activations in and out, T the requests that decoded a token in that
step, from the harness's own record) over the device time
``torch.profiler`` recorded for kernels whose name holds
``moe_experts_decode`` (the gate/up and down kernels of a decode call).

The expert count is an expectation: where routing reaches fewer experts
than uniform routing would, the count overstates the bytes and the share
reads high.  Measured on trinity-mini.mixed-chat (the engine's
``moe_experts_hit`` over 300 steps against the expectation at the rows
each decode call passes, 24; NVIDIA H100 80GB HBM3): 0.974, with the
experts drawn independently and around a common matrix alike, the real
coverage 2.6 % below uniform, within the 3 % this count allows.  Nothing
is read where the configuration is not afmoe or no such kernel ran."""
import counts_afmoe

SOURCE = "device_trace"
KERNEL = "moe_experts_decode"


def read(run):
    sl = run.slice
    if sl is None or run.cell.cfg.get("family") != "afmoe":
        return None
    device_s = sl.kernel_seconds(KERNEL)
    if device_s <= 0:
        return None
    s = counts_afmoe.Sizes(run.cell.cfg)
    least = 0.0
    for rows in run.slice_rows:
        if rows:
            T = len(rows)
            least += s.moe_layers * counts_afmoe.roofline_seconds(
                counts_afmoe.moe_call_flops(s, T),
                counts_afmoe.moe_call_bytes(s, T))
    if least <= 0:
        return None
    return 100.0 * least / device_s
