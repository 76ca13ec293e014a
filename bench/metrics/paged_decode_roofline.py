"""B1's share of its roofline over the traced slice: the least time the
card could take for what B1 must move and compute in the slice's decode
steps (``counts``: every resident K and V byte read once, q read, the
output written, from the harness's own record of each request that
decoded a token in that step, at its resident length) over the device
time ``torch.profiler`` recorded for kernels whose name holds
``paged_decode_kernel``."""
import counts

SOURCE = "device_trace"
KERNEL = "paged_decode_kernel"


def read(run):
    sl = run.slice
    if sl is None:
        return None
    device_s = sl.kernel_seconds(KERNEL)
    if device_s <= 0:
        return None
    s, least = run.sizes, 0.0
    for rows in run.slice_rows:
        if rows:
            least += counts.roofline_seconds(
                sum(counts.paged_decode_flops(s, n) for n in rows),
                sum(counts.paged_decode_bytes(s, n) for n in rows))
    if least <= 0:
        return None
    return 100.0 * least / device_s
