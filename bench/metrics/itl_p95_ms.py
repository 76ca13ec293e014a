"""Gap between consecutive tokens of one request, 95th percentile over
every gap of every request in the window, stamped when ``step()``
returns; a step that carried a prefill grant counts in full, and a
request still owing tokens at the close adds its wait since its last
token.  Host clock."""
import stats

SOURCE = "host_clock"


def read(run):
    p = stats.percentile(stats.window_gaps(run), 95)
    return None if p is None else 1e3 * p
