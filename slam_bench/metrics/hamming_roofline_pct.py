"""Kernel: the Hamming kernel's share of its roofline over every launch in
the trace: the launches' byte-bound time at the HBM peak (shapes from the
program's launch counter over the same stretch) over their device time.
None unless the trace holds exactly the launches the counter counted."""

from slam_bench import peaks


def read(run):
    tr = run["session"].get("trace")
    if not tr or tr["kernels"] is None:
        return None
    st, en, nid, names = tr["kernels"]
    dev, n_trace = 0, 0
    for j in (j for j, n in enumerate(names) if peaks.HAMMING_KERNEL in n):
        sel = nid == j
        dev += int((en[sel] - st[sel]).sum())
        n_trace += int(sel.sum())
    bound, n_count = 0.0, 0
    for shape, n in tr["hamming_shapes"].items():
        nq, nt = (int(x) for x in shape.split("x"))
        bound += n * peaks.hamming_bound_s(nq, nt)
        n_count += n
    if n_trace == 0 or n_trace != n_count or dev <= 0:
        return None
    return 100.0 * bound / (dev / 1e9)
