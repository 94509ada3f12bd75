"""The registration's search kernels' share of their roofline in the traced
training phase: the least time of the launches the slice holds (the larger
of 9 fp32 operations a valid pair at 67 TFLOP/s and the bytes at 3.35 TB/s)
over their device time (the sweep with its fold, or the accumulator's
sweep with its fill and unpack)."""

from benchmark.counts import bound_seconds, search_bytes, search_ops
from benchmark.trace import kernel_seconds

SWEEPS = ("nn_bidir_kernel", "nn_bidir_acc_kernel")
SEARCH = SWEEPS + ("fold_partials_kernel", "fill_words_kernel", "unpack_words_kernel")


def read(data):
    sl, reg = data.get("slice"), data.get("register")
    if sl is None or reg is None:
        return None
    seconds, _ = kernel_seconds(sl, SEARCH)
    _, launches = kernel_seconds(sl, SWEEPS)
    if launches == 0 or seconds <= 0:
        return None
    bound = bound_seconds(search_ops(reg["pairs"]), search_bytes(reg["points"]))
    return 100.0 * launches * bound / seconds
