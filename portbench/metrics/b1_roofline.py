"""Kernel B1: the least time of every B1 call in the traced window (its
bound at that call's rows, nbin, K, itemsize and form) over B1's device
time.  The bound counts the work the call's shapes need, whatever the
kernel does."""

from portbench.bounds import cross_spectrum_bound_ms

# B1's kernels (ops/csrc: the FFT arm and the two GEMM arms)
KERNELS = ("fft_dense_kernel", "fcs_kernel", "fcs_tc_kernel")


def read(ctx):
    t = sum(e - s for n, s, e in ctx["device"]
            if any(k in n for k in KERNELS))
    calls = ctx["b1_calls"]
    if t <= 0 or not calls:
        return None
    bound_ms = sum(cross_spectrum_bound_ms(
        c["nb"], c["nchan"], c["nbin"], c["K"], c["itemsize"],
        c["want_m2"], c["shared"])[0] for c in calls)
    return 100.0 * bound_ms * 1e-3 / t
