"""The SpDMM kernels' share of their roofline over the traced stretch,
in %: the least time of the aggregations' work over the device time of
the step-list and hub kernels."""

PATTERNS = ("spdmm_steps_kernel", "spdmm_hub_kernel")


def read(ctx):
    return ctx.roofline("spdmm", PATTERNS)
