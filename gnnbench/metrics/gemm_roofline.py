"""The GEMM kernel's share of its roofline over the traced stretch, in %:
the least time of the LINEAR layers' work (``models/<family>.work``)
over the kernel's device time."""

PATTERNS = ("gemm_f32_kernel",)


def read(ctx):
    return ctx.roofline("gemm", PATTERNS)
