"""The SDDMM kernel's share of its roofline over the traced stretch, in
%: the least time of the dot scores' work over the kernel's device
time."""

PATTERNS = ("sddmm_f32_kernel",)


def read(ctx):
    return ctx.roofline("sddmm", PATTERNS)
