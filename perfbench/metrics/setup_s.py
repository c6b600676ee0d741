"""setup_s: process start to the first timed call: imports, the kernel
library's load, the inputs, planning, packing, lowering, capture and
warm-up (s)."""


def read(ctx):
    return ctx.setup_s
