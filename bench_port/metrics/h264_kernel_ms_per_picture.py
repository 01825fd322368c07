"""Kernels K8-K10 (csrc/h264_inter.cu, h264_intra.cu, h264_deblock.cu):
their device time in the trace, per picture decoded. The trace names a
kernel with its namespace and signature, as
"(anonymous namespace)::h264_deblock_kernel(RecArgs)": a name counts when
it holds one of these."""

KERNELS = ("h264_inter_kernel", "h264_intra_kernel", "h264_deblock_kernel")


def read(run):
    tr = run["trace"]
    if tr is None or not run["pictures"]:
        return None
    us = tr.kernel_us(KERNELS)
    return us / 1e3 / run["pictures"] if us > 0 else None
