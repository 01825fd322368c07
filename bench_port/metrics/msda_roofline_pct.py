"""K11 (csrc/msda_kernel.cu, RT-DETR's deformable attention core): the
least time the card could take for the window's launches over the time
they took. Each launch's least time is the larger of its operations over
the float32 peak outside the tensor cores (67 TFLOP/s) and its bytes over
the HBM's 3.35 TB/s; both come from the frame's own sampling locations
(`msda_work` beside K11's wrapper, cova_tpu_torch/ops/cuda/msda_kernel.py:
the value rows the samples touch, each read once, the offsets, logits and
boxes read once, the output written once), counted here on the host from the boxes and offsets of each
launch that the oracle's `take()` kept. The time is the trace's device time
of the kernel by name. The value is written just before K11 reads it and
stays in the 50 MB L2, so a share near 100 % means that K11 reads from
L2, not from HBM."""

KERNELS = ("ms_deform_attn_kernel",)
HBM_BYTES_PER_S = 3.35e12


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    launches = [launch for j in run["jobs"] for frame in j.frames
                if isinstance(frame[5], dict) for launch in frame[5].get("msda", ())]
    if not launches:
        return None
    from cova_tpu_torch.ops.cuda.msda_kernel import msda_work

    work = [msda_work(*launch) for launch in launches]
    us = tr.kernel_us(KERNELS)
    if us <= 0:
        return None
    least = sum(max(ops / run["peak_flops"], nbytes / HBM_BYTES_PER_S) for ops, nbytes in work)
    return 100.0 * least / (us / 1e6)
