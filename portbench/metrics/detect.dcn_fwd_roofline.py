"""detect.dcn_fwd_roofline (%): the neck's shift-DCN forward kernels
(csrc/dcn_shift.cu: the bf16 wgmma kernel and its split-K reduce, or the
float32 kernel) against their bound: the sum over the neck's DCN layers at
the cell's shapes of max(bytes / 3.35 TB/s, operations / peak)
(`yardstick/roofline.py:shift_dcn_bound`) over the kernels' device time per
call. Moves detect_images_per_s."""

from portbench.yardstick.roofline import shift_dcn_bound

KERNELS = ("dcn_shift_bf16_wgmma_kernel", "dcn_shift_splitk_reduce_kernel",
           "dcn_shift_fwd_kernel")


def read(run):
    ms = run.kernels_ms_per_call(KERNELS)
    if not ms or not run.dcn_shapes:
        return None
    bound = sum(max(shift_dcn_bound(*s, run.dtype)) for s in run.dcn_shapes)
    return 100.0 * bound / ms
