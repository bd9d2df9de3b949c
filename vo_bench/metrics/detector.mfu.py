"""detector.mfu: the detector's model FLOPs a frame (2 x the multiply-adds of
the cfg's convolutions at its input size, ``roofline.detector_flops``) over
the mean loop iteration's seconds before the profiler times the card's
67 TFLOP/s float32 peak, in %: the share of the whole iteration that the
system's only model fills."""

from vo_bench import readings, roofline


def read(ctx):
    det = ctx.cell.config.get("detector")
    seconds = readings.mean_iteration_s(ctx)
    if det is None or not seconds:
        return None
    return 100.0 * roofline.detector_flops(det["cfg_text"]) / (seconds * roofline.FP32_FLOP_PER_S)
