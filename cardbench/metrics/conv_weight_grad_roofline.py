"""ResNet-8's conv weight gradients against their roofline, in percent:
the least time of their work (``frozen.roofline.resnet8_dw_bound_s``:
FLOP at the TF32 peak or bytes at the HBM rate, conv by conv, from the
benchmark's own copy of the geometry) over the device time of the kernels
launched inside the port's ``grouped_conv_dw`` ranges in the profiled
rounds.  The work reads the same whatever implements the gradient.  Every
local step takes one gradient a conv; a trace with another count of ranges
reads nothing."""
from cardbench.frozen import roofline as rl

RANGE = "grouped_conv_dw"
RANGES = (RANGE,)


def read(run):
    p = run.profile
    if p is None or RANGE not in p["ranges"]:
        return None
    seconds, hits = p["ranges"][RANGE]
    cfg, tr = run.config, run.traffic
    convs = len(rl.resnet8_convs(cfg["width"], cfg["image_hw"]))
    steps = run.profile_rounds * tr["max_batches_per_client"]
    if seconds <= 0 or hits != convs * steps:
        return None
    bound = steps * rl.resnet8_dw_bound_s(tr["cohort"], tr["batch"],
                                          cfg["width"], cfg["image_hw"])
    return 100.0 * bound / seconds
