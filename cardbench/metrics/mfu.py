"""The rounds' share of the card's peak, in percent: model FLOPs of the
work the rounds do (their local train steps with their teacher forwards,
the teacher's precompute over the cohort's shards and the evaluation's
forwards; ``frozen.roofline``), over their seconds times the peak of the
configuration's dtype (989 TFLOP/s bf16; 495 TFLOP/s fp32, the TF32
tensor cores, the fastest rate at which the card multiplies fp32
operands).  Taken over the traced run's rounds after the profiled ones."""


def read(run):
    if not run.span_rounds or run.unprofiled_s <= 0 or run.span_flops <= 0:
        return None
    return 100.0 * run.span_flops / (run.unprofiled_s * run.peak_flops)
