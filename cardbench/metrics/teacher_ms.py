"""Device milliseconds a round of FedGKD's teacher forwards, the work the
method adds to FedAvg: the device time of the kernels launched inside the
port's ``teacher`` ranges in the host-profiled rounds (the precompute over
the cohort's shards, once a round, in ``core/executor.py
VmapExecutor.run_round``; the teacher forward of every step in
``launch/steps.py make_loss_fn``), over the rounds.  A trace with another
count of ranges than the traffic implies reads nothing."""
from cardbench import spans

RANGES = ("teacher",)


def read(run):
    seconds = spans.range_s(run, "teacher", "teacher")
    return None if seconds is None else seconds / run.profile_rounds * 1e3
