"""Device milliseconds a round of the local steps' optimizer updates: the
device time of the kernels launched inside the port's ``step_optimizer``
ranges (``opt.update`` and ``apply_updates`` in ``core/client.py
make_step`` and ``launch/steps.py make_train_step``) in the host-profiled
rounds, over the rounds.  A trace with another count of ranges than a
step a batch reads nothing."""
from cardbench import spans

RANGES = ("step_optimizer",)


def read(run):
    seconds = spans.range_s(run, "step_optimizer", "step")
    return None if seconds is None else seconds / run.profile_rounds * 1e3
