"""Device milliseconds a round of the local steps' forwards: the device
time of the kernels and copies launched inside the port's
``step_forward`` ranges (``core/client.py make_step``, ``launch/steps.py
make_train_step``) in the host-profiled rounds, less that of the teacher
forwards inside them where the teacher runs in the step (``launch/steps.py
make_loss_fn``), over the rounds.  A trace with another count of ranges
than a step a batch reads nothing."""
from cardbench import spans

RANGES = ("step_forward", "teacher")


def read(run):
    seconds = spans.range_s(run, "step_forward", "step")
    if seconds is not None and spans.teacher_in_step(run):
        teacher = spans.range_s(run, "teacher", "teacher")
        seconds = None if teacher is None else seconds - teacher
    return None if seconds is None else seconds / run.profile_rounds * 1e3
