"""Milliseconds a round spends evaluating the new global model
(``core/fl_loop.py evaluate``; ``launch/train.py eval_ppl``), with the
device synchronised around the call, averaged over the traced run's
rounds after the profiled ones."""
SPAN = "eval"


def read(run):
    if not run.span_rounds or SPAN not in run.span_s:
        return None
    return run.span_s[SPAN] / run.span_rounds * 1e3
