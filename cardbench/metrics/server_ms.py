"""Milliseconds a round spends on the server: the aggregation and the
teacher's build (``fl_loop._aggregate`` and FedGKD's ``round_payload``;
``train.weighted_average`` and ``train.ensemble_average``), with the
device synchronised around each call, averaged over the traced run's
rounds after the profiled ones."""
SPAN = "server"


def read(run):
    if not run.span_rounds or SPAN not in run.span_s:
        return None
    return run.span_s[SPAN] / run.span_rounds * 1e3
