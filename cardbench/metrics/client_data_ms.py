"""Host milliseconds a round spends making its clients' token batches
(``launch/train.py client_batches``, the FL loop's data): the span the
harness wraps around that module attribute, averaged over the traced
run's rounds after the profiled ones."""
SPAN = "client_data"


def read(run):
    if not run.span_rounds or SPAN not in run.span_s:
        return None
    return run.span_s[SPAN] / run.span_rounds * 1e3
