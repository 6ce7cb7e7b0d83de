"""The attention forward (``repro_torch::flash_attention_fwd``, B4) against
its roofline, in percent: for every launch in the profiled rounds, the
least time of its work from its recorded shapes (q, k, v and o bytes once;
4·D FLOP an attended pair and query head, the causal half; FLOP at the
peak of the configuration's dtype with no factor for how a kernel splits
its products), summed, over the device time of the launches."""
from cardbench.frozen import roofline as rl

OP = "repro_torch::flash_attention_fwd"
OPS = (OP,)


def _arg(concrete, i):
    """A scalar argument as the profiler recorded it, or None."""
    if not concrete or len(concrete) <= i or concrete[i] in ("", None, []):
        return None
    v = concrete[i]
    return v == "True" if isinstance(v, str) and v in ("True", "False") else v


def read(run):
    p = run.profile
    calls = (p or {}).get("ops", {}).get(OP, [])
    if not calls:
        return None
    dtype = run.config["activation_dtype"]
    bound = seconds = 0.0
    for shapes, concrete, sec in calls:
        (b, sq, hq, d), (_, skv, hkv, _) = shapes[0], shapes[1]
        causal, window = _arg(concrete, 3), _arg(concrete, 4)
        if window is not None:
            return None            # a windowed mask: not this reader's work
        bound += rl.attention_fwd_bound_s(b, sq, skv, hq, hkv, d,
                                          True if causal is None else causal,
                                          dtype)
        seconds += sec
    return 100.0 * bound / seconds if seconds > 0 else None
