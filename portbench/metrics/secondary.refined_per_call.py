"""Secondaries the refinement aligned per refinement DP call: the
program's ``ops.counters()["secondary"]`` ``refined`` over
``refine_calls``, the process's counts when the traced run reads them
(warm-up, window, traced parts). None where the program keeps no such
counts or made no refinement call."""


def read(rec):
    from blasr_tpu_torch import ops

    counters = getattr(ops, "counters", None)
    sec = counters().get("secondary") if counters is not None else None
    if not sec or not sec.get("refine_calls"):
        return None
    return sec["refined"] / sec["refine_calls"]
