"""Decontam / JBU / classify chunks per traced call: the traced spans of the
``chunk`` layer over the traced calls; None without a trace."""


def read(run):
    if not run.trace or not run.trace.requests:
        return None
    return run.trace.layer_calls.get("chunk", 0) / run.trace.requests
