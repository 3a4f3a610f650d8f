"""Median per call of the port's ``preview`` spans, ms: every job's
loudest-window search and its two pieces cut and written
(``preview.create_preview``; ``perfbench/spans.py``).  None in a program
without the span."""

from perfbench import spans


def _ms(call):
    return call.host_ms("preview") if call.named("preview") else None


def read(run):
    return spans.median_per_call(run, _ms)
