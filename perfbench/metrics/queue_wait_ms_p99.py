"""p99, over the requests that the window's successful INFER records
carried, of the controller's send time (``ActionRecord.issued``) minus the
sender's call of ``Controller.on_request`` (``Sent.sent``, the instant the
program stamps ``RequestSpan.queued``): how long a request waited in the
controller (core/controller.py). None where no record holds ``issued``."""
from perfbench.harness.stats import percentile


def read(rec):
    sent = {s.req.id: s.sent for s in rec.requests}
    waits = [(a.issued - sent[r]) * 1e3 for a in rec.actions
             if a.status == "SUCCESS" and getattr(a, "issued", None)
             is not None for r in a.request_ids if r in sent]
    return percentile(waits, 99.0)
