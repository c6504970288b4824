"""Milliseconds of device time between the CUDA events recorded around
each INFER's launch (``ActionRecord.device_s``), summed over the window's
successful INFER records, over the requests they carried (engine,
serving/engine.py). None where no record holds the phase (on the CPU)."""


def read(rec):
    done = [a for a in rec.actions if a.status == "SUCCESS"
            and getattr(a, "device_s", None) is not None]
    rows = sum(a.batch_size for a in done)
    if not rows:
        return None
    return 1e3 * sum(a.device_s for a in done) / rows
