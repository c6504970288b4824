"""Milliseconds of each INFER's forward call, which enqueues its kernels
(``ActionRecord.launch_s``), summed over the window's successful INFER
records, over the requests they carried (engine, serving/engine.py). None
where no record holds the phase."""


def read(rec):
    done = [a for a in rec.actions if a.status == "SUCCESS"
            and getattr(a, "launch_s", None) is not None]
    rows = sum(a.batch_size for a in done)
    if not rows:
        return None
    return 1e3 * sum(a.launch_s for a in done) / rows
